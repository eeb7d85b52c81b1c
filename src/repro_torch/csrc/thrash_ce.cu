// Thrashing-aware cross-entropy, forward and backward, float32.
//
// Replaces the TPU kernels repro/kernels/thrash_ce/kernel.py::thrash_ce
// (_fwd_kernel, _bwd_kernel under a custom_vjp).  Per row of the logits
// (B, V): classes >= n_active are masked to -1e30, m = the row's max, s =
// sum exp(x - m), lse = log(s) + m, and the row's loss is (lse - x[label]) *
// w with w = 1 - mu * in_et; the loss is the mean over the rows.  The
// backward writes ((p - onehot) * w) * (g / B) with p = exp(x - m) /
// max(s, 1e-30): zero on the masked classes.
//
// What bounds it on an H100: at the predictor's shape (B 256, V 1024) the
// forward reads 1 MB and the backward reads 1 MB and writes 1 MB, a few
// hundred nanoseconds at 3.35 TB/s; about 10 operations per element are
// far below the card's rate, so bytes bound it, and below a few MB launch
// latency and the host's work per call do.  So the design spends as few
// launches per loss as it can:
//
// * Forward, one launch: one block of 256 threads per row (nothing
//   carries between rows), the row in registers (V <= 4096 is at most 16
//   values a thread), warp shuffles then eight per-warp partials read in
//   one fixed order.  Each block writes its row's loss to a scratch row and,
//   when a gradient is wanted, its (m, s) to a (B, 2) side tensor.  The
//   block that finishes last, picked by an integer ticket (an atomicAdd on
//   a counter that it resets to 0 itself, so no memset launch), sums the B
//   row losses in one fixed order and writes the mean: no second launch for
//   the mean, no float atomics, and a call repeats bit for bit.  The fence
//   and the ticket's round trip to L2 lengthen the last block: on an H100
//   the kernel takes about 0.0041 ms of device time where the per-row pass
//   alone took 0.0020 (chip_smoke.py, phase 3), and four rows to a block (a
//   quarter of the atomics on the one counter) took 0.0051.
// * Backward, one launch: it reads the logits once with the saved (m, s),
//   so it does no reduction; m and s are the forward's own bits, so the
//   gradient is the one that recomputing them gives (a null side tensor
//   recomputes them, which is how the two are held equal on the card).
// * Labels and flags are int32, as the trainer makes them; null flags mean
//   no thrashing term, so a loss without the term allocates no zeros.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                      // threads per row, one block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 4096;
constexpr int kPerThread = kMaxClasses / kThreads;  // a row's values per thread, at most
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A block-wide max or sum that every thread receives, in a fixed order.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red may still be read by an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float y = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) y = kMax ? fmaxf(y, red[w]) : y + red[w];
  return y;
}

__device__ __forceinline__ float masked(const float* lg, int c, int n_active) {
  return c >= n_active ? kNeg : lg[c];
}

// Thread t's values of the row: classes t, t + kThreads, ... (masked).
__device__ __forceinline__ void load_row(const float* lg, int V, int n_active, int t, float (&xs)[kPerThread]) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int c = t + k * kThreads;
    xs[k] = c < V ? masked(lg, c, n_active) : kNeg;
  }
}

// The row's max and sum of exp(x - max) over the masked logits, each
// thread's values taken in class order.
__device__ void row_stats(const float (&xs)[kPerThread], int V, int t, float* red, float& m, float& s) {
  float x = kNeg;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (t + k * kThreads < V) x = fmaxf(x, xs[k]);
  m = block_reduce<true>(x, red);
  float e = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (t + k * kThreads < V) e += expf(xs[k] - m);
  s = block_reduce<false>(e, red);
}

// The row's label, or -1 outside [0, V) (the TPU kernel's where(onehot, x,
// 0) then picks nothing).
__device__ __forceinline__ int row_label(const int* labels, long long row, int V) {
  const int l = labels[row];
  return (l >= 0 && l < V) ? l : -1;
}

// The row's weight 1 - mu * in_et (null flags: weight 1).
__device__ __forceinline__ float row_weight(const int* in_et, long long row, float mu) {
  return 1.f - mu * (in_et != nullptr ? static_cast<float>(in_et[row]) : 0.f);
}

__global__ void __launch_bounds__(kThreads)
thrash_ce_fwd_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                     const int* __restrict__ in_et, float* __restrict__ row_loss,
                     float* __restrict__ stats, unsigned* __restrict__ ticket, float* __restrict__ loss,
                     int B, int V, int n_active, float mu) {
  __shared__ float red[kWarps];
  __shared__ bool is_last;
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const float* lg = logits + row * V;
  int label = -1;
  float w = 1.f;
  if (t == 0) {  // issued before the row's loads, waited for after them
    label = row_label(labels, row, V);
    w = row_weight(in_et, row, mu);
  }
  float xs[kPerThread];
  load_row(lg, V, n_active, t, xs);
  float m, s;
  row_stats(xs, V, t, red, m, s);
  if (t == 0) {
    const float ll = label >= 0 ? masked(lg, label, n_active) : 0.f;
    const float lse = logf(s) + m;
    row_loss[row] = (lse - ll) * w;
    if (stats != nullptr) {
      stats[2 * row] = m;
      stats[2 * row + 1] = s;
    }
    __threadfence();  // the row's loss is visible before the ticket counts it
    is_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(B - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block: every row's loss is written; sum them in one fixed order
  // (thread t takes rows t, t + kThreads, ...; then the block's reduction)
  float x = 0.f;
  for (int r = t; r < B; r += kThreads) x += __ldcg(row_loss + r);
  const float total = block_reduce<false>(x, red);
  if (t == 0) {
    *loss = total / static_cast<float>(B);
    *ticket = 0u;  // ready for the next call on this stream
  }
}

__global__ void __launch_bounds__(kThreads)
thrash_ce_bwd_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                     const int* __restrict__ in_et, const float* __restrict__ stats,
                     const float* __restrict__ g, float* __restrict__ dlogits, int B, int V, int n_active,
                     float mu) {
  __shared__ float red[kWarps];
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const float* lg = logits + row * V;
  float xs[kPerThread];
  load_row(lg, V, n_active, t, xs);  // first: the longest loads (faster on an H100 than last)
  float m = 0.f, s = 0.f;
  if (stats != nullptr) {
    m = stats[2 * row];
    s = stats[2 * row + 1];
  }
  const float w = row_weight(in_et, row, mu);
  const float gb = g[0] / static_cast<float>(B);
  const int label = row_label(labels, row, V);
  if (stats == nullptr) row_stats(xs, V, t, red, m, s);
  const float denom = fmaxf(s, 1e-30f);
  float* out = dlogits + row * V;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int c = t + k * kThreads;
    if (c < V) {
      const float p = expf(xs[k] - m) / denom;
      const float onehot = c == label ? 1.f : 0.f;
      out[c] = ((p - onehot) * w) * gb;
    }
  }
}

}  // namespace

// logits (B, V) float32; labels (B,) int32; in_et (B,) int32 (0 or 1) or
// null; row_loss (B,) float32 scratch; stats (B, 2) float32 or null;
// ticket: one unsigned int, 0 before the call and after it; writes the mean
// loss to loss (one float32).  Returns cudaGetLastError() after the launch,
// or -1 for a shape it does not take.
extern "C" int repro_thrash_ce_fwd_f32(const void* logits, const void* labels, const void* in_et, void* row_loss,
                                       void* stats, void* ticket, void* loss, int B, int V, int n_active, float mu,
                                       void* stream) {
  if (B <= 0 || V <= 0 || V > kMaxClasses) return -1;
  thrash_ce_fwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels), static_cast<const int*>(in_et),
      static_cast<float*>(row_loss),
      static_cast<float*>(stats), static_cast<unsigned*>(ticket), static_cast<float*>(loss), B, V, n_active, mu);
  return static_cast<int>(cudaGetLastError());
}

// stats: the forward's (B, 2) (m, s), or null to recompute them; g: the
// loss's upstream gradient, one float32 on the device; writes dlogits (B, V)
// float32.
extern "C" int repro_thrash_ce_bwd_f32(const void* logits, const void* labels, const void* in_et, const void* stats,
                                       const void* g, void* dlogits, int B, int V, int n_active, float mu,
                                       void* stream) {
  if (B <= 0 || V <= 0 || V > kMaxClasses) return -1;
  thrash_ce_bwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels), static_cast<const int*>(in_et),
      static_cast<const float*>(stats),
      static_cast<const float*>(g), static_cast<float*>(dlogits), B, V, n_active, mu);
  return static_cast<int>(cudaGetLastError());
}
