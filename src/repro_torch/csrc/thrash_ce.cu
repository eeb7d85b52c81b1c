// Thrashing-aware cross-entropy, forward and backward, float32.
//
// Replaces the TPU kernels repro/kernels/thrash_ce/kernel.py::thrash_ce
// (_fwd_kernel, _bwd_kernel under a custom_vjp).  Per row of the logits
// (B, V): classes >= n_active are masked to -1e30, m = the row's max, lse =
// log(sum exp(x - m)) + m, and the forward writes (lse - x[label]) * w with
// w = 1 - mu * in_et; the wrapper averages the rows, as the TPU wrapper
// does.  The backward writes ((p - onehot) * w) * (g / B) with p = exp(x -
// m) / max(sum, 1e-30): zero on the masked classes.
//
// What bounds it on an H100: at the predictor's shape (B 256, V 1024) the
// forward reads 1 MB and the backward reads 1 MB and writes 1 MB, a few
// hundred nanoseconds at 3.35 TB/s; about 10 operations per element are
// far below the card's rate, so bytes bound it, and below a few MB launch
// latency does.  Design, simple first: one block of 256 threads per row
// (the TPU kernel's 128-row blocks become independent rows: nothing
// carries between blocks), strided loops over the row (V <= 4096 stays in
// L1 between the passes), warp shuffles then eight per-warp partials read
// by every thread in one fixed order, so the sums are deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 4096;
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

// The row's max and sum of exp(x - max) over the masked logits.
__device__ void row_stats(const float* lg, int V, int n_active, float* red, float& m, float& s) {
  float x = kNeg;
  for (int c = threadIdx.x; c < V; c += kThreads) x = fmaxf(x, masked(lg, c, n_active));
  m = block_reduce<true>(x, red);
  float e = 0.f;
  for (int c = threadIdx.x; c < V; c += kThreads) e += expf(masked(lg, c, n_active) - m);
  s = block_reduce<false>(e, red);
}

__global__ void __launch_bounds__(kThreads)
thrash_ce_fwd_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                     const int* __restrict__ in_et, float* __restrict__ loss, int V, int n_active, float mu) {
  __shared__ float red[kWarps];
  const long long row = blockIdx.x;
  const float* lg = logits + row * V;
  float m, s;
  row_stats(lg, V, n_active, red, m, s);
  if (threadIdx.x == 0) {
    const int label = labels[row];
    // the TPU kernel sums where(onehot, x, 0): 0 for a label outside [0, V)
    const float ll = (label >= 0 && label < V) ? masked(lg, label, n_active) : 0.f;
    const float lse = logf(s) + m;
    const float w = 1.f - mu * static_cast<float>(in_et[row]);
    loss[row] = (lse - ll) * w;
  }
}

__global__ void __launch_bounds__(kThreads)
thrash_ce_bwd_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                     const int* __restrict__ in_et, const float* __restrict__ g,
                     float* __restrict__ dlogits, int B, int V, int n_active, float mu) {
  __shared__ float red[kWarps];
  const long long row = blockIdx.x;
  const float* lg = logits + row * V;
  float m, s;
  row_stats(lg, V, n_active, red, m, s);
  const float denom = fmaxf(s, 1e-30f);
  const float w = 1.f - mu * static_cast<float>(in_et[row]);
  const float gb = g[0] / static_cast<float>(B);
  const int label = labels[row];
  float* out = dlogits + row * V;
  for (int c = threadIdx.x; c < V; c += kThreads) {
    const float p = expf(masked(lg, c, n_active) - m) / denom;
    const float onehot = c == label ? 1.f : 0.f;
    out[c] = ((p - onehot) * w) * gb;
  }
}

}  // namespace

// logits (B, V) float32, labels (B,) int32, in_et (B,) int32 (0 or 1);
// writes the per-row weighted losses (B,) float32.  Returns
// cudaGetLastError() after the launch, or -1 for a shape it does not take.
extern "C" int repro_thrash_ce_fwd_f32(const void* logits, const void* labels, const void* in_et, void* loss,
                                       int B, int V, int n_active, float mu, void* stream) {
  if (B <= 0 || V <= 0 || V > kMaxClasses) return -1;
  thrash_ce_fwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels), static_cast<const int*>(in_et),
      static_cast<float*>(loss), V, n_active, mu);
  return static_cast<int>(cudaGetLastError());
}

// g: the loss's upstream gradient, one float32 on the device; writes
// dlogits (B, V) float32.
extern "C" int repro_thrash_ce_bwd_f32(const void* logits, const void* labels, const void* in_et, const void* g,
                                       void* dlogits, int B, int V, int n_active, float mu, void* stream) {
  if (B <= 0 || V <= 0 || V > kMaxClasses) return -1;
  thrash_ce_bwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels), static_cast<const int*>(in_et),
      static_cast<const float*>(g), static_cast<float*>(dlogits), B, V, n_active, mu);
  return static_cast<int>(cudaGetLastError());
}
