// Grouped-query attention backward, float32: dQ, dK and dV of the forward
// in flash_attention.cu.
//
// The TPU package has no backward kernel: the JAX trainer differentiates the
// plain chunked attention (repro/models/layers.py::_attend_chunked) with
// XLA, while the forward it replaces on the card is the TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention (_fa_kernel).
// Given q (B, S, K, G, D), k and v (B, T, K, D) and dO (B, S, K, G, D), with
// the forward's masks (causal with a q_offset, keys at or past kv_len) and
// scaled query qs = q * scale:
//
//   s = qs . k (masked: -1e30),  P = softmax_j(s),  dP = dO . v,
//   dS = P * (dP - sum_j P * dP)  (0 where masked),
//   dQ = scale * dS . k,  dK = dS^T . qs,  dV = P^T . dO.
//
// A masked score takes part in the softmax exactly as in the forward (so a
// fully masked row averages v and sends dV its share) but gets no gradient,
// as torch.where gives none to the plain version's masked scores.
//
// What bounds it on an H100: at the predictor's shapes (B 256, S = T = 10,
// K 2, G 1, D 32) a call reads about 1.3 MB, writes about 1 MB and does
// about 13 MFLOP, so launch latency bounds it, then bytes.  Design, simple
// first: one block of 256 threads per (batch, kv head) holds the head's
// whole problem in shared memory (qs and dO for its S * G rows, k and v for
// its T keys, P and dS as (S * G, T) tiles), so it owns all of dK and dV for
// its head; each output element is one thread's loop in a fixed order, with
// no atomics, so the result is deterministic (a fine-tuned run gives the
// same counters twice).  The tiles must fit the 227 KB of shared memory a
// block can have; the wrapper raises for longer sequences.  Scores are full
// float32 FMAs (no TF32).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;
constexpr size_t kMaxSmem = 232448;  // what a block may opt into on Hopper

size_t smem_bytes(int R, int T, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(R) * D + 2 * static_cast<size_t>(T) * D +
                          2 * static_cast<size_t>(R) * T);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, int S, int T, int K, int G, int causal, int q_offset, int kv_len,
              float scale) {
  extern __shared__ float smem[];
  const int R = S * G;  // query rows of this head: row r is (s, g) = (r / G, r % G)
  float* qs = smem;           // (R, D) scaled queries
  float* dos = qs + R * D;    // (R, D) output gradients
  float* ks = dos + R * D;    // (T, D)
  float* vs = ks + T * D;     // (T, D)
  float* ps = vs + T * D;     // (R, T) scores, then P
  float* dss = ps + R * T;    // (R, T) dP, then dS
  const int kh = blockIdx.x % K;
  const int b = blockIdx.x / K;
  const int tid = threadIdx.x;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long src = ((((long long)b * S + r / G) * K + kh) * G + r % G) * D + d;
    qs[i] = q[src] * scale;
    dos[i] = dout[src];
  }
  for (int i = tid; i < T * D; i += kThreads) {
    const int t = i / D, d = i % D;
    const long long src = (((long long)b * T + t) * K + kh) * D + d;
    ks[i] = k[src];
    vs[i] = v[src];
  }
  __syncthreads();

  // scores (masked as in the forward) and dP = dO . v
  for (int i = tid; i < R * T; i += kThreads) {
    const int r = i / T, t = i % T;
    float sc = 0.f, dp = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      sc = fmaf(qs[r * D + d], ks[t * D + d], sc);
      dp = fmaf(dos[r * D + d], vs[t * D + d], dp);
    }
    const int q_pos = q_offset + r / G;
    if ((causal && q_pos < t) || t >= kv_len) sc = kNeg;
    ps[i] = sc;
    dss[i] = dp;
  }
  __syncthreads();

  // per row: P = softmax(s), dS = P * (dP - sum(P * dP)), 0 where masked
  for (int r = tid; r < R; r += kThreads) {
    float* pr = ps + r * T;
    float* dr = dss + r * T;
    const int q_pos = q_offset + r / G;
    float m = kNeg;
    for (int t = 0; t < T; ++t) m = fmaxf(m, pr[t]);
    float l = 0.f;
    for (int t = 0; t < T; ++t) l += expf(pr[t] - m);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float di = 0.f;
    for (int t = 0; t < T; ++t) {
      pr[t] = expf(pr[t] - m) * inv;
      di = fmaf(pr[t], dr[t], di);
    }
    for (int t = 0; t < T; ++t) {
      const bool live = !((causal && q_pos < t) || t >= kv_len);
      dr[t] = live ? pr[t] * (dr[t] - di) : 0.f;
    }
  }
  __syncthreads();

  // dQ = scale * dS . k
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float acc = 0.f;
    for (int t = 0; t < T; ++t) acc = fmaf(dss[r * T + t], ks[t * D + d], acc);
    dq[((((long long)b * S + r / G) * K + kh) * G + r % G) * D + d] = acc * scale;
  }
  // dK = dS^T . qs and dV = P^T . dO, whole for this head: no other block writes them
  for (int i = tid; i < T * D; i += kThreads) {
    const int t = i / D, d = i % D;
    float ak = 0.f, av = 0.f;
    for (int r = 0; r < R; ++r) {
      ak = fmaf(dss[r * T + t], qs[r * D + d], ak);
      av = fmaf(ps[r * T + t], dos[r * D + d], av);
    }
    const long long dst = (((long long)b * T + t) * K + kh) * D + d;
    dk[dst] = ak;
    dv[dst] = av;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* dout, float* dq, float* dk, float* dv,
           int B, int S, int T, int K, int G, int causal, int q_offset, int kv_len, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(S * G, T, D);
  if (bytes > kMaxSmem) return -1;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fa_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fa_bwd_kernel<D><<<B * K, kThreads, bytes, stream>>>(q, k, v, dout, dq, dk, dv, S, T, K, G, causal, q_offset,
                                                       kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors float32 and contiguous.  `scale` is the forward's: D ** -0.5.
// Returns cudaGetLastError() after the launch, or -1 for a head width the
// kernel is not built for or tiles that do not fit in shared memory.
extern "C" int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                                             void* dq, void* dk, void* dv, int B, int S, int T, int K, int G,
                                             int D, int causal, int q_offset, int kv_len, float scale,
                                             void* stream) {
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* dd = static_cast<const float*>(dout);
  auto* dqq = static_cast<float*>(dq);
  auto* dkk = static_cast<float*>(dk);
  auto* dvv = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_BWD(DD) \
  launch<DD>(qq, kk, vv, dd, dqq, dkk, dvv, B, S, T, K, G, causal, q_offset, kv_len, scale, st)
  switch (D) {
    case 8: return REPRO_FA_BWD(8);
    case 16: return REPRO_FA_BWD(16);
    case 32: return REPRO_FA_BWD(32);
    case 64: return REPRO_FA_BWD(64);
    case 128: return REPRO_FA_BWD(128);
    default: return -1;
  }
#undef REPRO_FA_BWD
}
