// Grouped-query attention forward with an online softmax, float32 or bf16.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (_fa_kernel): q (B, S, K, G, D), k and v (B, T, K, D),
// causal mask with a q_offset, a scalar kv_len, output (B, S, K, G, D).
// Masked scores are -1e30 and take part in the softmax exactly as in the
// reference, so a fully masked row averages v as it does there.  The bf16
// instantiation keeps the reference's rounding points: q * scale rounded to
// bf16, float32 scores and softmax, p rounded to bf16 before the PV
// product, a float32 accumulator and a bf16 output.
//
// What bounds it on an H100: at the predictor's shapes (B 256, S = T = 10,
// K 2, G 1, D 32) a call moves about 1 MB and does about 3 MFLOP, so it is
// bound by launch latency, not by bytes or operations.  At the serving
// prefill (bf16, B 2, S = T = 1792, K 2, G 7, D 64) it does about 11.5
// GFLOP of float32 FMAs on CUDA cores and reads about 5 MB, so operations
// bound it.  Design, simple first: one thread block per (batch, kv head,
// tile of query rows), one thread per (query row, group) that keeps its
// scaled query and its accumulator in registers; K and V tiles of 32 rows
// are staged in shared memory as float32 and read as broadcasts.  Scores are
// full float32 FMAs (no TF32, because the reference casts q and k to
// float32).  S and T need not be multiples of any tile.  At G 7 a tile holds
// 128 / 7 = 18 query rows and every tile walks all of T (masked keys are
// computed, not skipped): right but slow.  Tensor-core tiling (bf16 wgmma)
// and skipping fully masked key tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;  // query rows (row, group pairs) per thread block at most
constexpr int kBK = 32;     // keys per shared-memory tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
// x rounded to the element type and back (the identity for float)
template <typename E>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<E>(x)); }

template <typename E, int D>
__global__ void __launch_bounds__(kRows)
fa_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
              const E* __restrict__ v, E* __restrict__ o, int S, int T, int K, int G,
              int bq, int n_qt, int causal, int q_offset, int kv_len, float scale) {
  __shared__ float ks[kBK][D];
  __shared__ float vs[kBK][D];
  const int tile = blockIdx.x % n_qt;
  const int kh = (blockIdx.x / n_qt) % K;
  const int b = blockIdx.x / (n_qt * K);
  const int r = threadIdx.x;
  const int s = tile * bq + r / G;
  const int g = r % G;
  const bool active = r < bq * G && s < S;
  const long long row = active ? ((((long long)b * S + s) * K + kh) * G + g) * D : 0;
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? round_to<E>(to_f(q[row + d]) * scale) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNeg, l = 0.f;
  const int q_pos = q_offset + s;
  for (int t0 = 0; t0 < T; t0 += kBK) {
    const int n_t = min(kBK, T - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n_t * D; i += blockDim.x) {
      const int tt = i / D, d = i % D;
      const long long src = (((long long)b * T + t0 + tt) * K + kh) * D + d;
      ks[tt][d] = to_f(k[src]);
      vs[tt][d] = to_f(v[src]);
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < n_t; ++tt) {
      const int k_pos = t0 + tt;
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], ks[tt][d], sc);
      if ((causal && q_pos < k_pos) || k_pos >= kv_len) sc = kNeg;
      const float m_new = fmaxf(m, sc);
      const float p = expf(sc - m_new);
      const float alpha = expf(m - m_new);
      l = l * alpha + p;
      const float pr = round_to<E>(p);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pr, vs[tt][d], acc[d] * alpha);
      m = m_new;
    }
  }
  if (active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) o[row + d] = from_f<E>(acc[d] / denom);
  }
}

template <typename E, int D>
int launch(const E* q, const E* k, const E* v, E* o, int B, int S, int T, int K,
           int G, int causal, int q_offset, int kv_len, float scale, cudaStream_t stream) {
  const int bq = max(1, min(S, kRows / G));
  const int n_qt = (S + bq - 1) / bq;
  const int threads = ((bq * G + 31) / 32) * 32;
  fa_fwd_kernel<E, D><<<B * K * n_qt, threads, 0, stream>>>(q, k, v, o, S, T, K, G, bq, n_qt, causal,
                                                        q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int T, int K, int G, int D,
             int causal, int q_offset, int kv_len, float scale, void* stream) {
  const auto* qq = static_cast<const E*>(q);
  const auto* kk = static_cast<const E*>(k);
  const auto* vv = static_cast<const E*>(v);
  auto* oo = static_cast<E*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<E, 8>(qq, kk, vv, oo, B, S, T, K, G, causal, q_offset, kv_len, scale, st);
    case 16: return launch<E, 16>(qq, kk, vv, oo, B, S, T, K, G, causal, q_offset, kv_len, scale, st);
    case 32: return launch<E, 32>(qq, kk, vv, oo, B, S, T, K, G, causal, q_offset, kv_len, scale, st);
    case 64: return launch<E, 64>(qq, kk, vv, oo, B, S, T, K, G, causal, q_offset, kv_len, scale, st);
    case 128: return launch<E, 128>(qq, kk, vv, oo, B, S, T, K, G, causal, q_offset, kv_len, scale, st);
    default: return -1;
  }
}

}  // namespace

// `scale` multiplies q before the dot: D ** -0.5 rounded to the element
// type, as the reference's weak-typed `q * scale` rounds it.  Returns
// cudaGetLastError() after the launch, or -1 for a head width the kernel is
// not built for.
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                         int B, int S, int T, int K, int G, int D, int causal,
                                         int q_offset, int kv_len, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, B, S, T, K, G, D, causal, q_offset, kv_len, scale, stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          int B, int S, int T, int K, int G, int D, int causal,
                                          int q_offset, int kv_len, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, T, K, G, D, causal, q_offset, kv_len, scale, stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
