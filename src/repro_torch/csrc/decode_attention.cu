// One-token (decode) grouped-query attention against a KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::
// decode_attention_kernelcall (_dec_kernel): q (B, K, G, D), k and v
// (B, T, K, D), a scalar kv_len, output (B, K, G, D).  Arithmetic, step for
// step as there: q * scale rounded to the input type, float32 dots against
// K, keys at or after kv_len set to -1e30, an online softmax in float32 over
// blocks of 512 keys (the block's max, p = exp(s - m), l += sum p), p
// rounded to the input type before the float32 PV product, and
// acc / max(l, 1e-30) written in the input type.  bf16 and float32 share the
// template; T need not be a multiple of 512.
//
// What bounds it on an H100: at the serving path's shape (B 2, K 2, G 7,
// D 64, T 2048, bf16) a call reads about 2 * B * kv_len * K * D * 2 bytes,
// about 2 MB at kv_len 2048 (under a microsecond at 3.35 TB/s), and only
// B * K = 4 thread blocks run on 132 SMs, so it is bound by latency: the
// serial walk of each block over the cache.  Design, simple first: one
// thread block of 512 threads per (batch, kv head), walking the cache in
// blocks of 512 keys.  Per block: (1) a thread per key loads its K row with
// 16-byte loads and computes its G scores against the query rows, which
// every thread reads from shared memory as broadcasts; (2) a warp per query
// row updates the softmax state; (3) a thread per (head dim, slice of keys)
// loads each V element once and accumulates it into all G rows, and the
// slices' partial sums are added in a fixed order (so the result does not
// change from run to run).  The redesign for a later PR is split-K over the
// cache (a flash-decode with a combine pass), so that B * K * splits blocks
// fill the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 512;      // keys per online-softmax block (the TPU kernel's DEFAULT_BK)
constexpr int kThreads = 512;  // one thread per key of a block in step (1)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxGD = 1024;
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

// eight consecutive elements (16-byte aligned) as float32
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                        E* __restrict__ o, int T, int K, int G, int kv_len, float scale) {
  constexpr int kSlices = kThreads / D;  // key slices of step (3)
  extern __shared__ float smem[];
  float* qs = smem;              // scaled query rows (G, D)
  float* acc = qs + G * D;       // PV accumulator (G, D)
  float* sc = acc + G * D;       // a block's scores, then its rounded p (G, kBK)
  float* red = sc + G * kBK;     // step (3)'s partial sums (kSlices, G, D)
  float* m_s = red + kSlices * G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  const int kh = blockIdx.x % K;
  const int b = blockIdx.x / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qbase = ((long long)b * K + kh) * G * D;
  const long long row_stride = (long long)K * D;  // between consecutive keys
  const long long kvbase = (long long)b * T * row_stride + (long long)kh * D;
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = round_to<E>(to_f(q[qbase + i]) * scale);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  const int d3 = tid % D, slice = tid / D;
  for (int t0 = 0; t0 < T; t0 += kBK) {
    const int n = min(kBK, T - t0);
    // 1. scores: a thread per key
    if (tid < n) {
      const int t = t0 + tid;
      const E* kr = k + kvbase + (long long)t * row_stride;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kf[8];
        load8(kr + d0, kf);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
#pragma unroll
            for (int j = 0; j < 8; ++j) s[g] = fmaf(qs[g * D + d0 + j], kf[j], s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) sc[g * kBK + tid] = t < kv_len ? s[g] : kNeg;
      }
    }
    __syncthreads();
    // 2. the online-softmax state: a warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* row = sc + g * kBK;
      float bm = kNeg;
      for (int tt = lane; tt < n; tt += 32) bm = fmaxf(bm, row[tt]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, bm);
      float sum = 0.f;
      for (int tt = lane; tt < n; tt += 32) {
        const float p = expf(row[tt] - m_new);
        sum += p;
        row[tt] = round_to<E>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3. p @ V: a thread per (head dim, slice of keys), each V element read once
    {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      const E* vc = v + kvbase + (long long)t0 * row_stride + d3;
#pragma unroll 4
      for (int tt = slice; tt < n; tt += kSlices) {
        const float vv = to_f(vc[tt * row_stride]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) part[g] = fmaf(sc[g * kBK + tt], vv, part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) red[(slice * G + g) * D + d3] = part[g];
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float pv = 0.f;
      for (int sl = 0; sl < kSlices; ++sl) pv += red[(sl * G + g) * D + d];
      acc[i] = acc[i] * a_s[g] + pv;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += kThreads) {
    o[qbase + i] = from_f<E>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename E, int D>
int launch_d(const E* q, const E* k, const E* v, E* o, int B, int T, int K, int G, int kv_len, float scale,
             cudaStream_t st) {
  const size_t bytes = sizeof(float) * (2 * G * D + G * kBK + (kThreads / D) * G * D + 3 * G);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<E, D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attention_kernel<E, D><<<B * K, kThreads, bytes, st>>>(q, k, v, o, T, K, G, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T, int K, int G, int D,
           int kv_len, float scale, void* stream) {
  if (G < 1 || G > kMaxG || G * D > kMaxGD) return -1;
  const auto* qq = static_cast<const E*>(q);
  const auto* kk = static_cast<const E*>(k);
  const auto* vv = static_cast<const E*>(v);
  auto* oo = static_cast<E*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<E, 16>(qq, kk, vv, oo, B, T, K, G, kv_len, scale, st);
    case 32: return launch_d<E, 32>(qq, kk, vv, oo, B, T, K, G, kv_len, scale, st);
    case 64: return launch_d<E, 64>(qq, kk, vv, oo, B, T, K, G, kv_len, scale, st);
    case 128: return launch_d<E, 128>(qq, kk, vv, oo, B, T, K, G, kv_len, scale, st);
    default: return -1;
  }
}

}  // namespace

// `scale` is D ** -0.5 rounded to the element type (as the reference's
// weak-typed `q * scale` rounds it).  k and v must be 16-byte aligned.
// Returns cudaGetLastError() after the launch, or -1 for a head width or
// group the kernel is not built for.
extern "C" int repro_decode_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                           int T, int K, int G, int D, int kv_len, float scale,
                                           void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, T, K, G, D, kv_len, scale, stream);
}

extern "C" int repro_decode_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                          int T, int K, int G, int D, int kv_len, float scale,
                                          void* stream) {
  return launch<float>(q, k, v, o, B, T, K, G, D, kv_len, scale, stream);
}
