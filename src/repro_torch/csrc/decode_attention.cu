// One-token (decode) grouped-query attention against a KV cache, split-K.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::
// decode_attention_kernelcall (_dec_kernel): q (B, K, G, D), k and v
// (B, T, K, D), a scalar kv_len, output (B, K, G, D).  Arithmetic as there:
// q * scale rounded to the input type, float32 dots against K, keys at or
// after kv_len set to -1e30, an online softmax in float32 over blocks of 512
// keys whose running max M_j is the max of every score up to the end of
// block j, p = exp(s - M_j), l += sum p, p rounded to the input type before
// the float32 PV product, and acc / max(l, 1e-30) written in the input type.
// bf16 and float32 share the template; T need not be a multiple of 512.
//
// What bounds it on an H100: at the serving path's shape (B 2, K 2, G 7,
// D 64, T 2048, bf16) a call reads about 2 * B * kv_len * K * D * 2 bytes,
// about 2 MB at kv_len 2048 (under a microsecond at 3.35 TB/s), so latency
// bounds it: the work has to be spread over the SMs and the dependent steps
// kept few.  Design: the cache is cut into chunks of 64 keys, and each of
// the two kernels runs one block of 256 threads per (chunk, batch, kv head),
// 128 blocks at the serve shape.
//   1. decode_scores_kernel: four threads per key, each for every fourth of
//      the G scaled query rows, dot the key (16-byte loads) with those rows,
//      one fmaf chain per score in head-dim order (so p, below, is the same
//      float32 number as in this kernel's first, serial version); the scores
//      go to a float32 scratch (B, K, G, T) and each chunk's max per query
//      row to (B, K, G, chunks).
//   2. decode_pv_kernel: each block takes M_j, the prefix max of the chunk
//      maxima up to the end of its own 512-key block j, so that p is rounded
//      against the same running max as in the reference; it sums l from p
//      unrounded and P.V from p rounded, per chunk, in a fixed order, and
//      writes the partials.  The last block of each (batch, kv head) to
//      finish, picked by an integer atomic ticket, combines the partials in
//      chunk order with factors exp(M_j - M_final) (the product of the
//      reference's rescalings) and writes the output.
// No float atomics: every sum is taken in one fixed order, so a call repeats
// bit for bit.  Against the reference only float32 summation order differs.
// Chunks wholly at or past kv_len are not launched (their p is 0 and they
// leave M unchanged), except when kv_len <= 0: then every key is masked and
// the reference averages all of V, so every chunk runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 512;       // keys per online-softmax block (the TPU kernel's DEFAULT_BK)
constexpr int kChunk = 64;     // keys per thread block
constexpr int kPerBlock = kBK / kChunk;
constexpr int kThreads = 256;
constexpr int kParts = kThreads / kChunk;  // threads per key in pass 1, each for every kParts-th query row
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

// elements 8i..8i+7 of a row held in registers as 16-byte pieces, as float32
__device__ __forceinline__ void unpack8(const uint4* raw, int i, float* out, float) {
  const uint4 a = raw[2 * i], b = raw[2 * i + 1];
  out[0] = __uint_as_float(a.x), out[1] = __uint_as_float(a.y), out[2] = __uint_as_float(a.z);
  out[3] = __uint_as_float(a.w), out[4] = __uint_as_float(b.x), out[5] = __uint_as_float(b.y);
  out[6] = __uint_as_float(b.z), out[7] = __uint_as_float(b.w);
}
__device__ __forceinline__ void unpack8(const uint4* raw, int i, float* out, __nv_bfloat16) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x, out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The scratch, in floats: scores (BK, G, T), chunk maxima (BK, G, chunks),
// partial P.V (BK, chunks, G, D), partial l (BK, chunks, G), tickets (BK).
struct Scratch {
  float* scores;
  float* cmax;
  float* pacc;
  float* pl;
  unsigned* tickets;
};

inline long long scratch_floats(int BK, int T, int G, int D, int n_chunks) {
  return (long long)BK * G * T + (long long)BK * G * n_chunks + (long long)BK * n_chunks * G * D +
         (long long)BK * n_chunks * G + BK;
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
decode_scores_kernel(const E* __restrict__ q, const E* __restrict__ k, Scratch sc, int T, int K, int G,
                     int n_chunks, int kv_len, float scale) {
  __shared__ float qs[kMaxGD];
  __shared__ float row_s[kMaxG][kChunk];
  const int c = blockIdx.x, bk = blockIdx.y;
  const int b = bk / K, kh = bk % K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (c == 0 && tid == 0) sc.tickets[bk] = 0u;
  // a thread per (key, query row g0 + kParts * i): each score is one fmaf
  // chain over the head dims in order; g0 is uniform within a warp, so the
  // query reads are broadcasts.  The key row is loaded into registers
  // first, so that its latency overlaps the staging of q.
  const int key = tid % kChunk, g0 = tid / kChunk;
  const int t = c * kChunk + key;
  const E* kr = k + (((long long)b * T + min(t, T - 1)) * K + kh) * D;
  constexpr int kVec = D * (int)sizeof(E) / 16;
  uint4 raw[kVec];
  if (t < T) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) raw[i] = reinterpret_cast<const uint4*>(kr)[i];
  }
  const long long qbase = (long long)bk * G * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = round_to<E>(to_f(q[qbase + i]) * scale);
  __syncthreads();
  constexpr int kGs = kMaxG / kParts;
  float s[kGs];
#pragma unroll
  for (int i = 0; i < kGs; ++i) s[i] = 0.f;
  if (t < T) {
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      float kf[8];
      unpack8(raw, d0 / 8, kf, E());
#pragma unroll
      for (int i = 0; i < kGs; ++i) {
        const int g = g0 + kParts * i;
        if (g < G) {
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i] = fmaf(qs[g * D + d0 + j], kf[j], s[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kGs; ++i) {
    const int g = g0 + kParts * i;
    if (g < G) {
      float v = __int_as_float(0xff800000);  // -inf: past T there is no key at all
      if (t < T) {
        v = t < kv_len ? s[i] : kNeg;
        sc.scores[((long long)bk * G + g) * T + t] = v;
      }
      row_s[g][key] = v;
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    const float m = warp_max(fmaxf(row_s[g][lane], row_s[g][lane + 32]));
    if (lane == 0) sc.cmax[((long long)bk * G + g) * n_chunks + c] = m;
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
decode_pv_kernel(const E* __restrict__ v, E* __restrict__ o, Scratch sc, int T, int K, int G, int n_chunks,
                 int n_act) {
  constexpr int kSlices = kThreads / D;  // key slices of the P.V step
  extern __shared__ float smem[];
  float* m_s = smem;                     // M_j per query row, then l
  float* pr = m_s + kMaxG;               // p rounded (G, kChunk)
  float* pu = pr + kMaxG * kChunk;       // p unrounded (G, kChunk)
  float* red = pu + kMaxG * kChunk;      // P.V partial sums (kSlices, G, D)
  float* fj = red + kSlices * kMaxG * D;  // the combine's per-block max, then factor (G, blocks)
  __shared__ int is_last;
  constexpr int kPer = kChunk / kSlices;   // keys per thread in the P.V step
  const int c = blockIdx.x, bk = blockIdx.y;
  const int b = bk / K, kh = bk % K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's values (head dim d, keys slice + kSlices * i), loaded
  // first so that their latency overlaps the softmax step
  const int d = tid % D, slice = tid / D;
  const int n = min(kChunk, T - c * kChunk);
  const long long row_stride = (long long)K * D;
  const E* vc = v + ((long long)b * T + c * kChunk) * row_stride + (long long)kh * D + d;
  float vv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kk = slice + kSlices * i;
    vv[i] = kk < n ? to_f(vc[kk * row_stride]) : 0.f;
  }
  const float* cmax = sc.cmax + (long long)bk * G * n_chunks;
  // M_j: the prefix max of the chunk maxima up to the end of this chunk's 512-key block
  const int lim = min(n_act, (c / kPerBlock + 1) * kPerBlock);
  for (int g = warp; g < G; g += kWarps) {
    float m = kNeg;
    for (int cc = lane; cc < lim; cc += 32) m = fmaxf(m, cmax[g * n_chunks + cc]);
    m = warp_max(m);
    if (lane == 0) m_s[g] = m;
  }
  __syncthreads();
  for (int i = tid; i < G * kChunk; i += kThreads) {
    const int g = i / kChunk, kk = i % kChunk, t = c * kChunk + kk;
    float p = 0.f;
    if (t < T) p = expf(sc.scores[((long long)bk * G + g) * T + t] - m_s[g]);
    pu[g * kChunk + kk] = p;
    pr[g * kChunk + kk] = round_to<E>(p);
  }
  __syncthreads();
  float* pl = sc.pl + ((long long)bk * n_chunks + c) * G;
  for (int g = warp; g < G; g += kWarps) {
    const float l = warp_sum(pu[g * kChunk + lane] + pu[g * kChunk + lane + 32]);
    if (lane == 0) pl[g] = l;
  }
  {
    float part[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kk = slice + kSlices * i;  // p is 0 past T
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) part[g] = fmaf(pr[g * kChunk + kk], vv[i], part[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) red[(slice * G + g) * D + d] = part[g];
    }
  }
  __syncthreads();
  float* pacc = sc.pacc + ((long long)bk * n_chunks + c) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    float s = 0.f;
    for (int sl = 0; sl < kSlices; ++sl) s += red[sl * G * D + i];
    pacc[i] = s;
  }
  // the last block of this (batch, kv head) to get here combines the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(sc.tickets + bk, 1u) == (unsigned)(n_act - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int n_blocks = (n_act + kPerBlock - 1) / kPerBlock;
  for (int i = tid; i < G * n_blocks; i += kThreads) {
    const int g = i / n_blocks, j = i % n_blocks;
    float m = kNeg;
    for (int cc = j * kPerBlock; cc < min(n_act, (j + 1) * kPerBlock); ++cc) m = fmaxf(m, cmax[g * n_chunks + cc]);
    fj[i] = m;
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float* f = fj + g * n_blocks;
    for (int j = 1; j < n_blocks; ++j) f[j] = fmaxf(f[j], f[j - 1]);  // M_j
    const float m_final = f[n_blocks - 1];
    for (int j = 0; j < n_blocks; ++j) f[j] = expf(f[j] - m_final);
  }
  __syncthreads();
  // l: a warp per query row, lane-strided over the chunks, then a fixed tree
  for (int g = warp; g < G; g += kWarps) {
    const float* f = fj + g * n_blocks;
    const float* plg = sc.pl + (long long)bk * n_chunks * G + g;
    float l = 0.f;
    for (int cc = lane; cc < n_act; cc += 32) l = fmaf(__ldcg(plg + (long long)cc * G), f[cc / kPerBlock], l);
    l = warp_sum(l);
    if (lane == 0) m_s[g] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* pa = sc.pacc + (long long)bk * n_chunks * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float* f = fj + (i / D) * n_blocks;
    float acc = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < n_act; ++cc) acc = fmaf(__ldcg(pa + (long long)cc * G * D + i), f[cc / kPerBlock], acc);
    o[(long long)bk * G * D + i] = from_f<E>(acc / m_s[i / D]);
  }
}

template <typename E, int D>
int launch_d(const E* q, const E* k, const E* v, E* o, float* scratch, long long scratch_bytes, int B, int T,
             int K, int G, int kv_len, float scale, cudaStream_t st) {
  const int BK = B * K;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int n_act = kv_len <= 0 ? n_chunks : (min(kv_len, T) + kChunk - 1) / kChunk;
  if (n_act < 1 || scratch_bytes < (long long)sizeof(float) * scratch_floats(BK, T, G, D, n_chunks)) return -1;
  Scratch sc;
  sc.scores = scratch;
  sc.cmax = sc.scores + (long long)BK * G * T;
  sc.pacc = sc.cmax + (long long)BK * G * n_chunks;
  sc.pl = sc.pacc + (long long)BK * n_chunks * G * D;
  sc.tickets = reinterpret_cast<unsigned*>(sc.pl + (long long)BK * n_chunks * G);
  const dim3 grid(n_act, BK);
  decode_scores_kernel<E, D><<<grid, kThreads, 0, st>>>(q, k, sc, T, K, G, n_chunks, kv_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (n_act + kPerBlock - 1) / kPerBlock;
  const size_t bytes = sizeof(float) * (kMaxG + 2 * kMaxG * kChunk + (kThreads / D) * kMaxG * D + G * n_blocks);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_pv_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_pv_kernel<E, D><<<grid, kThreads, bytes, st>>>(v, o, sc, T, K, G, n_chunks, n_act);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch(const void* q, const void* k, const void* v, void* o, void* scratch, long long scratch_bytes, int B,
           int T, int K, int G, int D, int kv_len, float scale, void* stream) {
  if (G < 1 || G > kMaxG || G * D > kMaxGD) return -1;
  const auto* qq = static_cast<const E*>(q);
  const auto* kk = static_cast<const E*>(k);
  const auto* vv = static_cast<const E*>(v);
  auto* oo = static_cast<E*>(o);
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<E, 16>(qq, kk, vv, oo, sc, scratch_bytes, B, T, K, G, kv_len, scale, st);
    case 32: return launch_d<E, 32>(qq, kk, vv, oo, sc, scratch_bytes, B, T, K, G, kv_len, scale, st);
    case 64: return launch_d<E, 64>(qq, kk, vv, oo, sc, scratch_bytes, B, T, K, G, kv_len, scale, st);
    case 128: return launch_d<E, 128>(qq, kk, vv, oo, sc, scratch_bytes, B, T, K, G, kv_len, scale, st);
    default: return -1;
  }
}

}  // namespace

// `scale` is D ** -0.5 rounded to the element type (as the reference's
// weak-typed `q * scale` rounds it).  k and v must be 16-byte aligned and
// T >= 1.  Launches both kernels on `stream`; returns cudaGetLastError()
// after them, or -1 for a head width or group the kernel is not built for or
// a scratch smaller than scratch_floats() floats (kernels/decode_attention.py
// computes the same size).
extern "C" int repro_decode_attention_bf16(const void* q, const void* k, const void* v, void* o, void* scratch,
                                           long long scratch_bytes, int B, int T, int K, int G, int D, int kv_len,
                                           float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, scratch, scratch_bytes, B, T, K, G, D, kv_len, scale, stream);
}

extern "C" int repro_decode_attention_f32(const void* q, const void* k, const void* v, void* o, void* scratch,
                                          long long scratch_bytes, int B, int T, int K, int G, int D, int kv_len,
                                          float scale, void* stream) {
  return launch<float>(q, k, v, o, scratch, scratch_bytes, B, T, K, G, D, kv_len, scale, stream);
}
