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
// K 2, G 1, D 32) a call moves 4.6 MB and does about 13 MFLOP, so neither
// bytes nor operations bound it.  All 512 blocks are resident at once, four
// per SM, and after one round of global loads the SM's instruction issue is
// what they share: a warp with ten busy lanes costs as much to issue as one
// with 32.  No tensor cores: the products are full float32 FMAs, as in the
// reference.
//
// Design: one block per (batch, kv head) holds the head's whole problem in
// shared memory (qs and dO for its S * G rows, k and v for its T keys, each
// 16-byte chunk of a row rotated by the row's index so that threads reading
// different rows hit different banks; P and dS as (S * G, T) tiles), so it
// owns all of dK and dV for its head; no atomics, so the result is
// deterministic.  After one round of global loads:
//   1-2. when a row's keys fit in a warp (T <= 32), each row's keys on
//        neighbouring lanes of one warp (three rows of ten keys per warp at
//        the predictor's shape): a lane's score and dP, in-order fmaf chains
//        over d; the row's max (exact in any order), l = the sum of e =
//        exp(s - m) in key order and di = the sum of P * dP in key order,
//        each lane reading its row's lanes by shuffles; then P and dS.  A
//        masked score is -1e30 and its dP 0, without chains: its P is 0, or
//        its row has no live key and every dS of the row is 0, so for
//        finite inputs its dP never reaches an output (a NaN or infinite v
//        at a masked key would have).  Longer rows take pass 1 per (row,
//        key) and pass 2 per row, the row's sums read from shared memory;
//   3.   one thread per (row, four head dims) for dQ (keys in order) and per
//        (key, four head dims) for dK and dV (rows in order).
// The arithmetic is the serial kernel's, expression for expression, so the
// gradients are the same bit for bit.  The tiles must fit the 227 KB of
// shared memory a block can have; the wrapper raises for longer sequences.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // what a block may opt into on Hopper

// The launch's shape arguments, cached per shape by the wrapper.
struct FaArgs {
  int B, S, T, K, G, D, causal, q_offset, kv_len;
  float scale;  // D ** -0.5 rounded to float32
};

size_t smem_bytes(int R, int T, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(R) * D + 2 * static_cast<size_t>(T) * D +
                          2 * static_cast<size_t>(R) * T);
}

// chunk c of row i of a (rows, D) tile, stored rotated by the row
template <int D>
__device__ __forceinline__ float4& chunk(float4* tile, int i, int c) {
  return tile[i * (D / 4) + ((c ^ i) & (D / 4 - 1))];
}

// kVec: q, k, v and dO are 16-byte aligned, so rows move as float4
template <int D, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
fa_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, const FaArgs a) {
  constexpr int kC = D / 4;
  constexpr int kG = kC < 4 ? kC : (D <= 32 ? 4 : 2);  // chunks of each operand loaded ahead of the chains
  extern __shared__ float4 smem4[];
  const int S = a.S, T = a.T, K = a.K, G = a.G;
  const int R = S * G;  // query rows of this head: row r is (s, g) = (r / G, r % G)
  float4* qs = smem4;                            // (R, D) scaled queries
  float4* dos = qs + R * kC;                     // (R, D) output gradients
  float4* ks = dos + R * kC;                     // (T, D)
  float4* vs = ks + T * kC;                      // (T, D)
  float* ps = reinterpret_cast<float*>(vs + T * kC);  // (R, T) scores, then e, then P
  float* dss = ps + R * T;                            // (R, T) dP, then dS
  const int kh = blockIdx.x % K;
  const int b = blockIdx.x / K;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const auto q_row = [&](int r) { return ((((long long)b * S + r / G) * K + kh) * G + r % G) * D; };
  const auto kv_row = [&](int t) { return (((long long)b * T + t) * K + kh) * D; };
  const auto load4 = [&](const float* p) {
    return kVec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
  };
  const auto masked = [&](int r, int t) { return (a.causal && a.q_offset + r / G < t) || t >= a.kv_len; };
  const auto pair = [&](int r, int t, float& sc, float& dp) {  // in-order fmaf chains over d
    sc = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kC; c0 += kG) {  // a group's loads first, then its part of the chains
      float4 x[kG], y[kG], z[kG], w[kG];
#pragma unroll
      for (int c = 0; c < kG; ++c) {
        x[c] = chunk<D>(qs, r, c0 + c);
        y[c] = chunk<D>(ks, t, c0 + c);
        z[c] = chunk<D>(dos, r, c0 + c);
        w[c] = chunk<D>(vs, t, c0 + c);
      }
#pragma unroll
      for (int c = 0; c < kG; ++c) {
        sc = fmaf(x[c].x, y[c].x, sc);
        dp = fmaf(z[c].x, w[c].x, dp);
        sc = fmaf(x[c].y, y[c].y, sc);
        dp = fmaf(z[c].y, w[c].y, dp);
        sc = fmaf(x[c].z, y[c].z, sc);
        dp = fmaf(z[c].z, w[c].z, dp);
        sc = fmaf(x[c].w, y[c].w, sc);
        dp = fmaf(z[c].w, w[c].w, dp);
      }
    }
  };

  // one round of loads: each thread issues its q, dO, k and v chunks before storing any
  for (int i = tid; i < max(R, T) * kC; i += nthr) {
    const int r = i / kC, c = i % kC;
    float4 x, y, z, w;
    if (i < R * kC) {
      x = load4(q + q_row(r) + 4 * c);
      y = load4(dout + q_row(r) + 4 * c);
    }
    if (i < T * kC) {
      z = load4(k + kv_row(r) + 4 * c);
      w = load4(v + kv_row(r) + 4 * c);
    }
    if (i < R * kC) {
      chunk<D>(qs, r, c) = make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
      chunk<D>(dos, r, c) = y;
    }
    if (i < T * kC) {
      chunk<D>(ks, r, c) = z;
      chunk<D>(vs, r, c) = w;
    }
  }
  __syncthreads();

  if (T <= 32) {
    // 1-2. each row's keys on neighbouring lanes of one warp: a lane's score and dP (masked as in the
    // forward), then the row's max, l and di in key order from its lanes by shuffles, then P and dS
    const int seg = 32 / T;                                   // rows per warp
    const int rl = lane / T, t = lane % T, base = rl * T;    // this lane's row in the warp, key, row's first lane
    for (int w0 = warp * seg; w0 < R; w0 += nwarps * seg) {
      const int r = w0 + rl;
      const bool on = rl < seg && r < R;
      float sc = kNeg, dp = 0.f;
      if (on && !masked(r, t)) pair(r, t, sc, dp);
      float m = kNeg;
#pragma unroll 8
      for (int u = 0; u < T; ++u) m = fmaxf(m, __shfl_sync(kAll, sc, (base + u) & 31));
      const float e = expf(sc - m);
      float l = 0.f;
#pragma unroll 8
      for (int u = 0; u < T; ++u) l += __shfl_sync(kAll, e, (base + u) & 31);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const float p = e * inv;
      float di = 0.f;
#pragma unroll 8
      for (int u = 0; u < T; ++u) {
        di = fmaf(__shfl_sync(kAll, p, (base + u) & 31), __shfl_sync(kAll, dp, (base + u) & 31), di);
      }
      if (on) {
        dss[r * T + t] = masked(r, t) ? 0.f : p * (dp - di);
        ps[r * T + t] = p;
      }
    }
    __syncthreads();
  } else {
    // 1. per (row, key): the score (masked as in the forward) and dP = dO . v
    for (int i = tid; i < R * T; i += nthr) {
      const int r = i / T, t = i % T;
      float sc = kNeg, dp = 0.f;
      if (!masked(r, t)) pair(r, t, sc, dp);
      ps[i] = sc;
      dss[i] = dp;
    }
    __syncthreads();

    // 2. per row: P = softmax(s), dS = P * (dP - sum(P * dP)), 0 where masked
    for (int r = tid; r < R; r += nthr) {
      float* pr = ps + r * T;
      float* dr = dss + r * T;
      float m = kNeg;
#pragma unroll 8
      for (int t = 0; t < T; ++t) m = fmaxf(m, pr[t]);
      float l = 0.f;
#pragma unroll 8
      for (int t = 0; t < T; ++t) {
        const float e = expf(pr[t] - m);
        pr[t] = e;
        l += e;
      }
      const float inv = 1.f / fmaxf(l, 1e-30f);
      float di = 0.f;
#pragma unroll 8
      for (int t = 0; t < T; ++t) di = fmaf(pr[t] * inv, dr[t], di);
#pragma unroll 8
      for (int t = 0; t < T; ++t) {
        const float p = pr[t] * inv;
        dr[t] = masked(r, t) ? 0.f : p * (dr[t] - di);
        pr[t] = p;
      }
    }
    __syncthreads();
  }

  // 3. dQ = scale * dS . k per (row, chunk); dK = dS^T . qs and dV = P^T . dO per (key, chunk), whole for
  // this head: no other block writes them
  for (int i = tid; i < (R + T) * kC; i += nthr) {
    if (i < R * kC) {
      const int r = i / kC, c = i % kC;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int t = 0; t < T; ++t) {
        const float ds = dss[r * T + t];
        const float4 y = chunk<D>(ks, t, c);
        acc.x = fmaf(ds, y.x, acc.x);
        acc.y = fmaf(ds, y.y, acc.y);
        acc.z = fmaf(ds, y.z, acc.z);
        acc.w = fmaf(ds, y.w, acc.w);
      }
      reinterpret_cast<float4*>(dq + q_row(r))[c] =
          make_float4(acc.x * a.scale, acc.y * a.scale, acc.z * a.scale, acc.w * a.scale);
    } else {
      const int t = i / kC - R, c = i % kC;
      float4 ak = make_float4(0.f, 0.f, 0.f, 0.f), av = ak;
#pragma unroll 8
      for (int r = 0; r < R; ++r) {
        const float ds = dss[r * T + t], p = ps[r * T + t];
        const float4 x = chunk<D>(qs, r, c), z = chunk<D>(dos, r, c);
        ak.x = fmaf(ds, x.x, ak.x);
        ak.y = fmaf(ds, x.y, ak.y);
        ak.z = fmaf(ds, x.z, ak.z);
        ak.w = fmaf(ds, x.w, ak.w);
        av.x = fmaf(p, z.x, av.x);
        av.y = fmaf(p, z.y, av.y);
        av.z = fmaf(p, z.z, av.z);
        av.w = fmaf(p, z.w, av.w);
      }
      reinterpret_cast<float4*>(dk + kv_row(t))[c] = ak;
      reinterpret_cast<float4*>(dv + kv_row(t))[c] = av;
    }
  }
}

template <int D, bool kVec>
int launch(const float* q, const float* k, const float* v, const float* dout, float* dq, float* dk, float* dv,
           const FaArgs& a, size_t bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fa_bwd_kernel<D, kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int R = a.S * a.G;
  const int seg = 32 / max(a.T, 1);  // rows per warp in passes 1-2 when T <= 32
  const int rows = a.T <= 32 ? (R + seg - 1) / seg * 32 : R * a.T;
  const int work = max(rows, (R + a.T) * (D / 4));
  const int threads = min(kMaxThreads, max(32, (work + 31) / 32 * 32));
  fa_bwd_kernel<D, kVec><<<a.B * a.K, threads, bytes, stream>>>(q, k, v, dout, dq, dk, dv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* dout, float* dq, float* dk, float* dv,
           const FaArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.S * a.G, a.T, D);
  if (bytes > kMaxSmem) return -1;
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  return vec ? launch<D, true>(q, k, v, dout, dq, dk, dv, a, bytes, stream)
             : launch<D, false>(q, k, v, dout, dq, dk, dv, a, bytes, stream);
}

}  // namespace

// All tensors float32 and contiguous; dq, dk and dv 16-byte aligned (they
// may be one buffer's pieces).  `args` points to the launch's shape arguments in host memory
// (read before this returns; `scale` is the forward's, D ** -0.5).  Returns
// cudaGetLastError() after the launch, or -1 for a head width the kernel is
// not built for or tiles that do not fit in shared memory.
extern "C" int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                                             void* dq, void* dk, void* dv, const void* args, void* stream) {
  const FaArgs& a = *static_cast<const FaArgs*>(args);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* dd = static_cast<const float*>(dout);
  auto* dqq = static_cast<float*>(dq);
  auto* dkk = static_cast<float*>(dk);
  auto* dvv = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_BWD(DD) launch<DD>(qq, kk, vv, dd, dqq, dkk, dvv, a, st)
  switch (a.D) {
    case 8: return REPRO_FA_BWD(8);
    case 16: return REPRO_FA_BWD(16);
    case 32: return REPRO_FA_BWD(32);
    case 64: return REPRO_FA_BWD(64);
    case 128: return REPRO_FA_BWD(128);
    default: return -1;
  }
#undef REPRO_FA_BWD
}
