// Grouped-query attention forward with an online softmax, float32.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (_fa_kernel) for float32 inputs: q (B, S, K, G, D), k and
// v (B, T, K, D), causal mask with a q_offset, a scalar kv_len, output
// (B, S, K, G, D).  Masked scores are -1e30 and take part in the softmax
// exactly as in the reference, so a fully masked row averages v as it does
// there.  (bf16 runs on the tensor cores: csrc/flash_attention_bf16.cu.)
//
// What bounds it on an H100: at the predictor's shapes (B 256, S = T = 10,
// K 2, G 1, D 32) a call moves 2.6 MB and does about 3 MFLOP, so neither
// bytes nor operations bound it.  All 512 blocks are resident at once, four
// per SM, and after one round of global loads the SM's instruction issue is
// what they share: a warp with ten busy lanes costs as much to issue as one
// with 32.  No tensor cores: the reference computes in float32 and TF32
// would round the scores, so the products are full float32 FMAs.  At
// zamba2-7b's float32 prefill (B 2, S = T = 512, K 32, G 1, D 112, causal)
// it is about 3.8 GFLOP, so operations bound it (0.056 ms at 67 TFLOP/s);
// this design, made for ten-key rows, walks every key tile of a row.
//
// Design: one thread block per (batch, kv head, tile of query rows): 64
// (s, g) rows at D <= 16, 32 at D 32, 16 at 64, 9 at 112, 8 at 128.  Per
// tile of 32 keys, one round of global loads (the tile's K and V and, with
// the first tile, the block's scaled q rows) into shared memory, each 16-byte
// chunk of a row rotated by the row's index so that threads reading different
// rows hit different banks; then two passes with the lanes kept busy:
//   1-2. each row's keys on neighbouring lanes of one warp (three rows of ten
//        keys per warp at the predictor's shape): a lane scores its key, one
//        in-order fmaf chain over d on the scaled query (a masked key is
//        -1e30 without a chain), takes the running max before its key from
//        its row's lanes by shuffles (exact in any order) and computes
//        p = exp(s - m_t) and alpha = exp(m_{t-1} - m_t);
//   3.   one thread per (row, four head dims) runs the online softmax's
//        recurrence key by key: l = l * alpha + p, acc = fmaf(p, v, acc *
//        alpha).
// That is the serial kernel's arithmetic (one thread per row, keys in
// order), expression for expression, so the output is the same bit for bit;
// only the parallelism changed.  S and T need not be multiples of any tile.
//
// Head widths 8, 16, 32, 64, 112 (zamba2-7b's) and 128.  The rotation is an
// XOR of the chunk index with the row's, so a row of q and k holds the next
// power of two of D / 4 chunks: at D 112, 28 chunks in rows of 32, the last
// four never written or read (the rotation maps 0..27 into 0..31 one to one).
// Pass 1-2's reads are then as free of bank conflicts as at D 128: eight
// lanes reading chunk c of eight consecutive keys hit eight distinct 16-byte
// slots of a 128-byte line.  At D 112 that costs 12.5% more shared memory for
// q and k, and a score's chain runs in groups of 7 chunks (a divisor of 28)
// with the same fmaf order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBT = 32;            // keys per shared-memory tile
constexpr int kMaxThreads = 256;   // threads per block at most
constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

// The launch's shape arguments, cached per shape by the wrapper.
struct FaArgs {
  int B, S, T, K, G, D, causal, q_offset, kv_len;
  float scale;  // D ** -0.5 rounded to float32, as the reference's `q * scale`
};

// query rows per block: one thread per (row, 16-byte chunk) in pass 3
template <int D>
__host__ __device__ constexpr int rows_per_block() {
  return kMaxThreads / (D / 4) < 64 ? kMaxThreads / (D / 4) : 64;
}

// 16-byte chunks a row of q or k takes in shared memory: D / 4 rounded up to a power of two
template <int D>
__host__ __device__ constexpr int padded_chunks() {
  int n = 1;
  while (n < D / 4) n *= 2;
  return n;
}

// chunks loaded ahead of the score's chain: the largest divisor of D / 4 up to 8
template <int D>
__host__ __device__ constexpr int chain_group() {
  int g = D / 4 < 8 ? D / 4 : 8;
  while ((D / 4) % g) --g;
  return g;
}

// where chunk c of row i is stored: rotated by the row
template <int D>
__device__ __forceinline__ int rot(int i, int c) {
  return (c ^ i) & (padded_chunks<D>() - 1);
}

// kVec: q, k, v and o are 16-byte aligned, so rows move as float4
template <int D, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ o, const FaArgs a, int n_rt) {
  constexpr int kC = D / 4;
  constexpr int kCP = padded_chunks<D>();
  constexpr int kG = chain_group<D>();  // chunks loaded ahead of the score's chain
  constexpr int kRB = rows_per_block<D>();
  __shared__ float4 qs[kRB][kCP];  // scaled queries, chunks rotated by row
  __shared__ float4 ks[kBT][kCP];  // chunks rotated by key
  __shared__ float4 vs[kBT][kC];
  __shared__ float2 pa[kRB][kBT + 1];  // (p, alpha) per key
  __shared__ float mrun[2][kRB];       // each row's max at the tile's start, by tile parity
  __shared__ int qpos[kRB];            // each row's query position
  const int rt = blockIdx.x % n_rt;
  const int kh = (blockIdx.x / n_rt) % a.K;
  const int b = blockIdx.x / (n_rt * a.K);
  const int r0 = rt * kRB;
  const int nr = min(kRB, a.S * a.G - r0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const auto q_row = [&](int r) {  // element offset of block row r in q and o
    const int gr = r0 + r;
    return ((((long long)b * a.S + gr / a.G) * a.K + kh) * a.G + gr % a.G) * D;
  };
  const auto kv_row = [&](int t) { return (((long long)b * a.T + t) * a.K + kh) * D; };
  const auto load4 = [&](const float* p) {
    return kVec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
  };

  // pass 3's thread: (row, chunk), holding l and four accumulators across tiles
  const bool pv = tid < nr * kC;
  const int pr = tid / kC, pc = tid % kC;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = 0, par = 0; t0 < a.T; t0 += kBT, par ^= 1) {
    const int n_t = min(kBT, a.T - t0);
    const int seg = kBT / n_t;                          // rows per warp in passes 1-2
    const int rl = lane / n_t, kt = lane % n_t, base = rl * n_t;  // this lane's row in the warp, key, row's first lane
    if (t0 > 0) __syncthreads();  // the last tile's readers are done
    // one round of loads: the tile's K and V chunks and, with the first tile, the block's scaled q rows
    const int nq = t0 == 0 ? nr : 0;
    for (int i = tid; i < max(nq, n_t) * kC; i += nthr) {
      const int j = i / kC, c = i % kC;
      float4 x, y, z;
      if (j < nq) z = load4(q + q_row(j) + 4 * c);
      if (j < n_t) {
        x = load4(k + kv_row(t0 + j) + 4 * c);
        y = load4(v + kv_row(t0 + j) + 4 * c);
      }
      if (j < nq) {
        qs[j][rot<D>(j, c)] = make_float4(z.x * a.scale, z.y * a.scale, z.z * a.scale, z.w * a.scale);
        if (c == 0) qpos[j] = a.q_offset + (r0 + j) / a.G;
      }
      if (j < n_t) {
        ks[j][rot<D>(j, c)] = x;
        vs[j][c] = y;
      }
    }
    __syncthreads();
    // 1-2. the scores, each row's keys on neighbouring lanes of one warp; the running max before each key from
    // its row's lanes by shuffles; p and alpha
    for (int w0 = warp * seg; w0 < nr; w0 += nwarps * seg) {
      const int r = w0 + rl;
      const bool on = rl < seg && r < nr;
      const int k_pos = t0 + kt;
      float sc = kNeg;
      if (on && !((a.causal && qpos[r] < k_pos) || k_pos >= a.kv_len)) {
        sc = 0.f;
#pragma unroll
        for (int c0 = 0; c0 < kC; c0 += kG) {  // a group's loads first, then its part of the chain
          float4 x[kG], y[kG];
#pragma unroll
          for (int c = 0; c < kG; ++c) {
            x[c] = qs[r][rot<D>(r, c0 + c)];
            y[c] = ks[kt][rot<D>(kt, c0 + c)];
          }
#pragma unroll
          for (int c = 0; c < kG; ++c) {
            sc = fmaf(x[c].x, y[c].x, sc);
            sc = fmaf(x[c].y, y[c].y, sc);
            sc = fmaf(x[c].z, y[c].z, sc);
            sc = fmaf(x[c].w, y[c].w, sc);
          }
        }
      }
      float mp = on && t0 > 0 ? mrun[par][r] : kNeg;  // the max before key kt
#pragma unroll 8
      for (int u = 0; u < n_t; ++u) {
        const float x = __shfl_sync(kAll, sc, (base + u) & 31);
        if (u < kt) mp = fmaxf(mp, x);
      }
      if (on) {
        const float mt = fmaxf(mp, sc);
        pa[r][kt] = make_float2(expf(sc - mt), expf(mp - mt));
        if (kt == n_t - 1) mrun[par ^ 1][r] = mt;
      }
    }
    __syncthreads();
    // 3. the recurrence, key by key
    if (pv) {
#pragma unroll 8
      for (int t = 0; t < n_t; ++t) {
        const float2 x = pa[pr][t];
        const float4 y = vs[t][pc];
        l = l * x.y + x.x;
        acc.x = fmaf(x.x, y.x, acc.x * x.y);
        acc.y = fmaf(x.x, y.y, acc.y * x.y);
        acc.z = fmaf(x.x, y.z, acc.z * x.y);
        acc.w = fmaf(x.x, y.w, acc.w * x.y);
      }
    }
  }
  if (pv) {
    const float denom = fmaxf(l, 1e-30f);
    const float4 y = make_float4(acc.x / denom, acc.y / denom, acc.z / denom, acc.w / denom);
    if (kVec) {
      reinterpret_cast<float4*>(o + q_row(pr))[pc] = y;
    } else {
      float* p = o + q_row(pr) + 4 * pc;
      p[0] = y.x;
      p[1] = y.y;
      p[2] = y.z;
      p[3] = y.w;
    }
  }
}

template <int D, bool kVec>
int launch(const float* q, const float* k, const float* v, float* o, const FaArgs& a, cudaStream_t stream) {
  constexpr int kRB = rows_per_block<D>();
  const int R = a.S * a.G;
  const int nr = min(R, kRB);
  const int n_rt = (R + kRB - 1) / kRB;
  const int seg = kBT / min(max(a.T, 1), kBT);  // rows per warp in passes 1-2
  const int work = max(nr * (D / 4), (nr + seg - 1) / seg * 32);
  const int threads = min(kMaxThreads, max(32, (work + 31) / 32 * 32));
  fa_fwd_kernel<D, kVec><<<a.B * a.K * n_rt, threads, 0, stream>>>(q, k, v, o, a, n_rt);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, const FaArgs& a, cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  return vec ? launch<D, true>(q, k, v, o, a, stream) : launch<D, false>(q, k, v, o, a, stream);
}

}  // namespace

// `args` points to the launch's shape arguments in host memory (read before
// this returns).  Returns cudaGetLastError() after the launch, or -1 for a
// head width the kernel is not built for.
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o, const void* args,
                                         void* stream) {
  const FaArgs& a = *static_cast<const FaArgs*>(args);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  auto* oo = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (a.D) {
    case 8: return launch<8>(qq, kk, vv, oo, a, st);
    case 16: return launch<16>(qq, kk, vv, oo, a, st);
    case 32: return launch<32>(qq, kk, vv, oo, a, st);
    case 64: return launch<64>(qq, kk, vv, oo, a, st);
    case 112: return launch<112>(qq, kk, vv, oo, a, st);
    case 128: return launch<128>(qq, kk, vv, oo, a, st);
    default: return -1;
  }
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
