// Mamba-2 chunked SSD scan (state-space duality).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py::ssd_pallas
// (_ssd_kernel): x (B, L, H, P), dt (B, L, H), A_log (H,) float32, b and c
// (B, L, N) -> y (B, L, H, P) in x's type and the final state (B, H, P, N)
// float32.  Per (batch, head) the chunks of Q tokens run in order from a
// zero state; for a chunk, with cum = cumsum(dt * a) and a = -exp(A_log),
//
//   y_i   = exp(cum_i) * (C_i . state)  +  sum_{j <= i} (exp(cum_i - cum_j) * (C_i . B_j)) * dt_j * x_j
//   state = state * exp(cum_last)       +  sum_q (exp(cum_last - cum_q) * dt_q) * x_q (x) B_q
//
// all in float32 (x, dt, b and c are widened as they are loaded); only y
// is rounded to the input type.  exp is only ever taken of cum_i - cum_j
// with j <= i (masked before the exp), of cum_last - cum_q and of cum_last
// or cum_i, never of a factor exp(-cum_j): at full width cum falls to about
// -200 within a chunk, so every exp stays in (0, 1].
//
// What bounds it on an H100: at the serving path's shape (B 2, L 2048,
// H 32, P 64, N 128, Q 256, bf16) a call moves about 38 MB (0.011 ms at
// 3.35 TB/s) and does about 6.6 GFLOP of float32 work with C . B^T once per
// (batch, chunk) (0.098 ms at 67 TFLOP/s): operations.  The first kernel
// (one block of 256 threads per (batch, head, slice of P)) walked the 8
// chunks in series on 128 blocks, recomputed C . B^T per head and slice
// (64 times the work), read every operand of its CUDA-core products from
// shared memory, and spent 43% of its time waiting on element-wise tile
// loads (stamps, experiments/torch/ssd_stamps.py).  This design is the SSD
// split, three launches on the current stream, with every chunk in parallel:
//
//   1. ssd_states_kernel, per (batch, chunk, head, slice of P): cum (to a
//      float32 scratch, for the other two) and the chunk's own state from
//      zero, (co . x)^T . B with co_q = exp(cum_last - cum_q) * dt_q;
//   2. ssd_pass_kernel, per (batch, head, 1024 state entries): the only
//      serial part, s_c = s_{c-1} * exp(cum_last_c) + contrib_c over the
//      chunks, each chunk's incoming state written over its contribution;
//   3. ssd_y_kernel, per (batch, chunk, head, tile of 64 query rows, slice
//      of P): y_inter = exp(cum_i) * (C . s_in) from the incoming state,
//      then per 64-key tile up to the diagonal the scores C . B^T (computed
//      once per block, in registers), the weights w and y += w . x.
//
// bf16 inputs run every product on tensor cores (mma.sync m16n8k16, float32
// accumulators).  C . B^T multiplies bf16 by bf16: exact products.  The
// other three each have one float32 operand (s_in, w, co . x); it is split
// into three bf16 parts, hi + mid + lo, which hold its 24 bits exactly, and
// the product runs three times, so no float32 operand is ever rounded.
// float32 inputs keep the same blocks, tiles and accumulator layout with
// every product on CUDA cores (fmaf, operands from shared memory; w reaches
// the lanes that need it by quad shuffles).  Tiles arrive by cp.async (16
// bytes a thread, zeros past the chunk), double-buffered for bf16.  At the
// serve shape: 512, 512 and 2,048 blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxChunk = 1024;
constexpr int kRows = 64;         // query rows per y block: four warps of 16
constexpr int kKeys = 64;         // keys per staged tile
constexpr int kYThreads = 128;
constexpr int kPassThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename E>
constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// --- copies into shared memory --------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory; zeros when !valid (nothing read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// rows [0, rows) of width elements (row stride gstride) into dst (row
// stride ld); rows >= n_valid become zeros
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, int ld, const E* src, long long gstride, int rows, int width,
                                           int n_valid, int tid, int nthreads) {
  constexpr int V = 16 / sizeof(E);
  const int per_row = width / V;
  for (int e = tid; e < rows * per_row; e += nthreads) {
    const int r = e / per_row, q = e - r * per_row;
    const bool ok = r < n_valid;
    cp16(dst + r * ld + q * V, ok ? src + r * gstride + q * V : src, ok);
  }
}

// --- tensor-core fragments (bf16) ------------------------------------------
// mma.m16n8k16 layouts, g = lane / 4, t = lane % 4: A holds rows g and g + 8
// at k 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3); B holds column g at
// k 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1); the float32 accumulator holds
// rows g (c0, c1) and g + 8 (c2, c3) at columns 2t, 2t + 1.

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// v = h + m + l exactly, each a bf16 (v - h and r - m are exact: Sterbenz)
__device__ __forceinline__ void split3(float v, float& h, float& m, float& l) {
  h = __bfloat162float(__float2bfloat16_rn(v));
  const float r = v - h;
  m = __bfloat162float(__float2bfloat16_rn(r));
  l = r - m;
}
// the three bf16 parts of a pair of float32 values, packed as fragment registers
__device__ __forceinline__ void split3_pair(float v0, float v1, uint32_t& h, uint32_t& m, uint32_t& l) {
  float h0, m0, l0, h1, m1, l1;
  split3(v0, h0, m0, l0);
  split3(v1, h1, m1, l1);
  h = pack(h0, h1);
  m = pack(m0, m1);
  l = pack(l0, l1);
}

// acc (16 x 8 NT) += A . B^T on tensor cores: A rows in shared memory
// (bf16, row stride lda, k contiguous); B^T rows per output column, k
// contiguous, in `planes` bf16 planes of stride plane (their sum is the
// operand); K a multiple of 16; column pairs 2p, 2p + 1 with p >= np_lim skipped
template <int NT, int K, int PLANES>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* bt, int ldb, int plane, int np_lim, int lane) {
  const __nv_bfloat16* ap = a + ((lane & 7) + 8 * ((lane >> 3) & 1)) * lda + 8 * (lane >> 4);
  const __nv_bfloat16* bp = bt + ((lane & 7) + 8 * (lane >> 4)) * ldb + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t af[4];
    ldsm4(af, ap + 16 * ks);
#pragma unroll
    for (int pp = 0; pp < NT / 2; ++pp) {
      if (pp < np_lim) {
#pragma unroll
        for (int q = 0; q < PLANES; ++q) {
          uint32_t bf[4];
          ldsm4(bf, bp + q * plane + 16 * pp * ldb + 16 * ks);
          mma(acc[2 * pp], af, bf[0], bf[1]);
          mma(acc[2 * pp + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
}

// --- the same products on CUDA cores (float32), in the same layout ---------

// acc (16 x 8 NT) += A . B^T: A rows a[r * lda + k], B^T rows bt[col * ldb + k]
template <int NT, int K>
__device__ __forceinline__ void fma_rows(float (&acc)[NT][4], const float* a, int lda, const float* bt, int ldb,
                                         int np_lim, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * lda;
  const float* a1 = a0 + 8 * lda;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt / 2 < np_lim) {
        const float4 y0 = *reinterpret_cast<const float4*>(bt + (8 * nt + 2 * t) * ldb + k);
        const float4 y1 = *reinterpret_cast<const float4*>(bt + (8 * nt + 2 * t + 1) * ldb + k);
        float* c = acc[nt];
        c[0] = fmaf(x0.x, y0.x, c[0]); c[0] = fmaf(x0.y, y0.y, c[0]); c[0] = fmaf(x0.z, y0.z, c[0]); c[0] = fmaf(x0.w, y0.w, c[0]);
        c[1] = fmaf(x0.x, y1.x, c[1]); c[1] = fmaf(x0.y, y1.y, c[1]); c[1] = fmaf(x0.z, y1.z, c[1]); c[1] = fmaf(x0.w, y1.w, c[1]);
        c[2] = fmaf(x1.x, y0.x, c[2]); c[2] = fmaf(x1.y, y0.y, c[2]); c[2] = fmaf(x1.z, y0.z, c[2]); c[2] = fmaf(x1.w, y0.w, c[2]);
        c[3] = fmaf(x1.x, y1.x, c[3]); c[3] = fmaf(x1.y, y1.y, c[3]); c[3] = fmaf(x1.z, y1.z, c[3]); c[3] = fmaf(x1.w, y1.w, c[3]);
      }
    }
  }
}

// --- 1. each chunk's own state --------------------------------------------

template <typename E, int N, int PT>
struct StatesShape {
  static constexpr int PAD = 16 / sizeof(E);
  static constexpr int LDP = PT + PAD;                    // row of a u tile (keys x PT)
  static constexpr int LDN = N + PAD;                     // row of a B tile (keys x N)
  static constexpr int NTN = N / 8 < 8 ? N / 8 : 8;       // n8 tiles per warp
  static constexpr int GROUPS = N / (8 * NTN);
  static constexpr int WARPS = (PT / 16) * GROUPS;        // one warp per (16 rows of P, column group)
  static constexpr int PLANES = kBf16<E> ? 3 : 1;
  static constexpr size_t U_BYTES = (size_t)PLANES * kKeys * LDP * sizeof(E);
  static constexpr size_t B_BYTES = (size_t)kKeys * LDN * sizeof(E);
  static size_t smem(int Q) { return U_BYTES + B_BYTES + sizeof(float) * (2 * Q + 32); }
};

// one block per (batch, chunk, head, slice of PT head dims): cum of the
// chunk (written once, by slice 0) and the chunk's state from zero,
// contrib[p][n] = sum_q (co_q * x_q[p]) * B_q[n]
template <typename E, int N, int PT>
__global__ void __launch_bounds__(256)
ssd_states_kernel(const E* __restrict__ x, const E* __restrict__ dt, const float* __restrict__ a_log,
                  const E* __restrict__ bm, float* __restrict__ cum_g, float* __restrict__ contrib, int nc, int H,
                  int P, int Q) {
  using S = StatesShape<E, N, PT>;
  constexpr int LDP = S::LDP, LDN = S::LDN, NTN = S::NTN;
  extern __shared__ __align__(16) unsigned char smem[];
  E* us = reinterpret_cast<E*>(smem);                            // PLANES x (kKeys, LDP)
  E* bs = reinterpret_cast<E*>(smem + S::U_BYTES);               // (kKeys, LDN)
  float* cum = reinterpret_cast<float*>(smem + S::U_BYTES + S::B_BYTES);  // (Q)
  float* co = cum + Q;                                           // dt_q, then exp(cum_last - cum_q) * dt_q
  float* wsum = co + Q;                                          // (32) the warps' totals of the scan

  const int npt = P / PT;
  int rem = blockIdx.x;
  const int pt = rem % npt;
  rem /= npt;
  const int h = rem % H;
  rem /= H;
  const int c = rem % nc;
  const int b = rem / nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthr = blockDim.x;
  const long long tok0 = ((long long)b * nc + c) * Q;            // the chunk's first token
  const float a = -expf(a_log[h]);

  // cum = cumsum(dt * a): a serial run per thread over consecutive tokens, then a block scan
  for (int q = tid; q < Q; q += nthr) co[q] = to_f(dt[(tok0 + q) * H + h]);
  __syncthreads();
  const int per = (Q + nthr - 1) / nthr;
  const int q0 = min(tid * per, Q), q1 = min(q0 + per, Q);
  float run = 0.f;
  for (int q = q0; q < q1; ++q) {
    run = __fadd_rn(run, __fmul_rn(co[q], a));
    cum[q] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  float excl = __shfl_up_sync(kFull, incl, 1);  // the lanes before this one in the warp
  if (lane == 0) excl = 0.f;
  __syncthreads();
  float before = 0.f;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  before += excl;
  for (int q = q0; q < q1; ++q) cum[q] += before;
  __syncthreads();
  const float cum_last = cum[Q - 1];
  float* cum_out = cum_g + (((long long)b * nc + c) * H + h) * Q;
  for (int q = tid; q < Q; q += nthr) {
    if (pt == 0) cum_out[q] = cum[q];
    co[q] = __fmul_rn(expf(cum_last - cum[q]), co[q]);
  }

  // contrib = u^T . B over 64-key tiles, u = co * x; warp: 16 rows of P x 8 NTN states
  const int slab = warp % (PT / 16), n0 = (warp / (PT / 16)) * 8 * NTN;
  float acc[NTN][4];
#pragma unroll
  for (int i = 0; i < NTN; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const E* xrow = x + (tok0 * H + h) * P + pt * PT;
  for (int j0 = 0; j0 < Q; j0 += kKeys) {
    const int nk = min(kKeys, Q - j0);
    __syncthreads();
    stage_rows(bs, LDN, bm + (tok0 + j0) * N, N, kKeys, N, nk, tid, nthr);
    cp_commit();
    // u = co_q * x_q (float32), in PLANES parts
    constexpr int V = 16 / sizeof(E);
    for (int e = tid; e < kKeys * (PT / V); e += nthr) {
      const int r = e / (PT / V), p = (e - r * (PT / V)) * V;
      float u[V];
      if (r < nk) {
        const float cf = co[j0 + r];
        if constexpr (kBf16<E>) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xrow + (long long)(j0 + r) * H * P + p);
          const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int i = 0; i < V; ++i) u[i] = __fmul_rn(cf, __bfloat162float(v[i]));
        } else {
          const float4 v = *reinterpret_cast<const float4*>(xrow + (long long)(j0 + r) * H * P + p);
          u[0] = __fmul_rn(cf, v.x); u[1] = __fmul_rn(cf, v.y); u[2] = __fmul_rn(cf, v.z); u[3] = __fmul_rn(cf, v.w);
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) u[i] = 0.f;
      }
      if constexpr (kBf16<E>) {
        uint32_t hh[V / 2], mm[V / 2], ll[V / 2];
#pragma unroll
        for (int i = 0; i < V / 2; ++i) split3_pair(u[2 * i], u[2 * i + 1], hh[i], mm[i], ll[i]);
        E* dst = us + r * LDP + p;
        *reinterpret_cast<uint4*>(dst) = make_uint4(hh[0], hh[1], hh[2], hh[3]);
        *reinterpret_cast<uint4*>(dst + kKeys * LDP) = make_uint4(mm[0], mm[1], mm[2], mm[3]);
        *reinterpret_cast<uint4*>(dst + 2 * kKeys * LDP) = make_uint4(ll[0], ll[1], ll[2], ll[3]);
      } else {
        *reinterpret_cast<float4*>(us + r * LDP + p) = make_float4(u[0], u[1], u[2], u[3]);
      }
    }
    cp_wait<0>();
    __syncthreads();
    const int ksteps = (nk + 15) / 16;
    if constexpr (kBf16<E>) {
      // A = u^T (rows p, k = keys) and B (k = keys, columns n), both stored key-major: transposed loads
      const E* ap = us + ((lane & 7) + 8 * (lane >> 4)) * LDP + 16 * slab + 8 * ((lane >> 3) & 1);
      const E* bp = bs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDN + n0 + 8 * (lane >> 4);
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks) {
        if (ks < ksteps) {
          uint32_t bf[NTN / 2][4];
#pragma unroll
          for (int pp = 0; pp < NTN / 2; ++pp) ldsm4t(bf[pp], bp + 16 * ks * LDN + 16 * pp);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t af[4];
            ldsm4t(af, ap + q * kKeys * LDP + 16 * ks * LDP);
#pragma unroll
            for (int pp = 0; pp < NTN / 2; ++pp) {
              mma(acc[2 * pp], af, bf[pp][0], bf[pp][1]);
              mma(acc[2 * pp + 1], af, bf[pp][2], bf[pp][3]);
            }
          }
        }
      }
    } else {
      const int g = lane >> 2, t = lane & 3;
      for (int k = 0; k < nk; ++k) {
        const float a0 = us[k * LDP + 16 * slab + g], a1 = us[k * LDP + 16 * slab + g + 8];
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt) {
          const float2 y = *reinterpret_cast<const float2*>(bs + k * LDN + n0 + 8 * nt + 2 * t);
          acc[nt][0] = fmaf(a0, y.x, acc[nt][0]);
          acc[nt][1] = fmaf(a0, y.y, acc[nt][1]);
          acc[nt][2] = fmaf(a1, y.x, acc[nt][2]);
          acc[nt][3] = fmaf(a1, y.y, acc[nt][3]);
        }
      }
    }
  }
  const int g = lane >> 2, t = lane & 3;
  float* out = contrib + ((((long long)b * nc + c) * H + h) * P + pt * PT + 16 * slab + g) * N + n0 + 2 * t;
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    *reinterpret_cast<float2*>(out + 8 * nt) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + 8 * N + 8 * nt) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// --- 2. the state pass -----------------------------------------------------

// one thread per 4 entries of a (batch, head)'s (P, N) state: over the
// chunks, s_in = s (written over contrib), s = s * exp(cum_last) + contrib
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ cum_g, float* __restrict__ states, float* __restrict__ final_state,
                int nc, int H, int Q, int PN) {
  const int per_bh = (PN / 4 + kPassThreads - 1) / kPassThreads;
  const int bh = blockIdx.x / per_bh;
  const int e4 = (blockIdx.x - bh * per_bh) * kPassThreads + threadIdx.x;
  const int b = bh / H, h = bh - b * H;
  if (e4 * 4 < PN) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    const long long stride = (long long)H * PN;  // from one chunk's state of this head to the next
    float4* slot = reinterpret_cast<float4*>(states + ((long long)b * nc * H + h) * PN) + e4;
    const float* cl = cum_g + ((long long)b * nc * H + h) * Q + Q - 1;
    float4 nxt = slot[0];
    float dnx = cl[0];
    for (int c = 0; c < nc; ++c) {
      const float4 v = nxt;
      const float decay = expf(dnx);
      if (c + 1 < nc) {
        nxt = slot[(c + 1) * stride / 4];
        dnx = cl[(long long)(c + 1) * H * Q];
      }
      slot[c * stride / 4] = s;
      s.x = __fadd_rn(__fmul_rn(s.x, decay), v.x);
      s.y = __fadd_rn(__fmul_rn(s.y, decay), v.y);
      s.z = __fadd_rn(__fmul_rn(s.z, decay), v.z);
      s.w = __fadd_rn(__fmul_rn(s.w, decay), v.w);
    }
    reinterpret_cast<float4*>(final_state + (long long)bh * PN)[e4] = s;
  }
}

// --- 3. y ------------------------------------------------------------------

template <typename E, int N, int PT>
struct YShape {
  static constexpr int PAD = 16 / sizeof(E);
  static constexpr int LDN = N + PAD;   // row of a C, B or state tile
  static constexpr int LDP = PT + PAD;  // row of an x tile
  static constexpr int NTP = PT / 8;    // n8 tiles of y per warp
  static constexpr int PLANES = kBf16<E> ? 3 : 1;
  static constexpr int STAGES = kBf16<E> ? 2 : 1;
  static constexpr size_t C_BYTES = (size_t)kRows * LDN * sizeof(E);
  static constexpr size_t S_BYTES = (size_t)PLANES * PT * LDN * sizeof(E);
  static constexpr size_t KB_BYTES = (size_t)kKeys * LDN * sizeof(E);
  static constexpr size_t KX_BYTES = (size_t)kKeys * LDP * sizeof(E);
  static constexpr size_t KEY_BYTES = STAGES * (KB_BYTES + KX_BYTES);
  static constexpr size_t REGION = S_BYTES > KEY_BYTES ? S_BYTES : KEY_BYTES;
  static size_t smem(int Q) { return C_BYTES + REGION + sizeof(float) * 2 * Q; }
};

// one block of four warps per (batch, chunk, head, tile of 64 query rows,
// slice of PT head dims), the last row tiles (most keys) first; warp w owns
// rows 16w .. 16w + 15 of the tile
template <typename E, int N, int PT>
__global__ void __launch_bounds__(kYThreads)
ssd_y_kernel(const E* __restrict__ x, const E* __restrict__ dt, const E* __restrict__ bm,
             const E* __restrict__ cm, const float* __restrict__ cum_g, const float* __restrict__ states,
             E* __restrict__ y, int nc, int H, int P, int Q) {
  using S = YShape<E, N, PT>;
  constexpr int LDN = S::LDN, LDP = S::LDP, NTP = S::NTP, PLANES = S::PLANES, STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  E* cs = reinterpret_cast<E*>(smem);                             // (kRows, LDN)
  unsigned char* region = smem + S::C_BYTES;                      // the state planes, then the key tiles
  float* cum = reinterpret_cast<float*>(region + S::REGION);      // (Q)
  float* dtv = cum + Q;                                           // (Q)

  const int npt = P / PT, nrt = (Q + kRows - 1) / kRows;
  const int per_rt = gridDim.x / nrt;
  const int rt = nrt - 1 - blockIdx.x / per_rt;
  int rem = blockIdx.x % per_rt;
  const int pt = rem % npt;
  rem /= npt;
  const int h = rem % H;
  rem /= H;
  const int c = rem % nc;
  const int b = rem / nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long tok0 = ((long long)b * nc + c) * Q;
  const int i0 = rt * kRows, kend = min(Q, i0 + kRows);  // keys [0, kend) feed rows [i0, kend)
  const int r0 = i0 + 16 * warp;                          // this warp's first row
  const bool active = r0 < Q;
  const long long chs = ((long long)b * nc + c) * H + h;  // (batch, chunk, head)

  // C rows, cum and dt of the chunk's keys, and the incoming state in PLANES parts
  stage_rows(cs, LDN, cm + (tok0 + i0) * N, N, kRows, N, kend - i0, tid, kYThreads);
  cp_commit();
  for (int j = tid; j < kend; j += kYThreads) {
    cum[j] = cum_g[chs * Q + j];
    dtv[j] = to_f(dt[(tok0 + j) * H + h]);
  }
  {
    E* sp = reinterpret_cast<E*>(region);
    const float* src = states + (chs * P + pt * PT) * N;
    for (int e = tid; e < PT * N / 4; e += kYThreads) {
      const int p = (4 * e) / N, n = 4 * e - p * N;
      const float4 v = *reinterpret_cast<const float4*>(src + 4 * (long long)e);
      if constexpr (kBf16<E>) {
        uint32_t h0, m0, l0, h1, m1, l1;
        split3_pair(v.x, v.y, h0, m0, l0);
        split3_pair(v.z, v.w, h1, m1, l1);
        E* d = sp + p * LDN + n;
        *reinterpret_cast<uint2*>(d) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(d + PT * LDN) = make_uint2(m0, m1);
        *reinterpret_cast<uint2*>(d + 2 * PT * LDN) = make_uint2(l0, l1);
      } else {
        *reinterpret_cast<float4*>(sp + p * LDN + n) = v;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // y_inter = exp(cum_i) * (C_i . s_in): rows r0 + g, r0 + g + 8
  float acc[NTP][4];
#pragma unroll
  for (int i = 0; i < NTP; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (active) {
    const E* crow = cs + 16 * warp * LDN;
    const E* sp = reinterpret_cast<const E*>(region);
    if constexpr (kBf16<E>) {
      mma_rows<NTP, N, PLANES>(acc, crow, LDN, sp, LDN, PT * LDN, NTP / 2, lane);
    } else {
      fma_rows<NTP, N>(acc, crow, LDN, sp, LDN, NTP / 2, lane);
    }
    const int ia = r0 + g, ib = ia + 8;
    const float ea = ia < Q ? expf(cum[ia]) : 0.f, eb = ib < Q ? expf(cum[ib]) : 0.f;
#pragma unroll
    for (int i = 0; i < NTP; ++i) {
      acc[i][0] = __fmul_rn(acc[i][0], ea);
      acc[i][1] = __fmul_rn(acc[i][1], ea);
      acc[i][2] = __fmul_rn(acc[i][2], eb);
      acc[i][3] = __fmul_rn(acc[i][3], eb);
    }
  }
  __syncthreads();  // the region now holds key tiles

  // y_intra over the key tiles at or before the diagonal
  auto key_b = [&](int s) { return reinterpret_cast<E*>(region + s * (S::KB_BYTES + S::KX_BYTES)); };
  auto key_x = [&](int s) { return reinterpret_cast<E*>(region + s * (S::KB_BYTES + S::KX_BYTES) + S::KB_BYTES); };
  const E* xsrc = x + (tok0 * H + h) * P + pt * PT;
  auto fetch = [&](int j0, int s) {
    const int nk = min(kKeys, kend - j0);
    stage_rows(key_b(s), LDN, bm + (tok0 + j0) * N, N, kKeys, N, nk, tid, kYThreads);
    stage_rows(key_x(s), LDP, xsrc + (long long)j0 * H * P, (long long)H * P, kKeys, PT, nk, tid, kYThreads);
    cp_commit();
  };
  const int ntiles = (kend + kKeys - 1) / kKeys;
  fetch(0, 0);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int j0 = kt * kKeys;
    if (STAGES == 1 && kt > 0) fetch(j0, 0);
    if (STAGES == 2 && kt + 1 < ntiles) {
      fetch(j0 + kKeys, (kt + 1) % STAGES);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const E* kb = key_b(kt % STAGES);
    const E* kx = key_x(kt % STAGES);
    // 16-key column pairs with a key at or before this warp's last row
    const int last = min(r0 + 15, kend - 1);
    const int np = active && last >= j0 ? min(kKeys / 16, (last - j0) / 16 + 1) : 0;
    if (np > 0) {
      float sc[kKeys / 8][4];
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
      const E* crow = cs + 16 * warp * LDN;
      if constexpr (kBf16<E>) {
        mma_rows<kKeys / 8, N, 1>(sc, crow, LDN, kb, LDN, 0, np, lane);
      } else {
        fma_rows<kKeys / 8, N>(sc, crow, LDN, kb, LDN, np, lane);
      }
      // w_ij = (exp(cum_i - cum_j) * (C_i . B_j)) * dt_j for j <= i < Q, else 0 (masked before the exp)
      const int ia = r0 + g, ib = ia + 8;
      const float ca = cum[min(ia, kend - 1)], cb = cum[min(ib, kend - 1)];
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        if (nt / 2 < np) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * nt + 2 * t + e;
            const float cj = cum[min(j, kend - 1)], dj = dtv[min(j, kend - 1)];
            sc[nt][e] = (j <= ia && ia < Q) ? __fmul_rn(__fmul_rn(expf(ca - cj), sc[nt][e]), dj) : 0.f;
            sc[nt][2 + e] = (j <= ib && ib < Q) ? __fmul_rn(__fmul_rn(expf(cb - cj), sc[nt][2 + e]), dj) : 0.f;
          }
        }
      }
      // y += w . x: A = w (from the accumulators), B = x (k = keys, columns p), key-major in shared memory
      if constexpr (kBf16<E>) {
        const E* xp = kx + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDP + 8 * (lane >> 4);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          if (kk < np) {
            uint32_t ah[4], am[4], al[4];
            split3_pair(sc[2 * kk][0], sc[2 * kk][1], ah[0], am[0], al[0]);
            split3_pair(sc[2 * kk][2], sc[2 * kk][3], ah[1], am[1], al[1]);
            split3_pair(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], am[2], al[2]);
            split3_pair(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], am[3], al[3]);
#pragma unroll
            for (int pp = 0; pp < NTP / 2; ++pp) {
              uint32_t bf[4];
              ldsm4t(bf, xp + 16 * kk * LDP + 16 * pp);
              mma(acc[2 * pp], ah, bf[0], bf[1]);
              mma(acc[2 * pp + 1], ah, bf[2], bf[3]);
              mma(acc[2 * pp], am, bf[0], bf[1]);
              mma(acc[2 * pp + 1], am, bf[2], bf[3]);
              mma(acc[2 * pp], al, bf[0], bf[1]);
              mma(acc[2 * pp + 1], al, bf[2], bf[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          if (kk < np) {
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              // w[row][key 16 kk + k] lives in lane (g, (k % 8) / 2), accumulator tile 2 kk + k / 8
              const int src = (lane & ~3) | ((k & 7) >> 1);
              const float wa = __shfl_sync(kFull, sc[2 * kk + (k >> 3)][k & 1], src);
              const float wb = __shfl_sync(kFull, sc[2 * kk + (k >> 3)][2 + (k & 1)], src);
              const float* xr = kx + (16 * kk + k) * LDP + 2 * t;
#pragma unroll
              for (int nt = 0; nt < NTP; ++nt) {
                const float2 v = *reinterpret_cast<const float2*>(xr + 8 * nt);
                acc[nt][0] = fmaf(wa, v.x, acc[nt][0]);
                acc[nt][1] = fmaf(wa, v.y, acc[nt][1]);
                acc[nt][2] = fmaf(wb, v.x, acc[nt][2]);
                acc[nt][3] = fmaf(wb, v.y, acc[nt][3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // y, rounded once to the input type
  if (active) {
    const int ia = r0 + g, ib = ia + 8;
    E* ya = y + ((tok0 + ia) * H + h) * P + pt * PT + 2 * t;
    E* yb = ya + 8LL * H * P;
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      if constexpr (kBf16<E>) {
        if (ia < Q) *reinterpret_cast<__nv_bfloat162*>(ya + 8 * nt) = __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        if (ib < Q) *reinterpret_cast<__nv_bfloat162*>(yb + 8 * nt) = __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      } else {
        if (ia < Q) *reinterpret_cast<float2*>(ya + 8 * nt) = make_float2(acc[nt][0], acc[nt][1]);
        if (ib < Q) *reinterpret_cast<float2*>(yb + 8 * nt) = make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// --- launch ----------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename E, int N, int PT>
int launch_t(const E* x, const E* dt, const float* a_log, const E* b, const E* c, E* y, float* fs, float* scratch,
             int B, int L, int H, int P, int Q, cudaStream_t st) {
  const int nc = L / Q, nrt = (Q + kRows - 1) / kRows;
  const long long PN = (long long)P * N;
  float* contrib = scratch;                          // (B, nc, H, P, N): contributions, then incoming states
  float* cum = scratch + (long long)B * nc * H * PN;  // (B, nc, H, Q)
  const size_t s1 = StatesShape<E, N, PT>::smem(Q), s3 = YShape<E, N, PT>::smem(Q);
  cudaError_t err = allow_smem(ssd_states_kernel<E, N, PT>, s1);
  if (err == cudaSuccess) err = allow_smem(ssd_y_kernel<E, N, PT>, s3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_states_kernel<E, N, PT><<<B * nc * H * (P / PT), 32 * StatesShape<E, N, PT>::WARPS, s1, st>>>(
      x, dt, a_log, b, cum, contrib, nc, H, P, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int per_bh = (int)((PN / 4 + kPassThreads - 1) / kPassThreads);
  ssd_pass_kernel<<<B * H * per_bh, kPassThreads, 0, st>>>(cum, contrib, fs, nc, H, Q, (int)PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_y_kernel<E, N, PT><<<B * nc * H * nrt * (P / PT), kYThreads, s3, st>>>(x, dt, b, c, cum, contrib, y, nc,
                                                                             H, P, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int N>
int launch_n(const E* x, const E* dt, const float* a_log, const E* b, const E* c, E* y, float* fs, float* scratch,
             int B, int L, int H, int P, int Q, cudaStream_t st) {
  if (P % 64 == 0) return launch_t<E, N, 64>(x, dt, a_log, b, c, y, fs, scratch, B, L, H, P, Q, st);
  return launch_t<E, N, 16>(x, dt, a_log, b, c, y, fs, scratch, B, L, H, P, Q, st);
}

template <typename E>
int launch(const void* x, const void* dt, const void* a_log, const void* b, const void* c, void* y, void* fs,
           void* scratch, int B, int L, int H, int P, int N, int Q, void* stream) {
  if (P < 16 || P % 16 || Q < 1 || Q > kMaxChunk || L % Q) return -1;
  const auto* xx = static_cast<const E*>(x);
  const auto* dd = static_cast<const E*>(dt);
  const auto* aa = static_cast<const float*>(a_log);
  const auto* bb = static_cast<const E*>(b);
  const auto* cc = static_cast<const E*>(c);
  auto* yy = static_cast<E*>(y);
  auto* ff = static_cast<float*>(fs);
  auto* ss = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch_n<E, 16>(xx, dd, aa, bb, cc, yy, ff, ss, B, L, H, P, Q, st);
    case 32: return launch_n<E, 32>(xx, dd, aa, bb, cc, yy, ff, ss, B, L, H, P, Q, st);
    case 64: return launch_n<E, 64>(xx, dd, aa, bb, cc, yy, ff, ss, B, L, H, P, Q, st);
    case 128: return launch_n<E, 128>(xx, dd, aa, bb, cc, yy, ff, ss, B, L, H, P, Q, st);
    default: return -1;
  }
}

}  // namespace

// x, dt, b and c of one element type, a_log float32; y in the element
// type, the final state float32; all contiguous, x, b and c 16-byte
// aligned; scratch float32 of B * (L / Q) * H * (P * N + Q) entries.
// Launches the three kernels on `stream`; returns cudaGetLastError() after
// the launches, or -1 for a shape the kernels are not built for (P a
// multiple of 16, N of 16, 32, 64 or 128, 1 <= Q <= 1024 dividing L).
extern "C" int repro_ssd_scan_bf16(const void* x, const void* dt, const void* a_log, const void* b, const void* c,
                                   void* y, void* final_state, void* scratch, int B, int L, int H, int P, int N,
                                   int Q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a_log, b, c, y, final_state, scratch, B, L, H, P, N, Q, stream);
}

extern "C" int repro_ssd_scan_f32(const void* x, const void* dt, const void* a_log, const void* b, const void* c,
                                  void* y, void* final_state, void* scratch, int B, int L, int H, int P, int N,
                                  int Q, void* stream) {
  return launch<float>(x, dt, a_log, b, c, y, final_state, scratch, B, L, H, P, N, Q, stream);
}
