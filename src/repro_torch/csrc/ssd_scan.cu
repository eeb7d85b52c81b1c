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
// is rounded to the input type.  exp is only ever taken of a difference
// cum_i - cum_j with j <= i (never exp(cum_i) / exp(cum_j)), so it stays in
// (0, 1]: at full width cum falls to about -200 within a chunk.
//
// What bounds it on an H100: at the serving path's shape (B 2, L 2048,
// H 32, P 64, N 128, Q 256, bf16) a call moves about 38 MB (0.011 ms at
// 3.35 TB/s) and does about 6.6 GFLOP of float32 work if C . B is computed
// once per (batch, chunk) (0.098 ms at 67 TFLOP/s), so it is bound by
// float32 operations.  Design, simple first: the Pallas kernel keeps a
// (Q, Q, H) float32 tensor (8.4 MB) and the whole (H, P, N) state in VMEM;
// a Hopper block has at most 227 KB of shared memory.  So one block of 256
// threads per (batch, head, slice of PS head dims), PS 32 (P a multiple of
// 32) or 16, which gives 128 blocks at the serve shape; a loop over the
// chunks inside the block; the slice's PS x N float32 state in shared
// memory.  Per chunk: one warp scans cum; then per tile of 64 query rows,
// y_inter from the state, and for each tile of 64 keys at or before it,
// the 64 x 64 scores C . B^T, weighted and masked into shared memory, times
// the keys' x; then the state update over the chunk's keys.  Every product
// is register-tiled (a thread holds a strided 4 x 4, 4 x PS/16 or PS/16 x
// N/16 patch) on CUDA cores.  Each block recomputes C . B^T for its head and
// slice (2 x 32 x 2 times the work the bound counts for it); sharing the
// scores across heads, tensor cores (wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;        // query rows and key rows per tile
constexpr int kTX = 16;       // thread grid of the tile products: tx = tid % 16, ty = tid / 16
constexpr int kMaxChunk = 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

template <typename E, int N, int PS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const E* __restrict__ x, const E* __restrict__ dt, const float* __restrict__ a_log,
                const E* __restrict__ bm, const E* __restrict__ cm, E* __restrict__ y,
                float* __restrict__ final_state, int L, int H, int P, int Q) {
  constexpr int NP = N + 1;        // padded row of the state and of the B and C tiles
  constexpr int KY = kT / 16;      // query rows per thread
  constexpr int MY = PS / kTX;     // head dims per thread in y
  constexpr int KS = PS / 16;      // head dims per thread in the state update
  constexpr int MS = N / kTX;      // state dims per thread in the state update
  extern __shared__ float smem[];
  float* st = smem;                // the state slice (PS, N)
  float* cs = st + PS * NP;        // C tile (kT, N)
  float* bs = cs + kT * NP;        // B tile (kT, N)
  float* xs = bs + kT * NP;        // x tile of the keys (kT, PS)
  float* ws = xs + kT * PS;        // weights (kT, kT + 1)
  float* cum = ws + kT * (kT + 1); // (Q)
  float* dtv = cum + Q;            // (Q)
  float* co = dtv + Q;             // exp(cum_last - cum_q) * dt_q, (Q)

  const int nps = P / PS;
  const int ps = blockIdx.x % nps;
  const int h = (blockIdx.x / nps) % H;
  const int b = blockIdx.x / (nps * H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % kTX, ty = tid / kTX;
  const float a = -expf(a_log[h]);
  const long long row0 = (long long)b * L;  // the batch row's first token

  for (int e = tid; e < PS * NP; e += kThreads) st[e] = 0.f;

  // stage rows [r0, r0 + kT) of a (B, L, N) matrix of this batch row (zeros past the chunk)
  auto load_bc = [&](float* dst, const E* src, long long tok0, int n_rows) {
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, n = e % N;
      dst[r * NP + n] = r < n_rows ? to_f(src[(tok0 + r) * N + n]) : 0.f;
    }
  };
  auto load_x = [&](long long tok0, int n_rows) {
    for (int e = tid; e < kT * PS; e += kThreads) {
      const int r = e / PS, p = e % PS;
      xs[e] = r < n_rows ? to_f(x[((tok0 + r) * H + h) * P + ps * PS + p]) : 0.f;
    }
  };

  for (int c0 = 0; c0 < L; c0 += Q) {
    const long long tok = row0 + c0;
    // 1. dt and cum = cumsum(dt * a): one warp, a serial run per lane, then a shuffle scan
    for (int i = tid; i < Q; i += kThreads) dtv[i] = to_f(dt[(tok + i) * H + h]);
    __syncthreads();
    if (warp == 0) {
      const int per = (Q + 31) / 32;
      const int s0 = min(lane * per, Q), s1 = min(s0 + per, Q);
      float run = 0.f;
      for (int i = s0; i < s1; ++i) {
        run = __fadd_rn(run, __fmul_rn(dtv[i], a));
        cum[i] = run;
      }
      float tot = run;  // inclusive scan of the lanes' runs
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) excl = 0.f;
      for (int i = s0; i < s1; ++i) cum[i] += excl;
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) co[i] = __fmul_rn(expf(cum_last - cum[i]), dtv[i]);

    // 2. y, a tile of kT query rows at a time (the state is the chunk's incoming one)
    for (int i0 = 0; i0 < Q; i0 += kT) {
      const int nq = min(kT, Q - i0);
      __syncthreads();
      load_bc(cs, cm, tok + i0, nq);
      __syncthreads();
      // y_inter = exp(cum_i) * (C_i . state): rows ty + 16k, head dims tx + 16m
      float yi[KY][MY], ya[KY][MY];
#pragma unroll
      for (int k = 0; k < KY; ++k)
#pragma unroll
        for (int m = 0; m < MY; ++m) yi[k][m] = ya[k][m] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[KY], sv[MY];
#pragma unroll
        for (int k = 0; k < KY; ++k) cv[k] = cs[(ty + 16 * k) * NP + n];
#pragma unroll
        for (int m = 0; m < MY; ++m) sv[m] = st[(tx + kTX * m) * NP + n];
#pragma unroll
        for (int k = 0; k < KY; ++k)
#pragma unroll
          for (int m = 0; m < MY; ++m) yi[k][m] = fmaf(cv[k], sv[m], yi[k][m]);
      }
#pragma unroll
      for (int k = 0; k < KY; ++k) {
        const int i = ty + 16 * k;
        const float e = i < nq ? expf(cum[i0 + i]) : 0.f;
#pragma unroll
        for (int m = 0; m < MY; ++m) yi[k][m] = __fmul_rn(yi[k][m], e);
      }
      // y_intra: the key tiles at or before this query tile
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        const int nk = min(kT, Q - j0);
        __syncthreads();
        load_bc(bs, bm, tok + j0, nk);
        load_x(tok + j0, nk);
        __syncthreads();
        // w_ij = (exp(cum_i - cum_j) * (C_i . B_j)) * dt_j for j <= i, else 0: rows ty + 16k, keys tx + 16m
        float sc[KY][kT / kTX];
#pragma unroll
        for (int k = 0; k < KY; ++k)
#pragma unroll
          for (int m = 0; m < kT / kTX; ++m) sc[k][m] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[KY], bv[kT / kTX];
#pragma unroll
          for (int k = 0; k < KY; ++k) cv[k] = cs[(ty + 16 * k) * NP + n];
#pragma unroll
          for (int m = 0; m < kT / kTX; ++m) bv[m] = bs[(tx + kTX * m) * NP + n];
#pragma unroll
          for (int k = 0; k < KY; ++k)
#pragma unroll
            for (int m = 0; m < kT / kTX; ++m) sc[k][m] = fmaf(cv[k], bv[m], sc[k][m]);
        }
#pragma unroll
        for (int k = 0; k < KY; ++k) {
          const int i = i0 + ty + 16 * k;
#pragma unroll
          for (int m = 0; m < kT / kTX; ++m) {
            const int j = j0 + tx + kTX * m;
            float w = 0.f;
            if (j <= i && i < Q) w = __fmul_rn(__fmul_rn(expf(cum[i] - cum[j]), sc[k][m]), dtv[j]);
            ws[(ty + 16 * k) * (kT + 1) + tx + kTX * m] = w;
          }
        }
        __syncthreads();
        // y_intra += w . x_keys
        for (int jj = 0; jj < nk; ++jj) {
          float wv[KY], xv[MY];
#pragma unroll
          for (int k = 0; k < KY; ++k) wv[k] = ws[(ty + 16 * k) * (kT + 1) + jj];
#pragma unroll
          for (int m = 0; m < MY; ++m) xv[m] = xs[jj * PS + tx + kTX * m];
#pragma unroll
          for (int k = 0; k < KY; ++k)
#pragma unroll
            for (int m = 0; m < MY; ++m) ya[k][m] = fmaf(wv[k], xv[m], ya[k][m]);
        }
      }
#pragma unroll
      for (int k = 0; k < KY; ++k) {
        const int i = ty + 16 * k;
        if (i < nq) {
#pragma unroll
          for (int m = 0; m < MY; ++m)
            y[((tok + i0 + i) * H + h) * P + ps * PS + tx + kTX * m] = from_f<E>(yi[k][m] + ya[k][m]);
        }
      }
    }

    // 3. state = state * exp(cum_last) + sum_q co_q * x_q (x) B_q: head dims ty + 16k, state dims tx + 16m
    float acc[KS][MS];
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int m = 0; m < MS; ++m) acc[k][m] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += kT) {
      const int nk = min(kT, Q - j0);
      __syncthreads();
      load_bc(bs, bm, tok + j0, nk);
      load_x(tok + j0, nk);
      __syncthreads();
      for (int jj = 0; jj < nk; ++jj) {
        const float cf = co[j0 + jj];
        float xv[KS], bv[MS];
#pragma unroll
        for (int k = 0; k < KS; ++k) xv[k] = __fmul_rn(cf, xs[jj * PS + ty + 16 * k]);
#pragma unroll
        for (int m = 0; m < MS; ++m) bv[m] = bs[jj * NP + tx + kTX * m];
#pragma unroll
        for (int k = 0; k < KS; ++k)
#pragma unroll
          for (int m = 0; m < MS; ++m) acc[k][m] = fmaf(xv[k], bv[m], acc[k][m]);
      }
    }
    __syncthreads();
    const float decay = expf(cum_last);
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        float* s = st + (ty + 16 * k) * NP + tx + kTX * m;
        *s = __fadd_rn(__fmul_rn(*s, decay), acc[k][m]);
      }
    __syncthreads();
  }
  float* out = final_state + ((long long)(b * H + h) * P + ps * PS) * N;
  for (int e = tid; e < PS * N; e += kThreads) out[e] = st[(e / N) * NP + e % N];
}

template <typename E, int N, int PS>
int launch_t(const E* x, const E* dt, const float* a_log, const E* b, const E* c, E* y, float* fs, int B, int L,
             int H, int P, int Q, cudaStream_t st) {
  const size_t bytes = sizeof(float) * (PS * (N + 1) + 2 * kT * (N + 1) + kT * PS + kT * (kT + 1) + 3 * Q);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<E, N, PS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_scan_kernel<E, N, PS><<<B * H * (P / PS), kThreads, bytes, st>>>(x, dt, a_log, b, c, y, fs, L, H, P, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int N>
int launch_n(const E* x, const E* dt, const float* a_log, const E* b, const E* c, E* y, float* fs, int B, int L,
             int H, int P, int Q, cudaStream_t st) {
  if (P % 32 == 0) return launch_t<E, N, 32>(x, dt, a_log, b, c, y, fs, B, L, H, P, Q, st);
  return launch_t<E, N, 16>(x, dt, a_log, b, c, y, fs, B, L, H, P, Q, st);
}

template <typename E>
int launch(const void* x, const void* dt, const void* a_log, const void* b, const void* c, void* y, void* fs, int B,
           int L, int H, int P, int N, int Q, void* stream) {
  if (P < 16 || P % 16 || Q < 1 || Q > kMaxChunk || L % Q) return -1;
  const auto* xx = static_cast<const E*>(x);
  const auto* dd = static_cast<const E*>(dt);
  const auto* aa = static_cast<const float*>(a_log);
  const auto* bb = static_cast<const E*>(b);
  const auto* cc = static_cast<const E*>(c);
  auto* yy = static_cast<E*>(y);
  auto* ff = static_cast<float*>(fs);
  auto st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch_n<E, 16>(xx, dd, aa, bb, cc, yy, ff, B, L, H, P, Q, st);
    case 32: return launch_n<E, 32>(xx, dd, aa, bb, cc, yy, ff, B, L, H, P, Q, st);
    case 64: return launch_n<E, 64>(xx, dd, aa, bb, cc, yy, ff, B, L, H, P, Q, st);
    case 128: return launch_n<E, 128>(xx, dd, aa, bb, cc, yy, ff, B, L, H, P, Q, st);
    default: return -1;
  }
}

}  // namespace

// x, dt, b and c of one element type, a_log float32; y in the element
// type, the final state float32; all contiguous.  Returns
// cudaGetLastError() after the launch, or -1 for a shape the kernel is not
// built for (P a multiple of 16, N of 16, 32, 64 or 128, 1 <= Q <= 1024
// dividing L).
extern "C" int repro_ssd_scan_bf16(const void* x, const void* dt, const void* a_log, const void* b, const void* c,
                                   void* y, void* final_state, int B, int L, int H, int P, int N, int Q,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, dt, a_log, b, c, y, final_state, B, L, H, P, N, Q, stream);
}

extern "C" int repro_ssd_scan_f32(const void* x, const void* dt, const void* a_log, const void* b, const void* c,
                                  void* y, void* final_state, int B, int L, int H, int P, int N, int Q,
                                  void* stream) {
  return launch<float>(x, dt, a_log, b, c, y, final_state, B, L, H, P, N, Q, stream);
}
