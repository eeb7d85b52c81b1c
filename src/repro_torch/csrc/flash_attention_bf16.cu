// Grouped-query attention forward in bf16 on Hopper's tensor cores (wgmma).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (_fa_kernel) for bf16 inputs: q (B, S, K, G, D), k and v
// (B, T, K, D), a causal mask with a q_offset, a scalar kv_len, output
// (B, S, K, G, D).  (float32 runs csrc/flash_attention.cu.)  The reference's
// rounding points make the tensor cores exact here: q * scale is rounded to
// bf16 (the kernel does it while staging q); a bf16 x bf16 product is exact
// in float32, so a bf16 MMA with float32 accumulators gives the reference's
// float32 scores up to summation order; p is rounded to bf16 before the PV
// product, which is the MMA's A operand; the accumulator is float32 and the
// output bf16.  The online softmax takes its running max per key tile, as
// the reference takes it per KV chunk.  Masked scores are -1e30 and take
// part as in the reference (a fully masked row averages V over all T); keys
// past T take no part (-inf scores, V rows of zeros).
//
// What bounds it on an H100: at the serving prefill (B 2, S = T = 1792, K 2,
// G 7, D 64, causal) the causal function is about 11.5 GFLOP of bf16 MMA
// and about 5 MB of traffic, so operations bound it (0.0116 ms at 989
// TFLOP/s).  Design:
//   - GQA: the (s, g) rows of one (batch, kv head) are taken in q's own order
//     (row s * G + g) and cut into tiles of 64 rows, the M of one wgmma, with
//     no padding but at the end; a tile may start and end inside a query
//     position.  Every K and V tile is then loaded once for all G heads of
//     the tile's rows, and G up to 128 needs nothing else.  (One head per
//     M tile would reread K and V G times and, at G 7, spread the causal
//     diagonal over seven times as many tiles.)
//   - One block of two warpgroups per (tile of 128 rows, batch, kv head),
//     64 rows each, sharing every key and value tile; the row tiles with the
//     most keys are launched first.  S = Q.K^T is wgmma m64n64k16 with Q
//     and the key tile in shared memory (K's (T, D) rows are the K-major B
//     operand as they lie); P.V is wgmma m64nDk16 with P converted to bf16
//     in registers as the A operand and the value tile in shared memory as
//     the MN-major ("transposed") B operand.  All tiles use the non-swizzled
//     core-matrix layout (8 rows x 16 bytes contiguous).
//   - Key and value tiles of 64 keys arrive by 16-byte cp.async into a ring
//     of three stages, two tiles ahead, so loads overlap the MMAs and one
//     barrier per tile suffices.
//   - The softmax step is kept short, since each warpgroup's chain of S
//     MMA, softmax and P.V MMA, not the tensor cores' rate, sets the time
//     (about a fifth of the bf16 peak at the serve prefill): only the tiles
//     on the causal diagonal or at T or kv_len apply the mask, p is
//     ex2.approx.ftz of (s - m) * log2(e), and the accumulator is rescaled
//     only when a row's max moved.
//   - Causal tile skipping: a row tile whose every row sees at least one key
//     walks only the key tiles up to its last row's diagonal and below
//     kv_len (for a skipped tile p would be 0 and the rescaling 1, so this is
//     exact); a tile with a row that sees no key (kv_len 0, or a negative
//     causal position) walks all of T, as the reference does.
// Head widths 16, 32, 64 and 128 (the MMA's K step is 16 values).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWG = 2;               // warpgroups per block, 64 rows (one wgmma M tile) each
constexpr int kBM = 64 * kWG;        // (s, g) rows per block
constexpr int kBN = 64;              // keys per tile
constexpr int kThreads = 128 * kWG;
constexpr int kStages = 3;           // key and value tiles in flight
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk `c` (elements 8c..8c+7) of row r in a
// tile of D bf16 columns laid out as core matrices: the 8 rows of a core
// matrix are 128 contiguous bytes, the D / 8 core matrices of a group of 8
// rows follow each other, and the row groups follow.
template <int D>
__device__ __forceinline__ uint32_t cm_offset(int r, int c) {
  return (r >> 3) * (D * 16) + c * 128 + (r & 7) * 16;
}

// wgmma matrix descriptor, no swizzle: start address, leading-dimension
// byte offset (between core matrices adjacent along K) and stride byte
// offset (between core matrices adjacent along M or N), all in 16 bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// 2^x on the SFU, subnormal results flushed to zero (a p below 2^-126 adds nothing a bf16 P.V could hold)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // 16 bytes, or zeros where `valid` is false (no byte is read then)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keeps the compiler from moving reads or writes of an accumulator across the asynchronous MMAs
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, float32) = (scale_d ? d : 0) + A . B, A (64 x 16) and B (16 x N)
// bf16 in shared memory, both K-major (built for N = kBN)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d);
// d (64 x N, float32) += A . B, A (64 x 16) bf16 in registers, B (16 x N)
// bf16 in shared memory, MN-major
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
fa_wgmma_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S, int T, int K,
                    int G, int n_rt, int causal, int q_offset, int kv_len, float scale) {
  constexpr int kChunks = D / 8;                // 16-byte chunks per row
  constexpr int kTileBytes = kBN * D * 2;       // one key or value tile
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* qs = smem;                           // the row tile's scaled q (kBM x D)
  uint8_t* ks = qs + kBM * D * 2;               // kStages stages of keys
  uint8_t* vs = ks + kStages * kTileBytes;      // kStages stages of values
  const int BK = gridDim.x / n_rt;
  const int rt = n_rt - 1 - (int)blockIdx.x / BK;  // the row tiles with the most keys first
  const int bk = blockIdx.x % BK;
  const int b = bk / K, kh = bk % K;
  const int R = S * G, r0 = rt * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;

  // the key tiles this row tile walks
  const int n_kt_all = (T + kBN - 1) / kBN;
  int n_kt = n_kt_all;
  const int s_first = r0 / G, s_last = min(S - 1, (r0 + kBM - 1) / G);
  if (kv_len > 0 && (!causal || q_offset + s_first >= 0)) {
    int end = min(T, kv_len);
    if (causal) end = min(end, q_offset + s_last + 1);
    n_kt = (end + kBN - 1) / kBN;
  }

  // q * scale rounded to bf16, into core-matrix layout; eight neighbouring
  // threads fill one core matrix (rows r..r+7 of one 16-byte column chunk)
  for (int i = tid; i < kBM * kChunks; i += kThreads) {
    const int c = (i >> 3) % kChunks, r = ((i >> 3) / kChunks) * 8 + (i & 7);
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < R) {
      const int s = (r0 + r) / G, g = (r0 + r) % G;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(q + ((((long long)b * S + s) * K + kh) * G + g) * D + c * 8);
      const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t* out = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        out[j] = pack_bf16(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(qs + cm_offset<D>(r, c)) = packed;
  }

  const long long kv_row = (long long)K * D;  // elements between consecutive keys
  const __nv_bfloat16* kb = k + (long long)b * T * kv_row + (long long)kh * D;
  const __nv_bfloat16* vb = v + (long long)b * T * kv_row + (long long)kh * D;
  // this thread's 16-byte chunks of a key or value tile: row r_ld[it], column chunk c_ld[it]
  constexpr int kLdIters = (kBN * kChunks + kThreads - 1) / kThreads;
  int r_ld[kLdIters];
  uint32_t dst_ld[kLdIters];
  long long src_ld[kLdIters];
#pragma unroll
  for (int it = 0; it < kLdIters; ++it) {
    const int i = tid + it * kThreads;
    const int c = (i >> 3) % kChunks;
    r_ld[it] = i < kBN * kChunks ? ((i >> 3) / kChunks) * 8 + (i & 7) : kBN;  // kBN: no chunk
    dst_ld[it] = cm_offset<D>(r_ld[it], c);
    src_ld[it] = r_ld[it] * kv_row + c * 8;
  }
  const uint32_t ks_u32 = smem_u32(ks), vs_u32 = smem_u32(vs);
  auto load_tile = [&](int j, int stage) {
#pragma unroll
    for (int it = 0; it < kLdIters; ++it) {
      if (r_ld[it] == kBN) continue;
      const bool valid = j * kBN + r_ld[it] < T;
      const long long off = valid ? j * kBN * kv_row + src_ld[it] : 0;
      const uint32_t dst = dst_ld[it] + stage * kTileBytes;
      cp_async16(ks_u32 + dst, kb + off, valid);
      cp_async16(vs_u32 + dst, vb + off, valid);
    }
  };

  // this thread's rows of the block's tile (wgmma's accumulator layout: warp w of a warpgroup holds its
  // rows 16w..16w+15) and their positions
  const int row_in[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  int q_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) q_pos[h] = q_offset + (r0 + row_in[h]) / G;
  const int col0 = (lane & 3) * 2;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float sc[kBN / 2] = {};  // S = Q.K^T of the current key tile (the first MMA ignores what it holds)

  for (int j = 0; j < 2; ++j) {
    if (j < n_kt) load_tile(j, j);
    cp_async_commit();
  }
  for (int j = 0; j < n_kt; ++j) {
    const int stage = j % kStages;
    cp_async_wait1();  // this thread's copies of tile j have landed (tile j + 1 may be in flight)
    fence_proxy_async();
    __syncthreads();   // and everyone's (and q, on the first tile); and every thread is done with tile j - 1
    if (j + 2 < n_kt) load_tile(j + 2, (j + 2) % kStages);  // into the stage tile j - 1 used
    cp_async_commit();

    // S = Q . K^T
    const uint32_t k_addr = smem_u32(ks) + stage * kTileBytes;
    const uint32_t v_addr = smem_u32(vs) + stage * kTileBytes;
    const uint32_t q_addr = smem_u32(qs) + wg * 8 * (D * 16);  // this warpgroup's 64 rows
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kBN>(sc, make_desc(q_addr + kk * 256, 128, D * 16), make_desc(k_addr + kk * 256, 128, D * 16),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // mask (only a tile on the diagonal or at an edge needs it), the tile's
    // max and the online-softmax step, per row
    const int t0 = j * kBN;
    const bool interior = t0 + kBN <= min(T, kv_len) && (!causal || t0 + kBN - 1 <= q_offset + s_first);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sc[jn * 4 + h * 2 + e];
          if (!interior) {
            const int t = t0 + jn * 8 + col0 + e;
            if (t >= T) {
              s = __int_as_float(0xff800000);  // -inf: no key
            } else if ((causal && q_pos[h] < t) || t >= kv_len) {
              s = kNeg;
            }
          }
          mx = fmaxf(mx, s);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = ex2((m[h] - m_new) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sc[jn * 4 + h * 2 + e];
          s = ex2((s - m_new) * kLog2e);
          sum += s;
        }
      }
      l[h] = l[h] * alpha[h] + sum;
      m[h] = m_new;
    }
    // p rounded to bf16: the A operand of P.V, one k step of 16 keys per 4 registers
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // most tiles leave the max where it was
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        acc[jd * 4 + 0] *= alpha[0];
        acc[jd * 4 + 1] *= alpha[0];
        acc[jd * 4 + 2] *= alpha[1];
        acc[jd * 4 + 3] *= alpha[1];
      }
    }

    // O += P . V
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_rs<D>(acc, pa[kk], make_desc(v_addr + kk * 2 * (D * 16), D * 16, 128));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  }

  // l summed over the four threads of a row, in a fixed order; the output row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = r0 + row_in[h];
    if (r >= R) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    const int s = r / G, g = r % G;
    __nv_bfloat16* out = o + ((((long long)b * S + s) * K + kh) * G + g) * D;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      *reinterpret_cast<__nv_bfloat162*>(out + jd * 8 + col0) =
          __floats2bfloat162_rn(acc[jd * 4 + h * 2] / denom, acc[jd * 4 + h * 2 + 1] / denom);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T, int K, int G, int causal,
           int q_offset, int kv_len, float scale, cudaStream_t stream) {
  const int n_rt = (S * G + kBM - 1) / kBM;
  const int bytes = kBM * D * 2 + 2 * kStages * kBN * D * 2;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fa_wgmma_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fa_wgmma_fwd_kernel<D><<<B * K * n_rt, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, T, K, G, n_rt, causal, q_offset,
      kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `scale` multiplies q before the dot: D ** -0.5 rounded to bf16, as the
// reference's weak-typed `q * scale` rounds it.  q, k and v must be 16-byte
// aligned.  Returns cudaGetLastError() after the launch, or -1 for a head
// width the kernel is not built for.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                                          int T, int K, int G, int D, int causal, int q_offset, int kv_len,
                                          float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, S, T, K, G, causal, q_offset, kv_len, scale, st);
    case 32: return launch<32>(q, k, v, o, B, S, T, K, G, causal, q_offset, kv_len, scale, st);
    case 64: return launch<64>(q, k, v, o, B, S, T, K, G, causal, q_offset, kv_len, scale, st);
    case 128: return launch<128>(q, k, v, o, B, S, T, K, G, causal, q_offset, kv_len, scale, st);
    default: return -1;
  }
}
