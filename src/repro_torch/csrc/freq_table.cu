// The prediction-frequency table's update stream and lookup (1024 sets x 16
// ways, 6-bit saturating counters).
//
// Replaces the TPU kernels repro/kernels/freq_table/kernel.py::freq_update
// (_update_kernel) and ::freq_lookup (_lookup_kernel).
//
// Update rule, per streamed block b in arrival order (b == -1 is padding):
// the first way whose tag is b, else the first empty way (tag -1), else the
// lowest-counter way (first on ties); its tag becomes b and its counter
// min(old + 1, 63), where old is 0 unless the way hit.
//
// What bounds the update on an H100: latency of a serial walk.  Sets are
// independent but order within a set matters, which is the TPU kernel's
// grid tiling without its sequential grid: here one warp owns one set, its
// lanes 0-15 hold the set's 16 ways (tag and counter in registers), eight
// sets to a block of eight warps.  The first version had every warp walk
// the whole stream, 32 entries per ballot, and apply its set's entries one
// by one, so a set hit hundreds of times was a serial chain of hundreds of
// way choices while the block's other warps waited.  Now each block
// stages the stream in tiles of 2,048 entries and sorts each tile by set
// for its own eight sets only, a counting sort that keeps arrival order:
// each lane takes eight consecutive entries and counts them per set in
// 16-bit fields of two words, one warp scan of those words gives every
// lane its place among the warp's entries of each set, the warps' totals
// and a scan over the sets give each set's segment, and each lane writes
// its entries there (a tile with none of the block's sets ends after the
// count).  Each warp walks only its set's segment.  Same-block runs within a set collapse, as in the plain version:
// k touches of the set's current block are one saturating +k, applied by
// the run's head, which alone makes the way choice (one warp min-reduction
// over keys that order a hit, then an empty way, then the lowest counter,
// then the lane); a run's length is counted by popcounts over the window's
// heads and carries across windows and tiles.  Every branch is uniform
// across the warp, and sets never share a warp, so there are no atomics.
// Blocks below 0 are no-ops; the set index of the others is b % sets (a
// mask when the sets are a power of two).
//
// Lookup is one thread per queried block: the first-hit way's counter, else
// -1; it is bound by the latency of one dependent gather per block.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWays = 16;
constexpr int kCounterMax = 63;
constexpr int kSetsPerBlock = 8;  // one warp per set
constexpr int kTile = 2048;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int floor_mod(int b, int n) {
  int s = b % n;
  return s < 0 ? s + n : s;
}

__device__ __forceinline__ unsigned lanes_below(int n) { return n >= 32 ? kFull : (1u << n) - 1u; }

// k >= 1 consecutive touches of block b applied to the warp's set.  Lane
// w < 16 holds way w in (t, c).  One warp reduction picks the way: each way
// lane's key orders a hit before an empty way before the lowest counter,
// the first lane on ties.
__device__ __forceinline__ void apply_run(int b, int k, int lane, int& t, int& c) {
  const unsigned key = lane >= kWays ? 0xffffffffu
                       : t == b      ? (unsigned)lane
                       : t == -1     ? 32u + lane
                                     : 64u + ((unsigned)c << 5) + lane;
  const unsigned best = __reduce_min_sync(kFull, key);
  if (lane == (int)(best & 31u)) {
    c = min((best < 32u ? c : 0) + min(k, kCounterMax), kCounterMax);
    t = b;
  }
}

__global__ void __launch_bounds__(kSetsPerBlock * 32)
freq_update_kernel(int32_t* __restrict__ tags, int32_t* __restrict__ counters,
                   const int32_t* __restrict__ blocks, int n_blocks, int n_sets) {
  constexpr int kPer = kTile / (kSetsPerBlock * 32);      // consecutive entries per thread per tile
  __shared__ int32_t list[kTile];                         // the tile's entries of this block's sets, by set
  __shared__ int counts[kSetsPerBlock][kSetsPerBlock];    // [warp][set]: entries in the warp's slice of the tile
  __shared__ int seg[kSetsPerBlock + 1];                  // set s's segment of `list`: [seg[s], seg[s + 1])
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int set0 = blockIdx.x * kSetsPerBlock;
  const int set = set0 + warp;
  const bool mine = set < n_sets;  // uniform across the warp
  const bool pow2 = (n_sets & (n_sets - 1)) == 0;
  int t = -1, c = 0;
  if (mine && lane < kWays) {
    t = tags[set * kWays + lane];
    c = counters[set * kWays + lane];
  }
  int last_b = -1, run = 0;  // the set's current block and its touches not yet applied
  for (int base = 0; base < n_blocks; base += kTile) {
    const int n_tile = min(kTile, n_blocks - base);
    // lane l of warp w takes the tile's entries 8 (32 w + l) to 8 (32 w + l) + 7;
    // ls: the entry's set among this block's, else -1
    int bv[kPer], ls[kPer];
    const int j0 = (warp * 32 + lane) * kPer;
    const int32_t* src = blocks + base + j0;
    if (j0 + kPer <= n_tile && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int4 v0 = reinterpret_cast<const int4*>(src)[0], v1 = reinterpret_cast<const int4*>(src)[1];
      bv[0] = v0.x; bv[1] = v0.y; bv[2] = v0.z; bv[3] = v0.w;
      bv[4] = v1.x; bv[5] = v1.y; bv[6] = v1.z; bv[7] = v1.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) bv[k] = j0 + k < n_tile ? src[k] : -1;
    }
    // this lane's entries per set, as 16-bit fields (sets 0-3 in cl, 4-7 in ch)
    unsigned long long cl = 0, ch = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int b = bv[k];
      int s = -1;
      if (b >= 0) {
        s = (pow2 ? (b & (n_sets - 1)) : b % n_sets) - set0;
        if (s >= kSetsPerBlock) s = -1;
      }
      ls[k] = s < 0 ? -1 : s;
      if (ls[k] >= 0) {
        const unsigned long long one = 1ull << (16 * (ls[k] & 3));
        if (ls[k] & 4) ch += one; else cl += one;
      }
    }
    // inclusive scan over the warp's lanes, all eight sets at once
    unsigned long long il = cl, ih = ch;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long vl = __shfl_up_sync(kFull, il, off), vh = __shfl_up_sync(kFull, ih, off);
      if (lane >= off) {
        il += vl;
        ih += vh;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int q = 0; q < kSetsPerBlock; ++q) counts[warp][q] = (int)(((q < 4 ? il : ih) >> (16 * (q & 3))) & 0xffff);
    }
    __syncthreads();
    // lane s < 8: set s's total and the entries of the warps before this one;
    // the segment starts by a scan over lanes 0-7
    int total = 0, before = 0;
    if (lane < kSetsPerBlock) {
#pragma unroll
      for (int w = 0; w < kSetsPerBlock; ++w) {
        const int n = counts[w][lane];
        total += n;
        before += w < warp ? n : 0;
      }
    }
    int start = total;
#pragma unroll
    for (int off = 1; off < kSetsPerBlock; off <<= 1) {
      const int v = __shfl_up_sync(kFull, start, off);
      if (lane >= off) start += v;
    }
    const int all = __shfl_sync(kFull, start, kSetsPerBlock - 1);  // the block's entries in this tile
    start -= total;  // exclusive
    if (warp == 0 && lane <= kSetsPerBlock) seg[lane] = lane < kSetsPerBlock ? start : all;
    if (all == 0) {  // none of this block's sets in the tile (uniform across the block)
      __syncthreads();
      continue;
    }
    // this lane's first slot per set: the set's segment, plus the warp's part
    // before this warp, plus the lanes before this one (fields as above)
    unsigned long long pl = il - cl, ph = ih - ch;
    const int off_s = start + before;
#pragma unroll
    for (int q = 0; q < kSetsPerBlock; ++q) {
      const unsigned long long o = (unsigned long long)__shfl_sync(kFull, off_s, q) << (16 * (q & 3));
      if (q < 4) pl += o; else ph += o;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = ls[k];
      if (q >= 0) {
        const int sh = 16 * (q & 3);
        list[((q & 4 ? ph : pl) >> sh) & 0xffff] = bv[k];
        const unsigned long long one = 1ull << sh;
        if (q & 4) ph += one; else pl += one;
      }
    }
    __syncthreads();
    if (mine) {
      const int lo = seg[warp], hi = seg[warp + 1];
      for (int j0 = lo; j0 < hi; j0 += 32) {
        const int j = j0 + lane;
        const bool valid = j < hi;
        const int b = valid ? list[j] : -2;
        int prev = __shfl_up_sync(kFull, b, 1);
        if (lane == 0) prev = last_b;
        const unsigned vm = __ballot_sync(kFull, valid);
        unsigned heads = __ballot_sync(kFull, valid && b != prev);
        // entries before the window's first head extend the current run
        run += __popc(vm & lanes_below(heads != 0 ? __ffs(heads) - 1 : 32));
        while (heads != 0) {
          const int h = __ffs(heads) - 1;
          heads &= heads - 1;
          if (run > 0) apply_run(last_b, run, lane, t, c);
          const int next = heads != 0 ? __ffs(heads) - 1 : 32;
          last_b = __shfl_sync(kFull, b, h);
          run = __popc(vm & lanes_below(next) & ~lanes_below(h));
        }
      }
    }
    __syncthreads();
  }
  if (mine) {
    if (run > 0) apply_run(last_b, run, lane, t, c);
    if (lane < kWays) {
      tags[set * kWays + lane] = t;
      counters[set * kWays + lane] = c;
    }
  }
}

__global__ void freq_lookup_kernel(const int32_t* __restrict__ tags,
                                   const int32_t* __restrict__ counters,
                                   const int32_t* __restrict__ blocks, int32_t* __restrict__ out,
                                   int n_blocks, int n_sets) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_blocks) return;
  const int b = blocks[i];
  const int row = floor_mod(b, n_sets) * kWays;
  int hit = -1;
#pragma unroll
  for (int w = 0; w < kWays; ++w) {
    if (hit < 0 && tags[row + w] == b) hit = w;
  }
  out[i] = hit >= 0 ? counters[row + hit] : -1;
}

}  // namespace

extern "C" int repro_freq_update(void* tags, void* counters, const void* blocks, int n_blocks,
                                 int n_sets, void* stream) {
  const int grid = (n_sets + kSetsPerBlock - 1) / kSetsPerBlock;
  freq_update_kernel<<<grid, kSetsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(tags), static_cast<int32_t*>(counters),
      static_cast<const int32_t*>(blocks), n_blocks, n_sets);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_freq_lookup(const void* tags, const void* counters, const void* blocks,
                                 void* out, int n_blocks, int n_sets, void* stream) {
  constexpr int kThreads = 256;
  const int grid = (n_blocks + kThreads - 1) / kThreads;
  freq_lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tags), static_cast<const int32_t*>(counters),
      static_cast<const int32_t*>(blocks), static_cast<int32_t*>(out), n_blocks, n_sets);
  return static_cast<int>(cudaGetLastError());
}
