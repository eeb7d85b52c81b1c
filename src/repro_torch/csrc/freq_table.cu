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
// lanes 0-15 hold the set's 16 ways (tag and counter in registers), and the
// warp walks the whole block stream, applying only the blocks that hash to
// its set, which it finds 32 entries at a time with one ballot.  The way
// choice is warp ballots (hit, empty, and lowest counter after a 4-step
// shuffle min), each resolved to its first lane, so one update is a few
// dependent instructions instead of a 16-way scan by one thread; every
// branch is uniform across the warp.  A block equal to the set's previous
// block hits the same way again (a tag is never held by two ways of a
// set), so runs of one block skip the ballots.  The stream is staged
// through shared memory in tiles together with each block's set index,
// computed once per entry while staging (a modulo is tens of
// instructions).  Sets never share a warp, so they update with no atomics.
// The set index is a floor modulo, as in Python: C's % truncates toward
// zero.
//
// Lookup is one thread per queried block: the first-hit way's counter, else
// -1; it is bound by the latency of one dependent gather per block.
#include <cuda_runtime.h>

#include <climits>
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

// One streamed block b applied to the warp's set.  Lane w < 16 holds way w
// in (t, c); (last_b, last_way) is the set's previous block and its way.
__device__ __forceinline__ void apply_block(int b, int lane, int& t, int& c, int& last_b,
                                            int& last_way) {
  const bool way_lane = lane < kWays;
  int way;
  bool is_hit = true;
  if (b == last_b) {
    way = last_way;
  } else {
    const unsigned hit = __ballot_sync(kFull, way_lane && t == b);
    const unsigned empty = __ballot_sync(kFull, way_lane && t == -1);
    is_hit = hit != 0;
    if (is_hit) {
      way = __ffs(hit) - 1;
    } else if (empty != 0) {
      way = __ffs(empty) - 1;
    } else {
      int m = way_lane ? c : INT_MAX;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(kFull, m, off));
      m = __shfl_sync(kFull, m, 0);
      way = __ffs(__ballot_sync(kFull, way_lane && c == m)) - 1;
    }
  }
  if (lane == way) {
    c = min((is_hit ? c : 0) + 1, kCounterMax);
    t = b;
  }
  last_b = b;
  last_way = way;
}

__global__ void __launch_bounds__(kSetsPerBlock * 32)
freq_update_kernel(int32_t* __restrict__ tags, int32_t* __restrict__ counters,
                   const int32_t* __restrict__ blocks, int n_blocks, int n_sets) {
  __shared__ int32_t tile_b[kTile];
  __shared__ int32_t tile_s[kTile];  // set index of tile_b[j]; -1 for padding
  const int lane = threadIdx.x & 31;
  const int set = blockIdx.x * kSetsPerBlock + (threadIdx.x >> 5);
  const bool mine = set < n_sets;  // uniform across the warp
  int t = -1, c = 0;
  if (mine && lane < kWays) {
    t = tags[set * kWays + lane];
    c = counters[set * kWays + lane];
  }
  int last_b = -1, last_way = 0;
  for (int base = 0; base < n_blocks; base += kTile) {
    const int n_tile = min(kTile, n_blocks - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int b = blocks[base + i];
      tile_b[i] = b;
      tile_s[i] = b < 0 ? -1 : floor_mod(b, n_sets);
    }
    __syncthreads();
    if (!mine) continue;
    for (int j0 = 0; j0 < n_tile; j0 += 32) {
      // this set's entries among the next 32, applied in arrival order
      unsigned match = __ballot_sync(kFull, j0 + lane < n_tile && tile_s[j0 + lane] == set);
      for (; match != 0; match &= match - 1) {
        apply_block(tile_b[j0 + __ffs(match) - 1], lane, t, c, last_b, last_way);
      }
    }
  }
  if (mine && lane < kWays) {
    tags[set * kWays + lane] = t;
    counters[set * kWays + lane] = c;
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
