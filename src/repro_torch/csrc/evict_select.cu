// Victim selection for the simulator's eviction step, one launch per step.
//
// Replaces the TPU kernel repro/kernels/evict_select/kernel.py::evict_select
// (_select_kernel): mark the n_evict candidates whose (k0, k1, k2, k3, index)
// tuples are lexicographically smallest.  The keys are constant for the
// whole step, so the victims of the simulator's chained masked argmin are
// exactly the first n_evict candidates in that order, ties to the lowest
// index.
//
// What bounds it on an H100: latency.  The simulator launches it once per
// scan event (thousands per run) on arrays of a few hundred int32 keys, so
// the bytes (about 17 per block) are nothing next to the launch and the
// block-wide reductions.  Design: one thread block of 256 threads per call,
// threads striding over NB (any size); each victim is one block-wide
// lexicographic argmin (per-thread scan, warp shuffles, one shared-memory
// pass).  n_evict is read from device memory, so the host never waits for
// the occupancy count; the loop stops early when candidates run out.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Key {
  int k[4];
  int idx;
};

__device__ __forceinline__ Key sentinel() {
  Key s;
#pragma unroll
  for (int i = 0; i < 4; ++i) s.k[i] = INT_MAX;
  s.idx = INT_MAX;
  return s;
}

__device__ __forceinline__ bool less(const Key& a, const Key& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (a.k[i] != b.k[i]) return a.k[i] < b.k[i];
  }
  return a.idx < b.idx;
}

__device__ __forceinline__ Key warp_min(Key v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Key o;
#pragma unroll
    for (int i = 0; i < 4; ++i) o.k[i] = __shfl_down_sync(0xffffffffu, v.k[i], off);
    o.idx = __shfl_down_sync(0xffffffffu, v.idx, off);
    if (less(o, v)) v = o;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
evict_select_kernel(const uint8_t* __restrict__ cand, const int32_t* __restrict__ k0,
                    const int32_t* __restrict__ k1, const int32_t* __restrict__ k2,
                    const int32_t* __restrict__ k3, const int32_t* __restrict__ n_evict,
                    uint8_t* __restrict__ vict, int nb) {
  __shared__ Key warp_best[kWarps];
  __shared__ Key best;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < nb; i += kThreads) vict[i] = 0;
  const int n = max(*n_evict, 0);
  __syncthreads();
  for (int it = 0; it < n; ++it) {
    Key mine = sentinel();
    for (int i = tid; i < nb; i += kThreads) {
      if (cand[i] && !vict[i]) {
        Key c;
        c.k[0] = k0 ? k0[i] : 0;
        c.k[1] = k1 ? k1[i] : 0;
        c.k[2] = k2 ? k2[i] : 0;
        c.k[3] = k3 ? k3[i] : 0;
        c.idx = i;
        if (less(c, mine)) mine = c;
      }
    }
    mine = warp_min(mine);
    if (lane == 0) warp_best[warp] = mine;
    __syncthreads();
    if (warp == 0) {
      mine = lane < kWarps ? warp_best[lane] : sentinel();
      mine = warp_min(mine);
      if (lane == 0) {
        best = mine;
        if (mine.idx != INT_MAX) vict[mine.idx] = 1;
      }
    }
    __syncthreads();
    if (best.idx == INT_MAX) break;  // no candidate left (uniform across the block)
  }
}

}  // namespace

extern "C" int repro_evict_select(const void* cand, const void* k0, const void* k1, const void* k2,
                                  const void* k3, const void* n_evict, void* vict, int nb,
                                  void* stream) {
  evict_select_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cand), static_cast<const int32_t*>(k0),
      static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),
      static_cast<const int32_t*>(k3), static_cast<const int32_t*>(n_evict),
      static_cast<uint8_t*>(vict), nb);
  return static_cast<int>(cudaGetLastError());
}
