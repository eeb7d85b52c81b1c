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
// the bytes (about 17 per block) are nothing next to the launch.  The TPU
// kernel's n_evict serial argmins (a block-wide reduction and two barriers
// each) would make the time grow with n_evict, so this kernel ranks every
// candidate in one pass instead, with no serial chain:
//
// * Rank by counting.  (k0, k1, k2, k3, index) is a total order, so a
//   candidate is a victim exactly when fewer than n_evict candidates come
//   before it.  Each thread block stages every memory block's key tuple
//   (packed into two 64-bit words, each key biased to unsigned so that
//   unsigned order is int32 order) and candidate flag into shared memory
//   once, then ranks kPerBlock candidates, one warp each: the warp's lanes
//   split the count over the staged tuples and add their parts with warp
//   shuffles.  One store per memory block, vict[i] = cand[i] && rank <
//   n_evict, also clears the non-victims, so there is no zeroing pass.
// * NB / kPerBlock thread blocks share the NB^2 comparisons: at NB 256, 32
//   blocks of 256 threads with 8 comparisons per lane.  (On an H100, eight
//   lanes per candidate with 32 comparisons each took 0.0037 ms of device
//   time, this layout 0.0023: chip_smoke.py, phase 3.)  Any NB: above kTile
//   tuples the staging walks the keys in tiles.
// * n_evict is read on the device, so the host never waits for the
//   occupancy count; ranks stop at the number of candidates, so an
//   over-large n_evict cannot overdraw.  When it is 0, as on most scan
//   steps of a run, every block only clears its mask and returns: ranking
//   regardless took 2.4 us a call on the frozen run's steps, where the
//   parent's zeroing pass took 1.3 (chip_smoke.py's main-path profile).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerBlock = kThreads / 32;        // candidates ranked per block, a warp each
constexpr int kTile = 2048;                     // tuples staged at a time (34 KB)

struct __align__(16) Tuple {
  unsigned long long hi;  // (k0, k1)
  unsigned long long lo;  // (k2, k3)
};

__device__ __forceinline__ unsigned long long biased(const int32_t* k, int i) {
  return static_cast<unsigned long long>((k ? static_cast<uint32_t>(k[i]) : 0u) ^ 0x80000000u);
}

__device__ __forceinline__ Tuple load_tuple(const int32_t* k0, const int32_t* k1, const int32_t* k2,
                                            const int32_t* k3, int i) {
  Tuple t;
  t.hi = (biased(k0, i) << 32) | biased(k1, i);
  t.lo = (biased(k2, i) << 32) | biased(k3, i);
  return t;
}

// whether (a, ia) comes before (b, ib) in (k0, k1, k2, k3, index) order
__device__ __forceinline__ bool before(const Tuple& a, int ia, const Tuple& b, int ib) {
  return a.hi < b.hi || (a.hi == b.hi && (a.lo < b.lo || (a.lo == b.lo && ia < ib)));
}

__global__ void __launch_bounds__(kThreads)
evict_select_kernel(const uint8_t* __restrict__ cand, const int32_t* __restrict__ k0,
                    const int32_t* __restrict__ k1, const int32_t* __restrict__ k2,
                    const int32_t* __restrict__ k3, const int32_t* __restrict__ n_evict,
                    uint8_t* __restrict__ vict, int nb) {
  __shared__ Tuple tup[kTile];
  __shared__ uint8_t live[kTile];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int i = blockIdx.x * kPerBlock + (tid >> 5);
  const int n = *n_evict;
  if (n <= 0) {  // no victim: most scan steps of a run (the whole block returns together)
    if (lane == 0 && i < nb) vict[i] = 0;
    return;
  }
  const bool is_cand = i < nb && cand[i] != 0;
  Tuple mine{0ull, 0ull};
  if (i < nb) mine = load_tuple(k0, k1, k2, k3, i);
  int rank = 0;
  for (int t0 = 0; t0 < nb; t0 += kTile) {
    const int tn = min(kTile, nb - t0);
    if (t0 > 0) __syncthreads();  // the previous tile is counted
    for (int j = tid; j < tn; j += kThreads) {
      tup[j] = load_tuple(k0, k1, k2, k3, t0 + j);
      live[j] = cand[t0 + j];
    }
    __syncthreads();
    if (is_cand) {
#pragma unroll 4
      for (int j = lane; j < tn; j += 32) rank += (live[j] != 0) & before(tup[j], t0 + j, mine, i);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, o);
  if (lane == 0 && i < nb) vict[i] = is_cand && rank < n;
}

}  // namespace

extern "C" int repro_evict_select(const void* cand, const void* k0, const void* k1, const void* k2,
                                  const void* k3, const void* n_evict, void* vict, int nb,
                                  void* stream) {
  if (nb < 0) return -1;
  const int blocks = nb > 0 ? (nb + kPerBlock - 1) / kPerBlock : 1;
  evict_select_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cand), static_cast<const int32_t*>(k0),
      static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),
      static_cast<const int32_t*>(k3), static_cast<const int32_t*>(n_evict),
      static_cast<uint8_t*>(vict), nb);
  return static_cast<int>(cudaGetLastError());
}
