// The warp step of the matmul tier at record tiles of 257..1024 states
// (W = ceil(s_tile/32) = 12..32 state words), shared by scan_nfa_wide.cu
// (one warp per record), scan_long_wide.cu (one warp per window of one
// long string) and scan_stream.cu (one warp per record fed a mask stream,
// each lane its word of the step's mask row): lane l holds state word l, lanes >= W hold zero and join
// every vote; the live states are walked warp-uniformly (a ballot of the
// live words, a __shfl_sync of each, one shared-row load and OR per live
// state), then the mask AND; the accept test is one __any_sync. Shared
// memory holds one direction's rows (follow or pred), the mask rows and the
// accept rows of the table of scan_pallas.nfa_tables. The launchers run
// persistent blocks of kWideWarps warps (no more blocks than are resident
// at once).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_core.cuh"

namespace rrx {

constexpr int kWideWarps = 32;  // records in flight per block
constexpr int kWideThreads = 32 * kWideWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMinTile = 257;
constexpr int kMaxTile = 1024;  // 32 state words: one per lane
constexpr size_t kSmemLimit = 232448;

// Shared memory of a kernel: one direction's rows [S][W], the mask rows
// [kSyms][W], P accept rows [P][W], and (stats with P > 1) one state buffer
// of W words per warp.
inline size_t wide_smem_bytes(int S, int W, int P, bool bufs) {
  const size_t rows = static_cast<size_t>(S + kSyms + P) * W;
  return sizeof(uint32_t) * (rows + (bufs ? static_cast<size_t>(kWideWarps) * W : 0));
}

// One record tile as a warp steps it: the rows in shared memory, and this
// lane's word of the seed row (follow[0]) and of the union of the accept
// rows (zero for lanes >= W).
struct Wide {
  const uint32_t* rows;  // [S][W]: follow, or pred for the reverse kernel
  const uint32_t* mask;  // [kSyms][W]
  const uint32_t* acc;   // [P][W]
  int W;
  int col;  // this lane's word, or 0 for a lane >= W (whose results are dropped)
  bool on;  // lane < W
  uint32_t seed_l;
  uint32_t acc_l;

  // This lane's word of the OR of rows[s] over the states s of the warp's
  // set x (lane l holds word l).
  __device__ __forceinline__ uint32_t expand(uint32_t x) const {
    uint32_t y = 0u;
    unsigned live = __ballot_sync(kFull, x != 0u);
    while (live != 0u) {
      const int w = __ffs(live) - 1;
      live &= live - 1u;
      uint32_t b = __shfl_sync(kFull, x, w);
      const uint32_t* r = rows + 32 * w * W + col;
      while (b != 0u) {
        y |= r[(__ffs(b) - 1) * W];
        b &= b - 1u;
      }
    }
    return on ? y : 0u;
  }

  // v = (OR of follow[s] over s in v | gate ? follow[0] : 0) & m, m this
  // lane's word of the step's mask row
  __device__ __forceinline__ uint32_t fwd_word(uint32_t v, bool gate, uint32_t m) const {
    return (expand(v) | (gate ? seed_l : 0u)) & m;
  }

  // v = (OR of follow[s] over s in v | gate ? follow[0] : 0) & mask[sym]
  __device__ __forceinline__ uint32_t fwd(uint32_t v, bool gate, int sym) const {
    return fwd_word(v, gate, mask[sym * W + col]);
  }

  // R = OR of pred[u] over u in (R | acc) & m, m this lane's mask word
  __device__ __forceinline__ uint32_t rev_word(uint32_t r, uint32_t m) const {
    return expand((r | acc_l) & m);
  }

  // R = OR of pred[u] over u in (R | acc) & mask[sym]
  __device__ __forceinline__ uint32_t rev(uint32_t r, int sym) const {
    return rev_word(r, mask[sym * W + col]);
  }

  __device__ __forceinline__ bool accepts(uint32_t v) const {
    return __any_sync(kFull, (v & acc_l) != 0u);
  }

  // v & acc[c] != 0 for the state v (W words in shared memory) and accept
  // channel c.
  __device__ __forceinline__ bool channel_hit(const uint32_t* v, int c) const {
    const uint32_t* a = acc + c * W;
    uint32_t x = 0u;
    for (int k = 0; k < W; ++k) x |= v[k] & a[k];
    return x != 0u;
  }
};

__device__ __forceinline__ bool empty(uint32_t v) { return !__any_sync(kFull, v != 0u); }

// Copies one direction's rows (pred when `pred`, else follow), the mask rows
// and the P accept rows of the table into shared memory. Every thread of the
// block calls it (it ends in __syncthreads) before any thread returns.
__device__ __forceinline__ Wide load_wide(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                          int S, int W, int P, bool pred) {
  const int n_rows = S * W;
  const int n_tail = (kSyms + P) * W;
  const uint32_t* src = tab_g + (pred ? n_rows : 0);
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x) smem[i] = __ldg(src + i);
  const uint32_t* tail = tab_g + 2 * n_rows;
  for (int i = threadIdx.x; i < n_tail; i += blockDim.x) smem[n_rows + i] = __ldg(tail + i);
  __syncthreads();
  Wide k;
  k.rows = smem;
  k.mask = smem + n_rows;
  k.acc = k.mask + kSyms * W;
  k.W = W;
  const int lane = threadIdx.x & 31;
  k.on = lane < W;
  k.col = k.on ? lane : 0;
  uint32_t a = 0u;
  for (int p = 0; p < P; ++p) a |= k.acc[p * W + k.col];
  k.acc_l = k.on ? a : 0u;
  k.seed_l = k.on ? k.rows[k.col] : 0u;
  return k;
}

inline int words_of(int s_tile) { return (s_tile + 31) / 32; }

// The next unclaimed record index, the same on every lane of the warp.
__device__ __forceinline__ int next_record(int32_t* next, int lane) {
  int r = 0;
  if (lane == 0) r = atomicAdd(next, 1) + static_cast<int>(gridDim.x) * kWideWarps;
  return __shfl_sync(kFull, r, 0);
}

// The records of one warp: each warp starts at its own index, then takes the
// next unclaimed record from the launch's counter.
#define WIDE_RECORDS                                                                      \
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;                            \
  for (int r = static_cast<int>(blockIdx.x) * kWideWarps + warp; r < R;                   \
       r = next_record(next, lane))

// No more blocks than fit on the card at once: each block then walks its
// share of the records (WIDE_RECORDS) and copies its rows once.
template <class K, class... Args>
int launch_wide(K kernel, int R, size_t smem, void* stream, Args... args) {
  if (R == 0) return 0;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  int dev = 0, n_sm = 0, per_sm = 0;
  e = static_cast<int>(cudaGetDevice(&dev));
  if (e == 0) {
    e = static_cast<int>(cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev));
  }
  if (e == 0) {
    e = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads, smem));
  }
  if (e != 0) return e;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = min((R + kWideWarps - 1) / kWideWarps, n_sm * per_sm);
  kernel<<<blocks, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int occupancy_wide(K kernel, size_t smem, int* blocks_per_sm) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kWideThreads, smem));
}

}  // namespace rrx
