// The warp steps of the matmul tier at record tiles of 257..1024 states
// (W = ceil(s_tile/32) = 12..32 state words). Wide is the step of the
// kernels still on it: scan_nfa_wide.cu's anchor end, lazy and greedy spans
// (one warp per record), scan_long_wide.cu's carry (one warp per window of
// one long string) and scan_stream.cu (one warp per record fed a mask
// stream, each lane its word of the step's mask row): lane l holds state
// word l, lanes >= W hold zero and join every vote; the live states are
// walked warp-uniformly (a ballot of the live words, a __shfl_sync of each,
// one shared-row load and OR per live state), then the mask AND; the accept
// test is one __any_sync. Shared memory holds one direction's rows (follow
// or pred), the mask rows and the accept rows of the table of
// scan_pallas.nfa_tables. Band (below) is the step of scan_long_wide.cu's
// flags, count and reverse and of scan_nfa_wide.cu's stats, flags, reverse,
// reverse_mb and lazy_spans_mb: the diagonals of the follow matrix as lane
// shifts, only the other edges walked. The launchers run persistent blocks
// of kWideWarps warps (no more blocks than are resident at once).
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

// One record tile as a warp steps it on the Wide walk (anchor end, lazy and
// greedy spans, the long carry and scan_stream.cu's kernels): the rows in
// shared memory, and this lane's word of the seed row (follow[0]) and of
// the union of the accept rows (zero for lanes >= W).
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

  __device__ __forceinline__ bool accepts(uint32_t v) const {
    return __any_sync(kFull, (v & acc_l) != 0u);
  }

  // v & acc[c] != 0 for the state v (W words in shared memory) and accept
  // channel c.
  __device__ __forceinline__ bool channel_hit(const uint32_t* v, int c) const;
};

// v & row != 0 for a state v of W words in shared memory and a row of W
// words (an accept channel's row: Wide::channel_hit and the band-step
// kernels' channel tests; a span channel's sg row).
__device__ __forceinline__ bool meets_row(const uint32_t* v, const uint32_t* row, int W) {
  uint32_t x = 0u;
  for (int k = 0; k < W; ++k) x |= v[k] & row[k];
  return x != 0u;
}

__device__ __forceinline__ bool Wide::channel_hit(const uint32_t* v, int c) const {
  return meets_row(v, acc + c * W, W);
}

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

// The band step (scan_long_wide.cu's flags, count and reverse, and
// scan_nfa_wide.cu's stats, flags, reverse, reverse_mb and lazy_spans_mb
// over records). The tile's
// follow matrix is split (scan_pallas.band_split) into at most kMaxDiags kept
// diagonals, edges s -> s + d for the s of a source mask D_d, and a residual.
// A diagonal is a shift of the whole state set: a warp moves its words d / 32
// lanes with two shuffles and d % 32 bits with a funnel shift, whatever the
// number of live states. The seed row follow[0] is applied whole (forward:
// when the seed fires or state 0 is live; reverse: state 0 precedes the live
// states of follow[0], one vote). Only the rest of the residual is walked, as
// Wide walks every live state, and not at all when it is empty: keyword lists
// and runs put every edge but the seed row's on d = +1.
constexpr int kMaxDiags = 8;  // scan_pallas.BANDED_MAX_DIAGS

// The kept diagonals as one kernel moves them, passed by value (warp-uniform,
// read from the parameter bank): slots k < n_up shift the state words up
// (toward higher states), slots k >= kMaxDiags - n_dn down, by q[k] lanes and
// r[k] bits, then keep the states of row[k] of the band table: the
// diagonal's destinations (forward) or sources (reverse). Two loops of fixed
// trip count, each ending at its first empty slot, keep the masks in
// registers and branch on no direction; the diagonals of one word (q = 0,
// every offset of a keyword list or a short repetition) share one shuffle.
struct Diags {
  int n_up;
  int n_dn;
  int q[kMaxDiags];
  int r[kMaxDiags];
  int row[kMaxDiags];
};

// One window or record as G lanes of a warp step it (G = 32, or 16: two a
// warp, one a half): lane j of the group holds state word j (zero for j >=
// W, which join every shuffle and vote). The residual rows without row 0
// (follow, or pred for the reverse), the mask rows and the accept rows are in
// shared memory; this lane's word of each diagonal's mask, of the full seed
// row follow[0], of the union of the accept rows and of the states with a
// residual row to walk in registers.
template <int G>
struct Band {
  const uint32_t* rows;  // [S][W]: residual follow, or residual pred
  const uint32_t* mask;  // [kSyms][W]
  int W;
  int j;     // this lane's word in its group
  int half;  // its group: 0, or 1 for lanes 16..31 at G = 16
  int col;   // j, or 0 for j >= W (whose results are dropped)
  bool on;   // j < W
  uint32_t on_m;  // on ? ~0 : 0
  bool walk;    // some residual edge leaves a state s >= 1
  bool enter0;  // some edge enters state 0 (else it is live only in v0)
  uint32_t seed_l;
  uint32_t acc_l;
  uint32_t res_l;
  uint32_t dm[kMaxDiags];

  // The group's state set moved up by 32 q + r states: word j takes words j
  // - q and j - q - 1, zero below the group (a shuffle returns the lane's own
  // word there; q + 1 = 32 wraps to a shuffle by 0).
  __device__ __forceinline__ uint32_t up(uint32_t x, int q, int r) const {
    uint32_t a = __shfl_up_sync(kFull, x, q, G);
    uint32_t b = __shfl_up_sync(kFull, x, q + 1, G);
    a = j >= q ? a : 0u;
    b = j > q ? b : 0u;
    return __funnelshift_l(b, a, r);  // r = 0: a
  }

  // Moved down by 32 q + r states: word j takes words j + q and j + q + 1.
  __device__ __forceinline__ uint32_t down(uint32_t x, int q, int r) const {
    uint32_t a = __shfl_down_sync(kFull, x, q, G);
    uint32_t b = __shfl_down_sync(kFull, x, q + 1, G);
    a = j + q < G ? a : 0u;
    b = j + q + 1 < G ? b : 0u;
    return __funnelshift_r(a, b, r);  // r = 0: a
  }

  // OR over the kept diagonals of x's shift, masked by the slot's row
  __device__ __forceinline__ uint32_t diagonals(const Diags& dg, uint32_t x) const {
    uint32_t y = 0u;
    if (dg.n_up > 0) {
      uint32_t b1 = __shfl_up_sync(kFull, x, 1, G);  // word j - 1
      b1 = j >= 1 ? b1 : 0u;
#pragma unroll
      for (int k = 0; k < kMaxDiags; ++k) {
        if (k >= dg.n_up) break;
        if (dg.q[k] == 0) {
          y |= __funnelshift_l(b1, x, dg.r[k]) & dm[k];
        } else {
          y |= up(x, dg.q[k], dg.r[k]) & dm[k];
        }
      }
    }
    if (dg.n_dn > 0) {
      uint32_t b1 = __shfl_down_sync(kFull, x, 1, G);  // word j + 1
      b1 = j + 1 < G ? b1 : 0u;
#pragma unroll
      for (int k = kMaxDiags - 1; k >= 0; --k) {
        if (k < kMaxDiags - dg.n_dn) break;
        if (dg.q[k] == 0) {
          y |= __funnelshift_r(x, b1, dg.r[k]) & dm[k];
        } else {
          y |= down(x, dg.q[k], dg.r[k]) & dm[k];
        }
      }
    }
    return y;
  }

  // This lane's word of the OR of the residual rows of the states of x (this
  // lane's word of its group's set), walked warp-uniformly over the live
  // words of both groups: a lane takes a row only for its own group.
  __device__ __forceinline__ uint32_t walk_rows(uint32_t x) const {
    uint32_t y = 0u;
    unsigned live = __ballot_sync(kFull, x != 0u);
    while (live != 0u) {
      const int w = __ffs(live) - 1;
      live &= live - 1u;
      uint32_t b = __shfl_sync(kFull, x, w);
      const uint32_t* r = rows + 32 * (w % G) * W + col;
      const uint32_t keep = w / G == half ? ~0u : 0u;
      while (b != 0u) {
        y |= r[(__ffs(b) - 1) * W] & keep;
        b &= b - 1u;
      }
    }
    return y;
  }

  // state 0 is in the group's set (bit 0 of its first word)
  __device__ __forceinline__ bool has0(uint32_t v) const {
    return (__shfl_sync(kFull, v, 0, G) & 1u) != 0u;
  }

  // v = (sw | OR of follow[s] over s in v, s >= 1) & mask[sym], sw this
  // lane's word of the step's seed (zero past W): v shifted by each offset
  // onto the diagonal's destinations, the residual (rows s >= 1) walked. The
  // caller puts follow[0] into sw where state 0 is in v (enter0 and has0).
  __device__ __forceinline__ uint32_t fwd_word(const Diags& dg, uint32_t v, uint32_t sw,
                                               int sym) const {
    const uint32_t m = mask[sym * W + col] & on_m;
    uint32_t y = sw | diagonals(dg, v);
    if (walk) y |= walk_rows(v & res_l);
    return y & m;
  }

  // v = (OR of follow[s] over s in v | seed ? follow[0] : 0) & mask[sym],
  // seed set where the seed fires or state 0 is in v
  __device__ __forceinline__ uint32_t fwd(const Diags& dg, uint32_t v, bool seed, int sym) const {
    return fwd_word(dg, v, seed ? seed_l : 0u, sym);
  }

  // The step where no lane of the warp holds a live state: the seed word
  // alone (zero past W), masked
  __device__ __forceinline__ uint32_t seed_only(uint32_t sw, int sym) const {
    return sw & mask[sym * W + col] & on_m;
  }

  // The reverse step's input x = (R | acc) & mask[sym] (r and acc_l are 0
  // past W)
  __device__ __forceinline__ uint32_t rev_in(uint32_t r, int sym) const {
    return (r | acc_l) & mask[sym * W + col];
  }

  // R = OR of pred[u] over u in x: x shifted back by each offset onto the
  // diagonal's sources, the residual pred rows walked, and state 0 (s0, the
  // group's start bit) iff x meets follow[0]
  __device__ __forceinline__ uint32_t rev_step(const Diags& dg, uint32_t x, bool& s0) const {
    s0 = meets(x, seed_l);
    uint32_t y = diagonals(dg, x);
    if (walk) y |= walk_rows(x & res_l);
    return (y | (j == 0 && s0 ? 1u : 0u)) & on_m;
  }

  // R = OR of pred[u] over u in (R | acc) & mask[sym], s0 as rev_step's
  __device__ __forceinline__ uint32_t rev(const Diags& dg, uint32_t r, int sym, bool& s0) const {
    return rev_step(dg, rev_in(r, sym), s0);
  }

  // x meets the row a (this lane's word of each), in this lane's group
  __device__ __forceinline__ bool meets(uint32_t x, uint32_t a) const {
    const unsigned b = __ballot_sync(kFull, (x & a) != 0u);
    return (G == 32 ? b : (b >> (16 * half)) & 0xFFFFu) != 0u;
  }

  // v meets the accept rows, in this lane's group
  __device__ __forceinline__ bool accepts(uint32_t v) const { return meets(v, acc_l); }
};

// Copies the residual rows of one direction (pred when `pred`) of the band
// table band_g (scan_pallas.band_table) and the mask rows and P accept rows
// of the tile's table tab_g into shared memory, at load_wide's layout and
// size (the span-channel rows and warp buffers of the multi-channel kernels
// go after the accept rows). Every thread of the block calls it (it ends in a
// vote) before any thread returns.
template <int G>
__device__ __forceinline__ Band<G> load_band(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                             const uint32_t* __restrict__ band_g,
                                             const Diags& dg, int S, int W, bool pred,
                                             int P = 1) {
  const int n_rows = S * W;
  const int n_tail = (kSyms + P) * W;
  const uint32_t* res = band_g + (2 * kMaxDiags + 3) * W + (pred ? n_rows : 0);
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x) smem[i] = __ldg(res + i);
  const uint32_t* tail = tab_g + 2 * n_rows;
  for (int i = threadIdx.x; i < n_tail; i += blockDim.x) smem[n_rows + i] = __ldg(tail + i);
  __syncthreads();
  Band<G> k;
  k.rows = smem;
  k.mask = smem + n_rows;
  k.W = W;
  const int lane = threadIdx.x & 31;
  k.j = lane % G;
  k.half = lane / G;
  k.on = k.j < W;
  k.on_m = k.on ? ~0u : 0u;
  k.col = k.on ? k.j : 0;
  uint32_t a = 0u;
  for (int p = 0; p < P; ++p) a |= k.mask[(kSyms + p) * W + k.col];
  k.acc_l = k.on ? a : 0u;
  k.seed_l = k.on ? __ldg(tab_g + k.col) : 0u;
  k.res_l = k.on ? __ldg(band_g + (2 * kMaxDiags + (pred ? 1 : 0)) * W + k.col) : 0u;
  k.walk = __any_sync(kFull, k.res_l != 0u);
  k.enter0 = (__ldg(band_g + (2 * kMaxDiags + 2) * W) & 1u) != 0u;
  const uint32_t* dmask = band_g + (pred ? 0 : kMaxDiags * W);  // sources, or destinations
#pragma unroll
  for (int i = 0; i < kMaxDiags; ++i) {
    const bool kept = i < dg.n_up || i >= kMaxDiags - dg.n_dn;
    k.dm[i] = k.on && kept ? __ldg(dmask + dg.row[i] * W + k.col) : 0u;
  }
  return k;
}

// The diagonals of a band table for a kernel's direction: offsets[k] = d
// (the forward edges s -> s + d of band row k), |d| < s_tile. The forward
// step moves sources up by d, the reverse step destinations down by d; ups
// fill the slots from 0, downs from kMaxDiags - 1.
inline int band_diags(int nd, const int* offsets, bool reverse, int s_tile, Diags* dg) {
  if (nd < 0 || nd > kMaxDiags || (nd > 0 && offsets == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *dg = Diags{};
  for (int i = 0; i < nd; ++i) {
    const int d = offsets[i];
    if (d <= -s_tile || d >= s_tile) return static_cast<int>(cudaErrorInvalidValue);
    const int e = reverse ? -d : d;
    const int k = e >= 0 ? dg->n_up++ : kMaxDiags - 1 - dg->n_dn++;
    const int a = e < 0 ? -e : e;
    dg->q[k] = a >> 5;
    dg->r[k] = a & 31;
    dg->row[k] = i;
  }
  return 0;
}

inline int words_of(int s_tile) { return (s_tile + 31) / 32; }

// A band kernel's launcher check: a band table, and 16 lanes a window or
// record (two a warp) only for W <= 16.
inline int check_band(const void* band, int lanes, int s_tile) {
  if (band == nullptr || !(lanes == 32 || (lanes == 16 && words_of(s_tile) <= 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

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
