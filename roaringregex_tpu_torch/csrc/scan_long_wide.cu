// One long string on Hopper (sm_90a) at record tiles of 257..1024 states
// (W = ceil(s_tile/32) = 12..32 state words): the matmul tier's step over
// windows of a single string, one warp per window. scan_long.cu runs the
// same functions for tiles of up to 256 states, one thread per window.
//
// Replaces, at those tiles, five Pallas TPU kernels of the JAX package (all
// in roaringregex_tpu/ops/scan_pallas.py, called by ops/longstring.py's
// FastLongScanner; rows 26-30 of PERF.md's table):
//   rrx_long_wide_carry    <- _carry_kernel_lb (via _carry_call_b)
//   rrx_long_wide_flags    <- _flags_v0_kernel_lb (via _flags_v0_call_b)
//   rrx_long_wide_count    <- _count_v0_kernel_lb (via _count_v0_call_b) and,
//                             with a final-state output,
//                             _count_v0_final_kernel_lb (via _count_v0f_call_b)
//   rrx_long_wide_reverse  <- _reverse_kernel_lb (via _rev_call_b)
//
// What they compute: exactly what scan_long.cu's kernels compute, over the
// same window geometry (scan_long.cuh: global step 0 = BOS, i + 1 = byte i,
// n + 1 = EOS, dead outside; `^` and `$` only where the global stream has
// them; owned steps [lead, lead + block), block a multiple of 32, their
// flag and hit bits at bit g of one flat bit array) and the same arguments.
//
// Design: one warp per window on the warp step of scan_nfa_wide.cuh (lane l
// holds state word l; one direction's rows, the mask rows and the accept
// row in shared memory). Windows have one length, so persistent blocks (no
// more than are resident at once, each copying its rows once) stride over
// them: window w, w + 32 * gridDim.x, ... per warp. Lane l loads and stores
// word l of v0 / vout; the counts are warp-uniform registers; lane 0 writes
// each owned 32-step flag or hit word when it closes (owned global steps
// start at a multiple of block: no word straddles two windows). Every lane
// reads the same 16-byte chunk of the string (one broadcast load), the
// partial last chunk byte by byte.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan_core.cuh"
#include "scan_long.cuh"
#include "scan_nfa_wide.cuh"

namespace {

using namespace rrx;

#define LONG_WIDE_HEAD                                                                       \
  const uint8_t *__restrict__ data, long long n, int nw, int block, int lead, int T, int rep, \
      const uint32_t *__restrict__ tab_g, int S, int W

// The windows of one warp: its own index, then a stride of the grid's warps.
#define LONG_WIDE_WINDOWS                                                        \
  const int lane = threadIdx.x & 31;                                             \
  for (int w = static_cast<int>(blockIdx.x) * kWideWarps + (threadIdx.x >> 5); w < nw; \
       w += static_cast<int>(gridDim.x) * kWideWarps)

// The forward walk of window w from v0[w] (or the empty set; bits past the
// tile's S states are not states and are dropped), seeded where gate[w]
// (every window when null) and, unseeded, only at g < 2: f(t, v) after each
// step, v this lane's word. Returns the final word.
template <class F>
__device__ __forceinline__ uint32_t walk_window(const Wide& k, Window& win, int S,
                                                const uint32_t* __restrict__ v0,
                                                const uint8_t* __restrict__ gate, int seeded,
                                                int w, F&& f) {
  uint32_t v = 0u;
  if (v0 != nullptr && k.on) {
    const int live = S - 32 * k.col;  // states of this lane's word
    const uint32_t m = live >= 32 ? ~0u : (live <= 0 ? 0u : (1u << live) - 1u);
    v = v0[static_cast<size_t>(w) * k.W + k.col] & m;
  }
  const bool gw = gate == nullptr || gate[w] != 0;
#pragma unroll 1
  for (int t = 0; t < win.T; ++t) {
    v = k.fwd(v, gw && (seeded || t < win.t_seed_end), win.sym(t));
    f(t, v);
  }
  return v;
}

__global__ void __launch_bounds__(kWideThreads)
long_wide_carry_kernel(LONG_WIDE_HEAD, const uint32_t* __restrict__ v0,
                       const uint8_t* __restrict__ gate, int seeded,
                       uint32_t* __restrict__ vout) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, false);
  LONG_WIDE_WINDOWS {
    Window win = window(data, n, block, lead, T, rep, w);
    const uint32_t v = walk_window(k, win, S, v0, gate, seeded, w, [](int, uint32_t) {});
    if (k.on) vout[static_cast<size_t>(w) * W + lane] = v;
  }
}

__global__ void __launch_bounds__(kWideThreads)
long_wide_flags_kernel(LONG_WIDE_HEAD, const uint32_t* __restrict__ v0,
                       const uint8_t* __restrict__ gate, int seeded,
                       uint32_t* __restrict__ flags) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, false);
  const int hi = min(T, lead + block);
  LONG_WIDE_WINDOWS {
    Window win = window(data, n, block, lead, T, rep, w);
    uint32_t* out = flags + static_cast<size_t>(w / rep) * (block >> 5);  // bit g of the array
    uint32_t word = 0u;
    walk_window(k, win, S, v0, gate, seeded, w, [&](int t, uint32_t v) {
      if (t < lead || t >= hi) return;
      const int j = t - lead;
      word |= (k.accepts(v) ? 1u : 0u) << (j & 31);
      if ((j & 31) == 31 || t == hi - 1) {
        if (lane == 0) out[j >> 5] = word;
        word = 0u;
      }
    });
  }
}

__global__ void __launch_bounds__(kWideThreads)
long_wide_count_kernel(LONG_WIDE_HEAD, const uint32_t* __restrict__ v0,
                       const uint8_t* __restrict__ gate, int seeded,
                       int32_t* __restrict__ cnt_o, uint8_t* __restrict__ tail_o,
                       uint32_t* __restrict__ vout) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, false);
  const int hi = min(T, lead + block);
  LONG_WIDE_WINDOWS {
    Window win = window(data, n, block, lead, T, rep, w);
    const int t_eos = win.t_eos;
    int cnt = 0;
    bool tail = false;
    const uint32_t v = walk_window(k, win, S, v0, gate, seeded, w, [&](int t, uint32_t vv) {
      if (t < lead || t >= hi || !k.accepts(vv)) return;
      cnt += t < t_eos - 1 ? 1 : 0;
      tail = tail || t == t_eos - 1 || t == t_eos;
    });
    if (lane == 0) {
      cnt_o[w] = cnt;
      tail_o[w] = tail ? 1 : 0;
    }
    if (vout != nullptr && k.on) vout[static_cast<size_t>(w) * W + lane] = v;
  }
}

__global__ void __launch_bounds__(kWideThreads)
long_wide_reverse_kernel(LONG_WIDE_HEAD, uint32_t* __restrict__ hits) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, true);
  const int hi = min(T, lead + block);
  LONG_WIDE_WINDOWS {
    Window win = window(data, n, block, lead, T, rep, w);
    uint32_t* out = hits + static_cast<size_t>(w / rep) * (block >> 5);
    uint32_t rs = 0u, word = 0u;
#pragma unroll 1
    for (int t = T - 1; t >= 0; --t) {
      rs = k.rev(rs, win.sym(t));
      if (t < lead || t >= hi) continue;
      const int j = t - lead;
      word |= (__shfl_sync(kFull, rs, 0) & 1u) << (j & 31);
      if ((j & 31) == 0) {  // walking down, bit j closes word j / 32
        if (lane == 0) out[j >> 5] = word;
        word = 0u;
      }
    }
  }
}

// The launchers' checks: the window geometry (check_long) and a tile of
// 257..1024 states.
int check_long_wide(const void* data, long long n, int nw, int block, int lead, int T, int rep,
                    int s_tile) {
  if (s_tile < kMinTile || s_tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  return check_long(data, n, nw, block, lead, T, rep);
}

inline size_t long_wide_smem(int s_tile) {
  return wide_smem_bytes(s_tile, words_of(s_tile), 1, false);
}

}  // namespace

#define RRX_LONG_HEAD                                                                       \
  const void *data, long long n, int nw, int block, int lead, int T, int rep, const void *tab, \
      int s_tile
#define RRX_LONG_WIDE_ARGS                                                          \
  static_cast<const uint8_t*>(data), n, nw, block, lead, T, rep,                   \
      static_cast<const uint32_t*>(tab), s_tile, words_of(s_tile)

extern "C" {

// Every entry point takes scan_long.cu's arguments (the table of
// scan_pallas.nfa_tables for a tile of 257..1024 states).
//
// v0: [nw][W] uint32 or null (empty set); gate: [nw] uint8 or null (all
// windows gated); vout: [nw][W] uint32
int rrx_long_wide_carry(RRX_LONG_HEAD, const void* v0, const void* gate, int seeded, void* vout,
                        void* stream) {
  const int bad = check_long_wide(data, n, nw, block, lead, T, rep, s_tile);
  if (bad != 0) return bad;
  return launch_wide(long_wide_carry_kernel, nw, long_wide_smem(s_tile), stream,
                     RRX_LONG_WIDE_ARGS, static_cast<const uint32_t*>(v0),
                     static_cast<const uint8_t*>(gate), seeded, static_cast<uint32_t*>(vout));
}

// flags: flat bit array over the windows' owned steps, bit g of word g / 32
// (nw / rep * block / 32 words)
int rrx_long_wide_flags(RRX_LONG_HEAD, const void* v0, const void* gate, int seeded, void* flags,
                        void* stream) {
  const int bad = check_long_wide(data, n, nw, block, lead, T, rep, s_tile);
  if (bad != 0) return bad;
  if (T != lead + block) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wide(long_wide_flags_kernel, nw, long_wide_smem(s_tile), stream,
                     RRX_LONG_WIDE_ARGS, static_cast<const uint32_t*>(v0),
                     static_cast<const uint8_t*>(gate), seeded, static_cast<uint32_t*>(flags));
}

// cnt: [nw] int32; tail: [nw] uint8; vout: [nw][W] uint32 or null
int rrx_long_wide_count(RRX_LONG_HEAD, const void* v0, const void* gate, int seeded, void* cnt,
                        void* tail, void* vout, void* stream) {
  const int bad = check_long_wide(data, n, nw, block, lead, T, rep, s_tile);
  if (bad != 0) return bad;
  return launch_wide(long_wide_count_kernel, nw, long_wide_smem(s_tile), stream,
                     RRX_LONG_WIDE_ARGS, static_cast<const uint32_t*>(v0),
                     static_cast<const uint8_t*>(gate), seeded, static_cast<int32_t*>(cnt),
                     static_cast<uint8_t*>(tail), static_cast<uint32_t*>(vout));
}

// hits: flat bit array as rrx_long_wide_flags's
int rrx_long_wide_reverse(RRX_LONG_HEAD, void* hits, void* stream) {
  const int bad = check_long_wide(data, n, nw, block, lead, T, rep, s_tile);
  if (bad != 0) return bad;
  if (T < lead + block) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wide(long_wide_reverse_kernel, nw, long_wide_smem(s_tile), stream,
                     RRX_LONG_WIDE_ARGS, static_cast<uint32_t*>(hits));
}

// Resident blocks per SM (theoretical occupancy) of a wide window kernel for
// a tile of s_tile states, by index: 0 carry, 1 flags, 2 count, 3 reverse
// (rrx_occupancy's order for the long kernels).
int rrx_long_wide_occupancy(int kernel, int s_tile, int* blocks_per_sm) {
  if (s_tile < kMinTile || s_tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = long_wide_smem(s_tile);
  switch (kernel) {
    case 0:
      return occupancy_wide(long_wide_carry_kernel, smem, blocks_per_sm);
    case 1:
      return occupancy_wide(long_wide_flags_kernel, smem, blocks_per_sm);
    case 2:
      return occupancy_wide(long_wide_count_kernel, smem, blocks_per_sm);
    case 3:
      return occupancy_wide(long_wide_reverse_kernel, smem, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
