// One long string on Hopper (sm_90a) at record tiles of 257..1024 states
// (W = ceil(s_tile/32) = 12..32 state words): the matmul tier's step over
// windows of a single string, one warp per window (or two, below). scan_long.cu
// runs the same functions for tiles of up to 256 states, one thread per
// window.
//
// Replaces, at those tiles, five Pallas TPU kernels of the JAX package (all
// in roaringregex_tpu/ops/scan_pallas.py, called by ops/longstring.py's
// FastLongScanner; rows 26-30 of PERF.md's table):
//   rrx_long_wide_carry    <- _carry_kernel_lb (via _carry_call_b)
//   rrx_long_wide_flags    <- _flags_v0_kernel_lb (via _flags_v0_call_b)
//   rrx_long_wide_count    <- _count_v0_kernel_lb :3550 (via _count_v0_call_b)
//                             and, with a final-state output,
//                             _count_v0_final_kernel_lb :3650 (via
//                             _count_v0f_call_b)
//   rrx_long_wide_reverse  <- _reverse_kernel_lb :3488 (via _rev_call_b)
//
// What they compute: exactly what scan_long.cu's kernels compute, over the
// same window geometry (scan_long.cuh: global step 0 = BOS, i + 1 = byte i,
// n + 1 = EOS, dead outside; `^` and `$` only where the global stream has
// them; owned steps [lead, lead + block), block a multiple of 32, their
// flag and hit bits at bit g of one flat bit array) and the same arguments.
//
// Design: carry (off the default path: only the summary and speculative
// modes carry, and they take narrow tiles) runs one warp per window on the
// Wide step of scan_nfa_wide.cuh (lane l holds state word l; one
// direction's rows, the mask rows and the accept row in shared memory),
// whose cost follows the live states: each is a serial chain of __ffs, an
// address and a dependent shared load through the warp (PERF.md: cycles a
// window-step). Flags, count and reverse, the path of Pattern.long's
// count_ends, search, both bitmaps and finditer_long, run the Band step
// instead: the follow matrix's
// kept diagonals (scan_pallas.band_split: all of a keyword list's edges but
// the seed row's are on d = +1) move the whole state set by lane shuffles
// and a funnel shift, a few instructions a diagonal whatever is live; only
// the residual's live states are walked (one ballot when none is). They
// are bound by issue, not bytes: the string is read once (16-byte chunks
// broadcast to a window's lanes), the tables sit in shared memory and
// registers. At W <= 16 half of a warp would hold zero words, so two
// windows share a warp, one a half (shuffles of width 16, votes masked to
// the half, the residual walk over both halves' live words at once).
//
// Windows have one length, so persistent blocks (no more than are resident
// at once, each copying its rows once) stride over them: window w, w + 32 *
// gridDim.x, ... per warp. Lane l loads and stores word l of v0 / vout; the
// counts are warp-uniform registers; lane 0 (of the half) writes each owned
// 32-step flag or hit word when it closes (owned global steps start at a
// multiple of block: no word straddles two windows). Every lane reads its
// window's 16-byte chunk of the string (one broadcast load), the partial
// last chunk byte by byte.
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

// The windows of one warp on the band step: G = 32 lanes a window, or G =
// 16 and two windows a warp (window 2 p + half). A half past the last window
// steps window nw - 1 with its group and writes nothing (act false).
#define BAND_WINDOWS(G)                                                                \
  for (int p = static_cast<int>(blockIdx.x) * kWideWarps + (threadIdx.x >> 5);        \
       p * (32 / (G)) < nw; p += static_cast<int>(gridDim.x) * kWideWarps)

// The local steps [c0, c1) of a window that read whole 16-byte chunks of the
// string (c0 at a chunk boundary, c1 - c0 a multiple of 16; c0 = c1 <= T
// when none), warp-uniform: at G = 16 the two halves' windows start at the same
// offset in a chunk (block is a multiple of 32), and the range is the
// intersection of theirs.
template <int G>
__device__ __forceinline__ void chunk_steps(const Window& win, int& c0, int& c1) {
  const int b0 = max(0, win.t_bos + 1), b1 = min(win.T, win.t_eos);  // the byte steps
  c0 = min(win.T, b0 + static_cast<int>((-(win.base + b0)) & 15));
  c1 = b1 > c0 ? c0 + ((b1 - c0) & ~15) : c0;
  if (G == 16) {
    c0 = max(c0, __shfl_xor_sync(kFull, c0, 16));
    c1 = max(c0, min(c1, __shfl_xor_sync(kFull, c1, 16)));
  }
}

__device__ __forceinline__ uint4 chunk_at(const Window& win, int t) {
  return __ldg(reinterpret_cast<const uint4*>(win.data) + ((win.base + t) >> 4));
}

// f(t, sym) for the window's steps t = 0 .. T - 1 in order: the steps outside
// [c0, c1) (BOS, EOS, dead steps and the bytes of partial chunks) one at a
// time through Window::sym; inside, 16 steps a chunk, each byte taken off the
// bottom of the chunk's 16 bytes in registers (the next chunk's load issued
// a chunk ahead). The loops stay rolled: the step is long, and copies of it
// would crowd the instruction cache.
template <int G, class F>
__device__ __forceinline__ void steps_up(Window& win, F&& f) {
  int c0, c1;
  chunk_steps<G>(win, c0, c1);
  int t = 0;
#pragma unroll 1
  for (; t < c0; ++t) f(t, win.sym(t));
  uint4 nq = c0 < c1 ? chunk_at(win, c0) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
  for (; t < c1; t += 16) {
    const uint4 q = nq;
    nq = chunk_at(win, min(t + 16, c1 - 16));
    chunk_up(q, t, 16, f);
  }
#pragma unroll 1
  for (; t < win.T; ++t) f(t, win.sym(t));
}

// The same for t = T - 1 .. 0, walking down: each byte taken off the top.
template <int G, class F>
__device__ __forceinline__ void steps_down(Window& win, F&& f) {
  int c0, c1;
  chunk_steps<G>(win, c0, c1);
  int t = win.T - 1;
#pragma unroll 1
  for (; t >= c1; --t) f(t, win.sym(t));
  uint4 nq = c0 < c1 ? chunk_at(win, c1 - 16) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
  for (t = c1 - 16; t >= c0; t -= 16) {
    uint4 q = nq;
    nq = chunk_at(win, max(t - 16, c0));
#pragma unroll 1
    for (int b = 15; b >= 0; --b) {
      const int sym = static_cast<int>(q.w >> 24);
      q.w = __funnelshift_l(q.z, q.w, 8);
      q.z = __funnelshift_l(q.y, q.z, 8);
      q.y = __funnelshift_l(q.x, q.y, 8);
      q.x <<= 8;
      f(t + b, sym);
    }
  }
#pragma unroll 1
  for (t = c0 - 1; t >= 0; --t) f(t, win.sym(t));
}

// walk_window on the band step: window w from v0[w] (bits past S dropped),
// seeded where gate[w] and, unseeded, only at g < 2: f(t, v) after each step.
template <int G, class F>
__device__ __forceinline__ uint32_t walk_band(const Band<G>& k, const Diags& dg, Window& win,
                                              int S, const uint32_t* __restrict__ v0,
                                              const uint8_t* __restrict__ gate, int seeded, int w,
                                              F&& f) {
  uint32_t v = 0u;
  if (v0 != nullptr && k.on) {
    const int live = S - 32 * k.col;
    const uint32_t m = live >= 32 ? ~0u : (live <= 0 ? 0u : (1u << live) - 1u);
    v = v0[static_cast<size_t>(w) * k.W + k.col] & m;
  }
  // the seed row fires at t < seed_lim: where gated (every step seeded, g < 2
  // unseeded), and at t = 0 for state 0 in v0 (without an edge into state 0
  // it is live nowhere else; with one, has0 tests every step)
  const bool gw = gate == nullptr || gate[w] != 0;
  const int gated = gw ? (seeded ? win.T : win.t_seed_end) : 0;
  const int seed_lim = max(gated, k.has0(v) ? 1 : 0);
  steps_up<G>(win, [&](int t, int sym) {
    const bool zero = k.enter0 && k.has0(v);  // every lane joins the shuffle
    v = k.fwd(dg, v, t < seed_lim || zero, sym);
    f(t, v);
  });
  return v;
}

template <int G>
__global__ void __launch_bounds__(kWideThreads)
long_band_count_kernel(LONG_WIDE_HEAD, const uint32_t* __restrict__ v0,
                       const uint8_t* __restrict__ gate, int seeded,
                       int32_t* __restrict__ cnt_o, uint8_t* __restrict__ tail_o,
                       uint32_t* __restrict__ vout, const uint32_t* __restrict__ band_g,
                       const Diags dg) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Band<G> k = load_band<G>(smem, tab_g, band_g, dg, S, W, false);
  const int hi = min(T, lead + block);
  BAND_WINDOWS(G) {
    const int w0 = p * (32 / G) + k.half;
    const bool act = w0 < nw;
    const int w = act ? w0 : nw - 1;
    Window win = window(data, n, block, lead, T, rep, w);
    const int t_eos = win.t_eos;
    int cnt = 0;
    bool tail = false;
    const uint32_t v = walk_band(k, dg, win, S, v0, gate, seeded, w, [&](int t, uint32_t vv) {
      if (t < lead || t >= hi || !k.accepts(vv)) return;
      cnt += t < t_eos - 1 ? 1 : 0;
      tail = tail || t == t_eos - 1 || t == t_eos;
    });
    if (!act) continue;
    if (k.j == 0) {
      cnt_o[w] = cnt;
      tail_o[w] = tail ? 1 : 0;
    }
    if (vout != nullptr && k.on) vout[static_cast<size_t>(w) * W + k.j] = v;
  }
}

// Lane 0 of the window's lane group writes each owned 32-step flag word
// when it closes: the owned step j = t - lead's flag is shifted in at the
// top, so after the word's 32 steps it sits at bit j & 31 (T = lead +
// block, a multiple of 32: every step from lead on is owned, and the last
// closes the last word).
template <int G>
__global__ void __launch_bounds__(kWideThreads)
long_band_flags_kernel(LONG_WIDE_HEAD, const uint32_t* __restrict__ v0,
                       const uint8_t* __restrict__ gate, int seeded,
                       uint32_t* __restrict__ flags, const uint32_t* __restrict__ band_g,
                       const Diags dg) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Band<G> k = load_band<G>(smem, tab_g, band_g, dg, S, W, false);
  BAND_WINDOWS(G) {
    const int w0 = p * (32 / G) + k.half;
    const bool act = w0 < nw;
    const int w = act ? w0 : nw - 1;
    Window win = window(data, n, block, lead, T, rep, w);
    uint32_t* out = flags + static_cast<size_t>(w / rep) * (block >> 5);  // bit g of the array
    uint32_t word = 0u;
    walk_band(k, dg, win, S, v0, gate, seeded, w, [&](int t, uint32_t vv) {
      if (t < lead) return;  // the same t on every lane: accepts is a vote
      word = __funnelshift_r(word, k.accepts(vv) ? 1u : 0u, 1);
      const int j = t - lead;
      if ((j & 31) == 31 && act && k.j == 0) out[j >> 5] = word;
    });
  }
}

template <int G>
__global__ void __launch_bounds__(kWideThreads)
long_band_reverse_kernel(LONG_WIDE_HEAD, uint32_t* __restrict__ hits,
                         const uint32_t* __restrict__ band_g, const Diags dg) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Band<G> k = load_band<G>(smem, tab_g, band_g, dg, S, W, true);
  const int hi = min(T, lead + block);
  BAND_WINDOWS(G) {
    const int w0 = p * (32 / G) + k.half;
    const bool act = w0 < nw;
    const int w = act ? w0 : nw - 1;
    Window win = window(data, n, block, lead, T, rep, w);
    uint32_t* out = hits + static_cast<size_t>(w / rep) * (block >> 5);
    uint32_t rs = 0u, word = 0u;
    steps_down<G>(win, [&](int t, int sym) {
      bool s0;
      rs = k.rev(dg, rs, sym, s0);
      if (t < lead || t >= hi) return;
      const int j = t - lead;
      word |= (s0 ? 1u : 0u) << (j & 31);
      if ((j & 31) == 0) {  // walking down, bit j closes word j / 32
        if (act && k.j == 0) out[j >> 5] = word;
        word = 0u;
      }
    });
  }
}

// The launchers' checks: the window geometry (check_long) and a tile of
// 257..1024 states.
int check_long_wide(const void* data, long long n, int nw, int block, int lead, int T, int rep,
                    int s_tile) {
  if (s_tile < kMinTile || s_tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  return check_long(data, n, nw, block, lead, T, rep);
}

// ... and a band table, with 16 lanes a window only for W <= 16
int check_long_band(const void* data, long long n, int nw, int block, int lead, int T, int rep,
                    int s_tile, const void* band, int lanes) {
  const int bad = check_band(band, lanes, s_tile);
  return bad != 0 ? bad : check_long_wide(data, n, nw, block, lead, T, rep, s_tile);
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

// The band kernels (flags, count and reverse) also take the tile's band
// table (scan_pallas.band_table), its nd offsets (a host array) and the
// lanes a window: 32, or 16 (two windows a warp; W <= 16).
//
// flags: flat bit array over the windows' owned steps, bit g of word g / 32
// (nw / rep * block / 32 words)
int rrx_long_wide_flags(RRX_LONG_HEAD, const void* v0, const void* gate, int seeded, void* flags,
                        const void* band, int nd, const int* offsets, int lanes, void* stream) {
  Diags dg;
  int bad = check_long_band(data, n, nw, block, lead, T, rep, s_tile, band, lanes);
  if (bad == 0 && T != lead + block) bad = static_cast<int>(cudaErrorInvalidValue);
  if (bad == 0) bad = band_diags(nd, offsets, false, s_tile, &dg);
  if (bad != 0) return bad;
  const auto* b = static_cast<const uint32_t*>(band);
  const auto* v = static_cast<const uint32_t*>(v0);
  const auto* g = static_cast<const uint8_t*>(gate);
  auto* f = static_cast<uint32_t*>(flags);
  const size_t smem = long_wide_smem(s_tile);
  if (lanes == 16) {
    return launch_wide(long_band_flags_kernel<16>, (nw + 1) / 2, smem, stream,
                       RRX_LONG_WIDE_ARGS, v, g, seeded, f, b, dg);
  }
  return launch_wide(long_band_flags_kernel<32>, nw, smem, stream, RRX_LONG_WIDE_ARGS, v, g,
                     seeded, f, b, dg);
}

// cnt: [nw] int32; tail: [nw] uint8; vout: [nw][W] uint32 or null
int rrx_long_wide_count(RRX_LONG_HEAD, const void* v0, const void* gate, int seeded, void* cnt,
                        void* tail, void* vout, const void* band, int nd, const int* offsets,
                        int lanes, void* stream) {
  Diags dg;
  int bad = check_long_band(data, n, nw, block, lead, T, rep, s_tile, band, lanes);
  if (bad == 0) bad = band_diags(nd, offsets, false, s_tile, &dg);
  if (bad != 0) return bad;
  const auto* b = static_cast<const uint32_t*>(band);
  const auto* v = static_cast<const uint32_t*>(v0);
  const auto* g = static_cast<const uint8_t*>(gate);
  auto* c = static_cast<int32_t*>(cnt);
  auto* tl = static_cast<uint8_t*>(tail);
  auto* vo = static_cast<uint32_t*>(vout);
  const size_t smem = long_wide_smem(s_tile);
  if (lanes == 16) {
    return launch_wide(long_band_count_kernel<16>, (nw + 1) / 2, smem, stream,
                       RRX_LONG_WIDE_ARGS, v, g, seeded, c, tl, vo, b, dg);
  }
  return launch_wide(long_band_count_kernel<32>, nw, smem, stream, RRX_LONG_WIDE_ARGS, v, g,
                     seeded, c, tl, vo, b, dg);
}

// hits: flat bit array as rrx_long_wide_flags's
int rrx_long_wide_reverse(RRX_LONG_HEAD, void* hits, const void* band, int nd,
                          const int* offsets, int lanes, void* stream) {
  Diags dg;
  int bad = check_long_band(data, n, nw, block, lead, T, rep, s_tile, band, lanes);
  if (bad == 0 && T < lead + block) bad = static_cast<int>(cudaErrorInvalidValue);
  if (bad == 0) bad = band_diags(nd, offsets, true, s_tile, &dg);
  if (bad != 0) return bad;
  const auto* b = static_cast<const uint32_t*>(band);
  auto* h = static_cast<uint32_t*>(hits);
  const size_t smem = long_wide_smem(s_tile);
  if (lanes == 16) {
    return launch_wide(long_band_reverse_kernel<16>, (nw + 1) / 2, smem, stream,
                       RRX_LONG_WIDE_ARGS, h, b, dg);
  }
  return launch_wide(long_band_reverse_kernel<32>, nw, smem, stream, RRX_LONG_WIDE_ARGS, h, b,
                     dg);
}

// Resident blocks per SM (theoretical occupancy) of a wide window kernel for
// a tile of s_tile states, by index: 0 carry, 1 flags, 2 count, 3 reverse
// (rrx_occupancy's order for the long kernels; flags, count and reverse at
// 16 lanes a window for W <= 16), 4 count and 5 reverse at 32 lanes a
// window.
int rrx_long_wide_occupancy(int kernel, int s_tile, int* blocks_per_sm) {
  if (s_tile < kMinTile || s_tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = long_wide_smem(s_tile);
  const bool halves = words_of(s_tile) <= 16;
  switch (kernel) {
    case 0:
      return occupancy_wide(long_wide_carry_kernel, smem, blocks_per_sm);
    case 1:
      return halves ? occupancy_wide(long_band_flags_kernel<16>, smem, blocks_per_sm)
                    : occupancy_wide(long_band_flags_kernel<32>, smem, blocks_per_sm);
    case 2:
      return halves ? occupancy_wide(long_band_count_kernel<16>, smem, blocks_per_sm)
                    : occupancy_wide(long_band_count_kernel<32>, smem, blocks_per_sm);
    case 3:
      return halves ? occupancy_wide(long_band_reverse_kernel<16>, smem, blocks_per_sm)
                    : occupancy_wide(long_band_reverse_kernel<32>, smem, blocks_per_sm);
    case 4:
      return occupancy_wide(long_band_count_kernel<32>, smem, blocks_per_sm);
    case 5:
      return occupancy_wide(long_band_reverse_kernel<32>, smem, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
