// Bitband tier on Hopper (sm_90a): match statistics, forward flags,
// candidate starts, anchored rescans and span rounds of multiblock and
// sparse programs whose follow matrix decomposes into diagonals, rank-1
// columns and triangle families (ops/scan_bitband.py, bitband_spec).
//
// Replaces the five Pallas TPU call sites of the JAX package's
// roaringregex_tpu/ops/scan_bitband.py (four kernel bodies):
//   rrx_bitband_stats      <- _bitband_match_kernel_b (via _match_call_b)
//   rrx_bitband_flags      <- _bitband_flags_kernel_b (via _flags_call_b)
//   rrx_bitband_reverse    <- _bitband_reverse_kernel_b (via _reverse_call_b
//                             and _bb_reverse_pl)
//   rrx_bitband_anchor_end <- _bitband_anchor_kernel_b (via _bb_anchor_pl)
//   rrx_bitband_spans      <- _bb_spans_call's while_loop of rounds (a first
//                             start from the reverse hits, then the anchored
//                             rescan of _bitband_anchor_kernel_b)
//
// What they compute. A record's state set is W uint32 words (bit s % 32 of
// word s / 32 = state s; W a multiple of 8, at most 128). One forward step
//     v = expand(v | seed) & mask[sym]
// and one reverse step
//     R = expand_rev((R | acc) & mask[sym]);  hit = R & init != 0
// where expand is, over the tables of ops/scan_bitband.build_bitband_tables:
// - diagonals: y |= shift(v, d) & dmask_d (a cross-word funnel shift by the
//   offset d = dst - src; the reverse pass shifts by -d with the
//   source-indexed masks);
// - rank-1 columns c: forward y[c] |= any(v & rowmask_c); reverse, if bit c
//   of v is set, y |= rowmask_c;
// - triangle families (word window [lo, hi), zero outside it): forward
//   P = exclusive prefix-OR of v & E, y |= T_g & shift(P, g) per gap g;
//   reverse, per gap, S = exclusive suffix-OR of v & T_g, y |= E &
//   shift(S, -g).
// sym is the byte at step t (byte t-1), BOS at step 0, EOS at step len+1;
// meta's symbol rows give each its mask row (a byte in no run has none,
// a zero mask); steps past EOS are dead, change no output and are not run.
// Per record r with len = clamp(lengths[r], 0, L):
// - stats: the seed ORs in at every step when seeded, at steps t < 2 when
//   not; per accept channel c (row r_acc + c) a flag has end e = min(t,len):
//   cnt counts flags with e != last (the `$` step's duplicate), except for
//   a nullable seeded scan whose cnt is len+1; first keeps the first e,
//   last the latest, full is a flag at t >= len; nullable starts first = 0,
//   cnt = len+1 and last = len (seeded) or cnt = 1 and last = 0, full =
//   (len == 0). Outputs [R][C].
// - flags: every step's raw flags as words [Wt][R*C], bit t of column
//   r*C + c in word t/32, Wt = ceil((L+2)/32), words past EOS zero.
// - reverse: hit words [Wt][R], bit t = the initial state is in R after
//   step t (a match can start at max(t-1, 0)).
// - anchor end: seed at step st+1 (steps <= 1 when st == 0), st = -1
//   inactive; the first (lazy) or last (longest) flag of the rescan's
//   accept row (the row after the channels) with e = min(t, len) >= st;
//   -1 when none.
// - spans: at most cap rounds of: the first start s >= pos (s <= len) from
//   the hit words (start s = hit step s+1, or step 0 or 1 for s = 0), the
//   anchored end e from s, emit (s, e) if e >= s and pos = max(e, s+1), go
//   on while pos <= len; over = still going after cap rounds. Spans go
//   into [R][cap] rows, -1 past cnt (cnt <= cap).
//
// Design, and what bounds it on this card:
// - One warp per record. Lane l owns state words l, l+32, l+64, l+96; the
//   kernels are templated on the words per lane, NW = ceil(W/32) <= 4, and
//   pad every row to Wp = 32 NW words (zeros past W), so no lane tests its
//   words against W. A cross-word shift needs words owned by other lanes,
//   so each warp keeps its state words in a buffer of shared memory (and a
//   second one for the triangle's prefix or suffix), Wp words between
//   Wp + 1 zero words on each side: a shift by d states reads v[w + A] and
//   v[w + A + 1] (A = floor(-d / 32)) with no bounds test and joins them
//   with one funnel shift; the diagonals of one A share those two loads.
// - Rank-1 columns reduce with __any_sync; the triangle's prefix-OR is an
//   in-word smear ((x | -x) << 1 forward; the set bits below the highest one
//   in reverse) plus the carry from lower (higher) words, a __ballot_sync
//   over the words' any-bits.
// - The tables (every mask row, the meta header, the shifts) live in
//   shared memory, n_rows * Wp words and the header per block; config 10's
//   29 rows x 64 words are 7.4 KB. The accept flags are one __any_sync per
//   channel; lane c keeps channel c's bookkeeping (C <= 32).
// - A step is a dependent chain of shared loads, funnel shifts, ANDs, ORs
//   and warp votes (config 10: 16 diagonals, 2 triangle families over
//   W = 56 words), so a pass is bound by integer and shared-memory issue.
//   HBM carries one input byte per step (all lanes read the same 16-byte
//   chunk) and 1 bit per step of flag or hit words.
// - The walks are rolled loops (one copy of the step body per kernel),
//   which keeps nvcc's time small.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "scan_core.cuh"

namespace {

using namespace rrx;

constexpr int kWarps = 8;  // records per block
constexpr int kBbThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWords = 128;
constexpr int kMaxDiags = 32;
constexpr int kMaxRank1 = 32;
constexpr int kMaxFam = 6;
constexpr int kMaxChannels = 32;
// meta: [n_runs, n_diags, n_rank1, n_fam, tri_lo, tri_hi, C, 0 | diags |
// rank-1 columns | gaps | symbol rows] (ops/scan_bitband.bitband_meta)
constexpr int kMetaDiags = 8;
constexpr int kMetaRank1 = kMetaDiags + kMaxDiags;
constexpr int kMetaGaps = kMetaRank1 + kMaxRank1;
constexpr int kMetaSyms = kMetaGaps + 8;
constexpr int kMetaLen = kMetaSyms + kSyms;

// The per-block tables in shared memory: every row padded to Wp = 32 * NW
// words (zeros past W, so no lane tests its words against W), the meta
// header, and each diagonal's and family's shift as a word offset A and a
// bit shift s: word w of v shifted by d states toward higher indices is
// funnel(v[w + A], v[w + A + 1]) >> s with A = floor(-d / 32), s = -d mod 32
// (one form for both directions).
struct BB {
  const uint32_t* tab;  // shared [n_rows][Wp]
  const int* meta;      // shared [kMetaLen]
  const int* dA;        // shared [nd]: the diagonals' word offsets
  const int* dS;        // shared [nd]: their bit shifts
  const int* fA;        // shared [nf]: the families' word offsets
  const int* fS;        // shared [nf]
  int Wp, nd, n1, nf, lo, hi, C;
  int r_diag, r_rank1, r_tri, r_acc;  // first row of each block

  __device__ __forceinline__ const uint32_t* row(int k) const { return tab + k * Wp; }
};

// Each warp's two state buffers hold Wp words between Wp + 1 zero words on
// each side, so every shifted read lands inside them.
__host__ __device__ constexpr int bb_buf_words(int Wp) { return 3 * Wp + 2; }

inline size_t bb_smem_bytes(int W, int n_rows) {
  const int Wp = 32 * ((W + 31) / 32);
  return sizeof(uint32_t) * (static_cast<size_t>(n_rows) * Wp + kMetaLen + 2 * (kMaxDiags + kMaxFam)
                             + 2 * kWarps * bb_buf_words(Wp));
}

// Copies the tables into shared memory, computes the shifts of the
// diagonals and families (their sign flipped on the reverse pass) and
// zeroes the state buffers. Every thread of a block that holds a record
// calls it (it ends in __syncthreads) before any thread returns.
template <int NW>
__device__ __forceinline__ BB load_bb(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                      const int32_t* __restrict__ meta_g, int W, int n_rows,
                                      bool rev) {
  constexpr int Wp = 32 * NW;
  uint32_t* tab = smem;
  int* meta = reinterpret_cast<int*>(smem + n_rows * Wp);
  int* shifts = meta + kMetaLen;  // dA, dS, fA, fS
  for (int i = threadIdx.x; i < n_rows * Wp; i += blockDim.x) {
    const int r = i / Wp, c = i - r * Wp;
    tab[i] = c < W ? tab_g[r * W + c] : 0u;
  }
  for (int i = threadIdx.x; i < kMetaLen; i += blockDim.x) meta[i] = meta_g[i];
  for (int i = threadIdx.x; i < kMaxDiags + kMaxFam; i += blockDim.x) {
    const bool diag = i < kMaxDiags;
    const int j = diag ? i : i - kMaxDiags;
    const int d = (diag ? meta_g[kMetaDiags + j] : meta_g[kMetaGaps + j]) * (rev ? -1 : 1);
    int* A = diag ? shifts : shifts + 2 * kMaxDiags;
    const int n = diag ? kMaxDiags : kMaxFam;
    A[j] = (-d) >> 5;  // arithmetic shift: floor division
    A[n + j] = (-d) & 31;
  }
  uint32_t* bufs = reinterpret_cast<uint32_t*>(shifts + 2 * (kMaxDiags + kMaxFam));
  for (int i = threadIdx.x; i < 2 * kWarps * bb_buf_words(Wp); i += blockDim.x) bufs[i] = 0u;
  __syncthreads();
  BB bb;
  bb.tab = tab;
  bb.meta = meta;
  bb.dA = shifts;
  bb.dS = shifts + kMaxDiags;
  bb.fA = shifts + 2 * kMaxDiags;
  bb.fS = shifts + 2 * kMaxDiags + kMaxFam;
  bb.Wp = Wp;
  bb.nd = meta[1];
  bb.n1 = meta[2];
  bb.nf = meta[3];
  bb.lo = meta[4];
  bb.hi = meta[5];
  bb.C = meta[6];
  bb.r_diag = 3 + meta[0];
  bb.r_rank1 = bb.r_diag + bb.nd;
  bb.r_tri = bb.r_rank1 + bb.n1;
  bb.r_acc = bb.r_tri + (bb.nf ? 1 + bb.nf : 0);
  return bb;
}

// The warp's two state buffers, each pointing at its first state word.
template <int NW>
__device__ __forceinline__ uint32_t* warp_buf(uint32_t* smem, int n_rows, int warp, int which) {
  constexpr int Wp = 32 * NW;
  uint32_t* bufs = smem + n_rows * Wp + kMetaLen + 2 * (kMaxDiags + kMaxFam);
  return bufs + (2 * warp + which) * bb_buf_words(Wp) + Wp + 1;
}

// any(v & row) over the record's words, the same on every lane.
template <int NW>
__device__ __forceinline__ bool any_row(const BB& bb, const uint32_t (&v)[NW], int k_row,
                                        int lane) {
  const uint32_t* m = bb.row(k_row);
  uint32_t t = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) t |= v[k] & m[lane + 32 * k];
  return __any_sync(kFull, t != 0u) != 0;
}

// Stores v into the warp's buffer between two warp barriers.
template <int NW>
__device__ __forceinline__ void publish(uint32_t* buf, const uint32_t (&v)[NW], int lane) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NW; ++k) buf[lane + 32 * k] = v[k];
  __syncwarp();
}

// y = F^T v (rev: y = F v) from the tables of bb (forward or reverse; the
// shifts in bb carry the direction).
template <int NW>
__device__ __forceinline__ void expand(const BB& bb, uint32_t* vs, uint32_t* ps,
                                       const uint32_t (&v)[NW], uint32_t (&y)[NW], int lane,
                                       bool rev) {
  publish<NW>(vs, v, lane);
#pragma unroll
  for (int k = 0; k < NW; ++k) y[k] = 0;
  // diagonals of one word offset share the two words they read (the
  // offsets are sorted, so each offset's words load once a step)
  uint32_t lo_w[NW], hi_w[NW];
  int cached = 1 << 30;
  for (int i = 0; i < bb.nd; ++i) {
    const int A = bb.dA[i];
    if (A != cached) {
      cached = A;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        lo_w[k] = vs[lane + 32 * k + A];
        hi_w[k] = vs[lane + 32 * k + A + 1];
      }
    }
    const int sh = bb.dS[i];
    const uint32_t* m = bb.row(bb.r_diag + i);
#pragma unroll
    for (int k = 0; k < NW; ++k) y[k] |= __funnelshift_r(lo_w[k], hi_w[k], sh) & m[lane + 32 * k];
  }
  for (int i = 0; i < bb.n1; ++i) {
    const int c = bb.meta[kMetaRank1 + i];
    const uint32_t* rm = bb.row(bb.r_rank1 + i);
    if (rev) {
      // every source in the row sees column c's bit
      if ((vs[c >> 5] >> (c & 31)) & 1u) {
#pragma unroll
        for (int k = 0; k < NW; ++k) y[k] |= rm[lane + 32 * k];
      }
    } else if (any_row<NW>(bb, v, bb.r_rank1 + i, lane)) {
      // column c's bit = any source of the row in v
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (lane + 32 * k == (c >> 5)) y[k] |= 1u << (c & 31);
      }
    }
  }
  if (bb.nf == 0) return;
  // the triangle: E and the families' rows are zero outside the window
  // [lo, hi), and so is what the prefix (suffix) publishes, which is the
  // TPU's zero fill at the window's edges
  const int lo = bb.lo, hi = bb.hi;
  const uint32_t* E = bb.row(bb.r_tri);
  uint32_t x[NW], s[NW];
  unsigned bal[NW];
  if (!rev) {
    // P = exclusive prefix-OR of v & E; target p gets any exit q < p - g
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      x[k] = v[k] & E[lane + 32 * k];
      bal[k] = __ballot_sync(kFull, x[k] != 0u);
    }
    bool lower = false;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int w = lane + 32 * k;
      const bool below = lower || (bal[k] & ((1u << lane) - 1u)) != 0u;
      s[k] = (w >= lo && w < hi) ? ((x[k] | (0u - x[k])) << 1) | (below ? kFull : 0u) : 0u;
      lower = lower || bal[k] != 0u;
    }
    publish<NW>(ps, s, lane);
    for (int f = 0; f < bb.nf; ++f) {
      const int A = bb.fA[f], sh = bb.fS[f];
      const uint32_t* T = bb.row(bb.r_tri + 1 + f);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const int w = lane + 32 * k;
        y[k] |= T[w] & __funnelshift_r(ps[w + A], ps[w + A + 1], sh);
      }
    }
    return;
  }
  // reverse: per family, S = exclusive suffix-OR of v & T_g; exit q gets
  // any target p > q + g
  uint32_t acc[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) acc[k] = 0;
  for (int f = 0; f < bb.nf; ++f) {
    const uint32_t* T = bb.row(bb.r_tri + 1 + f);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      x[k] = v[k] & T[lane + 32 * k];
      bal[k] = __ballot_sync(kFull, x[k] != 0u);
    }
    bool upper = false;
#pragma unroll
    for (int k = NW - 1; k >= 0; --k) {
      const int w = lane + 32 * k;
      const bool above = upper || (bal[k] & ~((2u << lane) - 1u)) != 0u;
      const uint32_t in_word = x[k] ? (kFull >> __clz(x[k])) >> 1 : 0u;
      s[k] = (w >= lo && w < hi) ? in_word | (above ? kFull : 0u) : 0u;
      upper = upper || bal[k] != 0u;
    }
    publish<NW>(ps, s, lane);
    const int A = bb.fA[f], sh = bb.fS[f];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int w = lane + 32 * k;
      acc[k] |= __funnelshift_r(ps[w + A], ps[w + A + 1], sh);
    }
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) y[k] |= E[lane + 32 * k] & acc[k];
}

// v = expand(v | gate * seed) & mask[sym]
template <int NW>
__device__ __forceinline__ void step_fwd(const BB& bb, uint32_t* vs, uint32_t* ps, uint32_t (&v)[NW],
                                         bool gate, int sym, int lane) {
  const uint32_t* seed = bb.row(2);
  if (gate) {
#pragma unroll
    for (int k = 0; k < NW; ++k) v[k] |= seed[lane + 32 * k];
  }
  uint32_t y[NW];
  expand<NW>(bb, vs, ps, v, y, lane, false);
  const int r = bb.meta[kMetaSyms + sym];
#pragma unroll
  for (int k = 0; k < NW; ++k) v[k] = r >= 0 ? y[k] & bb.row(r)[lane + 32 * k] : 0u;
}

// R = expand_rev((R | acc) & mask[sym]) on the reverse tables
template <int NW>
__device__ __forceinline__ void step_rev(const BB& bb, uint32_t* vs, uint32_t* ps, uint32_t (&R)[NW],
                                         int sym, int lane) {
  const uint32_t* acc = bb.row(bb.r_acc);
  const int r = bb.meta[kMetaSyms + sym];
  uint32_t m[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int w = lane + 32 * k;
    m[k] = r >= 0 ? (R[k] | acc[w]) & bb.row(r)[w] : 0u;
  }
  expand<NW>(bb, vs, ps, m, R, lane, true);
}

// The anchored rescan of one record from start st: the first (lazy) or
// last (longest) accepting end e = min(t, len) >= st of the rescan's accept
// row, -1 when none. The walk starts at the seed step and stops once the
// state is empty after it (or, lazy, at the first end).
template <int NW>
__device__ __forceinline__ int anchor_end(const BB& bb, uint32_t* vs, uint32_t* ps, const uint4* row, int len,
                          int st, bool longest, int lane) {
  if (st < 0 || st > len) return -1;
  const int k_acc = bb.r_acc + bb.C;
  uint32_t v[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) v[k] = 0;
  int end = -1;
  uint4 q{};
  int qc = -1;
#pragma unroll 1
  for (int t = st == 0 ? 0 : st + 1; t <= len + 1; ++t) {
    int sym = t == 0 ? kBos : kEos;
    if (t >= 1 && t <= len) {
      const int j = t - 1;
      if ((j >> 4) != qc) {
        qc = j >> 4;
        q = __ldg(row + qc);
      }
      sym = byte_at(q, j & 15);
    }
    const bool gate = st == t - 1 || (st == 0 && t <= 1);
    step_fwd<NW>(bb, vs, ps, v, gate, sym, lane);
    if (any_row<NW>(bb, v, k_acc, lane)) {
      const int e = min(t, len);
      if (e >= st) {
        end = e;
        if (!longest) break;
      }
    }
    uint32_t live = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) live |= v[k];
    if (t >= st + 1 && !__any_sync(kFull, live != 0u)) break;
  }
  return end;
}

// The first start s >= pos (s <= len) in record r's hit words [Wt][R], or
// -1: the first hit step t in [pos == 0 ? 0 : pos+1, len+1], s = max(t-1, 0).
__device__ int first_start(const int32_t* hits, int R, int r, int pos, int len, int lane) {
  const int t_lo = pos == 0 ? 0 : pos + 1;
  const int t_hi = len + 1;
  if (t_lo > t_hi) return -1;
  for (int base = t_lo >> 5; base <= (t_hi >> 5); base += 32) {
    const int i = base + lane;
    uint32_t word = 0;
    if (i <= (t_hi >> 5)) {
      word = static_cast<uint32_t>(hits[static_cast<long long>(i) * R + r]);
      if (i == (t_lo >> 5)) word &= kFull << (t_lo & 31);
      if (i == (t_hi >> 5)) word &= (2u << (t_hi & 31)) - 1u;
    }
    const unsigned b = __ballot_sync(kFull, word != 0u);
    if (b) {
      const int src = __ffs(b) - 1;
      const uint32_t wsrc = __shfl_sync(kFull, word, src);
      const int t = (base + src) * 32 + __ffs(wsrc) - 1;
      return t > 0 ? t - 1 : 0;
    }
  }
  return -1;
}

#define RRX_BB_PARAMS                                                                   \
  const uint8_t *data, long long stride, int L, const int32_t *lengths, int R,          \
      const uint32_t *tab_g, const int32_t *meta_g, int W, int n_rows, const int32_t *live
#define RRX_BB_SETUP(REV)                                                               \
  extern __shared__ uint32_t smem[];                                                    \
  /* a block wholly past R or live skips the table load: the test is */                \
  /* uniform across the block, so it may come before load_bb's barrier */               \
  const int r0 = static_cast<int>(blockIdx.x) * kWarps;                                 \
  if (r0 >= R || (live != nullptr && r0 >= *live)) return;                              \
  const BB bb = load_bb<NW>(smem, tab_g, meta_g, W, n_rows, REV);                       \
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;                           \
  const int r = r0 + warp;                                                              \
  if (r >= R || (live != nullptr && r >= *live)) return;                                \
  uint32_t* vs = warp_buf<NW>(smem, n_rows, warp, 0);                                   \
  uint32_t* ps = warp_buf<NW>(smem, n_rows, warp, 1);                                   \
  const Row rec = record(data, stride, L, lengths, r);                                  \
  const int len = rec.len;

template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_stats_kernel(RRX_BB_PARAMS, int C, int seeded, int nullable, int32_t* cnt_o,
                    int32_t* first_o, int32_t* last_o, uint8_t* full_o) {
  RRX_BB_SETUP(false)
  int cnt, first, last, full;
  if (nullable) {
    cnt = seeded ? len + 1 : 1;
    last = seeded ? len : 0;
    first = 0;
    full = len == 0;
  } else {
    cnt = 0;
    first = -1;
    last = -1;
    full = 0;
  }
  uint32_t v[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) v[k] = 0;
  walk_steps(rec.row, len, [&](int t, int sym) {
    step_fwd<NW>(bb, vs, ps, v, seeded || t < 2, sym, lane);
    bool fl = false;
    for (int c = 0; c < C; ++c) {
      const bool a = any_row<NW>(bb, v, bb.r_acc + c, lane);
      if (c == lane) fl = a;
    }
    const int e = min(t, len);
    if (!(nullable && seeded)) cnt += (fl && e != last) ? 1 : 0;
    if (fl && first < 0) first = e;
    if (fl) last = e;
    if (fl && t >= len) full = 1;
  });
  if (lane < C) {
    const long long o = static_cast<long long>(r) * C + lane;
    cnt_o[o] = cnt;
    first_o[o] = first;
    last_o[o] = last;
    full_o[o] = static_cast<uint8_t>(full);
  }
}

template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_flags_kernel(RRX_BB_PARAMS, int C, int seeded, uint32_t* words) {
  RRX_BB_SETUP(false)
  const int Wt = (L + 2 + 31) >> 5;
  const long long cols = static_cast<long long>(R) * C;
  const long long col = static_cast<long long>(r) * C + lane;
  uint32_t v[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) v[k] = 0;
  uint32_t word = 0;
  int wi = 0;
  walk_steps(rec.row, len, [&](int t, int sym) {
    step_fwd<NW>(bb, vs, ps, v, seeded || t < 2, sym, lane);
    bool fl = false;
    for (int c = 0; c < C; ++c) {
      const bool a = any_row<NW>(bb, v, bb.r_acc + c, lane);
      if (c == lane) fl = a;
    }
    if ((t >> 5) != wi) {
      if (lane < C) words[wi * cols + col] = word;
      word = 0;
      wi = t >> 5;
    }
    word |= (fl ? 1u : 0u) << (t & 31);
  });
  if (lane < C) {
    words[wi * cols + col] = word;
    for (int i = wi + 1; i < Wt; ++i) words[i * cols + col] = 0u;
  }
}

template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_reverse_kernel(RRX_BB_PARAMS, uint32_t* hits) {
  RRX_BB_SETUP(true)
  const int Wt = (L + 2 + 31) >> 5;
  for (int i = ((len + 1) >> 5) + 1 + lane; i < Wt; i += 32) {
    hits[static_cast<long long>(i) * R + r] = 0u;
  }
  const int k_init = bb.r_acc + 1;
  uint32_t Rv[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) Rv[k] = 0;
  uint32_t word = 0;
  walk_steps_rev(rec.row, len, [&](int t, int sym) {
    step_rev<NW>(bb, vs, ps, Rv, sym, lane);
    word |= (any_row<NW>(bb, Rv, k_init, lane) ? 1u : 0u) << (t & 31);
    if ((t & 31) == 0) {
      if (lane == 0) hits[static_cast<long long>(t >> 5) * R + r] = word;
      word = 0;
    }
  });
}

template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_anchor_kernel(RRX_BB_PARAMS, const int32_t* starts, int longest, int32_t* end) {
  RRX_BB_SETUP(false)
  const int e = anchor_end<NW>(bb, vs, ps, rec.row, len, starts[r], longest != 0, lane);
  if (lane == 0) end[r] = e;
}

template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_spans_kernel(RRX_BB_PARAMS, const int32_t* hits, int cap, int longest, int32_t* starts,
                    int32_t* ends, int32_t* cnt, uint8_t* over) {
  RRX_BB_SETUP(false)
  int32_t* srow = starts + static_cast<long long>(r) * cap;
  int32_t* erow = ends + static_cast<long long>(r) * cap;
  int pos = 0, n = 0;
  bool active = true;
#pragma unroll 1
  for (int k = 0; k < cap && active; ++k) {
    const int s = first_start(hits, R, r, pos, len, lane);
    if (s < 0) {
      active = false;
      break;
    }
    const int e = anchor_end<NW>(bb, vs, ps, rec.row, len, s, longest != 0, lane);
    if (e < s) {
      active = false;
      break;
    }
    if (lane == 0) {
      srow[n] = s;
      erow[n] = e;
    }
    ++n;
    pos = max(e, s + 1);
    active = pos <= len;
  }
  for (int k = n + lane; k < cap; k += 32) {
    srow[k] = -1;
    erow[k] = -1;
  }
  if (lane == 0) {
    cnt[r] = n;
    over[r] = active ? 1 : 0;
  }
}

template <class F>
int by_lane_words(int W, F&& f) {
  if (W < 1 || W > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  switch ((W + 31) / 32) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 3:
      return f(std::integral_constant<int, 3>{});
    default:
      return f(std::integral_constant<int, 4>{});
  }
}

// The launchers' checks: the row layout (check_rows), W and the table's
// row count against the header's counts, and the channel count.
int check_bb(const void* data, long long stride, int L, int R, int W, int n_rows, int C) {
  if (W < 1 || W > kMaxWords || n_rows < 3 || C < 0 || C > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return check_rows(data, stride, L, R);
}

template <class K, class... Args>
int launch_bb(K kernel, int R, int W, int n_rows, void* stream, Args... args) {
  if (R == 0) return 0;
  const size_t smem = bb_smem_bytes(W, n_rows);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const int blocks = (R + kWarps - 1) / kWarps;
  kernel<<<blocks, kBbThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int occupancy_bb(K kernel, int W, int n_rows, int* blocks_per_sm) {
  const size_t smem = bb_smem_bytes(W, n_rows);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kBbThreads, smem));
}

}  // namespace

#define RRX_BB_HEAD                                                                        \
  const void *data, long long stride, int L, const void *lengths, int R, const void *tab, \
      const void *meta, int W, int n_rows, const void *live
#define RRX_BB_ARGS                                                                       \
  static_cast<const uint8_t*>(data), stride, L, static_cast<const int32_t*>(lengths), R, \
      static_cast<const uint32_t*>(tab), static_cast<const int32_t*>(meta), W, n_rows, \
      static_cast<const int32_t*>(live)

extern "C" {

// Every entry point: the rows (data, stride, L, lengths, R), the table
// (tab [n_rows][W] uint32, meta [kMetaLen] int32), then live: null, or a
// device int32 count past which every record returns at once with its
// outputs unwritten (the prefilter's compacted and full passes).
//
// tab: the forward table [n_rows][W] (ops/scan_bitband.BitbandTables.tab_f);
// cnt, first, last: [R][C] int32; full: [R][C] uint8
int rrx_bitband_stats(RRX_BB_HEAD, int C, int seeded, int nullable, void* cnt, void* first,
                      void* last, void* full, void* stream) {
  const int bad = check_bb(data, stride, L, R, W, n_rows, C);
  if (bad != 0) return bad;
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    return launch_bb(bb_stats_kernel<NW>, R, W, n_rows, stream, RRX_BB_ARGS, C, seeded,
                     nullable, static_cast<int32_t*>(cnt), static_cast<int32_t*>(first),
                     static_cast<int32_t*>(last), static_cast<uint8_t*>(full));
  });
}

// words: [ceil((L+2)/32)][R*C] uint32
int rrx_bitband_flags(RRX_BB_HEAD, int C, int seeded, void* words, void* stream) {
  const int bad = check_bb(data, stride, L, R, W, n_rows, C);
  if (bad != 0) return bad;
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    return launch_bb(bb_flags_kernel<NW>, R, W, n_rows, stream, RRX_BB_ARGS, C, seeded,
                     static_cast<uint32_t*>(words));
  });
}

// tab: the reverse table (BitbandTables.tab_r); hits: [ceil((L+2)/32)][R]
int rrx_bitband_reverse(RRX_BB_HEAD, void* hits, void* stream) {
  const int bad = check_bb(data, stride, L, R, W, n_rows, 0);
  if (bad != 0) return bad;
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    return launch_bb(bb_reverse_kernel<NW>, R, W, n_rows, stream, RRX_BB_ARGS,
                     static_cast<uint32_t*>(hits));
  });
}

// starts: [R] int32 (-1 inactive); end: [R] int32
int rrx_bitband_anchor_end(RRX_BB_HEAD, const void* starts, int longest, void* end,
                           void* stream) {
  const int bad = check_bb(data, stride, L, R, W, n_rows, 0);
  if (bad != 0) return bad;
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    return launch_bb(bb_anchor_kernel<NW>, R, W, n_rows, stream, RRX_BB_ARGS,
                     static_cast<const int32_t*>(starts), longest, static_cast<int32_t*>(end));
  });
}

// hits: rrx_bitband_reverse's words; starts, ends: [R][cap] int32; cnt: [R]
// int32; over: [R] uint8
int rrx_bitband_spans(RRX_BB_HEAD, const void* hits, int cap, int longest, void* starts,
                      void* ends, void* cnt, void* over, void* stream) {
  const int bad = check_bb(data, stride, L, R, W, n_rows, 0);
  if (bad != 0) return bad;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    return launch_bb(bb_spans_kernel<NW>, R, W, n_rows, stream, RRX_BB_ARGS,
                     static_cast<const int32_t*>(hits), cap, longest,
                     static_cast<int32_t*>(starts), static_cast<int32_t*>(ends),
                     static_cast<int32_t*>(cnt), static_cast<uint8_t*>(over));
  });
}

// Resident blocks per SM (theoretical occupancy) of a bitband kernel for W
// state words and a table of n_rows rows: 0 stats, 1 flags, 2 reverse,
// 3 anchor end, 4 spans.
int rrx_bitband_occupancy(int kernel, int W, int n_rows, int* blocks_per_sm) {
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    switch (kernel) {
      case 0:
        return occupancy_bb(bb_stats_kernel<NW>, W, n_rows, blocks_per_sm);
      case 1:
        return occupancy_bb(bb_flags_kernel<NW>, W, n_rows, blocks_per_sm);
      case 2:
        return occupancy_bb(bb_reverse_kernel<NW>, W, n_rows, blocks_per_sm);
      case 3:
        return occupancy_bb(bb_anchor_kernel<NW>, W, n_rows, blocks_per_sm);
      case 4:
        return occupancy_bb(bb_spans_kernel<NW>, W, n_rows, blocks_per_sm);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

int rrx_bitband_threads_per_block() { return kBbThreads; }

}  // extern "C"
