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
// - One warp per record. The kernels are templated on the words per lane,
//   NW = ceil(W/32) <= 4, and pad every row to Wp = 32 NW words (zeros past
//   W), so no lane tests its words against W.
// - stats and flags run the forward register step (RegStep, below) and
//   reverse its mirror (RevStep): lane l holds the contiguous words l NW .. l NW + NW -
//   1, the diagonals' masks, the seed (initial-state), exit and accept rows
//   sit in registers, a shift is lane shuffles and a funnel shift, and no
//   state goes through shared memory. The reverse step adds the accept set
//   through one precomputed row per mask row, E[row] = expand_rev(acc &
//   mask[row]), and skips the band step when R & mask[sym] is empty (config
//   10's reverse state is empty on most steps of a record without a match).
// - anchor end and spans run the shared-buffer step (expand): lane l
//   owns state words l, l+32, l+64, l+96. A cross-word
//   shift needs words owned by other lanes, so each warp keeps its state
//   words in a buffer of shared memory (and a second one for the
//   triangle's prefix or suffix), Wp words between Wp + 1 zero words on
//   each side: a shift by d states reads v[w + A] and v[w + A + 1] (A =
//   floor(-d / 32)) with no bounds test and joins them with one funnel
//   shift; the diagonals of one A share those two loads.
// - Forward rank-1 columns reduce with __any_sync; reverse ones read their
//   column's bit by one shuffle. The triangle's prefix-OR is an in-word
//   smear ((x | -x) << 1 forward; the set bits below the highest one for the
//   reverse's suffix-OR) plus the carry from lower (higher) words, a
//   __ballot_sync over the words' any-bits.
// - The tables (every mask row, the meta header, the shifts) live in
//   shared memory, n_rows * Wp words and the header per block; config 10's
//   29 rows x 64 words are 7.4 KB. The accept flags are one __any_sync per
//   channel; lane c keeps channel c's bookkeeping (C <= 32).
// - A step is a dependent chain of shared loads, funnel shifts, ANDs, ORs
//   and warp votes (config 10: 16 diagonals, 2 triangle families over
//   W = 56 words), so a pass is bound by integer and shared-memory issue
//   (the register step: integer issue). HBM carries one input byte per step
//   (all lanes read the same 16-byte chunk) and 1 bit per step of flag or
//   hit words.
// - The walks are rolled loops (one copy of the step body per kernel; the
//   stats and flags kernels' walk_chunks three: BOS, the byte loop, EOS),
//   which keeps nvcc's time small. The flags kernel keeps the open flag
//   word in a register and stores it when its 32 steps are done.
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

// The shared memory of a kernel: the tables, the meta header, the shifts
// and, with `bufs` (anchor end and spans), each warp's two state buffers.
inline size_t bb_smem_bytes(int W, int n_rows, bool bufs) {
  const int Wp = 32 * ((W + 31) / 32);
  return sizeof(uint32_t) * (static_cast<size_t>(n_rows) * Wp + kMetaLen + 2 * (kMaxDiags + kMaxFam)
                             + (bufs ? 2 * kWarps * bb_buf_words(Wp) : 0));
}

// Copies the tables into shared memory, computes the shifts of the
// diagonals and families (their sign flipped on the reverse pass) and, with
// `bufs`, zeroes the state buffers. Every thread of a block that holds a
// record calls it (it ends in __syncthreads) before any thread returns.
template <int NW>
__device__ __forceinline__ BB load_bb(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                      const int32_t* __restrict__ meta_g, int W, int n_rows,
                                      bool rev, bool bufs = true) {
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
  uint32_t* buf = reinterpret_cast<uint32_t*>(shifts + 2 * (kMaxDiags + kMaxFam));
  const int n_buf = bufs ? 2 * kWarps * bb_buf_words(Wp) : 0;
  for (int i = threadIdx.x; i < n_buf; i += blockDim.x) buf[i] = 0u;
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

// y = F^T v from the forward tables of bb (the shared-buffer step of
// anchor end and spans).
template <int NW>
__device__ __forceinline__ void expand(const BB& bb, uint32_t* vs, uint32_t* ps,
                                       const uint32_t (&v)[NW], uint32_t (&y)[NW], int lane) {
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
    if (any_row<NW>(bb, v, bb.r_rank1 + i, lane)) {
      // column c's bit = any source of the row in v
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (lane + 32 * k == (c >> 5)) y[k] |= 1u << (c & 31);
      }
    }
  }
  if (bb.nf == 0) return;
  // the triangle: E and the families' rows are zero outside the window
  // [lo, hi), and so is what the prefix publishes, which is the TPU's zero
  // fill at the window's edges. P = exclusive prefix-OR of v & E; target p
  // gets any exit q < p - g
  const int lo = bb.lo, hi = bb.hi;
  const uint32_t* E = bb.row(bb.r_tri);
  uint32_t x[NW], s[NW];
  unsigned bal[NW];
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
  expand<NW>(bb, vs, ps, v, y, lane);
  const int r = bb.meta[kMetaSyms + sym];
#pragma unroll
  for (int k = 0; k < NW; ++k) v[k] = r >= 0 ? y[k] & bb.row(r)[lane + 32 * k] : 0u;
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
// The head of a kernel of one record a warp (record r, its row rec and
// len) over the forward tables, with (bufs) or without the warps' state
// buffers.
#define RRX_BB_RECORD(bufs)                                                             \
  extern __shared__ uint32_t smem[];                                                    \
  /* a block wholly past R or live skips the table load: the test is */                \
  /* uniform across the block, so it may come before load_bb's barrier */               \
  const int r0 = static_cast<int>(blockIdx.x) * kWarps;                                 \
  if (r0 >= R || (live != nullptr && r0 >= *live)) return;                              \
  const BB bb = load_bb<NW>(smem, tab_g, meta_g, W, n_rows, false, bufs);               \
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;                           \
  const int r = r0 + warp;                                                              \
  if (r >= R || (live != nullptr && r >= *live)) return;                                \
  const Row rec = record(data, stride, L, lengths, r);                                  \
  const int len = rec.len;
// ... and the shared-buffer step's two buffers (anchor end, spans)
#define RRX_BB_SETUP                                                                    \
  RRX_BB_RECORD(true)                                                                   \
  uint32_t* vs = warp_buf<NW>(smem, n_rows, warp, 0);                                   \
  uint32_t* ps = warp_buf<NW>(smem, n_rows, warp, 1);

// ---------------------------------------------------------------------------
// The stats and flags kernels' forward step (RegStep): the record's state
// in registers, no shared state buffer, no __syncwarp
//
// Lane l holds the NW contiguous words l NW .. l NW + NW - 1 (the
// shared-buffer kernels' lane l holds the strided words l + 32 k). A shift by d states
// sets word w to funnel_r(x[w + A], x[w + A + 1], s) (A = floor(-d / 32), s
// = -d mod 32). With contiguous words, the words of a shift by A = -1 or
// -2 (d in [1, 64]: every diagonal of config 10, offsets 1..40 at NW = 2)
// or A = 0 (d in [-31, 0]) lie in the lane's own words and the previous
// (or next) lane's: one shuffle a word, fetched once a step and shared by
// every shift of that class, whose words are then a fixed choice among
// them. With strided words a shift by one word already crosses from lane
// 31 into the next word of lane 0 (two shuffles and a select a word for
// each word offset). The table rows in shared memory keep their layout
// (word w at w); a lane reads its NW words with one vector load (NW = 2, 4).
//
// Per step: the symbol's mask row is looked up and loaded first (its two
// dependent shared loads overlap the shifts); v | gate * seed (the seed row
// in registers); the diagonals of the classes A = -1 (from register slot 0
// up) and A = -2 (from slot KD - 1 down) one funnel shift and one AND-OR a
// word each, with their masks in registers (KD = kRegMaskWords / NW slots:
// config 10's 16 diagonals at NW = 2 take all 16, 32 registers); any other
// diagonal (another class, or past the slots) by shuffles of its own with
// its mask from shared memory (no barrier: the tables do not change); the
// rank-1 columns one __any_sync each; the triangle's exclusive prefix-OR
// in-word with one __ballot_sync carry, its families shifted as the
// diagonals (the classes A = -1 and A = 0 from the prefix's neighbour
// words); the accept test with C = 1 one vote on the accept row in
// registers. A step branches on no slot's shift: the shuffles of a class
// run at the top of the step, since a shuffle inside a branch on a runtime
// value costs a divergence check (BRA.DIV) and, where its lane is computed,
// a dozen more instructions (PERF.md: a step that fetched each slot's
// words under such a branch ran slower than the shared-buffer step). The
// bytes come off 16-byte chunks in registers, the next chunk loaded one
// chunk ahead (walk_chunks, scan_core.cuh).
constexpr int kRegMaskWords = 32;  // diagonal mask words a lane keeps in registers
constexpr int kRegSlots = 32;      // kRegMaskWords / NW at NW = 1

// The register steps' plan, built by the launcher from the spec's sorted
// offsets (host arrays) and passed by value (warp-uniform, read from the
// parameter bank): the first n1r diagonals of class 1 (word offset A = -1
// forward, d in [1, 32]; A = 0 reverse, d in [0, 31]; rows row1 on) sit in
// register slots 0 .. n1r - 1 with bit shifts s1, the first n2r of class 2
// (A = -2 forward, d in [33, 64]; A = 1 reverse, d in [32, 63]; rows row2
// on) in slots KD - 1 down with s2; n_rest diagonals are stepped apart (the
// rest of the two classes and every other offset). The triangle's families
// of A = 0 (gaps in [-31, 0] forward, [0, 31] reverse) are rows [frow0,
// frow0 + nf0) with shifts sf0, those of A = -1 ([1, 32] forward, [-32, -1]
// reverse) rows [frow1, frow1 + nf1) with sf1, nf_rest others (reg_plan).
struct RegPlan {
  int n1r, row1, n2r, row2, n_rest;
  int s1[kRegSlots];
  int s2[kRegSlots];
  int nf0, frow0, nf1, frow1, nf_rest;
  int sf0[kMaxFam];
  int sf1[kMaxFam];
};

__host__ __device__ __forceinline__ int floor_div(int x, int m) {
  return x >= 0 ? x / m : -((-x + m - 1) / m);
}

// x laundered through an empty asm in the step: a comparison with it is
// then made in the step, not hoisted out of the step loop as one live
// predicate per unrolled slot.
template <class T>
__device__ __forceinline__ T opaque(T x) {
  asm volatile("" : "+r"(x));
  return x;
}

// This lane's NW words of a padded table row.
template <int NW>
__device__ __forceinline__ void lane_words(const uint32_t* row, int lane, uint32_t (&x)[NW]) {
  const uint32_t* p = row + lane * NW;
  if constexpr (NW == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    x[0] = q.x;
    x[1] = q.y;
  } else if constexpr (NW == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) x[k] = p[k];
  }
}

// The words of lane lane - by (by < 0: lane + |by|), zero past the warp's
// ends. by is a compile-time constant, so every lane joins the shuffle.
template <int NW, int by>
__device__ __forceinline__ void lane_shift(const uint32_t (&x)[NW], int lane, uint32_t (&y)[NW]) {
  const bool in = by > 0 ? lane >= by : lane < 32 + by;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t t =
        by > 0 ? __shfl_up_sync(kFull, x[k], by) : __shfl_down_sync(kFull, x[k], -by);
    y[k] = in ? t : 0u;
  }
}

// The NW + 1 words from word A of the lane's words x on, A a compile-time
// -2 .. 1: from [pv2 (lane - 2), pv (lane - 1), x, nx (lane + 1), nx2
// (lane + 2)]; the neighbours' words that A does not reach are not read.
template <int NW, int A>
__device__ __forceinline__ void window(const uint32_t (&pv2)[NW], const uint32_t (&pv)[NW],
                                       const uint32_t (&x)[NW], const uint32_t (&nx)[NW],
                                       const uint32_t (&nx2)[NW], uint32_t (&p)[NW + 1]) {
#pragma unroll
  for (int j = 0; j <= NW; ++j) {
    const int m = 2 * NW + A + j;
    p[j] = m < NW       ? pv2[m < NW ? m : 0]
           : m < 2 * NW ? pv[m < 2 * NW ? m - NW : 0]
           : m < 3 * NW ? x[m < 3 * NW ? m - 2 * NW : 0]
           : m < 4 * NW ? nx[m < 4 * NW ? m - 3 * NW : 0]
                        : nx2[m < 5 * NW ? m - 4 * NW : 0];
  }
}

// y |= funnel_r(p[k], p[k + 1], s) & mask[k] for this lane's words.
template <int NW>
__device__ __forceinline__ void shift_or(uint32_t (&y)[NW], const uint32_t (&p)[NW + 1], int s,
                                         const uint32_t (&mask)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) y[k] |= __funnelshift_r(p[k], p[k + 1], s) & mask[k];
}

// y |= x shifted by A words and s bits, & mask: any A, by shuffles of the
// lanes lane + a and lane + a + 1 (a = floor(A / NW)) and a pick of the
// words from o = A - a NW on. The rare path (a diagonal outside the
// register classes).
template <int NW>
__device__ __forceinline__ void shift_any(uint32_t (&y)[NW], const uint32_t (&x)[NW], int A, int s,
                                          const uint32_t (&mask)[NW], int lane) {
  const int a = floor_div(A, NW), o = A - a * NW;
  const int s0 = lane + a;
  const bool in0 = s0 >= 0 && s0 < 32, in1 = s0 >= -1 && s0 < 31;
  uint32_t c[2 * NW], p[NW + 1];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t lo = __shfl_sync(kFull, x[k], s0 & 31);
    const uint32_t hi = __shfl_sync(kFull, x[k], (s0 + 1) & 31);
    c[k] = in0 ? lo : 0u;
    c[NW + k] = in1 ? hi : 0u;
  }
#pragma unroll
  for (int oo = 0; oo < NW; ++oo) {
    if (o == oo) {
#pragma unroll
      for (int j = 0; j <= NW; ++j) p[j] = c[oo + j];
    }
  }
  shift_or<NW>(y, p, s, mask);
}

// The triangle's exit row (zero without a triangle) and its word window,
// as both register steps keep them in registers.
template <int NW>
__device__ __forceinline__ void tri_rows(const BB& b, int lane, uint32_t (&exits)[NW],
                                         uint32_t (&win)[NW]) {
  lane_words<NW>(b.row(b.r_tri), lane, exits);  // a row past the accept rows when nf = 0
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int w = lane * NW + k;
    win[k] = w >= b.lo && w < b.hi ? kFull : 0u;
    if (b.nf == 0) exits[k] = 0u;
  }
}

// step_fwd on registers: v = expand(v | gate * seed) & mask[sym] over the
// same tables, with no shared state buffer and no warp barrier.
template <int NW>
struct RegStep {
  static constexpr int KD = kRegMaskWords / NW;  // diagonal slots with their masks in registers
  static constexpr int Wp = 32 * NW;
  int lane;
  uint32_t dm[KD][NW];  // the diagonals' destination masks
  uint32_t seed[NW], acc[NW], exits[NW], win[NW];  // win: the triangle's words

  __device__ __forceinline__ void init(const BB& b, const RegPlan& pl, int ln) {
    lane = ln;
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      const int row = j < pl.n1r ? pl.row1 + j : (j >= KD - pl.n2r ? pl.row2 + KD - 1 - j : -1);
      if (row >= 0) {
        lane_words<NW>(b.row(b.r_diag + row), lane, dm[j]);
      } else {
#pragma unroll
        for (int k = 0; k < NW; ++k) dm[j][k] = 0u;
      }
    }
    tri_rows<NW>(b, lane, exits, win);
    lane_words<NW>(b.row(2), lane, seed);
    lane_words<NW>(b.row(b.r_acc), lane, acc);
  }

  __device__ __forceinline__ void step(const BB& b, const RegPlan& pl, uint32_t (&v)[NW],
                                       bool gate, int sym) const {
    const int mr = b.meta[kMetaSyms + sym];
    uint32_t m[NW];
    lane_words<NW>(b.row(max(mr, 0)), lane, m);
    const uint32_t live = mr >= 0 ? kFull : 0u;
    uint32_t u[NW], y0[NW], y1[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      u[k] = v[k] | (gate ? seed[k] : 0u);
      y0[k] = 0u;
      y1[k] = 0u;
    }
    // the diagonals of A = -1 and A = -2, two OR chains
    uint32_t pv[NW], pv2[NW], p[NW + 1];
    lane_shift<NW, 1>(u, lane, pv);
    if constexpr (NW == 1) {
      lane_shift<NW, 2>(u, lane, pv2);
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) pv2[k] = 0u;  // A = -2 lies in pv and u
    }
    window<NW, -1>(pv2, pv, u, u, u, p);
    const int n1r = opaque(pl.n1r);
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      if (j >= n1r) break;
      shift_or<NW>((j & 1) ? y1 : y0, p, pl.s1[j], dm[j]);
    }
    window<NW, -2>(pv2, pv, u, u, u, p);
    const int n2r = opaque(pl.n2r);
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      if (j >= n2r) break;
      shift_or<NW>((j & 1) ? y0 : y1, p, pl.s2[j], dm[KD - 1 - j]);
    }
    // every other diagonal: its shift and mask from shared memory
    if (opaque(pl.n_rest) > 0) {
      for (int i = 0; i < b.nd; ++i) {
        if ((i >= pl.row1 && i < pl.row1 + pl.n1r) || (i >= pl.row2 && i < pl.row2 + pl.n2r)) {
          continue;
        }
        uint32_t mk[NW];
        lane_words<NW>(b.row(b.r_diag + i), lane, mk);
        shift_any<NW>(y0, u, b.dA[i], b.dS[i], mk, lane);
      }
    }
    // rank-1 columns: column col's bit = any source of its row in u
    for (int i = 0; i < b.n1; ++i) {
      const int col = b.meta[kMetaRank1 + i];
      uint32_t rm[NW];
      lane_words<NW>(b.row(b.r_rank1 + i), lane, rm);
      uint32_t t = 0u;
#pragma unroll
      for (int k = 0; k < NW; ++k) t |= u[k] & rm[k];
      if (__any_sync(kFull, t != 0u)) {
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          if (lane * NW + k == (col >> 5)) y0[k] |= 1u << (col & 31);
        }
      }
    }
    // the triangle: P = exclusive prefix-OR of u & E inside the window
    // [lo, hi) (zero outside it); target p gets any exit q < p - g
    if (b.nf > 0) {
      uint32_t x[NW], pre[NW];
      bool any = false;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        x[k] = u[k] & exits[k];
        any = any || x[k] != 0u;
      }
      bool below = (__ballot_sync(kFull, any) & ((1u << lane) - 1u)) != 0u;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        pre[k] = (((x[k] | (0u - x[k])) << 1) | (below ? kFull : 0u)) & win[k];
        below = below || x[k] != 0u;
      }
      uint32_t ppv[NW], pnx[NW], tg[NW];
      lane_shift<NW, 1>(pre, lane, ppv);
      lane_shift<NW, -1>(pre, lane, pnx);
      const uint32_t* trows = b.row(b.r_tri + 1);
      window<NW, 0>(ppv, ppv, pre, pnx, pnx, p);  // gaps in [-31, 0]
      const int nf0 = opaque(pl.nf0);
#pragma unroll
      for (int f = 0; f < kMaxFam; ++f) {
        if (f >= nf0) break;
        lane_words<NW>(trows + (pl.frow0 + f) * Wp, lane, tg);
        shift_or<NW>(y1, p, pl.sf0[f], tg);
      }
      window<NW, -1>(ppv, ppv, pre, pnx, pnx, p);  // gaps in [1, 32]
      const int nf1 = opaque(pl.nf1);
#pragma unroll
      for (int f = 0; f < kMaxFam; ++f) {
        if (f >= nf1) break;
        lane_words<NW>(trows + (pl.frow1 + f) * Wp, lane, tg);
        shift_or<NW>((f & 1) ? y0 : y1, p, pl.sf1[f], tg);
      }
      if (opaque(pl.nf_rest) > 0) {
        for (int f = 0; f < b.nf; ++f) {
          if ((f >= pl.frow0 && f < pl.frow0 + pl.nf0) ||
              (f >= pl.frow1 && f < pl.frow1 + pl.nf1)) {
            continue;
          }
          lane_words<NW>(trows + f * Wp, lane, tg);
          shift_any<NW>(y1, pre, b.fA[f], b.fS[f], tg, lane);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) v[k] = (y0[k] | y1[k]) & m[k] & live;
  }

  // v meets the accept row of channel c (the same on every lane)
  __device__ __forceinline__ bool accepts(const BB& b, const uint32_t (&v)[NW], int c) const {
    uint32_t a[NW];
    if (c == 0) {
#pragma unroll
      for (int k = 0; k < NW; ++k) a[k] = acc[k];
    } else {
      lane_words<NW>(b.row(b.r_acc + c), lane, a);
    }
    uint32_t t = 0u;
#pragma unroll
    for (int k = 0; k < NW; ++k) t |= v[k] & a[k];
    return __any_sync(kFull, t != 0u) != 0;
  }
};

// S = the exclusive suffix-OR of x inside the triangle's window (x is zero
// outside it): bit p of S is any bit q > p of x. Each word's smear (the bits
// below its highest one) and one __ballot_sync carry from the higher lanes;
// lane l holds the contiguous words l NW .. l NW + NW - 1.
template <int NW>
__device__ __forceinline__ void suffix_excl(const uint32_t (&x)[NW], const uint32_t (&win)[NW],
                                            int lane, uint32_t (&s)[NW]) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < NW; ++k) any = any || x[k] != 0u;
  bool above = (__ballot_sync(kFull, any) & ~((2u << lane) - 1u)) != 0u;
#pragma unroll
  for (int k = NW - 1; k >= 0; --k) {
    const uint32_t in_word = x[k] != 0u ? (kFull >> __clz(x[k])) >> 1 : 0u;
    s[k] = (in_word | (above ? kFull : 0u)) & win[k];
    above = above || x[k] != 0u;
  }
}

// The reverse step of rrx_bitband_reverse on registers, RegStep's mirror
// over the reverse tables (load_bb with rev: the shifts negated, the
// diagonals' masks source-indexed): R = expand_rev((R | acc) & mask[sym])
// taken as expand_rev(u) | E[row] with u = R & mask[sym], the expansion
// distributing over OR, and E[row] = expand_rev(acc & mask[row]) the table's
// extra row per mask row (ops/scan_bitband.with_e_rows). The plan is
// reg_plan's with rev: the diagonals of A = 0 (d in [0, 31]) and A = 1 (d in
// [32, 63]) from the lane's own words and the next lane's (and the one
// after at NW = 1), each slot's mask read from shared memory on the steps
// that run the band step (the registers RegStep gives its masks buy the
// reverse more resident warps, and its skipped steps outnumber the
// others); the families of A = 0 (g in [0, 31]) and A = -1 (g in [-32,
// -1]).
//
// A step whose u is empty on every lane (one __any_sync: the state holds no
// live partial match that the symbol continues) is R = E[row] and skips
// the band step (config 10's reverse state is E of its last symbol's row
// on most steps of a record: only a y met backwards starts a partial
// match). Otherwise the diagonals take one funnel shift and one AND-OR a
// word each; rank-1 column c: bit c
// of u from the one lane that holds it (a shuffle from a warp-uniform
// lane), and if set the column's row ORed in; the triangle per family: the
// exclusive suffix-OR of u & T_g (suffix_excl), shifted by -g and ANDed
// with the exit row.
template <int NW>
struct RevStep {
  static constexpr int KD = kRegMaskWords / NW;  // the plan's slots, as RegStep's
  static constexpr int Wp = 32 * NW;
  int lane, r_e;
  uint32_t init_row[NW], exits[NW], win[NW];

  __device__ __forceinline__ void init(const BB& b, const RegPlan& pl, int ln) {
    lane = ln;
    tri_rows<NW>(b, lane, exits, win);
    lane_words<NW>(b.row(b.r_acc + 1), lane, init_row);
    r_e = b.r_acc + 2;  // the E rows, after the accept seed and the initial-state rows
  }

  __device__ __forceinline__ void step(const BB& b, const RegPlan& pl, uint32_t (&R)[NW],
                                       int sym) const {
    const int mr = b.meta[kMetaSyms + sym];
    uint32_t m[NW], e[NW];
    lane_words<NW>(b.row(max(mr, 0)), lane, m);
    lane_words<NW>(b.row(r_e + max(mr, 0)), lane, e);
    const uint32_t live = mr >= 0 ? kFull : 0u;  // a symbol with no mask row empties R
    uint32_t u[NW];
    bool any = false;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      u[k] = R[k] & m[k] & live;
      any = any || u[k] != 0u;
      R[k] = e[k] & live;
    }
    if (!__any_sync(kFull, any)) return;
    uint32_t y0[NW], y1[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      y0[k] = 0u;
      y1[k] = 0u;
    }
    // the diagonals of A = 0 and A = 1, two OR chains
    uint32_t nx[NW], nx2[NW], p[NW + 1];
    lane_shift<NW, -1>(u, lane, nx);
    if constexpr (NW == 1) {
      lane_shift<NW, -2>(u, lane, nx2);
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) nx2[k] = 0u;  // A = 1 lies in u and nx
    }
    window<NW, 0>(u, u, u, nx, nx2, p);
    uint32_t mk[NW];
    const int n1r = opaque(pl.n1r);
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      if (j >= n1r) break;
      lane_words<NW>(b.row(b.r_diag + pl.row1 + j), lane, mk);
      shift_or<NW>((j & 1) ? y1 : y0, p, pl.s1[j], mk);
    }
    window<NW, 1>(u, u, u, nx, nx2, p);
    const int n2r = opaque(pl.n2r);
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      if (j >= n2r) break;
      lane_words<NW>(b.row(b.r_diag + pl.row2 + j), lane, mk);
      shift_or<NW>((j & 1) ? y0 : y1, p, pl.s2[j], mk);
    }
    // every other diagonal: its shift and mask from shared memory
    if (opaque(pl.n_rest) > 0) {
      for (int i = 0; i < b.nd; ++i) {
        if ((i >= pl.row1 && i < pl.row1 + pl.n1r) || (i >= pl.row2 && i < pl.row2 + pl.n2r)) {
          continue;
        }
        lane_words<NW>(b.row(b.r_diag + i), lane, mk);
        shift_any<NW>(y0, u, b.dA[i], b.dS[i], mk, lane);
      }
    }
    // rank-1 columns: every source in column col's row sees its bit
    for (int i = 0; i < b.n1; ++i) {
      const int col = b.meta[kMetaRank1 + i];
      const int wi = col >> 5;
      uint32_t pick = 0u;
#pragma unroll
      for (int k = 0; k < NW; ++k) pick = k == wi % NW ? u[k] : pick;
      const uint32_t w = __shfl_sync(kFull, pick, wi / NW);
      if ((w >> (col & 31)) & 1u) {
        uint32_t rm[NW];
        lane_words<NW>(b.row(b.r_rank1 + i), lane, rm);
#pragma unroll
        for (int k = 0; k < NW; ++k) y1[k] |= rm[k];
      }
    }
    // the triangle: per family, S = exclusive suffix-OR of u & T_g; exit q
    // gets any target p > q + g
    if (b.nf > 0) {
      const uint32_t* trows = b.row(b.r_tri + 1);
      uint32_t tg[NW], x[NW], sfx[NW], nb[NW];
      const int nf0 = opaque(pl.nf0);
#pragma unroll
      for (int f = 0; f < kMaxFam; ++f) {  // gaps in [0, 31]: S's own and next lane's words
        if (f >= nf0) break;
        lane_words<NW>(trows + (pl.frow0 + f) * Wp, lane, tg);
#pragma unroll
        for (int k = 0; k < NW; ++k) x[k] = u[k] & tg[k];
        suffix_excl<NW>(x, win, lane, sfx);
        lane_shift<NW, -1>(sfx, lane, nb);
        window<NW, 0>(sfx, sfx, sfx, nb, nb, p);
        shift_or<NW>((f & 1) ? y1 : y0, p, pl.sf0[f], exits);
      }
      const int nf1 = opaque(pl.nf1);
#pragma unroll
      for (int f = 0; f < kMaxFam; ++f) {  // gaps in [-32, -1]: the previous lane's words
        if (f >= nf1) break;
        lane_words<NW>(trows + (pl.frow1 + f) * Wp, lane, tg);
#pragma unroll
        for (int k = 0; k < NW; ++k) x[k] = u[k] & tg[k];
        suffix_excl<NW>(x, win, lane, sfx);
        lane_shift<NW, 1>(sfx, lane, nb);
        window<NW, -1>(nb, nb, sfx, sfx, sfx, p);
        shift_or<NW>((f & 1) ? y0 : y1, p, pl.sf1[f], exits);
      }
      if (opaque(pl.nf_rest) > 0) {
        for (int f = 0; f < b.nf; ++f) {
          if ((f >= pl.frow0 && f < pl.frow0 + pl.nf0) ||
              (f >= pl.frow1 && f < pl.frow1 + pl.nf1)) {
            continue;
          }
          lane_words<NW>(trows + f * Wp, lane, tg);
#pragma unroll
          for (int k = 0; k < NW; ++k) x[k] = u[k] & tg[k];
          suffix_excl<NW>(x, win, lane, sfx);
          shift_any<NW>(y1, sfx, b.fA[f], b.fS[f], exits, lane);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) R[k] |= y0[k] | y1[k];
  }

  // an initial state is in R (the same on every lane)
  __device__ __forceinline__ bool starts(const uint32_t (&R)[NW]) const {
    uint32_t t = 0u;
#pragma unroll
    for (int k = 0; k < NW; ++k) t |= R[k] & init_row[k];
    return __any_sync(kFull, t != 0u) != 0;
  }
};

template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_stats_kernel(RRX_BB_PARAMS, int C, int seeded, int nullable, int32_t* cnt_o,
                    int32_t* first_o, int32_t* last_o, uint8_t* full_o, const RegPlan plan) {
  RRX_BB_RECORD(false)
  RegStep<NW> st;
  st.init(bb, plan, lane);
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
  walk_chunks(rec.row, len, [&](int t, int sym) {
    st.step(bb, plan, v, seeded || t < 2, sym);
    bool fl;
    if (C == 1) {
      fl = st.accepts(bb, v, 0);
    } else {
      fl = false;
      for (int c = 0; c < C; ++c) {
        const bool a = st.accepts(bb, v, c);
        if (c == lane) fl = a;
      }
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

// The flag words on the stats kernel's step: bit t & 31 of the open word
// is step t's flag, and the word is stored when it closes (walking up, bit
// 31); lane c keeps channel c's word (lane 0 the only channel's), and after
// the EOS step the open word and the zero words past it are stored.
template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_flags_kernel(RRX_BB_PARAMS, int C, int seeded, uint32_t* words, const RegPlan plan) {
  RRX_BB_RECORD(false)
  const int Wt = (L + 2 + 31) >> 5;
  const long long cols = static_cast<long long>(R) * C;
  uint32_t* out = words + static_cast<long long>(r) * C + lane;  // word i at out[i * cols]
  RegStep<NW> st;
  st.init(bb, plan, lane);
  uint32_t v[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) v[k] = 0;
  uint32_t word = 0;
  walk_chunks(rec.row, len, [&](int t, int sym) {
    st.step(bb, plan, v, seeded || t < 2, sym);
    bool fl;
    if (C == 1) {
      fl = st.accepts(bb, v, 0);
    } else {
      fl = false;
      for (int c = 0; c < C; ++c) {
        const bool a = st.accepts(bb, v, c);
        if (c == lane) fl = a;
      }
    }
    word |= (fl ? 1u : 0u) << (t & 31);
    if ((t & 31) == 31) {  // walking up, bit t closes word t / 32
      if (lane < C) out[(t >> 5) * cols] = word;
      word = 0;
    }
  });
  if (lane < C) {
    const int w_eos = (len + 1) >> 5;
    if (((len + 1) & 31) != 31) out[w_eos * cols] = word;
    for (int i = w_eos + 1; i < Wt; ++i) out[i * cols] = 0u;
  }
}

// The reverse kernel's blocks stay resident and each warp takes its next
// record from the launch's counter (next, zero at launch) when it is done:
// a record whose reverse state stays live runs the band step on every step
// and takes several times as long as one whose steps are skipped, and a
// block of one record per warp would hold its slot until its slowest
// record ends.
template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_reverse_kernel(RRX_BB_PARAMS, uint32_t* hits, int32_t* next, const RegPlan plan) {
  extern __shared__ uint32_t smem[];
  // the records below live (all R without it); a block with none skips the
  // table load (uniform across the block, so before load_bb's barrier)
  const int n_rec = live != nullptr ? min(R, *live) : R;
  if (static_cast<int>(blockIdx.x) * kWarps >= n_rec) return;
  const BB bb = load_bb<NW>(smem, tab_g, meta_g, W, n_rows, true, false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Wt = (L + 2 + 31) >> 5;
  RevStep<NW> st;
  st.init(bb, plan, lane);
  for (int r = static_cast<int>(blockIdx.x) * kWarps + warp; r < n_rec;) {
    const Row rec = record(data, stride, L, lengths, r);
    const int len = rec.len;
    for (int i = ((len + 1) >> 5) + 1 + lane; i < Wt; i += 32) {
      hits[static_cast<long long>(i) * R + r] = 0u;
    }
    uint32_t Rv[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) Rv[k] = 0;
    uint32_t word = 0;
    walk_chunks_rev(rec.row, len, [&](int t, int sym) {
      st.step(bb, plan, Rv, sym);
      word |= (st.starts(Rv) ? 1u : 0u) << (t & 31);
      if ((t & 31) == 0) {
        if (lane == 0) hits[static_cast<long long>(t >> 5) * R + r] = word;
        word = 0;
      }
    });
    int nr = 0;
    if (lane == 0) nr = atomicAdd(next, 1) + static_cast<int>(gridDim.x) * kWarps;
    r = __shfl_sync(kFull, nr, 0);
  }
}

template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_anchor_kernel(RRX_BB_PARAMS, const int32_t* starts, int longest, int32_t* end) {
  RRX_BB_SETUP
  const int e = anchor_end<NW>(bb, vs, ps, rec.row, len, starts[r], longest != 0, lane);
  if (lane == 0) end[r] = e;
}

template <int NW>
__global__ void __launch_bounds__(kBbThreads)
    bb_spans_kernel(RRX_BB_PARAMS, const int32_t* hits, int cap, int longest, int32_t* starts,
                    int32_t* ends, int32_t* cnt, uint8_t* over) {
  RRX_BB_SETUP
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

// The first row and the count of the ascending offsets x[0 .. n) whose
// shift (by sg * x states) has word offset A = floor(-sg * x / 32) == a: a
// contiguous run, since the offsets ascend.
void plan_class(const int* x, int n, int sg, int a, int* first, int* count) {
  int i = 0;
  while (i < n && floor_div(-sg * x[i], 32) != a) ++i;
  int j = i;
  while (j < n && floor_div(-sg * x[j], 32) == a) ++j;
  *first = i;
  *count = j - i;
}

// The register steps' plan (RegPlan) of nd diagonal offsets and nf triangle
// gaps (host arrays, ascending: the spec's diags and tri_gaps, the meta
// header's) at NW words a lane, forward (RegStep: the shift by d) or rev
// (RevStep: the shift by -d). The diagonal classes are the word offsets A
// = -1 and -2 forward (d in [1, 32] and [33, 64]) and A = 0 and 1 reverse
// (d in [0, 31] and [32, 63]); the families' are A = 0 and -1 both ways.
int reg_plan(int NW, int nd, const int* diags, int nf, const int* gaps, bool rev, RegPlan* pl) {
  if (nd < 0 || nd > kMaxDiags || nf < 0 || nf > kMaxFam || (nd > 0 && diags == nullptr) ||
      (nf > 0 && gaps == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < nd + nf; ++i) {
    const bool diag = i < nd;
    const int* x = diag ? diags : gaps;
    const int j = diag ? i : i - nd;
    if (x[j] <= -32 * kMaxWords || x[j] >= 32 * kMaxWords || (j > 0 && x[j - 1] >= x[j])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  *pl = RegPlan{};
  const int KD = kRegMaskWords / NW;
  const int sg = rev ? -1 : 1;
  int n1, n2;
  plan_class(diags, nd, sg, rev ? 0 : -1, &pl->row1, &n1);
  plan_class(diags, nd, sg, rev ? 1 : -2, &pl->row2, &n2);
  pl->n1r = min(n1, KD);
  pl->n2r = min(n2, KD - pl->n1r);
  pl->n_rest = nd - pl->n1r - pl->n2r;
  for (int j = 0; j < pl->n1r; ++j) pl->s1[j] = (-sg * diags[pl->row1 + j]) & 31;
  for (int j = 0; j < pl->n2r; ++j) pl->s2[j] = (-sg * diags[pl->row2 + j]) & 31;
  plan_class(gaps, nf, sg, 0, &pl->frow0, &pl->nf0);
  plan_class(gaps, nf, sg, -1, &pl->frow1, &pl->nf1);
  pl->nf_rest = nf - pl->nf0 - pl->nf1;
  for (int f = 0; f < pl->nf0; ++f) pl->sf0[f] = (-sg * gaps[pl->frow0 + f]) & 31;
  for (int f = 0; f < pl->nf1; ++f) pl->sf1[f] = (-sg * gaps[pl->frow1 + f]) & 31;
  return 0;
}

// `bufs`: the kernel's warps have state buffers (anchor end and spans). One
// block per kWarps records or, `resident` (the reverse, whose warps take
// records from a counter), no more blocks than fit on the card at once.
template <class K, class... Args>
int launch_bb(K kernel, int R, int W, int n_rows, bool bufs, bool resident, void* stream,
              Args... args) {
  if (R == 0) return 0;
  const size_t smem = bb_smem_bytes(W, n_rows, bufs);
  int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  int blocks = (R + kWarps - 1) / kWarps;
  if (resident) {
    int dev = 0, n_sm = 0, per_sm = 0;
    e = static_cast<int>(cudaGetDevice(&dev));
    if (e == 0) {
      e = static_cast<int>(cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev));
    }
    if (e == 0) {
      e = static_cast<int>(
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBbThreads, smem));
    }
    if (e != 0) return e;
    blocks = min(blocks, max(1, n_sm * per_sm));
  }
  kernel<<<blocks, kBbThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int occupancy_bb(K kernel, int W, int n_rows, bool bufs, int* blocks_per_sm) {
  const size_t smem = bb_smem_bytes(W, n_rows, bufs);
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
// cnt, first, last: [R][C] int32; full: [R][C] uint8; then the nd diagonal
// offsets and nf triangle gaps of the table's spec (host int arrays, as in
// meta) for the register step's plan
int rrx_bitband_stats(RRX_BB_HEAD, int C, int seeded, int nullable, void* cnt, void* first,
                      void* last, void* full, int nd, const int* diags, int nf, const int* gaps,
                      void* stream) {
  int bad = check_bb(data, stride, L, R, W, n_rows, C);
  if (bad == 0 && C < 1) bad = static_cast<int>(cudaErrorInvalidValue);
  if (bad != 0) return bad;
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    RegPlan plan;
    const int e = reg_plan(NW, nd, diags, nf, gaps, false, &plan);
    if (e != 0) return e;
    return launch_bb(bb_stats_kernel<NW>, R, W, n_rows, false, false, stream, RRX_BB_ARGS, C,
                     seeded, nullable, static_cast<int32_t*>(cnt), static_cast<int32_t*>(first),
                     static_cast<int32_t*>(last), static_cast<uint8_t*>(full), plan);
  });
}

// words: [ceil((L+2)/32)][R*C] uint32; then the spec's offsets and gaps
// as for stats
int rrx_bitband_flags(RRX_BB_HEAD, int C, int seeded, void* words, int nd, const int* diags,
                      int nf, const int* gaps, void* stream) {
  int bad = check_bb(data, stride, L, R, W, n_rows, C);
  if (bad == 0 && C < 1) bad = static_cast<int>(cudaErrorInvalidValue);
  if (bad != 0) return bad;
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    RegPlan plan;
    const int e = reg_plan(NW, nd, diags, nf, gaps, false, &plan);
    if (e != 0) return e;
    return launch_bb(bb_flags_kernel<NW>, R, W, n_rows, false, false, stream, RRX_BB_ARGS, C,
                     seeded, static_cast<uint32_t*>(words), plan);
  });
}

// tab: the reverse table with its E rows (BitbandTables.tab_r); hits:
// [ceil((L+2)/32)][R]; next: a device int32 set to 0, the record counter
// the warps take work from; then the spec's offsets and gaps as for stats
int rrx_bitband_reverse(RRX_BB_HEAD, void* hits, void* next, int nd, const int* diags, int nf,
                        const int* gaps, void* stream) {
  const int bad = check_bb(data, stride, L, R, W, n_rows, 0);
  if (bad != 0) return bad;
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    RegPlan plan;
    const int e = reg_plan(NW, nd, diags, nf, gaps, true, &plan);
    if (e != 0) return e;
    return launch_bb(bb_reverse_kernel<NW>, R, W, n_rows, false, true, stream, RRX_BB_ARGS,
                     static_cast<uint32_t*>(hits), static_cast<int32_t*>(next), plan);
  });
}

// starts: [R] int32 (-1 inactive); end: [R] int32
int rrx_bitband_anchor_end(RRX_BB_HEAD, const void* starts, int longest, void* end,
                           void* stream) {
  const int bad = check_bb(data, stride, L, R, W, n_rows, 0);
  if (bad != 0) return bad;
  return by_lane_words(W, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    return launch_bb(bb_anchor_kernel<NW>, R, W, n_rows, true, false, stream, RRX_BB_ARGS,
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
    return launch_bb(bb_spans_kernel<NW>, R, W, n_rows, true, false, stream, RRX_BB_ARGS,
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
        return occupancy_bb(bb_stats_kernel<NW>, W, n_rows, false, blocks_per_sm);
      case 1:
        return occupancy_bb(bb_flags_kernel<NW>, W, n_rows, false, blocks_per_sm);
      case 2:
        return occupancy_bb(bb_reverse_kernel<NW>, W, n_rows, false, blocks_per_sm);
      case 3:
        return occupancy_bb(bb_anchor_kernel<NW>, W, n_rows, true, blocks_per_sm);
      case 4:
        return occupancy_bb(bb_spans_kernel<NW>, W, n_rows, true, blocks_per_sm);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

int rrx_bitband_threads_per_block() { return kBbThreads; }

}  // extern "C"
