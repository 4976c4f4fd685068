// Matmul tier on Hopper (sm_90a): match statistics, candidate starts,
// anchored rescans, and lazy and greedy spans of dense programs of up to
// 256 states (the dense128 and dense256 tiers; also the SWAR tier's nullable
// spans and the u32-word tier's spans and windowed scans). The same
// functions for record tiles of 257..1024 states (the dense multiblock
// matmul) run one warp per record in scan_nfa_wide.cu; the multi-channel
// span kernels below have no such form yet.
//
// Replaces six Pallas TPU kernels of the JAX package and the XLA glue
// around them (all in roaringregex_tpu/ops/scan_pallas.py):
//   rrx_nfa_stats        <- _match_kernel_b (via _match_call_b)
//   rrx_nfa_flags        <- _flags_kernel_b (via _flags_call_b) and its
//                           bit-packed form _flags_words_kernel_b
//   rrx_nfa_reverse      <- _reverse_kernel_b (via _reverse_pl); its hit
//                           words are also _reverse_words_kernel_b's output
//   rrx_nfa_anchor_end   <- _anchor_end_kernel_b (via _anchor_pl)
//   rrx_nfa_lazy_spans   <- _span_kernel_b (via _spans_call_b), with the
//                           event-stream compaction after it
//   rrx_nfa_greedy_spans <- _greedy_call_b's while_loop of rounds, each a
//                           first-start search and an anchored longest
//                           rescan (_anchor_end_kernel_b)
// and, for a multi-pattern program (MultiPattern's combined automaton, the
// patterns' positions disjoint, one accept row per pattern):
//   rrx_nfa_stats (P > 1)  <- _match_kernel_b with C = G*P accept channels
//   rrx_nfa_reverse_mb     <- _reverse_kernel_mb (via _spans_call_mb)
//   rrx_nfa_lazy_spans_mb  <- _span_kernel_mb (via _spans_call_mb), with the
//                            per-channel compaction after it
//
// What they compute. The TPU steps G records packed into 128 or 256 lanes
// as y = F_bd^T v (+ c0) in bf16 on the MXU, v = y * mask(byte), with a
// boolean renorm per slab. The same step of one record, in set form over
// the record tile's s_tile states (bit s of word s/32; the initial state is
// bit 0):
//     y = OR of follow[s] over s in v  |  (seed gate ? follow[0] : 0)
//     v = y & mask[sym]
// and the reverse step
//     R = OR of pred[u] over u in (R | acc) & mask[sym];  hit = bit 0 of R.
// sym is the byte at step t (byte t-1), BOS (256) at step 0, EOS (257) at
// step len+1; steps past EOS are dead and change no output, so no kernel
// runs them. BOS and EOS are table rows, never bytes; bytes >= 0x80 have
// zero rows. Per record r with len = clamp(lengths[r], 0, L):
// - stats (_match_kernel_b): seed gate every step when seeded, steps t < 2
//   when not (n_seed = 2). A flag (v & acc != 0) at t > lead has end
//   e = min(t, len): cnt counts flags whose e differs from the last one (the
//   `$` step's duplicate of e == len), except for a nullable seeded scan,
//   whose cnt is len + 1; first keeps the first e, last the latest, full is
//   a flag at t >= len. Nullable starts: first = 0, cnt = len + 1 and
//   last = len (seeded) or cnt = 1 and last = 0 (unseeded), full = len == 0.
// - flags: the raw accept flag of every step (seed gate as stats, no lead,
//   no `$` dedup) as flag words [W][R] uint32 in the layout of the hit
//   words below: 32 steps collected in a register, one coalesced store per
//   word, words past the EOS step zero. 1 bit per step leaves the card
//   where the TPU's _flags_kernel_b wrote an int8.
// - reverse: hit words [W][R] uint32, W = ceil((L+2)/32), bit t of record r
//   in word t/32 (the layout of rrx_swar_reverse, so scan_bits.hit_bits and
//   the span kernels read both).
// - anchor end: seed gate ((st == t-1) | (st == 0 & t <= 1)) & st >= 0;
//   the first (lazy) or last (longest) flag, end = min(t, len); -1 when
//   none; no `$` dedup.
// - lazy spans: claim sp = max(t-1, 0) when idle, the hit is set and
//   pos <= sp <= len; seed at step cur+1 (steps <= 1 when cur == 0); emit
//   (cur, e = min(t, len)) on a flag with e >= cur, then pos = max(e, cur+1)
//   and the state is cleared; after the EOS step an idle record with
//   pos <= len and hit bit len+1 emits the empty match (len, len). Spans go
//   straight into [R][cap] rows (-1 past the count); cnt counts every span,
//   also past cap.
// - greedy spans: rounds of (first start s >= pos, from the hit words, or
//   s = pos for a nullable program, whose every position <= len starts an
//   empty match; e = longest anchored end from s, or s when a nullable
//   program has none; emit if e >= s; pos = max(e, s+1); go on while
//   pos <= len), at most cap rounds; over = still going after them.
//
// Design, and what bounds it on this card:
// - One thread owns one record for its whole stream (a loop in the thread
//   takes the place of the TPU grid's time axis), with its state set in
//   W = ceil(s_tile/32) <= 8 registers; the kernels are templated on W.
// - The tile's rows live in shared memory: follow [S][W], pred [S][W],
//   mask [259][W], acc [W]: at s_tile 256, 24.7 KB per block. A step costs
//   popcount(v) row loads of W words plus the mask row, so its work follows
//   the data: keyword alternations keep 1-3 states live, a{1,n}-style
//   programs many. Records of one warp take different trip counts through
//   the set-bit loop (warp divergence).
// - HBM: one input byte per scanned byte, read 16 bytes at a time with the
//   next 16 prefetched (scan_core.cuh's walkers), plus 1 bit per step of hit
//   words for the reverse pass. At 1 GiB that is ~0.32 ms of the card's
//   3.35 TB/s, far under the integer work: every step is a dependent chain
//   (shared loads, ORs, the accept test and the bookkeeping), so a pass is
//   bound by integer issue and by that chain's latency, which many resident
//   records hide and a short batch cannot.
// - Anchored rescans start at their seed step and stop at the first 16-byte
//   chunk boundary with an empty state set (or, lazy, once an end is found),
//   so a greedy round costs the match's length, not the record's.
//
// Accept channels (P accept rows after the mask rows; the single-channel
// kernels above read row 0 and run only with P = 1):
// - stats, P > 1: per channel the bookkeeping of the stats kernel (its own
//   `$` dedup e != last, first, full), outputs [R][P]. The union of the
//   accept rows is tested first (W ANDs); only an accepting step walks the
//   channels.
// - reverse_mb: the reverse step with the union of the accept rows joining
//   (state 0 is in no mask row, so it steps as the program's accept set
//   does), and per channel p the hit x & sg_p != 0 of x = (R | acc) &
//   mask[sym], taken before R is updated (sg_p = follow[0] restricted to
//   pattern p's positions; x & follow[0] == 0 skips the channels). Hit words
//   [P][W][R]: channel p's block is the single-channel layout.
// - lazy_spans_mb: one forward walk in which each channel claims, seeds
//   (sg_p: the same row serves as the TPU's c0m column), emits on its own
//   accept row and, on an emit, clears its positions (posm_p) from the
//   shared state, which is the TPU's kill. The accept tests of one step all
//   read the state before that step's kills. Spans go straight into
//   [R][P][cap] rows; cnt [R][P] counts past cap.
// - Per (record, channel) bookkeeping (stats: cnt, first, last, full; spans:
//   cur, pos, cnt and the current hit word): in registers for at most
//   kRegChannels channels, the channel loops unrolled over that count; above
//   it in per-thread rows of global memory (the outputs, or a [R][P][2]
//   scratch from the wrapper for cur and pos), which stay in L1. P is not
//   capped: a combined automaton of <= 256 states has P <= 255 (more with
//   patterns that add no state).
// - The span-channel rows [P][2][W] (sg_p, posm_p) sit in shared memory after
//   the tile's rows: at s_tile 256 and P = 255 that is 24.7 + 8.2 + 16.3 KB.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "scan_core.cuh"
#include "scan_nfa.cuh"

namespace {

using namespace rrx;

// Anchored rescan of one record from start st: the first (lazy) or last
// (longest) accept step as an end clipped to len, -1 when none.
template <int W>
__device__ __forceinline__ int anchor_scan(const Nfa<W>& nfa, const Row& rec, int st,
                                           bool longest) {
  const int len = rec.len;
  if (st < 0 || st > len) return -1;  // seed step dead or never reached
  uint32_t v[W];
  clear(v);
  int first = -1, last = -1;
  auto step = [&](int t, int sym) {
    nfa.fwd(v, t == st + 1 || (st == 0 && t <= 1), sym);
    if (nfa.accepts(v)) {
      first = first < 0 ? t : first;
      last = t;
    }
  };
  // past the seed step an empty state set stays empty
  auto done = [&] { return empty(v) || (!longest && first >= 0); };
  if (st == 0) step(0, kBos);
  walk_fwd(rec.row, st, len, step, done);
  if (st == len || !done()) step(len + 1, kEos);
  const int t = longest ? last : first;
  return t < 0 ? -1 : min(t, len);
}

#define NFA_KERNEL_HEAD                                                                   \
  const uint8_t *__restrict__ data, long long stride, int L,                              \
      const int32_t *__restrict__ lengths, int R, const uint32_t *__restrict__ tab_g, int S

#define NFA_KERNEL_BEGIN                                   \
  extern __shared__ uint32_t smem[];                      \
  const Nfa<W> nfa = load_nfa<W>(smem, tab_g, S);         \
  const int r = blockIdx.x * blockDim.x + threadIdx.x;    \
  if (r >= R) return;                                     \
  const Row rec = record(data, stride, L, lengths, r);    \
  const int len = rec.len

template <int W>
__global__ void __launch_bounds__(kThreads)
nfa_stats_kernel(NFA_KERNEL_HEAD, int seeded, int lead, int nullable, int32_t* __restrict__ cnt_o,
                 int32_t* __restrict__ first_o, int32_t* __restrict__ last_o,
                 uint8_t* __restrict__ full_o) {
  NFA_KERNEL_BEGIN;
  const bool dedup = !(nullable && seeded);
  int cnt = 0, first = -1, last = -1;
  bool full = false;
  if (nullable) {
    cnt = seeded ? len + 1 : 1;
    last = seeded ? len : 0;
    first = 0;
    full = len == 0;
  }
  uint32_t v[W];
  clear(v);
  auto step = [&](int t, int sym) {
    nfa.fwd(v, seeded || t < 2, sym);
    if (t > lead && nfa.accepts(v)) {
      const int e = min(t, len);
      cnt += (dedup && e != last) ? 1 : 0;
      first = first < 0 ? e : first;
      last = e;
      full = full || t >= len;
    }
  };
  step(0, kBos);
  walk_fwd(rec.row, 0, len, step, [] { return false; });
  step(len + 1, kEos);
  cnt_o[r] = cnt;
  first_o[r] = first;
  last_o[r] = last;
  full_o[r] = full ? 1 : 0;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
nfa_flags_kernel(NFA_KERNEL_HEAD, int seeded, uint32_t* __restrict__ flags) {
  NFA_KERNEL_BEGIN;
  const int Wh = (L + 2 + 31) >> 5;
  uint32_t v[W];
  clear(v);
  uint32_t word = 0u;
  auto step = [&](int t, int sym) {
    nfa.fwd(v, seeded || t < 2, sym);
    word |= (nfa.accepts(v) ? 1u : 0u) << (t & 31);
    if ((t & 31) == 31) {  // walking up, bit t closes word t / 32
      flags[(size_t)(t >> 5) * R + r] = word;
      word = 0u;
    }
  };
  step(0, kBos);
  walk_fwd(rec.row, 0, len, step, [] { return false; });
  step(len + 1, kEos);
  const int w_eos = (len + 1) >> 5;
  if (((len + 1) & 31) != 31) flags[(size_t)w_eos * R + r] = word;
  for (int w = w_eos + 1; w < Wh; ++w) flags[(size_t)w * R + r] = 0u;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
nfa_reverse_kernel(NFA_KERNEL_HEAD, uint32_t* __restrict__ hits) {
  NFA_KERNEL_BEGIN;
  const int Wh = (L + 2 + 31) >> 5;
  for (int w = ((len + 1) >> 5) + 1; w < Wh; ++w) hits[(size_t)w * R + r] = 0u;
  uint32_t rs[W];
  clear(rs);
  uint32_t word = 0u;
  auto step = [&](int t, int sym) {
    nfa.rev(rs, sym);
    word |= (rs[0] & 1u) << (t & 31);
    if ((t & 31) == 0) {  // walking down, bit t closes word t / 32
      hits[(size_t)(t >> 5) * R + r] = word;
      word = 0u;
    }
  };
  step(len + 1, kEos);
  walk_rev(rec.row, len, step);
  step(0, kBos);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
nfa_anchor_end_kernel(NFA_KERNEL_HEAD, const int32_t* __restrict__ starts, int longest,
                      int32_t* __restrict__ end_o) {
  NFA_KERNEL_BEGIN;
  (void)len;
  end_o[r] = anchor_scan(nfa, rec, starts[r], longest != 0);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
nfa_lazy_spans_kernel(NFA_KERNEL_HEAD, const uint32_t* __restrict__ hits, int cap,
                      int32_t* __restrict__ starts_o, int32_t* __restrict__ ends_o,
                      int32_t* __restrict__ cnt_o) {
  NFA_KERNEL_BEGIN;
  int32_t* so = starts_o + (size_t)r * cap;
  int32_t* eo = ends_o + (size_t)r * cap;
  uint32_t v[W];
  clear(v);
  uint32_t hw = 0u;
  int pos = 0, cur = -1, cnt = 0;
  auto step = [&](int t, int sym) {
    if ((t & 31) == 0) hw = __ldg(hits + (size_t)(t >> 5) * R + r);
    const int sp = max(t - 1, 0);
    if (cur < 0 && ((hw >> (t & 31)) & 1u) && pos <= sp && sp <= len) cur = sp;
    nfa.fwd(v, cur >= 0 && (cur == t - 1 || (cur == 0 && t <= 1)), sym);
    const int e = min(t, len);
    if (cur >= 0 && e >= cur && nfa.accepts(v)) {
      if (cnt < cap) {
        so[cnt] = cur;
        eo[cnt] = e;
      }
      ++cnt;
      pos = max(e, cur + 1);
      cur = -1;
      clear(v);
    }
  };
  step(0, kBos);
  walk_fwd(rec.row, 0, len, step, [] { return false; });
  step(len + 1, kEos);
  // the empty match at len, whose start hit the EOS step read while a span
  // ending at that step still held cur (see scan_spans.cu)
  if (cur < 0 && pos <= len && ((hw >> ((len + 1) & 31)) & 1u)) {
    if (cnt < cap) {
      so[cnt] = len;
      eo[cnt] = len;
    }
    ++cnt;
  }
  fill_tail(so, eo, min(cnt, cap), cap);
  cnt_o[r] = cnt;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
nfa_greedy_spans_kernel(NFA_KERNEL_HEAD, const uint32_t* __restrict__ hits, int cap,
                        int nullable, int32_t* __restrict__ starts_o,
                        int32_t* __restrict__ ends_o, int32_t* __restrict__ cnt_o,
                        uint8_t* __restrict__ over_o) {
  NFA_KERNEL_BEGIN;
  const int w_top = (len + 1) >> 5;  // hit words past it are 0
  int32_t* so = starts_o + (size_t)r * cap;
  int32_t* eo = ends_o + (size_t)r * cap;
  int pos = 0, n = 0;
  bool active = true;
  for (int round = 0; round < cap && active; ++round) {
    int s = pos;  // nullable: every position <= len starts an empty match
    if (!nullable) {
      const int thr = pos > 0 ? pos + 1 : 0;  // steps 0 and 1 both start at 0
      int t = -1;
      for (int w = thr >> 5; w <= w_top; ++w) {
        uint32_t hw = __ldg(hits + (size_t)w * R + r);
        if (w == thr >> 5) hw &= ~0u << (thr & 31);
        if (hw != 0u) {
          t = 32 * w + __ffs(hw) - 1;
          break;
        }
      }
      s = t < 0 ? len + 1 : max(t - 1, 0);
    }
    if (s > len) {
      active = false;
      break;
    }
    int e = anchor_scan(nfa, rec, s, true);
    if (nullable && e < s) e = s;  // the empty match at s
    if (e < s) {
      active = false;
      break;
    }
    so[n] = s;
    eo[n] = e;
    ++n;
    pos = max(e, s + 1);
    active = pos <= len;
  }
  fill_tail(so, eo, n, cap);
  cnt_o[r] = n;
  over_o[r] = active ? 1 : 0;
}

// Stats with P accept channels: cnt, first, last, full per channel.
template <int W, int kP>
__global__ void __launch_bounds__(kThreads)
nfa_stats_mc_kernel(NFA_KERNEL_HEAD, int P, int seeded, int lead, int nullable,
                    int32_t* __restrict__ cnt_o, int32_t* __restrict__ first_o,
                    int32_t* __restrict__ last_o, uint8_t* __restrict__ full_o) {
  extern __shared__ uint32_t smem[];
  const Nfa<W> nfa = load_nfa<W>(smem, tab_g, S, P);
  const uint32_t* accs = smem + (2 * S + kSyms) * W;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Row rec = record(data, stride, L, lengths, r);
  const int len = rec.len;
  const size_t row = static_cast<size_t>(r) * P;
  // cnt, first, last: registers, or the outputs' rows (full: its own row)
  int32_t* const rows[3] = {cnt_o + row, first_o + row, last_o + row};
  ChanRegs<kP, 3> ch(rows);
  bool full_r[kP > 0 ? kP : 1];
  const bool dedup = !(nullable && seeded);
#pragma unroll
  for (int p = 0; p < chan_bound<kP>(P); ++p) {
    if (kP > 0 && p >= P) break;
    ch.at(0, p) = nullable ? (seeded ? len + 1 : 1) : 0;
    ch.at(1, p) = nullable ? 0 : -1;
    ch.at(2, p) = nullable ? (seeded ? len : 0) : -1;
    const bool f0 = nullable && len == 0;
    if constexpr (kP > 0) {
      full_r[p] = f0;
    } else {
      full_o[row + p] = f0 ? 1 : 0;
    }
  }
  uint32_t v[W];
  clear(v);
  auto step = [&](int t, int sym) {
    nfa.fwd(v, seeded || t < 2, sym);
    if (t <= lead || !nfa.accepts(v)) return;
    const int e = min(t, len);
#pragma unroll
    for (int p = 0; p < chan_bound<kP>(P); ++p) {
      if (kP > 0 && p >= P) break;
      if (!meets(v, accs + p * W)) continue;
      int& last = ch.at(2, p);
      ch.at(0, p) += (dedup && e != last) ? 1 : 0;
      ch.at(1, p) = ch.at(1, p) < 0 ? e : ch.at(1, p);
      last = e;
      if (t >= len) {
        if constexpr (kP > 0) {
          full_r[p] = true;
        } else {
          full_o[row + p] = 1;
        }
      }
    }
  };
  walk_steps(rec.row, len, step);
  if constexpr (kP > 0) {
#pragma unroll
    for (int p = 0; p < chan_bound<kP>(P); ++p) {
      if (p >= P) break;
      cnt_o[row + p] = ch.at(0, p);
      first_o[row + p] = ch.at(1, p);
      last_o[row + p] = ch.at(2, p);
      full_o[row + p] = full_r[p] ? 1 : 0;
    }
  }
}

// Hit words of the P channels of one record while the reverse walk fills
// them: registers for at most kP channels, written when a word closes; else
// the words themselves in global memory, zeroed when a word opens.
template <int kP>
struct HitWords {
  uint32_t w_[kP];
  __device__ __forceinline__ void open(uint32_t*, int, size_t, int P) {
#pragma unroll
    for (int p = 0; p < kP; ++p) w_[p] = 0u;
    (void)P;
  }
  __device__ __forceinline__ void set(uint32_t*, size_t, int p, uint32_t bit) { w_[p] |= bit; }
  __device__ __forceinline__ void close(uint32_t* hits, size_t at, size_t plane, int P) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p >= P) break;
      hits[at + p * plane] = w_[p];
    }
  }
};

template <>
struct HitWords<0> {
  __device__ __forceinline__ void open(uint32_t* hits, size_t at, size_t plane, int P) {
    for (int p = 0; p < P; ++p) hits[at + p * plane] = 0u;
  }
  __device__ __forceinline__ void set(uint32_t* hits, size_t at, int p, uint32_t bit) {
    (void)p;
    hits[at] |= bit;
  }
  __device__ __forceinline__ void close(uint32_t*, size_t, size_t, int) {}
};

// span: [P][2][W] rows (sg_p, posm_p); hits: [P][Wh][R]
template <int W, int kP>
__global__ void __launch_bounds__(kThreads)
nfa_reverse_mb_kernel(NFA_KERNEL_HEAD, int P, const uint32_t* __restrict__ span_g,
                      uint32_t* __restrict__ hits) {
  extern __shared__ uint32_t smem[];
  const Nfa<W> nfa = load_nfa<W>(smem, tab_g, S, P, span_g, 2 * P * W);
  const uint32_t* span = smem + (2 * S + kSyms + P) * W;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Row rec = record(data, stride, L, lengths, r);
  const int len = rec.len;
  const int Wh = (L + 2 + 31) >> 5;
  const size_t plane = static_cast<size_t>(Wh) * R;  // one channel's block
  for (int p = 0; p < P; ++p) {
    for (int w = ((len + 1) >> 5) + 1; w < Wh; ++w) hits[p * plane + (size_t)w * R + r] = 0u;
  }
  uint32_t rs[W];
  clear(rs);
  HitWords<kP> hw;
  auto step = [&](int t, int sym) {
    const size_t at = (size_t)(t >> 5) * R + r;
    if (t == len + 1 || (t & 31) == 31) hw.open(hits, at, plane, P);
    const uint32_t* m = nfa.mask + sym * W;
    uint32_t x[W];
#pragma unroll
    for (int k = 0; k < W; ++k) x[k] = (rs[k] | nfa.acc[k]) & m[k];
    if (meets(x, nfa.follow)) {  // follow[0]: the union of the sg rows
      const uint32_t bit = 1u << (t & 31);
#pragma unroll
      for (int p = 0; p < chan_bound<kP>(P); ++p) {
        if (kP > 0 && p >= P) break;
        if (meets(x, span + 2 * p * W)) hw.set(hits, at + p * plane, p, bit);
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) rs[k] = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t b = x[w];
      while (b != 0u) {
        const uint32_t* pr = nfa.pred + (32 * w + __ffs(b) - 1) * W;
        b &= b - 1u;
#pragma unroll
        for (int k = 0; k < W; ++k) rs[k] |= pr[k];
      }
    }
    if ((t & 31) == 0) hw.close(hits, at, plane, P);  // walking down, bit t closes word t / 32
  };
  walk_steps_rev(rec.row, len, step);
}

// span: [P][2][W] rows (sg_p, posm_p); hits: [P][Wh][R] from
// rrx_nfa_reverse_mb; starts, ends: [R][P][cap]; cnt: [R][P]; scratch:
// [R][P][2] (cur, pos) when P > kRegChannels
template <int W, int kP>
__global__ void __launch_bounds__(kThreads)
nfa_lazy_spans_mb_kernel(NFA_KERNEL_HEAD, int P, const uint32_t* __restrict__ span_g,
                         const uint32_t* __restrict__ hits, int cap,
                         int32_t* __restrict__ starts_o, int32_t* __restrict__ ends_o,
                         int32_t* __restrict__ cnt_o, int32_t* __restrict__ scratch) {
  extern __shared__ uint32_t smem[];
  const Nfa<W> nfa = load_nfa<W>(smem, tab_g, S, P, span_g, 2 * P * W);
  const uint32_t* accs = smem + (2 * S + kSyms) * W;
  const uint32_t* span = accs + P * W;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Row rec = record(data, stride, L, lengths, r);
  const int len = rec.len;
  const int Wh = (L + 2 + 31) >> 5;
  const size_t plane = static_cast<size_t>(Wh) * R;
  const size_t row = static_cast<size_t>(r) * P;
  // per channel: cur (-1 idle), pos, cnt
  int32_t* const rows[3] = {kP > 0 ? nullptr : scratch + 2 * row,
                            kP > 0 ? nullptr : scratch + 2 * row + P, cnt_o + row};
  ChanRegs<kP, 3> ch(rows);
  uint32_t hw_r[kP > 0 ? kP : 1];
#pragma unroll
  for (int p = 0; p < chan_bound<kP>(P); ++p) {
    if (kP > 0 && p >= P) break;
    ch.at(0, p) = -1;
    ch.at(1, p) = 0;
    ch.at(2, p) = 0;
  }
  uint32_t v[W];
  clear(v);
  auto step = [&](int t, int sym) {
    const int sp = max(t - 1, 0);
    const size_t at = (size_t)(t >> 5) * R + r;
    uint32_t seed[W];
#pragma unroll
    for (int k = 0; k < W; ++k) seed[k] = 0u;
#pragma unroll
    for (int p = 0; p < chan_bound<kP>(P); ++p) {
      if (kP > 0 && p >= P) break;
      int& cur = ch.at(0, p);
      uint32_t hw;
      if constexpr (kP > 0) {
        if ((t & 31) == 0) hw_r[p] = __ldg(hits + at + p * plane);
        hw = hw_r[p];
      } else {
        hw = cur < 0 ? __ldg(hits + at + p * plane) : 0u;
      }
      if (cur < 0 && ((hw >> (t & 31)) & 1u) && ch.at(1, p) <= sp && sp <= len) cur = sp;
      if (cur >= 0 && (cur == t - 1 || (cur == 0 && t <= 1))) {
        const uint32_t* sg = span + 2 * p * W;
#pragma unroll
        for (int k = 0; k < W; ++k) seed[k] |= sg[k];
      }
    }
    nfa.fwd_seed(v, seed, sym);
    if (!nfa.accepts(v)) return;
    const int e = min(t, len);
    uint32_t vf[W];  // the accept tests read the state before this step's kills
#pragma unroll
    for (int k = 0; k < W; ++k) vf[k] = v[k];
#pragma unroll
    for (int p = 0; p < chan_bound<kP>(P); ++p) {
      if (kP > 0 && p >= P) break;
      int& cur = ch.at(0, p);
      if (cur < 0 || e < cur || !meets(vf, accs + p * W)) continue;
      int& n = ch.at(2, p);
      if (n < cap) {
        starts_o[(row + p) * cap + n] = cur;
        ends_o[(row + p) * cap + n] = e;
      }
      ++n;
      ch.at(1, p) = max(e, cur + 1);
      cur = -1;
      const uint32_t* pm = span + (2 * p + 1) * W;
#pragma unroll
      for (int k = 0; k < W; ++k) v[k] &= ~pm[k];
    }
  };
  walk_steps(rec.row, len, step);
  const size_t at_eos = (size_t)((len + 1) >> 5) * R + r;
#pragma unroll
  for (int p = 0; p < chan_bound<kP>(P); ++p) {
    if (kP > 0 && p >= P) break;
    // the empty match at len after a span that ended at the EOS step, per
    // channel (see nfa_lazy_spans_kernel)
    if (ch.at(0, p) < 0 && ch.at(1, p) <= len &&
        ((__ldg(hits + at_eos + p * plane) >> ((len + 1) & 31)) & 1u)) {
      int& n = ch.at(2, p);
      if (n < cap) {
        starts_o[(row + p) * cap + n] = len;
        ends_o[(row + p) * cap + n] = len;
      }
      ++n;
    }
    const int n = ch.at(2, p);
    fill_tail(starts_o + (row + p) * cap, ends_o + (row + p) * cap, min(n, cap), cap);
    if constexpr (kP > 0) cnt_o[row + p] = n;
  }
}

template <class K, class... Args>
int launch_smem(K kernel, int R, size_t smem, void* stream, Args... args) {
  if (R == 0) return 0;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const int blocks = (R + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class K, class... Args>
int launch(K kernel, int R, int S, int W, void* stream, Args... args) {
  if (R == 0) return 0;
  const size_t smem = nfa_smem_bytes(S, W);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const int blocks = (R + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int occupancy(K kernel, int S, int W, int* blocks_per_sm, int P = 1, int extra = 0) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, nfa_smem_bytes(S, W, P, extra)));
}

// Calls f(integral_constant<int, kP>) for the channel bookkeeping of P
// channels: registers up to kRegChannels, else global rows (kP = 0).
template <class F>
int by_channels(int P, F&& f) {
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (P <= kRegChannels) return f(std::integral_constant<int, kRegChannels>{});
  return f(std::integral_constant<int, 0>{});
}

}  // namespace

namespace rrx {

int nfa_channels_occupancy(int kernel, int s_tile, int P, int* blocks_per_sm) {
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return by_channels(P, [&](auto c) {
      constexpr int kP = decltype(c)::value;
      switch (kernel) {
        case 0:
          return occupancy(nfa_stats_mc_kernel<W, kP>, s_tile, W, blocks_per_sm, P);
        case 1:
          return occupancy(nfa_reverse_mb_kernel<W, kP>, s_tile, W, blocks_per_sm, P, 2 * P * W);
        case 2:
          return occupancy(nfa_lazy_spans_mb_kernel<W, kP>, s_tile, W, blocks_per_sm, P,
                           2 * P * W);
        default:
          return static_cast<int>(cudaErrorInvalidValue);
      }
    });
  });
}

int nfa_occupancy(int kernel, int s_tile, int* blocks_per_sm) {
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    switch (kernel) {
      case 0:
        return occupancy(nfa_stats_kernel<W>, s_tile, W, blocks_per_sm);
      case 1:
        return occupancy(nfa_reverse_kernel<W>, s_tile, W, blocks_per_sm);
      case 2:
        return occupancy(nfa_anchor_end_kernel<W>, s_tile, W, blocks_per_sm);
      case 3:
        return occupancy(nfa_lazy_spans_kernel<W>, s_tile, W, blocks_per_sm);
      case 4:
        return occupancy(nfa_greedy_spans_kernel<W>, s_tile, W, blocks_per_sm);
      case 5:
        return occupancy(nfa_flags_kernel<W>, s_tile, W, blocks_per_sm);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

}  // namespace rrx

#define RRX_NFA_HEAD \
  const void *data, long long stride, int L, const void *lengths, int R, const void *tab, int s_tile
#define RRX_NFA_ARGS                                                                     \
  static_cast<const uint8_t*>(data), stride, L, static_cast<const int32_t*>(lengths), R, \
      static_cast<const uint32_t*>(tab), s_tile

extern "C" {

// P accept rows in the table; cnt, first, last: [R][P] int32; full: [R][P]
// uint8; lead < 0 = no lead. P = 1 runs the single-channel kernel.
int rrx_nfa_stats(RRX_NFA_HEAD, int P, int seeded, int lead, int nullable, void* cnt,
                  void* first, void* last, void* full, void* stream) {
  const int bad = check_rows(data, stride, L, R);
  if (bad != 0) return bad;
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if (P == 1) {
      return launch(nfa_stats_kernel<W>, R, s_tile, W, stream, RRX_NFA_ARGS, seeded, lead,
                    nullable, static_cast<int32_t*>(cnt), static_cast<int32_t*>(first),
                    static_cast<int32_t*>(last), static_cast<uint8_t*>(full));
    }
    return by_channels(P, [&](auto c) {
      constexpr int kP = decltype(c)::value;
      return launch_smem(nfa_stats_mc_kernel<W, kP>, R, nfa_smem_bytes(s_tile, W, P), stream,
                         RRX_NFA_ARGS, P, seeded, lead, nullable, static_cast<int32_t*>(cnt),
                         static_cast<int32_t*>(first), static_cast<int32_t*>(last),
                         static_cast<uint8_t*>(full));
    });
  });
}

// P accept rows in the table; span: [P][2][W] uint32; hits: [P][ceil((L+2)/32)][R]
int rrx_nfa_reverse_mb(RRX_NFA_HEAD, int P, const void* span, void* hits, void* stream) {
  const int bad = check_rows(data, stride, L, R);
  if (bad != 0) return bad;
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return by_channels(P, [&](auto c) {
      constexpr int kP = decltype(c)::value;
      return launch_smem(nfa_reverse_mb_kernel<W, kP>, R, nfa_smem_bytes(s_tile, W, P, 2 * P * W),
                         stream, RRX_NFA_ARGS, P, static_cast<const uint32_t*>(span),
                         static_cast<uint32_t*>(hits));
    });
  });
}

// hits from rrx_nfa_reverse_mb; starts, ends: [R][P][cap] int32; cnt: [R][P]
// int32; scratch: [R][P][2] int32 when P > 8 (else unread)
int rrx_nfa_lazy_spans_mb(RRX_NFA_HEAD, int P, const void* span, const void* hits, int cap,
                          void* starts, void* ends, void* cnt, void* scratch, void* stream) {
  const int bad = check_rows(data, stride, L, R);
  if (bad != 0) return bad;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return by_channels(P, [&](auto c) {
      constexpr int kP = decltype(c)::value;
      return launch_smem(nfa_lazy_spans_mb_kernel<W, kP>, R,
                         nfa_smem_bytes(s_tile, W, P, 2 * P * W), stream, RRX_NFA_ARGS, P,
                         static_cast<const uint32_t*>(span), static_cast<const uint32_t*>(hits),
                         cap, static_cast<int32_t*>(starts), static_cast<int32_t*>(ends),
                         static_cast<int32_t*>(cnt), static_cast<int32_t*>(scratch));
    });
  });
}

// flags: [ceil((L+2)/32)][R] uint32, bit t = step t's accept flag
int rrx_nfa_flags(RRX_NFA_HEAD, int seeded, void* flags, void* stream) {
  const int bad = check_rows(data, stride, L, R);
  if (bad != 0) return bad;
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return launch(nfa_flags_kernel<W>, R, s_tile, W, stream, RRX_NFA_ARGS, seeded,
                  static_cast<uint32_t*>(flags));
  });
}

// hits: [ceil((L+2)/32)][R] uint32
int rrx_nfa_reverse(RRX_NFA_HEAD, void* hits, void* stream) {
  const int bad = check_rows(data, stride, L, R);
  if (bad != 0) return bad;
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return launch(nfa_reverse_kernel<W>, R, s_tile, W, stream, RRX_NFA_ARGS,
                  static_cast<uint32_t*>(hits));
  });
}

// starts: [R] int32 (-1 = inactive); end: [R] int32
int rrx_nfa_anchor_end(RRX_NFA_HEAD, const void* starts, int longest, void* end, void* stream) {
  const int bad = check_rows(data, stride, L, R);
  if (bad != 0) return bad;
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return launch(nfa_anchor_end_kernel<W>, R, s_tile, W, stream, RRX_NFA_ARGS,
                  static_cast<const int32_t*>(starts), longest, static_cast<int32_t*>(end));
  });
}

// hits from rrx_nfa_reverse; starts, ends: [R][cap] int32; cnt: [R] int32
int rrx_nfa_lazy_spans(RRX_NFA_HEAD, const void* hits, int cap, void* starts, void* ends,
                       void* cnt, void* stream) {
  const int bad = check_rows(data, stride, L, R);
  if (bad != 0) return bad;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return launch(nfa_lazy_spans_kernel<W>, R, s_tile, W, stream, RRX_NFA_ARGS,
                  static_cast<const uint32_t*>(hits), cap, static_cast<int32_t*>(starts),
                  static_cast<int32_t*>(ends), static_cast<int32_t*>(cnt));
  });
}

// as rrx_nfa_lazy_spans, plus nullable and over: [R] uint8
int rrx_nfa_greedy_spans(RRX_NFA_HEAD, const void* hits, int cap, int nullable, void* starts,
                         void* ends, void* cnt, void* over, void* stream) {
  const int bad = check_rows(data, stride, L, R);
  if (bad != 0) return bad;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return launch(nfa_greedy_spans_kernel<W>, R, s_tile, W, stream, RRX_NFA_ARGS,
                  static_cast<const uint32_t*>(hits), cap, nullable,
                  static_cast<int32_t*>(starts), static_cast<int32_t*>(ends),
                  static_cast<int32_t*>(cnt), static_cast<uint8_t*>(over));
  });
}

}  // extern "C"
