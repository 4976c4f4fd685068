// Dense multiblock matmul tier on Hopper (sm_90a): match statistics, forward
// flags, candidate starts, anchored rescans, and lazy and greedy spans of
// dense programs of 257..1024 states (record tiles of s_tile 384..1024,
// W = s_tile/32 = 12..32 state words), one warp per record. scan_nfa.cu
// runs the same functions for tiles of up to 256 states, one thread per
// record.
//
// Replaces, at those tiles, eight Pallas TPU kernels of the JAX package and
// the XLA glue around them (all in roaringregex_tpu/ops/scan_pallas.py; rows
// 14-22 of PERF.md's table):
//   rrx_nfa_wide_stats        <- _match_kernel_b (via _match_call_b), with
//                                P accept channels (C = G*P there)
//   rrx_nfa_wide_flags        <- _flags_kernel_b (via _flags_call_b) and its
//                                bit-packed form _flags_words_kernel_b
//   rrx_nfa_wide_reverse      <- _reverse_kernel_b (via _reverse_pl); its hit
//                                words are also _reverse_words_kernel_b's
//   rrx_nfa_wide_anchor_end   <- _anchor_end_kernel_b (via _anchor_pl)
//   rrx_nfa_wide_lazy_spans   <- _span_kernel_b (via _spans_call_b), with the
//                                event-stream compaction after it
//   rrx_nfa_wide_greedy_spans <- _greedy_call_b's while_loop of rounds
//   rrx_nfa_wide_reverse_mb   <- _reverse_kernel_mb (via _spans_call_mb): the
//                                hit words of P accept channels, one pass
//   rrx_nfa_wide_lazy_spans_mb <- _span_kernel_mb (via _spans_call_mb), with
//                                the compaction after it: every channel's
//                                lazy spans from one forward pass
// The TPU's banded diag_ks form of a multiblock program (banded_offsets,
// _apply_ft) is a layout of the same function: the set form below serves
// banded programs too.
//
// What they compute: exactly what scan_nfa.cu's kernels compute (its header
// states the semantics: the seed gates, the `$` dedup, the nullable starts,
// the lazy spans' empty match at len after the EOS step, the greedy rounds),
// over the same table (scan_pallas.nfa_tables: follow [S][W], pred [S][W],
// mask [kSyms][W], P accept rows [P][W]). In set form one forward step is
//     v = (OR of follow[s] over s in v | seed gate ? follow[0] : 0) & mask[sym]
// and one reverse step
//     R = OR of pred[u] over u in (R | acc) & mask[sym];  hit = state 0 in R.
//
// Design, and what bounds it on this card:
// - One warp per record: lane l < W holds state word l in one register;
//   lanes >= W hold zero and take part in every shuffle and vote. W is a
//   runtime argument (one instantiation per kernel keeps nvcc's time short).
// - The anchor end and the lazy and greedy span kernels' step (Wide, the
//   only kernels of this file still on it) walks the live states
//   warp-uniformly: a ballot of the lanes with a live word, then for each
//   such word w its bits broadcast by __shfl_sync, and for each set bit s
//   lane l ORs row[s][l] from shared memory (consecutive lanes, consecutive
//   words: no bank conflict). Every lane sees the same set bits, so the
//   warp does not diverge; the cost is one shared load per live state and
//   step, plus W-independent vote and mask work. The accept test is one
//   __any_sync. Their bytes come one step at a time through Stream::sym.
// - Stats, flags, reverse, reverse_mb and lazy_spans_mb run the band step
//   (Band, scan_nfa_wide.cuh) on the record kernels' band splits
//   (scan_pallas.with_band: the reverses keep every diagonal band_split
//   finds; stats, flags and lazy_spans_mb read the record flags' split, one
//   diagonal kept, else every edge walked): each kept diagonal moves the
//   whole state set by two lane shuffles and a funnel shift whatever is
//   live, the seed row is applied whole (forward: where the seed fires or
//   state 0 is live; reverse: one vote, state 0 preceding the live states of
//   follow[0], the step's hit bit), and only the residual's live states are
//   walked as above. A planted chain keeps hundreds of states live in the
//   reverse, which the walk pays for one by one and the diagonals do not
//   (going forward it keeps one thread, walked); a keyword list
//   with a `+` keeps only its word ends in the residual. Their bytes come off
//   a 16-byte chunk in registers, the next chunk loaded one ahead
//   (walk_chunks_pair and walk_chunks up, walk_chunks_rev down). Stats (one
//   channel) and flags at W <= 16 run two records a warp (G = 16 lanes each:
//   the Wide walk's lanes 16-31 would hold zero words), walking to the
//   longer record with each half's own EOS and dead steps after it; the
//   forward kernels skip the step to the seed alone where the warp holds no
//   live state (one vote: a chain's state set is empty on most steps, a
//   lazy span's from its end to the next claimed start). The band step takes
//   ~48-64 registers, so one 1024-thread block an SM at every tile (the Wide
//   walk's 32 fit two at W <= 16; PERF.md).
// - Shared memory holds only the direction a kernel needs (follow for the
//   Wide forward kernels, the residual follow or pred rows for the band
//   step), the mask rows and the accept rows: at s_tile 1024, 128 KB + 33 KB,
//   so one 1024-thread block per SM; the whole table (295 KB) would not fit
//   the 227 KB a block may have. At s_tile 384 (W = 12) the block needs 31
//   KB, and two fit on an SM where the registers allow (32 a thread).
// - Persistent blocks: no more blocks than are resident at once, each copies
//   its rows once, and its warps take records (or pairs) from a counter in
//   global memory (next, zero at launch), so that long-lived records (many
//   live states, a greedy round per span) do not pile up on a few warps.
// - Every lane of a record's lanes reads the same 16-byte chunk (one
//   broadcast load). HBM carries one byte per step and 1 bit per step of
//   flag or hit words; a pass is bound by the step's dependent chain of
//   shuffles, shared loads and votes, and by integer issue.
// - Stats with P > 1 accept channels (32 lanes a record): the union of the
//   accept rows is tested every step; on a step where it fires the warp's
//   state goes to a buffer in shared memory and lane c tests channels c,
//   c+32, ... and updates their statistics in the output rows ([R][P],
//   global memory). One channel (P = 1) keeps its statistics in registers,
//   the same on every lane of the record's half.
// - The multi-channel span kernels (MultiPattern unions): the union of the
//   accept rows (forward) or follow[0] (reverse: the union of the channels'
//   sg rows, the band step's s0 vote) is tested every step; only where it
//   fires is the state staged
//   in the warp's buffer for lane c to test channels c, c+32, .... Lane p
//   keeps channel p's bookkeeping (lazy: cur, pos, count; reverse: its open
//   hit word) in registers for p < 32, global rows past that; a step's seed
//   is the OR of the sg rows of the channels a ballot names.
// - Anchored rescans start at their seed step and stop at the first step
//   past it with an empty state set (or, lazy, once an end is found), so a
//   greedy round costs the match's length, not the record's.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan_core.cuh"
#include "scan_nfa_wide.cuh"

namespace {

using namespace rrx;

// A record's stream for the Wide kernels (anchor end, lazy and greedy spans),
// read in any order: step 0 is BOS, step t carries byte t-1, step len+1 is
// EOS. The bytes are read 16 at a time (every lane the same chunk), a chunk
// once for each run of steps inside it.
struct Stream {
  const uint4* row;
  int len;
  int qi;
  uint4 q;

  __device__ __forceinline__ int sym(int t) {
    if (t == 0) return kBos;
    if (t > len) return kEos;
    const int j = t - 1;
    if ((j >> 4) != qi) {
      qi = j >> 4;
      q = __ldg(row + qi);
    }
    return byte_at(q, j & 15);
  }
};

__device__ __forceinline__ Stream stream_of(const uint8_t* data, long long stride, int L,
                                            const int32_t* lengths, int r) {
  const Row rec = record(data, stride, L, lengths, r);
  return Stream{rec.row, rec.len, -1, make_uint4(0, 0, 0, 0)};
}

#define WIDE_PARAMS                                                                       \
  const uint8_t *__restrict__ data, long long stride, int L,                              \
      const int32_t *__restrict__ lengths, int R, const uint32_t *__restrict__ tab_g,     \
      int S, int W
// Writes -1 into span slots from .. cap-1 of one record's rows, the warp's
// lanes in parallel.
__device__ __forceinline__ void fill_tail_warp(int32_t* s, int32_t* e, int from, int cap,
                                               int lane) {
  for (int k = from + lane; k < cap; k += 32) {
    s[k] = -1;
    e[k] = -1;
  }
}

// Anchored rescan of one record from start st: the first (lazy) or last
// (longest) accept step as an end clipped to len, -1 when none.
__device__ __forceinline__ int anchor_scan(const Wide& k, Stream& s, int st, bool longest) {
  const int len = s.len;
  if (st < 0 || st > len) return -1;  // seed step dead or never reached
  uint32_t v = 0u;
  int first = -1, last = -1;
#pragma unroll 1
  for (int t = st == 0 ? 0 : st + 1; t <= len + 1; ++t) {
    v = k.fwd(v, t == st + 1 || (st == 0 && t <= 1), s.sym(t));
    if (k.accepts(v)) {
      first = first < 0 ? t : first;
      last = t;
    }
    // past the seed step an empty state set stays empty
    if (t > st && (empty(v) || (!longest && first >= 0))) break;
  }
  const int t = longest ? last : first;
  return t < 0 ? -1 : min(t, len);
}

// The records of one warp on the band step: G = 32 lanes a record, or G = 16
// and two records a warp (records 2 u and 2 u + 1, one a half), u taken from
// the launch's counter. A half past the last record steps record R - 1 with
// its group and writes nothing (act false).
#define BAND_RECORDS(G)                                                                  \
  const int lane = threadIdx.x & 31;                                                     \
  for (int u = static_cast<int>(blockIdx.x) * kWideWarps + (threadIdx.x >> 5);           \
       u * (32 / (G)) < R; u = next_record(next, lane))

// Match statistics on the band step (the record flags' band table, follow
// direction, P accept rows: acc_l their union), G lanes a record: the flags
// kernel's step, walk and skip. Each half keeps its record's cnt, first,
// last and full in registers (P = 1, the same on each lane of the half;
// lane j = 0 writes them after the walk); an accept counts at lead < t <=
// len + 1 of the half's own record, so the dead steps past its EOS step
// count nothing, and its state is cleared after every step from its EOS
// step on, so that a finished record keeps neither the skip nor the stop
// waiting (nor steps on the dead step's mask row). An unseeded scan stops
// once t >= 1 and no lane of the warp holds a live state: past the last
// seed step an empty set accepts nothing. P > 1 runs G = 32 only: on a
// step where the union fires the warp's state goes to its buffer and lane
// c tests channels c, c+32, ... and updates their rows ([R][P], global
// memory).
template <int G>
__global__ void __launch_bounds__(kWideThreads)
wide_stats_kernel(WIDE_PARAMS, int P, int seeded, int lead, int nullable,
                  int32_t* __restrict__ cnt_o, int32_t* __restrict__ first_o,
                  int32_t* __restrict__ last_o, uint8_t* __restrict__ full_o,
                  const uint32_t* __restrict__ band_g, const Diags dg, int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Band<G> k = load_band<G>(smem, tab_g, band_g, dg, S, W, false, P);
  const bool dedup = !(nullable && seeded);
  const bool chans = G == 32 && P > 1;
  const uint32_t* acc = k.mask + kSyms * W;  // the P accept rows
  uint32_t* buf = smem + static_cast<size_t>(S + kSyms + P) * W + (threadIdx.x >> 5) * W;
  BAND_RECORDS(G) {
    const int r0 = u * (32 / G) + k.half;
    const bool act = r0 < R;
    const int r = act ? r0 : R - 1;
    const Row rec = record(data, stride, L, lengths, r);
    const int len = rec.len, eos = len + 1;
    const int len_max = G == 32 ? len : max(len, __shfl_xor_sync(kFull, len, 16));
    const long long base = static_cast<long long>(r) * P;
    int cnt = nullable ? (seeded ? len + 1 : 1) : 0;
    int first = nullable ? 0 : -1;
    int last = nullable ? (seeded ? len : 0) : -1;
    bool full = nullable && len == 0;
    if (chans) {
      for (int c = lane; c < P; c += 32) {
        cnt_o[base + c] = cnt;
        first_o[base + c] = first;
        last_o[base + c] = last;
        full_o[base + c] = full ? 1 : 0;
      }
    }
    uint32_t v = 0u;
    walk_chunks_pair(
        rec.row, len, len_max,
        [&](int t, int sym) {
          const bool gate = seeded || t < 2;
          if (__any_sync(kFull, v != 0u)) {
            v = k.fwd(dg, v, gate || (k.enter0 && k.has0(v)), sym);
          } else {
            v = k.seed_only(gate ? k.seed_l : 0u, sym);
          }
          // every lane votes; the condition is warp-uniform at G = 32
          if (k.accepts(v) && t > lead && t <= eos) {
            const int e = min(t, len);
            if (!chans) {
              cnt += (dedup && e != last) ? 1 : 0;
              first = first < 0 ? e : first;
              last = e;
              full = full || t >= len;
            } else {
              if (k.on) buf[lane] = v;
              __syncwarp();
              for (int c = lane; c < P; c += 32) {
                if (!meets_row(buf, acc + c * W, W)) continue;
                const long long o = base + c;
                if (dedup && e != last_o[o]) cnt_o[o] += 1;
                if (first_o[o] < 0) first_o[o] = e;
                last_o[o] = e;
                if (t >= len) full_o[o] = 1;
              }
              __syncwarp();
            }
          }
          v = t >= eos ? 0u : v;
        },
        [&](int t) { return !seeded && t >= 1 && !__any_sync(kFull, v != 0u); });
    if (!chans && act && k.j == 0) {
      cnt_o[r] = cnt;
      first_o[r] = first;
      last_o[r] = last;
      full_o[r] = full ? 1 : 0;
    }
  }
}

// Forward flags on the band step (the record flags' band table, follow
// direction), G lanes a record. Both halves walk to the longer record
// (walk_chunks_pair); a half takes its own EOS step and dead steps after it
// and sets no flag bit past its EOS step, so the dead step's mask row does
// not matter. Where no
// lane of the warp holds a live state, the step is the seed row alone (no
// shifts, no walk). Lane 0 of the half writes each flag word when bit 31
// closes it, up to the EOS word, which it writes after the walk if the walk
// ended before it closed; the words past it are zeroed.
template <int G>
__global__ void __launch_bounds__(kWideThreads)
wide_flags_kernel(WIDE_PARAMS, int seeded, uint32_t* __restrict__ flags,
                  const uint32_t* __restrict__ band_g, const Diags dg, int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Band<G> k = load_band<G>(smem, tab_g, band_g, dg, S, W, false);
  const int Wh = (L + 2 + 31) >> 5;
  BAND_RECORDS(G) {
    const int r0 = u * (32 / G) + k.half;
    const bool act = r0 < R;
    const int r = act ? r0 : R - 1;
    const Row rec = record(data, stride, L, lengths, r);
    const int len = rec.len, eos = len + 1;
    const int len_max = G == 32 ? len : max(len, __shfl_xor_sync(kFull, len, 16));
    if (act) {
      for (int w = (eos >> 5) + 1 + k.j; w < Wh; w += G) flags[static_cast<size_t>(w) * R + r] = 0u;
    }
    uint32_t v = 0u, word = 0u;
    walk_chunks_pair(rec.row, len, len_max, [&](int t, int sym) {
      const bool gate = seeded || t < 2;
      if (__any_sync(kFull, v != 0u)) {
        v = k.fwd(dg, v, gate || (k.enter0 && k.has0(v)), sym);
      } else {
        v = k.seed_only(gate ? k.seed_l : 0u, sym);
      }
      const bool hit = k.accepts(v);  // every lane votes
      if (t <= eos) word |= (hit ? 1u : 0u) << (t & 31);
      if ((t & 31) == 31) {  // walking up, bit t closes word t / 32
        if (act && k.j == 0 && t - 31 <= eos) flags[static_cast<size_t>(t >> 5) * R + r] = word;
        word = 0u;
      }
    });
    if (act && k.j == 0 && (eos | 31) > len_max + 1) {
      flags[static_cast<size_t>(eos >> 5) * R + r] = word;
    }
  }
}

// The band step over records: Band<32>'s diagonals and residual walk on
// the tile's band table (scan_pallas.band_table, pred direction), the bytes
// walked down by walk_chunks_rev. The hit bit of step t is s0, state 0
// preceding a live state of follow[0] (state 0 of the step's result).
__global__ void __launch_bounds__(kWideThreads)
wide_reverse_kernel(WIDE_PARAMS, uint32_t* __restrict__ hits, const uint32_t* __restrict__ band_g,
                    const Diags dg, int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Band<32> k = load_band<32>(smem, tab_g, band_g, dg, S, W, true);
  const int Wh = (L + 2 + 31) >> 5;
  WIDE_RECORDS {
    const Row rec = record(data, stride, L, lengths, r);
    const int len = rec.len;
    for (int w = ((len + 1) >> 5) + 1 + lane; w < Wh; w += 32) {
      hits[static_cast<size_t>(w) * R + r] = 0u;
    }
    uint32_t rs = 0u, word = 0u;
    walk_chunks_rev(rec.row, len, [&](int t, int sym) {
      bool s0;
      rs = k.rev(dg, rs, sym, s0);
      word |= (s0 ? 1u : 0u) << (t & 31);
      if ((t & 31) == 0) {  // walking down, bit t closes word t / 32
        if (lane == 0) hits[static_cast<size_t>(t >> 5) * R + r] = word;
        word = 0u;
      }
    });
  }
}

__global__ void __launch_bounds__(kWideThreads)
wide_anchor_end_kernel(WIDE_PARAMS, const int32_t* __restrict__ starts, int longest,
                       int32_t* __restrict__ end_o, int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, false);
  WIDE_RECORDS {
    Stream s = stream_of(data, stride, L, lengths, r);
    const int e = anchor_scan(k, s, starts[r], longest != 0);
    if (lane == 0) end_o[r] = e;
  }
}

__global__ void __launch_bounds__(kWideThreads)
wide_lazy_spans_kernel(WIDE_PARAMS, const uint32_t* __restrict__ hits, int cap,
                       int32_t* __restrict__ starts_o, int32_t* __restrict__ ends_o,
                       int32_t* __restrict__ cnt_o, int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, false);
  WIDE_RECORDS {
    Stream s = stream_of(data, stride, L, lengths, r);
    const int len = s.len;
    int32_t* so = starts_o + static_cast<size_t>(r) * cap;
    int32_t* eo = ends_o + static_cast<size_t>(r) * cap;
    uint32_t v = 0u, hw = 0u;
    int pos = 0, cur = -1, cnt = 0;
#pragma unroll 1
    for (int t = 0; t <= len + 1; ++t) {
      if ((t & 31) == 0) hw = __ldg(hits + static_cast<size_t>(t >> 5) * R + r);
      const int sp = max(t - 1, 0);
      if (cur < 0 && ((hw >> (t & 31)) & 1u) && pos <= sp && sp <= len) cur = sp;
      v = k.fwd(v, cur >= 0 && (cur == t - 1 || (cur == 0 && t <= 1)), s.sym(t));
      const int e = min(t, len);
      const bool acc = k.accepts(v);
      if (cur >= 0 && e >= cur && acc) {
        if (lane == 0 && cnt < cap) {
          so[cnt] = cur;
          eo[cnt] = e;
        }
        ++cnt;
        pos = max(e, cur + 1);
        cur = -1;
        v = 0u;
      }
    }
    // the empty match at len, whose start hit the EOS step read while a span
    // ending at that step still held cur (see scan_spans.cu)
    if (cur < 0 && pos <= len && ((hw >> ((len + 1) & 31)) & 1u)) {
      if (lane == 0 && cnt < cap) {
        so[cnt] = len;
        eo[cnt] = len;
      }
      ++cnt;
    }
    fill_tail_warp(so, eo, min(cnt, cap), cap, lane);
    if (lane == 0) cnt_o[r] = cnt;
  }
}

__global__ void __launch_bounds__(kWideThreads)
wide_greedy_spans_kernel(WIDE_PARAMS, const uint32_t* __restrict__ hits, int cap, int nullable,
                         int32_t* __restrict__ starts_o, int32_t* __restrict__ ends_o,
                         int32_t* __restrict__ cnt_o, uint8_t* __restrict__ over_o,
                         int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, false);
  WIDE_RECORDS {
    Stream s = stream_of(data, stride, L, lengths, r);
    const int len = s.len;
    const int w_top = (len + 1) >> 5;  // hit words past it are 0
    int32_t* so = starts_o + static_cast<size_t>(r) * cap;
    int32_t* eo = ends_o + static_cast<size_t>(r) * cap;
    int pos = 0, n = 0;
    bool active = true;
#pragma unroll 1
    for (int round = 0; round < cap && active; ++round) {
      int st = pos;  // nullable: every position <= len starts an empty match
      if (!nullable) {
        const int thr = pos > 0 ? pos + 1 : 0;  // steps 0 and 1 both start at 0
        int t = -1;
        for (int w = thr >> 5; w <= w_top; ++w) {
          uint32_t hw = __ldg(hits + static_cast<size_t>(w) * R + r);
          if (w == thr >> 5) hw &= ~0u << (thr & 31);
          if (hw != 0u) {
            t = 32 * w + __ffs(hw) - 1;
            break;
          }
        }
        st = t < 0 ? len + 1 : max(t - 1, 0);
      }
      if (st > len) {
        active = false;
        break;
      }
      int e = anchor_scan(k, s, st, true);
      if (nullable && e < st) e = st;  // the empty match at st
      if (e < st) {
        active = false;
        break;
      }
      if (lane == 0) {
        so[n] = st;
        eo[n] = e;
      }
      ++n;
      pos = max(e, st + 1);
      active = pos <= len;
    }
    fill_tail_warp(so, eo, n, cap, lane);
    if (lane == 0) {
      cnt_o[r] = n;
      over_o[r] = active ? 1 : 0;
    }
  }
}

// The multi-channel span kernels (P accept channels of a MultiPattern
// union, the patterns' positions disjoint). Shared memory past the accept
// rows: the span-channel rows [P][2][W] (sg_p, posm_p; scan_pallas.
// span_channels), then one state buffer of W words per warp.
inline size_t wide_mb_smem_bytes(int S, int W, int P) {
  return wide_smem_bytes(S, W, P, true) + sizeof(uint32_t) * 2 * static_cast<size_t>(P) * W;
}

// Copies the span-channel rows after the accept rows; the __syncthreads of
// load_wide or load_band, which every kernel calls next, makes them visible.
__device__ __forceinline__ const uint32_t* load_span(uint32_t* smem,
                                                     const uint32_t* __restrict__ span_g, int S,
                                                     int W, int P) {
  uint32_t* span = smem + static_cast<size_t>(S + kSyms + P) * W;
  for (int i = threadIdx.x; i < 2 * P * W; i += blockDim.x) span[i] = __ldg(span_g + i);
  return span;
}

// hits: [P][Wh][R], channel p's block the single-channel layout. The band
// step of wide_reverse_kernel (Band<32> on the tile's band table, pred
// direction, P accept rows: acc_l their union), the bytes walked down by
// walk_chunks_rev: x = (R | acc) & mask[sym]; where x meets follow[0] (the
// union of the sg rows: the step's s0 vote) the warp's x goes to its buffer
// and lane c tests channels c, c+32, ...: bit t of channel p is set when x
// meets sg_p. Lane p < 32 keeps channel p's open hit word in a register and
// writes it when the word closes; channels past 32 OR their bits into global
// memory (each word zeroed when it opens). Then R = the band step on x.
__global__ void __launch_bounds__(kWideThreads)
wide_reverse_mb_kernel(WIDE_PARAMS, int P, const uint32_t* __restrict__ span_g,
                       uint32_t* __restrict__ hits, const uint32_t* __restrict__ band_g,
                       const Diags dg, int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t* span = load_span(smem, span_g, S, W, P);
  const Band<32> k = load_band<32>(smem, tab_g, band_g, dg, S, W, true, P);
  const int Wh = (L + 2 + 31) >> 5;
  const size_t plane = static_cast<size_t>(Wh) * R;  // one channel's block
  WIDE_RECORDS {
    uint32_t* buf = smem + static_cast<size_t>(S + kSyms + 3 * P) * W + warp * W;
    const Row rec = record(data, stride, L, lengths, r);
    const int len = rec.len;
    for (int p = 0; p < P; ++p) {
      for (int w = ((len + 1) >> 5) + 1 + lane; w < Wh; w += 32) {
        hits[p * plane + static_cast<size_t>(w) * R + r] = 0u;
      }
    }
    uint32_t rs = 0u, hw = 0u;
    walk_chunks_rev(rec.row, len, [&](int t, int sym) {
      const size_t at = static_cast<size_t>(t >> 5) * R + r;
      if (t == len + 1 || (t & 31) == 31) {  // walking down, word t / 32 opens
        hw = 0u;
        for (int c = lane + 32; c < P; c += 32) hits[c * plane + at] = 0u;
      }
      const uint32_t x = k.rev_in(rs, sym);
      bool s0;
      rs = k.rev_step(dg, x, s0);
      if (s0) {
        if (k.on) buf[lane] = x;
        __syncwarp();
        const uint32_t bit = 1u << (t & 31);
        for (int c = lane; c < P; c += 32) {
          if (!meets_row(buf, span + 2 * c * W, W)) continue;
          if (c == lane) {
            hw |= bit;
          } else {
            hits[c * plane + at] |= bit;
          }
        }
        __syncwarp();
      }
      if ((t & 31) == 0 && lane < P) hits[lane * plane + at] = hw;  // bit t closes word t / 32
    });
  }
}

// One channel's lazy-span bookkeeping (cur: -1 idle, else the claimed
// start; pos: the next start allowed; n: spans so far), in the registers of
// lane p for channel p < 32, in global rows past that (scratch [R][P][2]
// for cur and pos, the count in cnt [R][P]).
struct Chan {
  int cur, pos, n;
};

__device__ __forceinline__ Chan load_chan(const int32_t* scr, const int32_t* cnt, int c) {
  return Chan{scr[2 * c], scr[2 * c + 1], cnt[c]};
}

__device__ __forceinline__ void store_chan(int32_t* scr, int32_t* cnt, int c, const Chan& ch) {
  scr[2 * c] = ch.cur;
  scr[2 * c + 1] = ch.pos;
  cnt[c] = ch.n;
}

// Claims a start for an idle channel at step t whose hit bit is set, and
// returns whether the channel seeds step t (sg_p at step cur + 1, steps <= 1
// when cur == 0).
__device__ __forceinline__ bool claim(Chan& ch, uint32_t hw, int t, int len) {
  const int sp = max(t - 1, 0);
  if (ch.cur < 0 && ((hw >> (t & 31)) & 1u) && ch.pos <= sp && sp <= len) ch.cur = sp;
  return ch.cur >= 0 && (ch.cur == t - 1 || (ch.cur == 0 && t <= 1));
}

// Emits (cur, e) for a claimed channel c whose accept row (of the rows acc
// [P][W]) meets the state v (W words in shared memory), e >= cur; returns
// whether it did.
__device__ __forceinline__ bool emit(Chan& ch, const uint32_t* acc, int W, const uint32_t* v,
                                     int c, int e, int cap, int32_t* so, int32_t* eo) {
  if (ch.cur < 0 || e < ch.cur || !meets_row(v, acc + c * W, W)) return false;
  if (ch.n < cap) {
    so[ch.n] = ch.cur;
    eo[ch.n] = e;
  }
  ++ch.n;
  ch.pos = max(e, ch.cur + 1);
  ch.cur = -1;
  return true;
}

// Lane l's word of the OR of row `which` (0: sg, 1: posm) of the channels
// base + b for the set bits b of a warp ballot.
__device__ __forceinline__ uint32_t or_rows(const uint32_t* span, unsigned bits, int base,
                                            int which, const Band<32>& k) {
  uint32_t y = 0u;
  while (bits != 0u) {
    const int c = base + __ffs(bits) - 1;
    bits &= bits - 1u;
    y |= span[(2 * c + which) * k.W + k.col];
  }
  return k.on ? y : 0u;
}

// hits: [P][Wh][R] from rrx_nfa_wide_reverse_mb; starts, ends: [R][P][cap];
// cnt: [R][P]; scratch: [R][P][2] when P > 32. One forward walk on the band
// step (Band<32> on the record flags' band table, P accept rows: acc_l their
// union), the bytes by walk_chunks: every channel claims, seeds and emits on
// its own hit words and in its own position subspace; the seed of a step is
// the OR of the sg rows of the channels that seed it (a ballot over the
// channel lanes), which the band step takes as its seed word. Where no lane
// holds a live state the step is that seed alone, masked (no shifts, no
// walk), and where no channel seeds either the state stays empty and the
// accept vote is skipped: going forward a lazy span's set lives only from a
// claimed start to its first end. On a step where the union of the accept
// rows fires, the state before any kill goes to the warp's buffer, each
// lane tests its channels, and every emitting channel's positions (posm_p)
// are cleared from the state. After the EOS step an idle channel with pos
// <= len and hit bit len + 1 emits the empty match (len, len), as
// rrx_nfa_lazy_spans_mb does.
__global__ void __launch_bounds__(kWideThreads)
wide_lazy_spans_mb_kernel(WIDE_PARAMS, int P, const uint32_t* __restrict__ span_g,
                          const uint32_t* __restrict__ hits, int cap,
                          int32_t* __restrict__ starts_o, int32_t* __restrict__ ends_o,
                          int32_t* __restrict__ cnt_o, int32_t* __restrict__ scratch,
                          const uint32_t* __restrict__ band_g, const Diags dg, int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t* span = load_span(smem, span_g, S, W, P);
  const Band<32> k = load_band<32>(smem, tab_g, band_g, dg, S, W, false, P);
  const uint32_t* acc = k.mask + kSyms * W;  // the P accept rows
  const int Wh = (L + 2 + 31) >> 5;
  const size_t plane = static_cast<size_t>(Wh) * R;
  const int groups = (P + 31) >> 5;
  WIDE_RECORDS {
    uint32_t* buf = smem + static_cast<size_t>(S + kSyms + 3 * P) * W + warp * W;
    const Row rec = record(data, stride, L, lengths, r);
    const int len = rec.len;
    const size_t row = static_cast<size_t>(r) * P;
    int32_t* scr = scratch + 2 * row;
    int32_t* cnt = cnt_o + row;
    const size_t out = row * cap;  // channel c's slots: out + c * cap
    Chan ch{-1, 0, 0};             // channel `lane`
    for (int c = lane + 32; c < P; c += 32) store_chan(scr, cnt, c, Chan{-1, 0, 0});
    uint32_t hw = 0u, v = 0u;
    walk_chunks(rec.row, len, [&](int t, int sym) {
      const size_t at = static_cast<size_t>(t >> 5) * R + r;
      if ((t & 31) == 0 && lane < P) hw = __ldg(hits + lane * plane + at);
      unsigned bits = __ballot_sync(kFull, lane < P && claim(ch, hw, t, len));
      bool seeding = bits != 0u;
      uint32_t seed = or_rows(span, bits, 0, 0, k);
      for (int g = 1; g < groups; ++g) {
        const int c = lane + 32 * g;
        bool sd = false;
        if (c < P) {
          Chan cc = load_chan(scr, cnt, c);
          const uint32_t h = cc.cur < 0 ? __ldg(hits + c * plane + at) : 0u;
          sd = claim(cc, h, t, len);
          scr[2 * c] = cc.cur;
        }
        bits = __ballot_sync(kFull, sd);
        seeding = seeding || bits != 0u;
        seed |= or_rows(span, bits, 32 * g, 0, k);
      }
      if (__any_sync(kFull, v != 0u)) {
        v = k.fwd_word(dg, v, seed | (k.enter0 && k.has0(v) ? k.seed_l : 0u), sym);
      } else if (seeding) {
        v = k.seed_only(seed, sym);
      } else {
        return;  // v stays empty
      }
      if (!k.accepts(v)) return;
      const int e = min(t, len);
      if (k.on) buf[lane] = v;  // the accept tests read the state before this step's kills
      __syncwarp();
      uint32_t kill = or_rows(span,
                              __ballot_sync(kFull, lane < P && emit(ch, acc, W, buf, lane, e, cap,
                                                                    starts_o + out + lane * cap,
                                                                    ends_o + out + lane * cap)),
                              0, 1, k);
      for (int g = 1; g < groups; ++g) {
        const int c = lane + 32 * g;
        bool em = false;
        if (c < P) {
          Chan cc = load_chan(scr, cnt, c);
          em = emit(cc, acc, W, buf, c, e, cap, starts_o + out + c * cap, ends_o + out + c * cap);
          if (em) store_chan(scr, cnt, c, cc);
        }
        kill |= or_rows(span, __ballot_sync(kFull, em), 32 * g, 1, k);
      }
      __syncwarp();
      v &= ~kill;
    });
    // per channel, the empty match at len after a span that ended at the
    // EOS step (see rrx_nfa_lazy_spans_mb)
    const size_t at_eos = static_cast<size_t>((len + 1) >> 5) * R + r;
    const int b_eos = (len + 1) & 31;
    for (int c = lane; c < P; c += 32) {
      Chan cc = c == lane ? ch : load_chan(scr, cnt, c);
      if (cc.cur < 0 && cc.pos <= len && ((__ldg(hits + c * plane + at_eos) >> b_eos) & 1u)) {
        if (cc.n < cap) {
          starts_o[out + c * cap + cc.n] = len;
          ends_o[out + c * cap + cc.n] = len;
        }
        ++cc.n;
      }
      cnt[c] = cc.n;
    }
    __syncwarp();
    for (int c = 0; c < P; ++c) {
      fill_tail_warp(starts_o + out + c * cap, ends_o + out + c * cap, min(cnt[c], cap), cap,
                     lane);
    }
    __syncwarp();
  }
}

// The launchers' checks: the row layout (check_rows), a tile of 257..1024
// states with W = ceil(s_tile/32) words, and P >= 1 accept rows.
int check_wide(const void* data, long long stride, int L, int R, int s_tile, int P) {
  if (s_tile < kMinTile || s_tile > kMaxTile || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return check_rows(data, stride, L, R);
}

}  // namespace

#define RRX_WIDE_HEAD \
  const void *data, long long stride, int L, const void *lengths, int R, const void *tab, int s_tile
#define RRX_WIDE_ARGS                                                                    \
  static_cast<const uint8_t*>(data), stride, L, static_cast<const int32_t*>(lengths), R, \
      static_cast<const uint32_t*>(tab), s_tile, words_of(s_tile)

extern "C" {

// Every entry point: the head of scan_nfa.cu's (the rows, the table of
// scan_pallas.nfa_tables for a tile of 257..1024 states), its own arguments
// as there, then next: a device int32 set to 0, the record counter the
// warps take work from, and the stream.
//
// P accept rows in the table; cnt, first, last: [R][P] int32; full: [R][P]
// uint8; lead < 0 = no lead; then the record flags' band table, its offsets
// (as rrx_nfa_wide_flags takes them) and the lanes a record: 32, or 16 (two
// records a warp; W <= 16 and P = 1)
int rrx_nfa_wide_stats(RRX_WIDE_HEAD, int P, int seeded, int lead, int nullable, void* cnt,
                       void* first, void* last, void* full, const void* band, int nd,
                       const int* offsets, int lanes, void* next, void* stream) {
  Diags dg;
  int bad = check_wide(data, stride, L, R, s_tile, P);
  if (bad == 0) bad = check_band(band, lanes, s_tile);
  if (bad == 0 && lanes == 16 && P > 1) bad = static_cast<int>(cudaErrorInvalidValue);
  if (bad == 0) bad = band_diags(nd, offsets, false, s_tile, &dg);
  if (bad != 0) return bad;
  const size_t smem = wide_smem_bytes(s_tile, words_of(s_tile), P, P > 1);
  auto* c = static_cast<int32_t*>(cnt);
  auto* f = static_cast<int32_t*>(first);
  auto* l = static_cast<int32_t*>(last);
  auto* u = static_cast<uint8_t*>(full);
  const auto* b = static_cast<const uint32_t*>(band);
  auto* nx = static_cast<int32_t*>(next);
  if (lanes == 16) {
    return launch_wide(wide_stats_kernel<16>, (R + 1) / 2, smem, stream, RRX_WIDE_ARGS, P, seeded,
                       lead, nullable, c, f, l, u, b, dg, nx);
  }
  return launch_wide(wide_stats_kernel<32>, R, smem, stream, RRX_WIDE_ARGS, P, seeded, lead,
                     nullable, c, f, l, u, b, dg, nx);
}

// flags: [ceil((L+2)/32)][R] uint32, bit t = step t's accept flag; then the
// tile's band table, its offsets (as rrx_nfa_wide_reverse takes them) and the
// lanes a record: 32, or 16 (two records a warp; W <= 16)
int rrx_nfa_wide_flags(RRX_WIDE_HEAD, int seeded, void* flags, const void* band, int nd,
                       const int* offsets, int lanes, void* next, void* stream) {
  Diags dg;
  int bad = check_wide(data, stride, L, R, s_tile, 1);
  if (bad == 0) bad = check_band(band, lanes, s_tile);
  if (bad == 0) bad = band_diags(nd, offsets, false, s_tile, &dg);
  if (bad != 0) return bad;
  const size_t smem = wide_smem_bytes(s_tile, words_of(s_tile), 1, false);
  auto* f = static_cast<uint32_t*>(flags);
  const auto* b = static_cast<const uint32_t*>(band);
  auto* nx = static_cast<int32_t*>(next);
  if (lanes == 16) {
    return launch_wide(wide_flags_kernel<16>, (R + 1) / 2, smem, stream, RRX_WIDE_ARGS, seeded, f,
                       b, dg, nx);
  }
  return launch_wide(wide_flags_kernel<32>, R, smem, stream, RRX_WIDE_ARGS, seeded, f, b, dg, nx);
}

// hits: [ceil((L+2)/32)][R] uint32; then the tile's band table
// (scan_pallas.band_table), the number of its offsets and the offsets (a
// host int array), as rrx_long_wide_reverse takes them
int rrx_nfa_wide_reverse(RRX_WIDE_HEAD, void* hits, const void* band, int nd, const int* offsets,
                         void* next, void* stream) {
  Diags dg;
  int bad = check_wide(data, stride, L, R, s_tile, 1);
  if (bad == 0) bad = check_band(band, 32, s_tile);
  if (bad == 0) bad = band_diags(nd, offsets, true, s_tile, &dg);
  if (bad != 0) return bad;
  return launch_wide(wide_reverse_kernel, R, wide_smem_bytes(s_tile, words_of(s_tile), 1, false),
                     stream, RRX_WIDE_ARGS, static_cast<uint32_t*>(hits),
                     static_cast<const uint32_t*>(band), dg, static_cast<int32_t*>(next));
}

// starts: [R] int32 (-1 = inactive); end: [R] int32
int rrx_nfa_wide_anchor_end(RRX_WIDE_HEAD, const void* starts, int longest, void* end,
                            void* next, void* stream) {
  const int bad = check_wide(data, stride, L, R, s_tile, 1);
  if (bad != 0) return bad;
  return launch_wide(wide_anchor_end_kernel, R,
                     wide_smem_bytes(s_tile, words_of(s_tile), 1, false), stream, RRX_WIDE_ARGS,
                     static_cast<const int32_t*>(starts), longest, static_cast<int32_t*>(end),
                     static_cast<int32_t*>(next));
}

// hits from rrx_nfa_wide_reverse; starts, ends: [R][cap] int32; cnt: [R] int32
int rrx_nfa_wide_lazy_spans(RRX_WIDE_HEAD, const void* hits, int cap, void* starts, void* ends,
                            void* cnt, void* next, void* stream) {
  const int bad = check_wide(data, stride, L, R, s_tile, 1);
  if (bad != 0) return bad;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wide(wide_lazy_spans_kernel, R,
                     wide_smem_bytes(s_tile, words_of(s_tile), 1, false), stream, RRX_WIDE_ARGS,
                     static_cast<const uint32_t*>(hits), cap, static_cast<int32_t*>(starts),
                     static_cast<int32_t*>(ends), static_cast<int32_t*>(cnt),
                     static_cast<int32_t*>(next));
}

// as rrx_nfa_wide_lazy_spans, plus nullable and over: [R] uint8
int rrx_nfa_wide_greedy_spans(RRX_WIDE_HEAD, const void* hits, int cap, int nullable,
                              void* starts, void* ends, void* cnt, void* over, void* next,
                              void* stream) {
  const int bad = check_wide(data, stride, L, R, s_tile, 1);
  if (bad != 0) return bad;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wide(wide_greedy_spans_kernel, R,
                     wide_smem_bytes(s_tile, words_of(s_tile), 1, false), stream, RRX_WIDE_ARGS,
                     static_cast<const uint32_t*>(hits), cap, nullable,
                     static_cast<int32_t*>(starts), static_cast<int32_t*>(ends),
                     static_cast<int32_t*>(cnt), static_cast<uint8_t*>(over),
                     static_cast<int32_t*>(next));
}

// P accept rows in the table; span: [P][2][W] uint32 (scan_pallas.span_channels);
// hits: [P][ceil((L+2)/32)][R] uint32; then the tile's band table and its
// offsets, as rrx_nfa_wide_reverse takes them
int rrx_nfa_wide_reverse_mb(RRX_WIDE_HEAD, int P, const void* span, void* hits, const void* band,
                            int nd, const int* offsets, void* next, void* stream) {
  Diags dg;
  int bad = check_wide(data, stride, L, R, s_tile, P);
  if (bad == 0) bad = check_band(band, 32, s_tile);
  if (bad == 0) bad = band_diags(nd, offsets, true, s_tile, &dg);
  if (bad != 0) return bad;
  return launch_wide(wide_reverse_mb_kernel, R, wide_mb_smem_bytes(s_tile, words_of(s_tile), P),
                     stream, RRX_WIDE_ARGS, P, static_cast<const uint32_t*>(span),
                     static_cast<uint32_t*>(hits), static_cast<const uint32_t*>(band), dg,
                     static_cast<int32_t*>(next));
}

// hits from rrx_nfa_wide_reverse_mb; starts, ends: [R][P][cap] int32; cnt:
// [R][P] int32; scratch: [R][P][2] int32 when P > 32 (else unread); then the
// record flags' band table, its offsets (as rrx_nfa_wide_flags takes them)
// and the lanes a record (32)
int rrx_nfa_wide_lazy_spans_mb(RRX_WIDE_HEAD, int P, const void* span, const void* hits, int cap,
                               void* starts, void* ends, void* cnt, void* scratch,
                               const void* band, int nd, const int* offsets, int lanes,
                               void* next, void* stream) {
  Diags dg;
  int bad = check_wide(data, stride, L, R, s_tile, P);
  if (bad == 0) bad = check_band(band, 32, s_tile);
  if (bad == 0 && (cap < 1 || lanes != 32)) bad = static_cast<int>(cudaErrorInvalidValue);
  if (bad == 0) bad = band_diags(nd, offsets, false, s_tile, &dg);
  if (bad != 0) return bad;
  return launch_wide(wide_lazy_spans_mb_kernel, R,
                     wide_mb_smem_bytes(s_tile, words_of(s_tile), P), stream, RRX_WIDE_ARGS, P,
                     static_cast<const uint32_t*>(span), static_cast<const uint32_t*>(hits), cap,
                     static_cast<int32_t*>(starts), static_cast<int32_t*>(ends),
                     static_cast<int32_t*>(cnt), static_cast<int32_t*>(scratch),
                     static_cast<const uint32_t*>(band), dg, static_cast<int32_t*>(next));
}

// Resident blocks per SM (theoretical occupancy) of a wide kernel for a tile
// of s_tile states and P accept rows, by index: 0 stats (the band step, two
// records a warp for W <= 16 and P = 1), 1 reverse (the band step), 2 anchor
// end, 3 lazy spans, 4 greedy spans, 5 flags (the band step, two records a
// warp for W <= 16) (rrx_occupancy's order), then the multi-channel kernels:
// 6 reverse_mb, 7 lazy_spans_mb (both the band step); 8 flags and 9 stats at
// 32 lanes a record.
int rrx_nfa_wide_occupancy(int kernel, int s_tile, int P, int* blocks_per_sm) {
  if (s_tile < kMinTile || s_tile > kMaxTile || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = words_of(s_tile);
  const bool stats = kernel == 0 || kernel == 9;
  const size_t smem = kernel == 6 || kernel == 7
                          ? wide_mb_smem_bytes(s_tile, W, P)
                          : wide_smem_bytes(s_tile, W, stats ? P : 1, stats && P > 1);
  switch (kernel) {
    case 0:
      return W <= 16 && P == 1 ? occupancy_wide(wide_stats_kernel<16>, smem, blocks_per_sm)
                               : occupancy_wide(wide_stats_kernel<32>, smem, blocks_per_sm);
    case 1:
      return occupancy_wide(wide_reverse_kernel, smem, blocks_per_sm);
    case 2:
      return occupancy_wide(wide_anchor_end_kernel, smem, blocks_per_sm);
    case 3:
      return occupancy_wide(wide_lazy_spans_kernel, smem, blocks_per_sm);
    case 4:
      return occupancy_wide(wide_greedy_spans_kernel, smem, blocks_per_sm);
    case 5:
      return W <= 16 ? occupancy_wide(wide_flags_kernel<16>, smem, blocks_per_sm)
                     : occupancy_wide(wide_flags_kernel<32>, smem, blocks_per_sm);
    case 6:
      return occupancy_wide(wide_reverse_mb_kernel, smem, blocks_per_sm);
    case 7:
      return occupancy_wide(wide_lazy_spans_mb_kernel, smem, blocks_per_sm);
    case 8:
      return occupancy_wide(wide_flags_kernel<32>, smem, blocks_per_sm);
    case 9:
      return occupancy_wide(wide_stats_kernel<32>, smem, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int rrx_nfa_wide_threads_per_block() { return kWideThreads; }

}  // extern "C"
