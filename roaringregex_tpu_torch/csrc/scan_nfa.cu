// Matmul tier on Hopper (sm_90a): match statistics, candidate starts,
// anchored rescans, and lazy and greedy spans of dense programs of up to
// 256 states (the dense128 and dense256 tiers; also the SWAR tier's nullable
// spans and the u32-word tier's spans and windowed scans).
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
//   and the state is cleared. Spans go straight into [R][cap] rows (-1 past
//   the count); cnt counts every span, also past cap.
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
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "scan_core.cuh"

namespace {

using namespace rrx;

inline size_t nfa_smem_bytes(int S, int W) {
  return sizeof(uint32_t) * static_cast<size_t>((2 * S + kSyms + 1) * W);
}

template <int W>
struct Nfa {
  const uint32_t* follow;  // shared [S][W]
  const uint32_t* pred;    // shared [S][W]
  const uint32_t* mask;    // shared [kSyms][W]
  uint32_t acc[W];

  // v = (OR of follow[s] over s in v | gate ? follow[0] : 0) & mask[sym]
  __device__ __forceinline__ void fwd(uint32_t (&v)[W], bool gate, int sym) const {
    uint32_t y[W];
#pragma unroll
    for (int k = 0; k < W; ++k) y[k] = gate ? follow[k] : 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t b = v[w];
      while (b != 0u) {
        const uint32_t* f = follow + (32 * w + __ffs(b) - 1) * W;
        b &= b - 1u;
#pragma unroll
        for (int k = 0; k < W; ++k) y[k] |= f[k];
      }
    }
    const uint32_t* m = mask + sym * W;
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = y[k] & m[k];
  }

  // r = OR of pred[u] over u in (r | acc) & mask[sym]
  __device__ __forceinline__ void rev(uint32_t (&r)[W], int sym) const {
    const uint32_t* m = mask + sym * W;
    uint32_t x[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      x[k] = (r[k] | acc[k]) & m[k];
      r[k] = 0u;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t b = x[w];
      while (b != 0u) {
        const uint32_t* p = pred + (32 * w + __ffs(b) - 1) * W;
        b &= b - 1u;
#pragma unroll
        for (int k = 0; k < W; ++k) r[k] |= p[k];
      }
    }
  }

  __device__ __forceinline__ bool accepts(const uint32_t (&v)[W]) const {
    uint32_t a = 0u;
#pragma unroll
    for (int k = 0; k < W; ++k) a |= v[k] & acc[k];
    return a != 0u;
  }
};

template <int W>
__device__ __forceinline__ bool empty(const uint32_t (&v)[W]) {
  uint32_t a = 0u;
#pragma unroll
  for (int k = 0; k < W; ++k) a |= v[k];
  return a == 0u;
}

template <int W>
__device__ __forceinline__ void clear(uint32_t (&v)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = 0u;
}

// Copies the tile's rows into dynamic shared memory. Every thread of the
// block calls it (it ends in __syncthreads) before any thread returns.
template <int W>
__device__ __forceinline__ Nfa<W> load_nfa(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                           int S) {
  const int n = (2 * S + kSyms + 1) * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = tab_g[i];
  __syncthreads();
  Nfa<W> nfa{smem, smem + S * W, smem + 2 * S * W, {}};
#pragma unroll
  for (int k = 0; k < W; ++k) nfa.acc[k] = smem[(2 * S + kSyms) * W + k];
  return nfa;
}

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

// Calls f(std::integral_constant<int, W>{}) for the state-word count of a
// record tile of s_tile states; other tiles are refused.
template <class F>
int by_words(int s_tile, F&& f) {
  if (s_tile < 1 || s_tile > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch ((s_tile + 31) / 32) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 8:
      return f(std::integral_constant<int, 8>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
int occupancy(K kernel, int S, int W, int* blocks_per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, nfa_smem_bytes(S, W)));
}

}  // namespace

namespace rrx {

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

// cnt, first, last: [R] int32; full: [R] uint8; lead < 0 = no lead
int rrx_nfa_stats(RRX_NFA_HEAD, int seeded, int lead, int nullable, void* cnt, void* first,
                  void* last, void* full, void* stream) {
  const int bad = check_rows(data, stride, L, R);
  if (bad != 0) return bad;
  return by_words(s_tile, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return launch(nfa_stats_kernel<W>, R, s_tile, W, stream, RRX_NFA_ARGS, seeded, lead,
                  nullable, static_cast<int32_t*>(cnt), static_cast<int32_t*>(first),
                  static_cast<int32_t*>(last), static_cast<uint8_t*>(full));
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
