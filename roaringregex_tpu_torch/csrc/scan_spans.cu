// Span extraction on the SWAR tier (programs of <= 8 states), for Hopper
// (sm_90a): candidate starts, anchored rescans, lazy and greedy spans.
//
// Replaces three Pallas TPU kernels of the JAX package and the XLA glue
// around them (all in roaringregex_tpu/ops/scan_swar.py):
//   rrx_swar_reverse      <- _swar_reverse_kernel (via _swar_reverse_pl)
//   rrx_swar_lazy_spans   <- _swar_span_kernel (via _swar_spans_call), with
//                            the event-stream compaction after it
//   rrx_swar_anchor_end   <- _swar_anchor_kernel (via _swar_anchor_pl) +
//                            the _anchor_ends reduction
//   rrx_swar_greedy_spans <- _swar_greedy_call's while_loop of rounds, each
//                            a first-start search in the reverse bit-log and
//                            an anchored longest rescan (_swar_anchor_kernel)
//
// Stream steps and the (delta, table) step are scan_core.cuh's: step 0 is
// BOS (a table row, never a byte), step t carries byte t-1, step len+1 is
// EOS and runs even when len == L, bytes >= 0x80 have zero rows. None of
// these kernels drops the `$` duplicate at EOS (only the forward stats do):
// an end is min(step, len), and first/last policies see both flags.
//
// What each computes, per record r with len = clamp(lengths[r], 0, L):
// - reverse: R = 0 before the EOS step (steps past EOS are dead and leave
//   it 0), then for t = len+1 down to 0: R = rev(R | acc, sym(t)); hit bit t
//   = bit 0 of R (a match can start at max(t-1, 0)). Hit words are laid out
//   [W][R] uint32, W = ceil((L+2)/32), bit t of record r in word t/32, so
//   neighbouring threads write neighbouring words.
// - lazy spans: one forward pass with the claim/anchor/emit bookkeeping of
//   _swar_span_kernel: claim sp = max(t-1, 0) when idle, the hit is set and
//   pos <= sp <= len; seed state 0 at step cur+1 (steps <= 1 when cur == 0);
//   emit (cur, e = min(t, len)) when an accept flag rises with e >= cur,
//   then pos = max(e, cur+1) and the record's state is cleared. After the
//   EOS step, an idle record with pos <= len and hit bit len+1 emits the
//   empty match (len, len): that hit is read while a span ending at the EOS
//   step still holds cur (the TPU kernel drops it). The spans go
//   straight into [R][cap] start/end rows (-1 past the count) and cnt[R]
//   counts every span, also past cap. The TPU's [T, 32 G8, B] int32 event
//   stream and its cumsum/scatter compaction never exist here.
// - anchor end: the forward step seeded only at the record's start st
//   (step st+1, or steps <= 1 when st == 0; inactive when st < 0), reduced
//   in the thread to the first (lazy) or last (longest) accept step, end =
//   min(step, len), -1 when none.
// - greedy spans: rounds of (first hit step t >= thr, thr = pos+1 if pos > 0
//   else 0; s = max(t-1, 0) <= len; e = longest anchored end from s; emit if
//   e >= s; pos = max(e, s+1); go on while pos <= len), at most cap rounds;
//   over = still going after cap rounds. Records never interact, so a loop
//   in the thread gives exactly the outputs of the TPU's batched
//   while_loop, and the host waits for no round.
//
// Design, and what bounds it on this card:
// - One thread owns one record for its whole stream, as in scan_bits.cu: the
//   automaton and the bookkeeping stay in registers. Each pass reads one
//   input byte per scanned byte, 16 bytes at a time; reverse writes 1 bit
//   per step (1/8 of the input: 138 MB of hit words per GiB), lazy spans
//   read those bits back. Every byte costs a chain of integer operations
//   that depends on the step before (n_delta x (shared load, shift, and,
//   or) plus the bookkeeping), so a pass is bound by integer issue and by
//   that chain's latency; many resident records hide the latency, few
//   records (config 7: 9,765, under one block of 128 per SM) cannot.
// - Anchored rescans start at their seed step (a state set before it is
//   empty) and stop once the set is empty again after it, or at the first
//   accept for lazy ends: a rescan costs the match's length, not the
//   record's, which is what makes a greedy round loop in the thread cheap.
// - Greedy reads candidate starts straight from the hit words with a
//   find-first-set per 32 steps.
// - Span rows are written by their owning thread, so stores to them do
//   not coalesce; spans are sparse next to the bytes scanned.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan_core.cuh"

namespace {

using namespace rrx;

// Anchored rescan of one record from start st: the first (lazy) or last
// (longest) accept step as an end clipped to len, -1 when none.
__device__ __forceinline__ int anchor_scan(const Tables& tb, uint32_t acc, const Row& rec,
                                           int st, bool longest) {
  const int len = rec.len;
  if (st < 0 || st > len) return -1;  // seed step dead or never reached
  uint32_t v = 0;
  int first = -1, last = -1;
  auto step = [&](int t, int sym) {
    const bool seed = t == st + 1 || (st == 0 && t <= 1);
    v = tb.fwd(v | (seed ? 1u : 0u), sym);
    if ((v & acc) != 0u) {
      first = first < 0 ? t : first;
      last = t;
    }
  };
  // past the last seed step an empty state set stays empty
  auto done = [&] { return v == 0u || (!longest && first >= 0); };
  if (st == 0) step(0, kBos);
  walk_fwd(rec.row, st, len, step, done);
  if (st == len || !done()) step(len + 1, kEos);
  const int t = longest ? last : first;
  return t < 0 ? -1 : min(t, len);
}

__global__ void __launch_bounds__(kThreads)
swar_reverse_kernel(const uint8_t* __restrict__ data, long long stride, int L,
                    const int32_t* __restrict__ lengths, int R,
                    const uint32_t* __restrict__ tab_g, const int32_t* __restrict__ deltas_g,
                    int n_d, uint32_t acc, uint32_t* __restrict__ hits) {
  extern __shared__ uint32_t smem[];
  const Tables tb = load_tables(smem, tab_g, deltas_g, n_d);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Row rec = record(data, stride, L, lengths, r);
  const int W = (L + 2 + 31) >> 5;
  for (int w = ((rec.len + 1) >> 5) + 1; w < W; ++w) hits[(size_t)w * R + r] = 0u;
  uint32_t rs = 0, word = 0;
  auto step = [&](int t, int sym) {
    rs = tb.rev(rs | acc, sym);
    word |= (rs & 1u) << (t & 31);
    if ((t & 31) == 0) {  // walking down, bit t closes word t / 32
      hits[(size_t)(t >> 5) * R + r] = word;
      word = 0;
    }
  };
  step(rec.len + 1, kEos);
  walk_rev(rec.row, rec.len, step);
  step(0, kBos);
}

__global__ void __launch_bounds__(kThreads)
swar_lazy_spans_kernel(const uint8_t* __restrict__ data, long long stride, int L,
                       const int32_t* __restrict__ lengths, int R,
                       const uint32_t* __restrict__ tab_g, const int32_t* __restrict__ deltas_g,
                       int n_d, uint32_t acc, const uint32_t* __restrict__ hits, int cap,
                       int32_t* __restrict__ starts_o, int32_t* __restrict__ ends_o,
                       int32_t* __restrict__ cnt_o) {
  extern __shared__ uint32_t smem[];
  const Tables tb = load_tables(smem, tab_g, deltas_g, n_d);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Row rec = record(data, stride, L, lengths, r);
  const int len = rec.len;
  int32_t* so = starts_o + (size_t)r * cap;
  int32_t* eo = ends_o + (size_t)r * cap;
  uint32_t v = 0, hw = 0;
  int pos = 0, cur = -1, cnt = 0;
  auto step = [&](int t, int sym) {
    if ((t & 31) == 0) hw = __ldg(hits + (size_t)(t >> 5) * R + r);
    const int sp = max(t - 1, 0);
    if (cur < 0 && ((hw >> (t & 31)) & 1u) && pos <= sp && sp <= len) cur = sp;
    const bool seed = cur >= 0 && (cur == t - 1 || (cur == 0 && t <= 1));
    v = tb.fwd(v | (seed ? 1u : 0u), sym);
    const int e = min(t, len);
    if ((v & acc) != 0u && cur >= 0 && e >= cur) {
      if (cnt < cap) {
        so[cnt] = cur;
        eo[cnt] = e;
      }
      ++cnt;
      pos = max(e, cur + 1);
      cur = -1;
      v = 0;
    }
  };
  step(0, kBos);
  walk_fwd(rec.row, 0, len, step, [] { return false; });
  step(len + 1, kEos);
  // the EOS step's start hit (bit len+1) is read while a span that ends at
  // that step still holds cur; only the empty match starts at len, so an
  // idle record with pos <= len emits it here
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

__global__ void __launch_bounds__(kThreads)
swar_anchor_end_kernel(const uint8_t* __restrict__ data, long long stride, int L,
                       const int32_t* __restrict__ lengths, int R,
                       const uint32_t* __restrict__ tab_g, const int32_t* __restrict__ deltas_g,
                       int n_d, uint32_t acc, const int32_t* __restrict__ starts, int longest,
                       int32_t* __restrict__ end_o) {
  extern __shared__ uint32_t smem[];
  const Tables tb = load_tables(smem, tab_g, deltas_g, n_d);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  end_o[r] = anchor_scan(tb, acc, record(data, stride, L, lengths, r), starts[r], longest != 0);
}

__global__ void __launch_bounds__(kThreads)
swar_greedy_spans_kernel(const uint8_t* __restrict__ data, long long stride, int L,
                         const int32_t* __restrict__ lengths, int R,
                         const uint32_t* __restrict__ tab_g, const int32_t* __restrict__ deltas_g,
                         int n_d, uint32_t acc, const uint32_t* __restrict__ hits, int cap,
                         int32_t* __restrict__ starts_o, int32_t* __restrict__ ends_o,
                         int32_t* __restrict__ cnt_o, uint8_t* __restrict__ over_o) {
  extern __shared__ uint32_t smem[];
  const Tables tb = load_tables(smem, tab_g, deltas_g, n_d);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Row rec = record(data, stride, L, lengths, r);
  const int len = rec.len;
  const int w_top = (len + 1) >> 5;  // hit words past it are 0
  int32_t* so = starts_o + (size_t)r * cap;
  int32_t* eo = ends_o + (size_t)r * cap;
  int pos = 0, n = 0;
  bool active = true;
  for (int round = 0; round < cap && active; ++round) {
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
    const int s = max(t - 1, 0);
    if (t < 0 || s > len) {
      active = false;
      break;
    }
    const int e = anchor_scan(tb, acc, rec, s, true);
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

template <class K, class... Args>
int launch(K kernel, int R, int n_d, void* stream, Args... args) {
  if (R == 0) return 0;
  const size_t smem = smem_bytes(n_d);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const int blocks = (R + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace rrx {

int spans_occupancy(int kernel, int n_d, int* blocks_per_sm) {
  const size_t smem = smem_bytes(n_d);
  cudaError_t e;
  switch (kernel) {
    case 0:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, swar_reverse_kernel,
                                                        kThreads, smem);
      break;
    case 1:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, swar_lazy_spans_kernel,
                                                        kThreads, smem);
      break;
    case 2:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, swar_anchor_end_kernel,
                                                        kThreads, smem);
      break;
    case 3:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, swar_greedy_spans_kernel,
                                                        kThreads, smem);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // namespace rrx

#define RRX_HEAD                                                                   \
  const void *data, long long stride, int L, const void *lengths, int R, const void *tab, \
      const void *deltas, int n_d, unsigned acc
#define RRX_CHECK                                                    \
  do {                                                               \
    const int bad = check_args(data, stride, L, R, n_d, acc, 8);     \
    if (bad != 0) return bad;                                        \
  } while (0)
#define RRX_ARGS                                                                       \
  static_cast<const uint8_t*>(data), stride, L, static_cast<const int32_t*>(lengths), R, \
      static_cast<const uint32_t*>(tab), static_cast<const int32_t*>(deltas), n_d, acc

extern "C" {

// hits: [ceil((L+2)/32)][R] uint32
int rrx_swar_reverse(RRX_HEAD, void* hits, void* stream) {
  RRX_CHECK;
  return launch(swar_reverse_kernel, R, n_d, stream, RRX_ARGS, static_cast<uint32_t*>(hits));
}

// hits from rrx_swar_reverse; starts, ends: [R][cap] int32; cnt: [R] int32
int rrx_swar_lazy_spans(RRX_HEAD, const void* hits, int cap, void* starts, void* ends,
                        void* cnt, void* stream) {
  RRX_CHECK;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(swar_lazy_spans_kernel, R, n_d, stream, RRX_ARGS,
                static_cast<const uint32_t*>(hits), cap, static_cast<int32_t*>(starts),
                static_cast<int32_t*>(ends), static_cast<int32_t*>(cnt));
}

// starts: [R] int32 (-1 = inactive); end: [R] int32
int rrx_swar_anchor_end(RRX_HEAD, const void* starts, int longest, void* end, void* stream) {
  RRX_CHECK;
  return launch(swar_anchor_end_kernel, R, n_d, stream, RRX_ARGS,
                static_cast<const int32_t*>(starts), longest, static_cast<int32_t*>(end));
}

// as rrx_swar_lazy_spans, plus over: [R] uint8
int rrx_swar_greedy_spans(RRX_HEAD, const void* hits, int cap, void* starts, void* ends,
                          void* cnt, void* over, void* stream) {
  RRX_CHECK;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(swar_greedy_spans_kernel, R, n_d, stream, RRX_ARGS,
                static_cast<const uint32_t*>(hits), cap, static_cast<int32_t*>(starts),
                static_cast<int32_t*>(ends), static_cast<int32_t*>(cnt),
                static_cast<uint8_t*>(over));
}

}  // extern "C"
