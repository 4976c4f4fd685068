// Per-record bit-set NFA scan with fused match statistics, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package together with the XLA
// bit-log reductions that follow them:
//   rrx_swar_stats  <- roaringregex_tpu/ops/scan_swar.py  _swar_kernel + _swar_stats
//                      (programs of <= 8 states, 4 records per u32 on the TPU)
//   rrx_word_stats  <- roaringregex_tpu/ops/scan_word.py  _word_kernel + _word_stats
//                      (programs of <= 32 states, 1 record per u32 on the TPU;
//                      with P accept channels, a multi-pattern program's
//                      per-channel bit-logs [T/8, ROWS*P, B] and their
//                      reduction to [R, P] statistics)
//   rrx_swar_multi_stats <- roaringregex_tpu/ops/scan_swar.py _swar_multi_kernel
//                      (via SwarScanner._run_swar_multi :1493) + _swar_stats
//                      per byte lane, nullable=False (a MultiPattern of up to
//                      4 patterns of <= 8 states, RRX_SWAR_MULTI=1)
//
// What both compute, per record r of data[R, stride] (uint8, bytes 0..len-1
// live), as the scanner method match_stats_b does:
//   stream step t = 0 .. len+1; t = 0 is the BOS step, step t carries byte
//   t-1, step len+1 is the EOS step. Per step
//     vv = v | seed          (seed = state 0 = bit 0; every step when seeded,
//                             steps t < 2 only when not)
//     v' = OR_i shift(vv, delta_i) & tab[sym][i]
//   where sym is the byte (0..255), 256 at BOS, 257 at EOS. tab[sym][i] is
//   the target mask of every (delta_i, gate) pair whose gate holds sym, so a
//   byte outside every gate (bytes >= 0x80 included) kills the state. The
//   accept flag of step t is (v' & acc) != 0, except that the EOS step's
//   flag is dropped when step len already flagged (the `$` duplicate of end
//   == len). Flags at steps t <= lead are not counted (overlapped windows).
//   From the flags: cnt, first step, last step, then the closed forms of
//   _swar_stats / _word_stats: ends clip to len, -1 when none, full = some
//   flag at step >= len, and the nullable forms (seeded and unseeded).
//   Both TPU kernels are the same recurrence on different packings; the
//   host turns a SwarSpec or a WordSpec into the same (delta, table) form,
//   so one body serves both entry points.
//
// Design, and what bounds it on this card:
// - One thread owns one record for its whole stream and keeps (v, cnt,
//   first, last) in registers: no bit-log, no second pass, four [R] outputs.
//   The TPU needed the bit-log because its grid carries state across time
//   chunks; here a loop inside the thread takes the place of that grid axis.
// - HBM: one byte read per scanned byte (plus 13 bytes of output per
//   record). At 3.35 TB/s that is ~0.3 ms per GiB. The integer work per byte
//   is the longer pole: n_delta x (shared load, shift, and, or) plus the
//   accept test and the stats update, ~15-20 instructions per byte for a
//   2-delta program, and each step depends on the last, so the kernel is
//   bound by integer issue and by the latency of that chain. Many resident
//   threads hide the latency; short batches (few records) cannot.
// - Coalescing: records are row-major, so neighbouring threads read
//   addresses `stride` bytes apart. Each thread reads its row 16 bytes at a
//   time (uint4 through the read-only path) and prefetches the next 16
//   before it steps through the current ones, so every 32-byte sector is
//   used whole across two consecutive loads. The wrapper guarantees a
//   16-byte aligned base and a stride that is a multiple of 16.
// - Occupancy: 128 threads per block, one record per thread. A batch of
//   ~39,000 windows (10 MB of 1 KiB records, windowed 4 ways) fills 306
//   blocks, about 2.3 per SM of 132, so well under a quarter of the
//   resident-thread capacity; 1 GiB batches fill the card. Packing several
//   records per thread, or splitting records across threads with an
//   automaton-state handoff, is later work.
// - Tables: tab [259][n_delta] uint32 (rows 256/257 = BOS/EOS, 258 = dead,
//   unused here) in shared memory, at most 63 deltas = 65 KB; above 48 KB
//   the launcher raises the block's dynamic shared-memory limit. The step,
//   the table load and the row walk are scan_core.cuh's, shared with the
//   span kernels (scan_spans.cu).
// - Unsigned arithmetic: the state is uint32_t, so >> is logical and bit 31
//   (the word tier's 32nd state) is an ordinary bit. Shift amounts are
//   0..31, never 32.
// - Sentinels: first = 1 << 30 (BIG) and last = -1 until a flag is seen,
//   exactly as the JAX reduction; lengths are clamped to [0, L] so a bad
//   length cannot read past the row.
// - Accept channels (rrx_word_stats with P > 1: MultiPattern's combined
//   automaton, one accept mask per pattern). The step is the same; each
//   channel has its own flags, its own `$` dedup (the EOS step's flag is
//   dropped when the channel flagged at step len: tested on the state of
//   step len, kept for that one step) and its own (cnt, first, last), so the
//   outputs are [R][P]. A step whose state meets no channel's mask (the
//   union test, one AND) walks no channel; only an accepting step does. The
//   row is walked one step per loop trip from one call site (walk_steps),
//   which keeps nvcc's time small and costs a little per step (PERF.md).
//   Up to kRegChannels channels keep
//   their running stats in registers (the channel loops unroll over a fixed
//   count); above that they live in the record's rows of the output arrays,
//   per-thread global scratch that stays in L1. The channel masks sit in
//   shared memory after the tables. P = 1 launches the single-channel kernel
//   above, unchanged.
// - Slots (rrx_swar_multi_stats). The TPU packed 4 records x 4 patterns
//   into each u32 lane: a record's byte replicated across a quad of lanes,
//   pattern k's 8-bit set in byte lane k, the gate masks restricted per
//   slot. Here one thread keeps one record's four slots in one u32: the
//   host's slotted (delta, table) form (scan_swar.swar_multi_tables) puts
//   pattern k's target bits in byte lane k, and no shift moves a bit of one
//   slot to a target bit of another (SwarMultiSpec's argument), so the step
//   is the same shift/AND/OR as above; the seed is state 0 of every slot.
//   Each slot's flag, `$` carry and (cnt, first, last) live in registers
//   (4 x 3 ints, loops unrolled over the 4 slots); a step whose state meets
//   no slot's accept bits (one AND with their union) touches none of them.
//   Bound: as rrx_swar_stats, integer issue per byte (n_delta slotted pairs
//   plus the per-slot bookkeeping on accepting steps), one byte read per
//   scanned byte for all P patterns.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan_core.cuh"

namespace {

using namespace rrx;

constexpr int kBig = 1 << 30;

struct Stats {
  uint32_t acc;
  bool seeded;
  int lead;
  uint32_t v = 0;
  bool prev = false;
  int cnt = 0;
  int first = kBig;
  int last = -1;

  __device__ __forceinline__ void step(const Tables& tb, int t, int sym, bool eos) {
    v = tb.fwd(v | ((seeded || t < 2) ? 1u : 0u), sym);
    const bool fl = (v & acc) != 0u;
    const bool emit = fl && !(eos && prev) && t > lead;
    prev = fl;
    cnt += emit ? 1 : 0;
    first = (emit && first == kBig) ? t : first;
    last = emit ? t : last;
  }
};

template <int kStates>
__global__ void __launch_bounds__(kThreads)
scan_stats_kernel(const uint8_t* __restrict__ data, long long stride, int L,
                  const int32_t* __restrict__ lengths, int R,
                  const uint32_t* __restrict__ tab_g,
                  const int32_t* __restrict__ deltas_g, int n_d,
                  uint32_t acc, int seeded, int lead, int nullable,
                  int32_t* __restrict__ cnt_o, int32_t* __restrict__ first_o,
                  int32_t* __restrict__ last_o, uint8_t* __restrict__ full_o) {
  extern __shared__ uint32_t smem[];
  const Tables tb = load_tables(smem, tab_g, deltas_g, n_d);

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Row rec = record(data, stride, L, lengths, r);
  const int len = rec.len;

  Stats s{acc, seeded != 0, lead};
  s.step(tb, 0, kBos, false);
  walk_fwd(rec.row, 0, len, [&](int t, int sym) { s.step(tb, t, sym, false); },
           [] { return false; });
  s.step(tb, len + 1, kEos, true);

  // closed forms of _swar_stats / _word_stats
  const bool any = s.cnt > 0;
  bool full = any && s.last >= len;
  int cnt, first, last;
  if (nullable) {
    full = full || len == 0;
    first = 0;
    if (seeded) {
      cnt = len + 1;
      last = s.last < 0 ? len : min(s.last, len);
    } else {
      cnt = len == 0 ? 1 : 1 + s.cnt - (s.first == 0 ? 1 : 0);
      last = max(min(s.last < 0 ? 0 : s.last, len), 0);
    }
  } else {
    cnt = s.cnt;
    first = s.first >= kBig ? -1 : min(s.first, len);
    last = s.last < 0 ? -1 : min(s.last, len);
  }
  cnt_o[r] = cnt;
  first_o[r] = first;
  last_o[r] = last;
  full_o[r] = full ? 1 : 0;
}

template <int kP>
__global__ void __launch_bounds__(kThreads)
word_stats_mc_kernel(const uint8_t* __restrict__ data, long long stride, int L,
                     const int32_t* __restrict__ lengths, int R,
                     const uint32_t* __restrict__ tab_g,
                     const int32_t* __restrict__ deltas_g, int n_d, uint32_t acc_union,
                     int P, const uint32_t* __restrict__ accs_g,
                     int seeded, int lead, int nullable,
                     int32_t* __restrict__ cnt_o, int32_t* __restrict__ first_o,
                     int32_t* __restrict__ last_o, uint8_t* __restrict__ full_o) {
  extern __shared__ uint32_t smem[];
  const Tables tb = load_tables(smem, tab_g, deltas_g, n_d);
  uint32_t* accs = smem + (kSyms + 2) * n_d;  // after the tables (smem_bytes(n_d))
  for (int i = threadIdx.x; i < P; i += blockDim.x) accs[i] = accs_g[i];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Row rec = record(data, stride, L, lengths, r);
  const int len = rec.len;
  const size_t row = static_cast<size_t>(r) * P;
  // cnt, first step, last step: registers, or the outputs' rows
  int32_t* const rows[3] = {cnt_o + row, first_o + row, last_o + row};
  ChanRegs<kP, 3> ch(rows);
#pragma unroll
  for (int p = 0; p < chan_bound<kP>(P); ++p) {
    if (kP > 0 && p >= P) break;
    ch.at(0, p) = 0;
    ch.at(1, p) = kBig;
    ch.at(2, p) = -1;
  }

  uint32_t v = 0u;
  uint32_t vlen = 0u;  // the state of step len, for the EOS step's per-channel `$` dedup
  walk_steps(rec.row, len, [&](int t, int sym) {
    const bool eos = t == len + 1;
    if (eos) vlen = v;
    v = tb.fwd(v | ((seeded || t < 2) ? 1u : 0u), sym);
    if (t <= lead || (v & acc_union) == 0u) return;
#pragma unroll
    for (int p = 0; p < chan_bound<kP>(P); ++p) {
      if (kP > 0 && p >= P) break;
      const uint32_t a = accs[p];
      if ((v & a) == 0u || (eos && (vlen & a) != 0u)) continue;
      ++ch.at(0, p);
      ch.at(1, p) = ch.at(1, p) == kBig ? t : ch.at(1, p);
      ch.at(2, p) = t;
    }
  });

  // closed forms of _word_stats, per channel
#pragma unroll
  for (int p = 0; p < chan_bound<kP>(P); ++p) {
    if (kP > 0 && p >= P) break;
    const int c = ch.at(0, p), f = ch.at(1, p), l = ch.at(2, p);
    bool full = c > 0 && l >= len;
    int cnt, first, last;
    if (nullable) {
      full = full || len == 0;
      first = 0;
      if (seeded) {
        cnt = len + 1;
        last = l < 0 ? len : min(l, len);
      } else {
        cnt = len == 0 ? 1 : 1 + c - (f == 0 ? 1 : 0);
        last = max(min(l < 0 ? 0 : l, len), 0);
      }
    } else {
      cnt = c;
      first = f >= kBig ? -1 : min(f, len);
      last = l < 0 ? -1 : min(l, len);
    }
    cnt_o[row + p] = cnt;
    first_o[row + p] = first;
    last_o[row + p] = last;
    full_o[row + p] = full ? 1 : 0;
  }
}

template <int kP>
int launch_mc(const void* data, long long stride, int L, const void* lengths, int R,
              const void* tab, const void* deltas, int n_d, unsigned acc, int P,
              const void* accs, int seeded, int lead, int nullable, void* cnt, void* first,
              void* last, void* full, void* stream) {
  const size_t smem = smem_bytes(n_d) + sizeof(uint32_t) * static_cast<size_t>(P);
  int e = allow_smem(word_stats_mc_kernel<kP>, smem);
  if (e != 0) return e;
  const int blocks = (R + kThreads - 1) / kThreads;
  word_stats_mc_kernel<kP><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), stride, L, static_cast<const int32_t*>(lengths), R,
      static_cast<const uint32_t*>(tab), static_cast<const int32_t*>(deltas), n_d, acc, P,
      static_cast<const uint32_t*>(accs), seeded, lead, nullable, static_cast<int32_t*>(cnt),
      static_cast<int32_t*>(first), static_cast<int32_t*>(last), static_cast<uint8_t*>(full));
  return static_cast<int>(cudaGetLastError());
}

template <int kStates>
int launch(const void* data, long long stride, int L, const void* lengths, int R,
           const void* tab, const void* deltas, int n_d, unsigned acc,
           int seeded, int lead, int nullable, void* cnt, void* first,
           void* last, void* full, void* stream) {
  int e = check_args(data, stride, L, R, n_d, acc, kStates);
  if (e != 0 || R == 0) return e;
  const size_t smem = smem_bytes(n_d);
  e = allow_smem(scan_stats_kernel<kStates>, smem);
  if (e != 0) return e;
  const int blocks = (R + kThreads - 1) / kThreads;
  scan_stats_kernel<kStates><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), stride, L,
      static_cast<const int32_t*>(lengths), R, static_cast<const uint32_t*>(tab),
      static_cast<const int32_t*>(deltas), n_d, acc, seeded, lead, nullable,
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(first),
      static_cast<int32_t*>(last), static_cast<uint8_t*>(full));
  return static_cast<int>(cudaGetLastError());
}

// The slotted multi-pattern scan: up to 4 patterns of at most 8 states, one
// byte lane ("slot") of the u32 state each. The seed is state 0 of every
// slot; slot k's flag is (v & accs[k]) != 0, with its own `$` dedup (prev:
// bit k = slot k flagged at the step before) and its own (cnt, first step,
// last step) in registers; the outputs are the non-nullable closed forms,
// [R][P].
constexpr uint32_t kSlotSeed = 0x01010101u;

__global__ void __launch_bounds__(kThreads)
swar_multi_stats_kernel(const uint8_t* __restrict__ data, long long stride, int L,
                        const int32_t* __restrict__ lengths, int R,
                        const uint32_t* __restrict__ tab_g,
                        const int32_t* __restrict__ deltas_g, int n_d, uint32_t acc_union,
                        int P, const uint32_t* __restrict__ accs_g, int seeded,
                        int32_t* __restrict__ cnt_o, int32_t* __restrict__ first_o,
                        int32_t* __restrict__ last_o, uint8_t* __restrict__ full_o) {
  extern __shared__ uint32_t smem[];
  const Tables tb = load_tables(smem, tab_g, deltas_g, n_d);

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Row rec = record(data, stride, L, lengths, r);
  const int len = rec.len;
  uint32_t acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = k < P ? __ldg(accs_g + k) : 0u;

  uint32_t v = 0u;
  uint32_t prev = 0u;
  int cnt[4], first[4], last[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cnt[k] = 0;
    first[k] = kBig;
    last[k] = -1;
  }
  auto step = [&](int t, int sym, bool eos) {
    v = tb.fwd(v | ((seeded || t < 2) ? kSlotSeed : 0u), sym);
    if ((v & acc_union) == 0u) {
      prev = 0u;
      return;
    }
    uint32_t fl = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool f = (v & acc[k]) != 0u;
      fl |= f ? 1u << k : 0u;
      const bool emit = f && !(eos && ((prev >> k) & 1u) != 0u);
      cnt[k] += emit ? 1 : 0;
      first[k] = (emit && first[k] == kBig) ? t : first[k];
      last[k] = emit ? t : last[k];
    }
    prev = fl;
  };
  step(0, kBos, false);
  walk_fwd(rec.row, 0, len, [&](int t, int sym) { step(t, sym, false); },
           [] { return false; });
  step(len + 1, kEos, true);

  const size_t row = static_cast<size_t>(r) * P;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= P) break;
    cnt_o[row + k] = cnt[k];
    first_o[row + k] = first[k] >= kBig ? -1 : min(first[k], len);
    last_o[row + k] = last[k] < 0 ? -1 : min(last[k], len);
    full_o[row + k] = (cnt[k] > 0 && last[k] >= len) ? 1 : 0;
  }
}

template <int kStates>
int occupancy(int n_d, int* blocks_per_sm) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, scan_stats_kernel<kStates>, kThreads, smem_bytes(n_d));
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

int rrx_swar_stats(const void* data, long long stride, int L, const void* lengths,
                   int R, const void* tab, const void* deltas, int n_d,
                   unsigned acc, int seeded, int lead, int nullable, void* cnt,
                   void* first, void* last, void* full, void* stream) {
  return launch<8>(data, stride, L, lengths, R, tab, deltas, n_d, acc, seeded,
                   lead, nullable, cnt, first, last, full, stream);
}

// P accept channels: accs [P] uint32 masks (acc = their union), outputs
// [R][P]; P = 1 runs the single-channel kernel on acc (accs unread).
int rrx_word_stats(const void* data, long long stride, int L, const void* lengths,
                   int R, const void* tab, const void* deltas, int n_d,
                   unsigned acc, int P, const void* accs, int seeded, int lead,
                   int nullable, void* cnt, void* first, void* last, void* full,
                   void* stream) {
  if (P == 1) {
    return launch<32>(data, stride, L, lengths, R, tab, deltas, n_d, acc, seeded,
                      lead, nullable, cnt, first, last, full, stream);
  }
  const int e = check_args(data, stride, L, R, n_d, acc, 32);
  if (e != 0) return e;
  if (P < 1 || accs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  if (P <= kRegChannels) {
    return launch_mc<kRegChannels>(data, stride, L, lengths, R, tab, deltas, n_d, acc, P, accs,
                                   seeded, lead, nullable, cnt, first, last, full, stream);
  }
  return launch_mc<0>(data, stride, L, lengths, R, tab, deltas, n_d, acc, P, accs, seeded,
                      lead, nullable, cnt, first, last, full, stream);
}

// The slotted multi-pattern SWAR scan: P (1..4) slots, accs [P] uint32 slot
// accept masks on the card (slot k's within byte lane k; acc = their
// union), outputs [R][P].
int rrx_swar_multi_stats(const void* data, long long stride, int L, const void* lengths,
                         int R, const void* tab, const void* deltas, int n_d, unsigned acc,
                         int P, const void* accs, int seeded, void* cnt, void* first,
                         void* last, void* full, void* stream) {
  int e = check_args(data, stride, L, R, n_d, acc, 32);
  if (e != 0) return e;
  if (P < 1 || P > 4 || accs == nullptr || (P < 4 && (acc >> (8 * P)) != 0u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return 0;
  const size_t smem = smem_bytes(n_d);
  e = allow_smem(swar_multi_stats_kernel, smem);
  if (e != 0) return e;
  const int blocks = (R + kThreads - 1) / kThreads;
  swar_multi_stats_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), stride, L, static_cast<const int32_t*>(lengths), R,
      static_cast<const uint32_t*>(tab), static_cast<const int32_t*>(deltas), n_d, acc, P,
      static_cast<const uint32_t*>(accs), seeded, static_cast<int32_t*>(cnt),
      static_cast<int32_t*>(first), static_cast<int32_t*>(last), static_cast<uint8_t*>(full));
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of one kernel (theoretical occupancy). Kernel
// index: 0 rrx_swar_stats, 1 rrx_word_stats (one channel), then the span kernels of
// scan_spans.cu: 2 rrx_swar_reverse, 3 rrx_swar_lazy_spans,
// 4 rrx_swar_anchor_end, 5 rrx_swar_greedy_spans; for these `size` is the
// table's delta count. Then the matmul-tier kernels of scan_nfa.cu:
// 6 rrx_nfa_stats, 7 rrx_nfa_reverse, 8 rrx_nfa_anchor_end,
// 9 rrx_nfa_lazy_spans, 10 rrx_nfa_greedy_spans, 11 rrx_nfa_flags; for these
// `size` is s_tile. Then the counting-tier kernels of scan_count.cu:
// 12 rrx_count_stats, 13 rrx_count_flags, 14 rrx_count_reverse; for these
// `size` is the body length k. 17-20: the long-string window kernels of
// scan_long.cu (`size` = s_tile); 21: rrx_swar_multi_stats (`size` = the
// table's delta count).
int rrx_occupancy(int kernel, int size, int* blocks_per_sm) {
  if (kernel == 0) return occupancy<8>(size, blocks_per_sm);
  if (kernel == 1) return occupancy<32>(size, blocks_per_sm);
  if (kernel < 6) return spans_occupancy(kernel - 2, size, blocks_per_sm);
  if (kernel < 12) return nfa_occupancy(kernel - 6, size, blocks_per_sm);
  if (kernel < 15) return count_occupancy(kernel - 12, size, blocks_per_sm);
  if (kernel >= 17 && kernel < 21) return long_occupancy(kernel - 17, size, blocks_per_sm);
  if (kernel == 21) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, swar_multi_stats_kernel, kThreads, smem_bytes(size));
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks per SM of the P-channel kernels: 0 rrx_word_stats (`size`
// = the table's delta count), then scan_nfa.cu's (`size` = s_tile):
// 1 rrx_nfa_stats, 2 rrx_nfa_reverse_mb, 3 rrx_nfa_lazy_spans_mb.
int rrx_occupancy_channels(int kernel, int size, int P, int* blocks_per_sm) {
  if (kernel == 0) {
    if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(size) + sizeof(uint32_t) * static_cast<size_t>(P);
    const cudaError_t e =
        P <= kRegChannels
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks_per_sm, word_stats_mc_kernel<kRegChannels>, kThreads, smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks_per_sm, word_stats_mc_kernel<0>, kThreads, smem);
    return static_cast<int>(e);
  }
  return nfa_channels_occupancy(kernel - 1, size, P, blocks_per_sm);
}

int rrx_threads_per_block() { return kThreads; }

const char* rrx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
