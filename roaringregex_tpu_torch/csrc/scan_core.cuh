// Shared core of the per-record bit-set scans (scan_bits.cu, scan_spans.cu,
// scan_nfa.cu): the (delta, table) step of the SWAR and u32-word tiers, the
// row walks, the record rows and the launchers' argument checks.
//
// One program is in its (delta, table) form: tab[sym][i] is the union of
// the target masks of the pairs at delta_i whose gate holds sym (a byte,
// 256 = BOS, 257 = EOS; bytes >= 0x80 have zero rows). A forward step is
//     v' = OR_i shift(v, delta_i) & tab[sym][i]
// and the mirrored (reverse) step runs the same pairs target -> source:
//     R' = OR_i unshift(R & tab[sym][i], delta_i)
// with shift = << delta for delta > 0 and >> -delta for delta < 0, and
// unshift its inverse. Both are one expression over the shift amounts
// sl = max(delta, 0), sr = max(-delta, 0): (v << sl) >> sr forward,
// (x >> sl) << sr reverse. The state is uint32_t, so >> is logical and
// shift amounts are 0..31.
//
// Records are rows of data[R, stride] (uint8, 16-byte aligned, stride a
// multiple of 16); stream step t = 0 is BOS, step t carries byte t-1, step
// len+1 is EOS. The walkers below read a row 16 bytes at a time through
// the read-only path, with the next 16 bytes prefetched, so each thread
// uses every 32-byte sector whole across two consecutive loads.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace rrx {

constexpr int kSyms = 259;  // 256 bytes, BOS, EOS, dead
constexpr int kBos = 256;
constexpr int kEos = 257;
constexpr int kDead = 258;  // a step past EOS or before BOS (its mask row: zero)
constexpr int kThreads = 128;
constexpr int kMaxDeltas = 63;  // deltas lie in [-31, 31]

struct Tables {
  const uint32_t* tab;  // shared [kSyms][n_d]
  const int* sl;        // shared [n_d] left shift amounts
  const int* sr;        // shared [n_d] right shift amounts
  int n_d;

  __device__ __forceinline__ uint32_t fwd(uint32_t vv, int sym) const {
    const uint32_t* row = tab + sym * n_d;
    uint32_t nxt = 0;
    for (int i = 0; i < n_d; ++i) nxt |= ((vv << sl[i]) >> sr[i]) & row[i];
    return nxt;
  }

  __device__ __forceinline__ uint32_t rev(uint32_t x, int sym) const {
    const uint32_t* row = tab + sym * n_d;
    uint32_t nxt = 0;
    for (int i = 0; i < n_d; ++i) nxt |= ((x & row[i]) >> sl[i]) << sr[i];
    return nxt;
  }
};

inline size_t smem_bytes(int n_d) {
  return sizeof(uint32_t) * (size_t)kSyms * n_d + 2 * sizeof(int) * (size_t)n_d;
}

// Copies the tables into dynamic shared memory. Every thread of the block
// calls it (it ends in __syncthreads) before any thread returns.
__device__ __forceinline__ Tables load_tables(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                              const int32_t* __restrict__ deltas_g, int n_d) {
  uint32_t* tab = smem;
  int* sl = reinterpret_cast<int*>(smem + kSyms * n_d);
  int* sr = sl + n_d;
  for (int i = threadIdx.x; i < kSyms * n_d; i += blockDim.x) tab[i] = tab_g[i];
  for (int i = threadIdx.x; i < n_d; i += blockDim.x) {
    const int d = deltas_g[i];
    sl[i] = d > 0 ? d : 0;
    sr[i] = d < 0 ? -d : 0;
  }
  __syncthreads();
  return Tables{tab, sl, sr, n_d};
}

struct Row {
  const uint4* row;
  int len;  // clamped to [0, L]
};

__device__ __forceinline__ Row record(const uint8_t* data, long long stride, int L,
                                      const int32_t* lengths, int r) {
  return Row{reinterpret_cast<const uint4*>(data + r * stride), min(max(lengths[r], 0), L)};
}

// Writes -1 into span slots from .. cap-1 of one record's start/end rows.
__device__ __forceinline__ void fill_tail(int32_t* s, int32_t* e, int from, int cap) {
  for (int k = from; k < cap; ++k) {
    s[k] = -1;
    e[k] = -1;
  }
}

__device__ __forceinline__ int byte_at(const uint4& q, int i) {
  const uint32_t w = i < 4 ? q.x : i < 8 ? q.y : i < 12 ? q.z : q.w;
  return (w >> (8 * (i & 3))) & 0xFFu;
}

// Forward walk over bytes b0 .. len-1 of a row: f(t, byte) for the steps
// t = b0+1 .. len, in order. stop() is asked after every 16-byte chunk;
// once it says true the walk ends (the caller makes sure that skipping the
// rest changes no output).
template <class F, class Stop>
__device__ __forceinline__ void walk_fwd(const uint4* row, int b0, int len, F&& f, Stop&& stop) {
  const int nchunks = (len + 15) >> 4;
  int c = b0 >> 4;
  if (c >= nchunks) return;
  uint4 cur = __ldg(row + c);
  for (; c < nchunks; ++c) {
    const uint4 nxt = (c + 1 < nchunks) ? __ldg(row + c + 1) : cur;
    const int lo = b0 - 16 * c;  // > 0 only in the first chunk
    const int n = len - 16 * c;  // < 16 only in the last chunk
    if (lo <= 0 && n >= 16) {
#pragma unroll
      for (int i = 0; i < 16; ++i) f(1 + 16 * c + i, byte_at(cur, i));
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i >= lo && i < n) f(1 + 16 * c + i, byte_at(cur, i));
      }
    }
    if (stop()) return;
    cur = nxt;
  }
}

// Backward walk over bytes len-1 .. 0 of a row: f(t, byte) for the steps
// t = len .. 1, in that order.
template <class F>
__device__ __forceinline__ void walk_rev(const uint4* row, int len, F&& f) {
  int c = ((len + 15) >> 4) - 1;
  if (c < 0) return;
  uint4 cur = __ldg(row + c);
  for (; c >= 0; --c) {
    const uint4 nxt = c > 0 ? __ldg(row + c - 1) : cur;
    const int n = len - 16 * c;
    if (n >= 16) {
#pragma unroll
      for (int i = 15; i >= 0; --i) f(1 + 16 * c + i, byte_at(cur, i));
    } else {
#pragma unroll
      for (int i = 15; i >= 0; --i) {
        if (i < n) f(1 + 16 * c + i, byte_at(cur, i));
      }
    }
    cur = nxt;
  }
}

// Every stream step of a record in order, t = 0 .. len+1: f(t, sym) with sym
// = kBos at 0, the byte t-1, kEos at len+1. One call site and a loop that
// does not unroll: the multi-channel kernels, whose step body is large,
// keep their code (and nvcc's time) small this way; the row is still read
// 16 bytes at a time.
template <class F>
__device__ __forceinline__ void walk_steps(const uint4* row, int len, F&& f) {
  uint4 q{};
#pragma unroll 1
  for (int t = 0; t <= len + 1; ++t) {
    int sym = t == 0 ? kBos : kEos;
    if (t >= 1 && t <= len) {
      const int j = t - 1;
      if ((j & 15) == 0) q = __ldg(row + (j >> 4));
      sym = byte_at(q, j & 15);
    }
    f(t, sym);
  }
}

// The stop of a walk that runs to its end: the default of chunk_up and
// walk_chunks_pair, which then take no test.
struct NoStop {
  __device__ __forceinline__ constexpr bool operator()(int) const { return false; }
};

// f(t0 + b, byte b of q) for b = 0 .. n - 1: each byte taken off the bottom
// of the 16-byte chunk in registers (a rolled loop: the callers' steps are
// long). stop(t) is asked after each step t; once it says true no step
// follows and chunk_up returns true.
template <class F, class Stop = NoStop>
__device__ __forceinline__ bool chunk_up(uint4 q, int t0, int n, F&& f, Stop&& stop = Stop{}) {
#pragma unroll 1
  for (int b = 0; b < n; ++b) {
    const int sym = static_cast<int>(q.x & 0xFFu);
    q.x = __funnelshift_r(q.x, q.y, 8);
    q.y = __funnelshift_r(q.y, q.z, 8);
    q.z = __funnelshift_r(q.z, q.w, 8);
    q.w >>= 8;
    f(t0 + b, sym);
    if (stop(t0 + b)) return true;
  }
  return false;
}

// walk_steps with the next chunk's load issued a chunk ahead (the last
// chunk is loaded again at the end: no read past the row), each chunk's
// bytes through chunk_up: three copies of the step (BOS, the bytes, EOS)
// where walk_steps has one.
template <class F>
__device__ __forceinline__ void walk_chunks(const uint4* row, int len, F&& f) {
  f(0, kBos);
  const int nc = (len + 15) >> 4;
  uint4 nq = nc > 0 ? __ldg(row) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const uint4 q = nq;
    nq = __ldg(row + min(c + 1, nc - 1));
    chunk_up(q, 1 + 16 * c, min(16, len - 16 * c), f);
  }
  f(len + 1, kEos);
}

// walk_chunks for two records at once, one a half of a warp (the wide
// record kernels' two records a warp), walked up to the longer one so that
// the loop is warp-uniform: f(t, sym) for t = 0 .. len_max + 1, sym this
// half's own symbol: kBos at 0, byte t-1 for t <= len, kEos at len+1 and
// kDead past it. Each half reads its own record's chunks, the next loaded a
// chunk ahead (once its record is done, its last chunk again: no read past
// its row). stop(t), warp-uniform, is asked after each step t but the last
// (as walk_fwd's stop, the caller makes sure that skipping the rest changes
// no output); the default asks nothing.
template <class F, class Stop = NoStop>
__device__ __forceinline__ void walk_chunks_pair(const uint4* row, int len, int len_max, F&& f,
                                                 Stop&& stop = Stop{}) {
  f(0, kBos);
  if (stop(0)) return;
  const int nc = (len_max + 15) >> 4;  // the longer record's chunks
  const int own = (len + 15) >> 4;     // this half's
  uint4 nq = own > 0 ? __ldg(row) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const uint4 q = nq;
    if (own > 0) nq = __ldg(row + min(c + 1, own - 1));
    if (chunk_up(
            q, 1 + 16 * c, min(16, len_max - 16 * c),
            [&](int t, int sym) { f(t, t <= len ? sym : (t == len + 1 ? kEos : kDead)); },
            stop)) {
      return;
    }
  }
  f(len_max + 1, len_max == len ? kEos : kDead);
}

// walk_steps backwards, t = len+1 .. 0, one call site of f: an outer loop
// over segments (the EOS step, the record's 16-byte chunks from the last,
// the BOS step) and an inner one over a segment's steps. Each chunk is
// loaded a chunk ahead (chunk c - 1 is asked for when chunk c is taken
// up, so its latency hides behind 16 steps) and its bytes are taken off the
// top of the chunk in registers: the last chunk is first shifted up until
// byte len-1 is its top byte, then each step takes the top byte and shifts
// the chunk up by 8 bits. No step tests for a chunk's end.
template <class F>
__device__ __forceinline__ void walk_chunks_rev(const uint4* row, int len, F&& f) {
  auto up8 = [](uint4& x) {
    x.w = __funnelshift_l(x.z, x.w, 8);
    x.z = __funnelshift_l(x.y, x.z, 8);
    x.y = __funnelshift_l(x.x, x.y, 8);
    x.x <<= 8;
  };
  const int nc = (len + 15) >> 4;  // the record's chunks
  uint4 nq = nc > 0 ? __ldg(row + nc - 1) : make_uint4(0u, 0u, 0u, 0u);
  int t = len + 1;
#pragma unroll 1
  for (int c = nc; c >= -1; --c) {  // c = nc: the EOS step; c = -1: the BOS step
    uint4 q = nq;
    int n = 1, fixed = c < 0 ? kBos : kEos;
    if (c >= 0 && c < nc) {
      n = min(16, len - 16 * c);
      fixed = -1;
      nq = __ldg(row + max(c - 1, 0));
#pragma unroll 1
      for (int k = n; k < 16; ++k) up8(q);  // byte n-1 of the chunk to its top
    }
#pragma unroll 1
    for (int b = 0; b < n; ++b, --t) {
      const int sym = fixed >= 0 ? fixed : static_cast<int>(q.w >> 24);
      up8(q);
      f(t, sym);
    }
  }
}

// walk_steps backwards: t = len+1 .. 0.
template <class F>
__device__ __forceinline__ void walk_steps_rev(const uint4* row, int len, F&& f) {
  uint4 q{};
#pragma unroll 1
  for (int t = len + 1; t >= 0; --t) {
    int sym = t == 0 ? kBos : kEos;
    if (t >= 1 && t <= len) {
      const int j = t - 1;
      if (t == len || (j & 15) == 15) q = __ldg(row + (j >> 4));
      sym = byte_at(q, j & 15);
    }
    f(t, sym);
  }
}

// Accept channels (multi-pattern programs): the per-(record, channel)
// bookkeeping of the P-channel kernels stays in registers for at most
// kRegChannels channels, else in per-thread rows of global memory.
constexpr int kRegChannels = 8;

// The loop bound of a channel loop: the fixed register count (the loop
// unrolls and per-channel arrays stay in registers; channels p >= P are
// skipped) or the runtime count.
template <int kP>
__device__ __forceinline__ int chan_bound(int P) {
  return kP > 0 ? kP : P;
}

// kN running int values per channel of one record: registers for at most
// kP channels (kP > 0), else (kP == 0) the given per-thread rows.
template <int kP, int kN>
struct ChanRegs {
  int v_[kN][kP];
  __device__ __forceinline__ explicit ChanRegs(int32_t* const (&)[kN]) {}
  __device__ __forceinline__ int& at(int i, int p) { return v_[i][p]; }
};

template <int kN>
struct ChanRegs<0, kN> {
  int32_t* row_[kN];
  __device__ __forceinline__ explicit ChanRegs(int32_t* const (&rows)[kN]) {
#pragma unroll
    for (int i = 0; i < kN; ++i) row_[i] = rows[i];
  }
  __device__ __forceinline__ int& at(int i, int p) { return row_[i][p]; }
};

// The launchers' shared checks on what the wrapper passes: negative shapes
// or a misaligned row (check_rows; rows may overlap: the long-string
// windows are a strided view of one buffer), and for the (delta, table) kernels a
// bad table size or accept bits past the automaton's width (check_args),
// are refused before any launch.
inline int check_rows(const void* data, long long stride, int L, int R) {
  if (R < 0 || L < 0 || (R > 1 && stride <= 0) || stride % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(data) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

inline int check_args(const void* data, long long stride, int L, int R, int n_d,
                      unsigned acc, int states) {
  if (n_d < 0 || n_d > kMaxDeltas) return static_cast<int>(cudaErrorInvalidValue);
  if (states < 32 && (acc >> states) != 0u) return static_cast<int>(cudaErrorInvalidValue);
  return check_rows(data, stride, L, R);
}

// Raises a kernel's dynamic shared-memory limit when its tables need more
// than the default 48 KB.
template <class K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// Resident blocks per SM of the span kernels (scan_spans.cu), by index:
// 0 reverse, 1 lazy spans, 2 anchor end, 3 greedy spans.
int spans_occupancy(int kernel, int n_d, int* blocks_per_sm);

// Resident blocks per SM of the matmul-tier kernels (scan_nfa.cu) for a
// record tile of s_tile states, by index: 0 stats, 1 reverse, 2 anchor end,
// 3 lazy spans, 4 greedy spans, 5 flags.
int nfa_occupancy(int kernel, int s_tile, int* blocks_per_sm);

// Resident blocks per SM of the matmul tier's P-channel kernels
// (scan_nfa.cu), by index: 0 stats, 1 reverse_mb, 2 lazy_spans_mb.
int nfa_channels_occupancy(int kernel, int s_tile, int P, int* blocks_per_sm);

// Resident blocks per SM of the counting-tier kernels (scan_count.cu) for a
// body of k positions, by index: 0 stats, 1 flags, 2 reverse.
int count_occupancy(int kernel, int k, int* blocks_per_sm);

// Resident blocks per SM of the long-string window kernels (scan_long.cu)
// for a record tile of s_tile states, by index: 0 carry, 1 flags, 2 count,
// 3 reverse.
int long_occupancy(int kernel, int s_tile, int* blocks_per_sm);

}  // namespace rrx
