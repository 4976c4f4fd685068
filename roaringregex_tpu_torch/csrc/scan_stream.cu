// Stream-fed scans on Hopper (sm_90a): match statistics, forward flags,
// candidate starts and anchored rescans of a dense or multiblock program
// (record tiles of up to 1024 states) over a precomputed symbol-mask stream
// instead of bytes: the packed backend of ops/scan_packed.py and the
// stream-fed methods of scan_pallas.PallasScanner.
//
// Replaces four Pallas TPU kernels of the JAX package (rows 7-10 of
// PERF.md's table, all in roaringregex_tpu/ops/scan_pallas.py) and the
// portable scan_packed primitives that compute the same functions:
//   rrx_stream_stats     <- _match_kernel (via PallasScanner._match_call);
//                           scan_packed.match_stats, with P accept channels
//   rrx_stream_flags     <- _flags_kernel (via _flags_call);
//                           scan_packed.forward_flags
//   rrx_stream_reverse   <- _reverse_kernel (via _reverse_call);
//                           scan_packed.reverse_hits
//   rrx_stream_first_end <- _first_end_kernel (via _first_end_call), lazy;
//                           scan_packed.first_end_from, lazy and longest
//
// The stream: words [T][R][W] uint32, T steps of R records, W =
// ceil(s_tile/32) words a record-step (bit s of word s/32 = state s may
// take this step's symbol). Step 0 is BOS, step t the byte t-1, then the
// EOS step and zero rows (ops/scan_packed.mask_stream_from_bytes). The
// table is scan_pallas.nfa_tables' (follow [S][W], pred [S][W], the mask
// rows, which these kernels do not read, and P accept rows).
//
// What they compute: the matmul tier's set-form step (scan_nfa.cu's header)
// with the mask row taken from the stream,
//     v = (OR of follow[s] over s in v | seed gate ? follow[0] : 0) & m_t
//     R = OR of pred[u] over u in (R | acc) & m_t;  hit = state 0 in R
// over every step t < T of the stream, as the JAX functions run it:
// - stats: seed gate every step (seeded) or t < 2; a step whose state meets
//   a channel's accept row has end e = min(t, len): cnt counts the e that
//   differ from the channel's last one (not for a nullable seeded scan),
//   first is the first e, last the latest; nullable starts: cnt = len + 1,
//   last = len (seeded) or cnt = 1, last = 0, and first = 0. An unseeded
//   scan stops at its first empty state past step 1 (no seed comes after).
// - flags: the accept flag of every step as flag words [ceil(T/32)][R],
//   bit t of record r in word t/32.
// - reverse: hit words [ceil(T/32)][R] from step T-1 down to 0.
// - first end: start st >= 0 seeds step st+1, and st = 0 also step 0; the
//   first (lazy) or last (longest) accepting step's e = min(t, len) with
//   e >= st, -1 when none; the scan starts at the seed step and stops at the
//   first empty state past it (or, lazy, at the first end).
//
// Design: the step and its tables are those of the byte-fed kernels (tiles
// of up to 256 states: one thread per record, its state in W <= 8
// registers, the rows in shared memory; 257..1024 states: one warp per
// record, lane l holding state word l, persistent blocks taking records
// from a counter), so they are as right as those are. What changes is the
// input: 4 W bytes a record-step from HBM, time-major so that a warp's
// loads of one step are contiguous (W consecutive words per thread, or one
// word per lane), the next step's row prefetched into registers before
// this step's expansion. That input is 4 W times the byte kernels', so the
// byte-fed kernels stay the default path; the packed backend and the
// counting tier's anchored rescans (JAX engine.py:825-835) run these.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "scan_core.cuh"
#include "scan_nfa.cuh"
#include "scan_nfa_wide.cuh"

namespace {

using namespace rrx;

// One record's rows of the stream: step t's W words at p + t * step.
template <int W>
struct StreamRows {
  const uint32_t* p;
  size_t step;

  __device__ __forceinline__ void load(uint32_t (&m)[W], int t) const {
    const uint32_t* q = p + static_cast<size_t>(t) * step;
#pragma unroll
    for (int k = 0; k < W; ++k) m[k] = __ldg(q + k);
  }
};

template <int W>
__device__ __forceinline__ void copy(uint32_t (&a)[W], const uint32_t (&b)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) a[k] = b[k];
}

#define STREAM_HEAD \
  const uint32_t *__restrict__ words, int T, int R, const uint32_t *__restrict__ tab_g, int S

#define STREAM_BEGIN(P)                                             \
  extern __shared__ uint32_t smem[];                                \
  const Nfa<W> nfa = load_nfa<W>(smem, tab_g, S, P);                \
  const int r = blockIdx.x * blockDim.x + threadIdx.x;              \
  if (r >= R) return;                                               \
  const StreamRows<W> rows{words + static_cast<size_t>(r) * W,      \
                           static_cast<size_t>(R) * W}

// ---- one thread per record (W <= 8) ---------------------------------------

template <int W>
__global__ void __launch_bounds__(kThreads)
stream_stats_kernel(STREAM_HEAD, const int32_t* __restrict__ lengths, int P, int seeded,
                    int nullable, int32_t* __restrict__ cnt_o, int32_t* __restrict__ first_o,
                    int32_t* __restrict__ last_o) {
  STREAM_BEGIN(P);
  const uint32_t* accs = smem + (2 * S + kSyms) * W;
  const int len = lengths[r];
  const bool dedup = !(nullable && seeded);
  const size_t row = static_cast<size_t>(r) * P;
  // one channel in registers; P > 1 in the output rows [R][P]
  int cnt = nullable ? (seeded ? len + 1 : 1) : 0;
  int first = nullable ? 0 : -1;
  int last = nullable ? (seeded ? len : 0) : -1;
  if (P > 1) {
    for (int p = 0; p < P; ++p) {
      cnt_o[row + p] = cnt;
      first_o[row + p] = first;
      last_o[row + p] = last;
    }
  }
  uint32_t v[W], m[W], mn[W];
  clear(v);
  if (T > 0) rows.load(m, 0);
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) rows.load(mn, t + 1);
    nfa.fwd_row(v, seeded || t < 2, m);
    if (nfa.accepts(v)) {
      const int e = min(t, len);
      if (P == 1) {
        cnt += (dedup && e != last) ? 1 : 0;
        first = first < 0 ? e : first;
        last = e;
      } else {
        for (int p = 0; p < P; ++p) {
          if (!meets(v, accs + p * W)) continue;
          const size_t o = row + p;
          if (dedup && e != last_o[o]) cnt_o[o] += 1;
          if (first_o[o] < 0) first_o[o] = e;
          last_o[o] = e;
        }
      }
    }
    // unseeded: past the last seed step an empty state set accepts nothing
    if (!seeded && t >= 1 && empty(v)) break;
    copy(m, mn);
  }
  if (P == 1) {
    cnt_o[r] = cnt;
    first_o[r] = first;
    last_o[r] = last;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
stream_flags_kernel(STREAM_HEAD, int seeded, uint32_t* __restrict__ flags) {
  STREAM_BEGIN(1);
  uint32_t v[W], m[W], mn[W];
  clear(v);
  if (T > 0) rows.load(m, 0);
  uint32_t word = 0u;
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) rows.load(mn, t + 1);
    nfa.fwd_row(v, seeded || t < 2, m);
    word |= (nfa.accepts(v) ? 1u : 0u) << (t & 31);
    if ((t & 31) == 31 || t == T - 1) {  // walking up, bit t closes word t / 32
      flags[static_cast<size_t>(t >> 5) * R + r] = word;
      word = 0u;
    }
    copy(m, mn);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
stream_reverse_kernel(STREAM_HEAD, uint32_t* __restrict__ hits) {
  STREAM_BEGIN(1);
  uint32_t rs[W], m[W], mn[W];
  clear(rs);
  if (T > 0) rows.load(m, T - 1);
  uint32_t word = 0u;
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) rows.load(mn, t - 1);
    nfa.rev_row(rs, m);
    word |= (rs[0] & 1u) << (t & 31);
    if ((t & 31) == 0) {  // walking down, bit t closes word t / 32
      hits[static_cast<size_t>(t >> 5) * R + r] = word;
      word = 0u;
    }
    copy(m, mn);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
stream_first_end_kernel(STREAM_HEAD, const int32_t* __restrict__ lengths,
                        const int32_t* __restrict__ starts, int longest,
                        int32_t* __restrict__ end_o) {
  STREAM_BEGIN(1);
  const int st = starts[r], len = lengths[r];
  int first = -1;
  if (st >= 0) {
    const int t0 = st == 0 ? 0 : st + 1;
    uint32_t v[W], m[W], mn[W];
    clear(v);
    if (t0 < T) rows.load(m, t0);
#pragma unroll 1
    for (int t = t0; t < T; ++t) {
      if (t + 1 < T) rows.load(mn, t + 1);
      nfa.fwd_row(v, t == st + 1 || (st == 0 && t <= 1), m);
      if (nfa.accepts(v)) {
        const int e = min(t, len);
        if (e >= st && (longest || first < 0)) first = e;
      }
      // past the last seed step an empty state set stays empty
      if (t > st && (empty(v) || (!longest && first >= 0))) break;
      copy(m, mn);
    }
  }
  end_o[r] = first;
}

// ---- one warp per record (W = 12..32) ---------------------------------------

#define WIDE_STREAM_HEAD STREAM_HEAD, int W

// This lane's word of record r's row at step t (0 for a lane >= W).
__device__ __forceinline__ uint32_t lane_word(const Wide& k, const uint32_t* words, int R,
                                              int r, int t) {
  return k.on ? __ldg(words + (static_cast<size_t>(t) * R + r) * k.W + k.col) : 0u;
}

__global__ void __launch_bounds__(kWideThreads)
wide_stream_stats_kernel(WIDE_STREAM_HEAD, const int32_t* __restrict__ lengths, int P,
                         int seeded, int nullable, int32_t* __restrict__ cnt_o,
                         int32_t* __restrict__ first_o, int32_t* __restrict__ last_o,
                         int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, P, false);
  const bool dedup = !(nullable && seeded);
  WIDE_RECORDS {
    uint32_t* buf = smem + static_cast<size_t>(S + kSyms + P) * W + warp * W;
    const int len = lengths[r];
    const long long base = static_cast<long long>(r) * P;
    int cnt = nullable ? (seeded ? len + 1 : 1) : 0;
    int first = nullable ? 0 : -1;
    int last = nullable ? (seeded ? len : 0) : -1;
    if (P > 1) {
      for (int c = lane; c < P; c += 32) {
        cnt_o[base + c] = cnt;
        first_o[base + c] = first;
        last_o[base + c] = last;
      }
      __syncwarp();
    }
    uint32_t v = 0u;
    uint32_t m = T > 0 ? lane_word(k, words, R, r, 0) : 0u;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const uint32_t mn = t + 1 < T ? lane_word(k, words, R, r, t + 1) : 0u;
      v = k.fwd_word(v, seeded || t < 2, m);
      if (k.accepts(v)) {
        const int e = min(t, len);
        if (P == 1) {
          cnt += (dedup && e != last) ? 1 : 0;
          first = first < 0 ? e : first;
          last = e;
        } else {
          if (k.on) buf[lane] = v;
          __syncwarp();
          for (int c = lane; c < P; c += 32) {
            if (!k.channel_hit(buf, c)) continue;
            const long long o = base + c;
            if (dedup && e != last_o[o]) cnt_o[o] += 1;
            if (first_o[o] < 0) first_o[o] = e;
            last_o[o] = e;
          }
          __syncwarp();
        }
      }
      // unseeded: past the last seed step an empty state set accepts nothing
      if (!seeded && t >= 1 && empty(v)) break;
      m = mn;
    }
    if (P == 1 && lane == 0) {
      cnt_o[r] = cnt;
      first_o[r] = first;
      last_o[r] = last;
    }
  }
}

__global__ void __launch_bounds__(kWideThreads)
wide_stream_flags_kernel(WIDE_STREAM_HEAD, int seeded, uint32_t* __restrict__ flags,
                         int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, false);
  WIDE_RECORDS {
    uint32_t v = 0u, word = 0u;
    uint32_t m = T > 0 ? lane_word(k, words, R, r, 0) : 0u;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const uint32_t mn = t + 1 < T ? lane_word(k, words, R, r, t + 1) : 0u;
      v = k.fwd_word(v, seeded || t < 2, m);
      word |= (k.accepts(v) ? 1u : 0u) << (t & 31);
      if ((t & 31) == 31 || t == T - 1) {  // walking up, bit t closes word t / 32
        if (lane == 0) flags[static_cast<size_t>(t >> 5) * R + r] = word;
        word = 0u;
      }
      m = mn;
    }
  }
}

__global__ void __launch_bounds__(kWideThreads)
wide_stream_reverse_kernel(WIDE_STREAM_HEAD, uint32_t* __restrict__ hits, int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, true);
  WIDE_RECORDS {
    uint32_t rs = 0u, word = 0u;
    uint32_t m = T > 0 ? lane_word(k, words, R, r, T - 1) : 0u;
#pragma unroll 1
    for (int t = T - 1; t >= 0; --t) {
      const uint32_t mn = t > 0 ? lane_word(k, words, R, r, t - 1) : 0u;
      rs = k.rev_word(rs, m);
      word |= (__shfl_sync(kFull, rs, 0) & 1u) << (t & 31);
      if ((t & 31) == 0) {  // walking down, bit t closes word t / 32
        if (lane == 0) hits[static_cast<size_t>(t >> 5) * R + r] = word;
        word = 0u;
      }
      m = mn;
    }
  }
}

__global__ void __launch_bounds__(kWideThreads)
wide_stream_first_end_kernel(WIDE_STREAM_HEAD, const int32_t* __restrict__ lengths,
                             const int32_t* __restrict__ starts, int longest,
                             int32_t* __restrict__ end_o, int32_t* next) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Wide k = load_wide(smem, tab_g, S, W, 1, false);
  WIDE_RECORDS {
    const int st = starts[r], len = lengths[r];
    int first = -1;
    if (st >= 0) {
      const int t0 = st == 0 ? 0 : st + 1;
      uint32_t v = 0u;
      uint32_t m = t0 < T ? lane_word(k, words, R, r, t0) : 0u;
#pragma unroll 1
      for (int t = t0; t < T; ++t) {
        const uint32_t mn = t + 1 < T ? lane_word(k, words, R, r, t + 1) : 0u;
        v = k.fwd_word(v, t == st + 1 || (st == 0 && t <= 1), m);
        if (k.accepts(v)) {
          const int e = min(t, len);
          if (e >= st && (longest || first < 0)) first = e;
        }
        // past the last seed step an empty state set stays empty
        if (t > st && (empty(v) || (!longest && first >= 0))) break;
        m = mn;
      }
    }
    if (lane == 0) end_o[r] = first;
  }
}

// ---- launchers ----------------------------------------------------------------

template <class K, class... Args>
int launch_rows(K kernel, int R, size_t smem, void* stream, Args... args) {
  if (R == 0) return 0;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const int blocks = (R + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int check_stream(const void* words, int T, int R, int s_tile, int P) {
  if (words == nullptr && static_cast<long long>(T) * R > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T < 0 || R < 0 || P < 1 || s_tile < 1 || s_tile > kMaxTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Runs narrow(integral_constant<int, W>) for a tile of up to 256 states (one
// thread per record) or wide(W) for 257..1024 (one warp per record).
template <class N, class Wd>
int by_form(int s_tile, N&& narrow, Wd&& wide) {
  if (s_tile <= 256) return by_words(s_tile, narrow);
  return wide(words_of(s_tile));
}

}  // namespace

#define RRX_STREAM_HEAD const void *words, int T, int R, const void *tab, int s_tile
#define RRX_STREAM_ARGS \
  static_cast<const uint32_t*>(words), T, R, static_cast<const uint32_t*>(tab), s_tile

extern "C" {

// Every entry point: the stream words [T][R][ceil(s_tile/32)] uint32, the
// table of scan_pallas.nfa_tables (P accept rows), its own arguments, then
// next (a device int32 set to 0: the record counter of the warp form, which
// the thread form does not read) and the stream.
//
// lengths: [R] int32; cnt, first, last: [R][P] int32
int rrx_stream_stats(RRX_STREAM_HEAD, const void* lengths, int P, int seeded, int nullable,
                     void* cnt, void* first, void* last, void* next, void* stream) {
  const int bad = check_stream(words, T, R, s_tile, P);
  if (bad != 0) return bad;
  const auto* ln = static_cast<const int32_t*>(lengths);
  auto* c = static_cast<int32_t*>(cnt);
  auto* f = static_cast<int32_t*>(first);
  auto* l = static_cast<int32_t*>(last);
  return by_form(
      s_tile,
      [&](auto w) {
        constexpr int W = decltype(w)::value;
        return launch_rows(stream_stats_kernel<W>, R, nfa_smem_bytes(s_tile, W, P), stream,
                           RRX_STREAM_ARGS, ln, P, seeded, nullable, c, f, l);
      },
      [&](int W) {
        return launch_wide(wide_stream_stats_kernel, R, wide_smem_bytes(s_tile, W, P, P > 1),
                           stream, RRX_STREAM_ARGS, W, ln, P, seeded, nullable, c, f, l,
                           static_cast<int32_t*>(next));
      });
}

// flags: [ceil(T/32)][R] uint32, bit t = step t's accept flag
int rrx_stream_flags(RRX_STREAM_HEAD, int seeded, void* flags, void* next, void* stream) {
  const int bad = check_stream(words, T, R, s_tile, 1);
  if (bad != 0) return bad;
  auto* fl = static_cast<uint32_t*>(flags);
  return by_form(
      s_tile,
      [&](auto w) {
        constexpr int W = decltype(w)::value;
        return launch_rows(stream_flags_kernel<W>, R, nfa_smem_bytes(s_tile, W), stream,
                           RRX_STREAM_ARGS, seeded, fl);
      },
      [&](int W) {
        return launch_wide(wide_stream_flags_kernel, R, wide_smem_bytes(s_tile, W, 1, false),
                           stream, RRX_STREAM_ARGS, W, seeded, fl, static_cast<int32_t*>(next));
      });
}

// hits: [ceil(T/32)][R] uint32, bit t = the initial state live before step t
int rrx_stream_reverse(RRX_STREAM_HEAD, void* hits, void* next, void* stream) {
  const int bad = check_stream(words, T, R, s_tile, 1);
  if (bad != 0) return bad;
  auto* h = static_cast<uint32_t*>(hits);
  return by_form(
      s_tile,
      [&](auto w) {
        constexpr int W = decltype(w)::value;
        return launch_rows(stream_reverse_kernel<W>, R, nfa_smem_bytes(s_tile, W), stream,
                           RRX_STREAM_ARGS, h);
      },
      [&](int W) {
        return launch_wide(wide_stream_reverse_kernel, R, wide_smem_bytes(s_tile, W, 1, false),
                           stream, RRX_STREAM_ARGS, W, h, static_cast<int32_t*>(next));
      });
}

// lengths, starts: [R] int32 (start -1 = inactive); end: [R] int32
int rrx_stream_first_end(RRX_STREAM_HEAD, const void* lengths, const void* starts, int longest,
                         void* end, void* next, void* stream) {
  const int bad = check_stream(words, T, R, s_tile, 1);
  if (bad != 0) return bad;
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* e = static_cast<int32_t*>(end);
  return by_form(
      s_tile,
      [&](auto w) {
        constexpr int W = decltype(w)::value;
        return launch_rows(stream_first_end_kernel<W>, R, nfa_smem_bytes(s_tile, W), stream,
                           RRX_STREAM_ARGS, ln, st, longest, e);
      },
      [&](int W) {
        return launch_wide(wide_stream_first_end_kernel, R,
                           wide_smem_bytes(s_tile, W, 1, false), stream, RRX_STREAM_ARGS, W, ln,
                           st, longest, e, static_cast<int32_t*>(next));
      });
}

// Resident blocks per SM (theoretical occupancy) of a stream kernel for a
// tile of s_tile states, by index: 0 stats, 1 flags, 2 reverse, 3 first end;
// *threads: the threads of one block.
int rrx_stream_occupancy(int kernel, int s_tile, int* blocks_per_sm, int* threads) {
  if (s_tile < 1 || s_tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  return by_form(
      s_tile,
      [&](auto w) {
        constexpr int W = decltype(w)::value;
        *threads = kThreads;
        const size_t smem = nfa_smem_bytes(s_tile, W);
        auto occ = [&](auto kern) {
          const int e = allow_smem(kern, smem);
          if (e != 0) return e;
          return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              blocks_per_sm, kern, kThreads, smem));
        };
        switch (kernel) {
          case 0:
            return occ(stream_stats_kernel<W>);
          case 1:
            return occ(stream_flags_kernel<W>);
          case 2:
            return occ(stream_reverse_kernel<W>);
          case 3:
            return occ(stream_first_end_kernel<W>);
          default:
            return static_cast<int>(cudaErrorInvalidValue);
        }
      },
      [&](int W) {
        *threads = kWideThreads;
        const size_t smem = wide_smem_bytes(s_tile, W, 1, false);
        switch (kernel) {
          case 0:
            return occupancy_wide(wide_stream_stats_kernel, smem, blocks_per_sm);
          case 1:
            return occupancy_wide(wide_stream_flags_kernel, smem, blocks_per_sm);
          case 2:
            return occupancy_wide(wide_stream_reverse_kernel, smem, blocks_per_sm);
          case 3:
            return occupancy_wide(wide_stream_first_end_kernel, smem, blocks_per_sm);
          default:
            return static_cast<int>(cudaErrorInvalidValue);
        }
      });
}

}  // extern "C"
