// Counting tier on Hopper (sm_90a): whole-pattern X{m,n} whose body X is a
// fixed-length sequence of byte classes, or an alternation of up to four
// such sequences of one length k <= 8 (a{1,300}, (ab){2,600},
// (ab|cd){1,400}; the plan is scan_pallas.counting_plan's).
//
// Replaces three Pallas TPU kernels of the JAX package (all in
// roaringregex_tpu/ops/scan_pallas.py):
//   rrx_count_stats   <- _count_match_kernel (via CountScanner._match_call)
//   rrx_count_flags   <- _count_flags_kernel (via CountScanner._flags_call)
//   rrx_count_reverse <- _count_reverse_kernel (via CountScanner._reverse_call)
//
// What they compute. The Glushkov automaton of X{m,n} has n*k positions and
// a dense triangular follow matrix, but its reachable state sets collapse
// to one integer per record: the run r of consecutive body copies ending at
// the cursor, stepped at stride k:
//     r[t] = occ[t] ? min(r[t-k] + 1, cap) : 0,   cap = n, or max(m, 1) if n = 0
// with occ[t] = a body copy ends at step t, tracked with per-branch
// prefix-progress bits. Seeded, a match ends at t iff r[t] >= max(m, 1).
// Unseeded (a match from position 0), an anchored-prefix flag ap[t] = occ[t]
// ? ap[t-k] : 0 (ap = 1 before the first byte) accepts at t iff t >= m*k,
// t <= len, t % k == 0 and t <= n*k; for k == 1 ap passes through the
// steps past len unchanged. The reverse pass runs the mirror: r_rev[t] =
// body copies starting at step t, capped at max(m, 1), and a start hit at
// t iff r_rev[t] >= max(m, 1). A nullable program (m = 0) has its empty
// matches added by the callers (stats initial values, bitmaps). Stream
// steps as everywhere: step 0 is BOS, step t carries byte t-1, step len+1
// is EOS; only steps 1..len carry body bytes.
// - stats: (cnt, first, last, full) exactly as rrx_nfa_stats builds them
//   from the flags (lead, the `$` duplicate, the nullable initial values).
// - flags: flag words [ceil((L+2)/32)][R] uint32, bit t = step t's flag.
// - reverse: hit words of the same layout, bit t = a match starts at
//   max(t-1, 0) (rrx_nfa_reverse's convention).
//
// Design, and what bounds it on this card:
// - The TPU packs 32 records per sublane row and runs the recurrence as a
//   handful of int32 vector ops per byte. Here one thread owns one record
//   for its whole stream, as in every kernel of this port.
// - R branches of k positions make at most 32 (branch, position) class
//   tests, so one 256-entry u32 table in shared memory, hit[byte], answers
//   all of them with one load: bit br*k + q = the byte is in branch br's
//   position-q class. The prefix-progress bits of every branch then advance
//   with one shift-OR-AND on a u32 (x = ((x << 1) | ones) & hit[byte]); a
//   branch's top bit is its body end. The reverse pass shifts the other
//   way. The k-lag run buffer (and the unseeded k-lag flag buffer) are k
//   ints in registers: the kernels are templated on k = 1..8.
// - HBM: one input byte per scanned byte, read 16 bytes at a time with the
//   next 16 prefetched (scan_core.cuh's walkers), plus 16 B of stats per
//   record or 1 bit per step of flag or hit words. At 1 GiB that is ~0.32
//   ms of the card's 3.35 TB/s; the ~15-25 integer operations of a step's
//   dependent chain (table load, shift, compare, lag select, min, the
//   bookkeeping) bound the pass, at the card's integer issue rate when
//   enough records are resident to hide the chain's latency.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "scan_core.cuh"

namespace {

using namespace rrx;

struct Plan {
  const uint32_t* hit;  // shared [256]: bit br*k + q = byte in branch br's position-q class
  uint32_t ones;        // bit br*k of every branch: its position 0
  uint32_t tops;        // bit br*k + k-1 of every branch: its last position
  int mm;               // max(m, 1)
  int cap;              // n, or mm when unbounded
  int n;                // 0 = unbounded
};

// The forward recurrence of one record, body length K.
template <int K>
struct Fwd {
  uint32_t x = 0u;  // prefix-progress bits of every branch
  int rb[K];        // r[t-K] .. r[t-1]
  int ab[K];        // ap[t-K] .. ap[t-1] (unseeded)

  __device__ __forceinline__ Fwd() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      rb[j] = 0;
      ab[j] = 1;
    }
  }

  // Step t with body-class bits h (0 off the bytes 1..len); the accept flag.
  __device__ __forceinline__ bool step(const Plan& p, int t, uint32_t h, int len, bool seeded) {
    x = ((x << 1) | p.ones) & h;
    const bool occ = (x & p.tops) != 0u;
    x &= ~p.tops;
    const int r = occ ? min(rb[0] + 1, p.cap) : 0;
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) rb[j] = rb[j + 1];
    rb[K - 1] = r;
    if (seeded) return r >= p.mm;
    const int lag = ab[0];
    int ap = t < 1 ? 1 : (occ ? lag : 0);
    if (K == 1 && t > len) ap = lag;  // the dead tail passes through
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) ab[j] = ab[j + 1];
    ab[K - 1] = ap;
    bool fl = ap != 0 && t >= p.mm * K && t <= len;
    if (K > 1) fl = fl && t % K == 0;
    if (p.n != 0) fl = fl && t <= p.n * K;
    return fl;
  }
};

// The reverse recurrence of one record: steps walked from len+1 down to 0.
template <int K>
struct Rev {
  uint32_t y = 0u;  // suffix-progress bits of every branch
  int rb[K];        // r_rev[t+1] .. r_rev[t+K]

  __device__ __forceinline__ Rev() {
#pragma unroll
    for (int j = 0; j < K; ++j) rb[j] = 0;
  }

  // Step t with body-class bits h; the start hit.
  __device__ __forceinline__ bool step(const Plan& p, uint32_t h) {
    y = ((y >> 1) | p.tops) & h;
    const bool occ = (y & p.ones) != 0u;
    y &= ~p.ones;
    const int r = occ ? min(rb[K - 1] + 1, p.mm) : 0;
#pragma unroll
    for (int j = K - 1; j > 0; --j) rb[j] = rb[j - 1];
    rb[0] = r;
    return r >= p.mm;
  }
};

// Copies the class table into shared memory. Every thread of the block
// calls it (it ends in __syncthreads) before any thread returns.
__device__ __forceinline__ Plan load_plan(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                          int k, int n_br, int m, int n) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) smem[i] = tab_g[i];
  __syncthreads();
  uint32_t ones = 0u;
  for (int b = 0; b < n_br; ++b) ones |= 1u << (b * k);
  const int mm = max(m, 1);
  return Plan{smem, ones, ones << (k - 1), mm, n != 0 ? n : mm, n};
}

#define COUNT_KERNEL_HEAD                                                                 \
  const uint8_t *__restrict__ data, long long stride, int L,                              \
      const int32_t *__restrict__ lengths, int R, const uint32_t *__restrict__ tab_g, int k, \
      int n_br, int m, int n

#define COUNT_KERNEL_BEGIN                                 \
  __shared__ uint32_t smem[256];                          \
  const Plan p = load_plan(smem, tab_g, k, n_br, m, n);   \
  const int r = blockIdx.x * blockDim.x + threadIdx.x;    \
  if (r >= R) return;                                     \
  const Row rec = record(data, stride, L, lengths, r);    \
  const int len = rec.len

template <int K>
__global__ void __launch_bounds__(kThreads)
count_stats_kernel(COUNT_KERNEL_HEAD, int seeded, int lead, int nullable,
                   int32_t* __restrict__ cnt_o, int32_t* __restrict__ first_o,
                   int32_t* __restrict__ last_o, uint8_t* __restrict__ full_o) {
  COUNT_KERNEL_BEGIN;
  const bool dedup = !(nullable && seeded);
  int cnt = 0, first = -1, last = -1;
  bool full = false;
  if (nullable) {
    cnt = seeded ? len + 1 : 1;
    last = seeded ? len : 0;
    first = 0;
    full = len == 0;
  }
  Fwd<K> f;
  auto step = [&](int t, uint32_t h) {
    if (f.step(p, t, h, len, seeded != 0) && t > lead) {
      const int e = min(t, len);
      cnt += (dedup && e != last) ? 1 : 0;
      first = first < 0 ? e : first;
      last = e;
      full = full || t >= len;
    }
  };
  step(0, 0u);
  walk_fwd(rec.row, 0, len, [&](int t, int b) { step(t, p.hit[b]); }, [] { return false; });
  step(len + 1, 0u);
  cnt_o[r] = cnt;
  first_o[r] = first;
  last_o[r] = last;
  full_o[r] = full ? 1 : 0;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
count_flags_kernel(COUNT_KERNEL_HEAD, int seeded, uint32_t* __restrict__ flags) {
  COUNT_KERNEL_BEGIN;
  const int Wh = (L + 2 + 31) >> 5;
  Fwd<K> f;
  uint32_t word = 0u;
  auto step = [&](int t, uint32_t h) {
    word |= (f.step(p, t, h, len, seeded != 0) ? 1u : 0u) << (t & 31);
    if ((t & 31) == 31) {  // walking up, bit t closes word t / 32
      flags[(size_t)(t >> 5) * R + r] = word;
      word = 0u;
    }
  };
  step(0, 0u);
  walk_fwd(rec.row, 0, len, [&](int t, int b) { step(t, p.hit[b]); }, [] { return false; });
  step(len + 1, 0u);
  const int w_eos = (len + 1) >> 5;
  if (((len + 1) & 31) != 31) flags[(size_t)w_eos * R + r] = word;
  for (int w = w_eos + 1; w < Wh; ++w) flags[(size_t)w * R + r] = 0u;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
count_reverse_kernel(COUNT_KERNEL_HEAD, uint32_t* __restrict__ hits) {
  COUNT_KERNEL_BEGIN;
  const int Wh = (L + 2 + 31) >> 5;
  for (int w = ((len + 1) >> 5) + 1; w < Wh; ++w) hits[(size_t)w * R + r] = 0u;
  Rev<K> b;
  uint32_t word = 0u;
  auto step = [&](int t, uint32_t h) {
    word |= (b.step(p, h) ? 1u : 0u) << (t & 31);
    if ((t & 31) == 0) {  // walking down, bit t closes word t / 32
      hits[(size_t)(t >> 5) * R + r] = word;
      word = 0u;
    }
  };
  step(len + 1, 0u);
  walk_rev(rec.row, len, [&](int t, int byte) { step(t, p.hit[byte]); });
  step(0, 0u);
}

// Calls f(std::integral_constant<int, K>{}) for a body of k positions;
// other lengths are refused.
template <class F>
int by_k(int k, F&& f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline int check_plan(int k, int n_br, int m, int n) {
  if (k < 1 || k > 8 || n_br < 1 || n_br > 4 || m < 0 || n < 0 || (n != 0 && n < m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <class K, class... Args>
int launch(K kernel, int R, void* stream, Args... args) {
  if (R == 0) return 0;
  const int blocks = (R + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int occupancy(K kernel, int* blocks_per_sm) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, 0));
}

}  // namespace

namespace rrx {

int count_occupancy(int kernel, int k, int* blocks_per_sm) {
  return by_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    switch (kernel) {
      case 0: return occupancy(count_stats_kernel<K>, blocks_per_sm);
      case 1: return occupancy(count_flags_kernel<K>, blocks_per_sm);
      case 2: return occupancy(count_reverse_kernel<K>, blocks_per_sm);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

}  // namespace rrx

#define RRX_COUNT_HEAD                                                                  \
  const void *data, long long stride, int L, const void *lengths, int R, const void *tab, \
      int k, int n_br, int m, int n
#define RRX_COUNT_ARGS                                                                   \
  static_cast<const uint8_t*>(data), stride, L, static_cast<const int32_t*>(lengths), R, \
      static_cast<const uint32_t*>(tab), k, n_br, m, n

extern "C" {

// tab: [256] uint32 class bits; cnt, first, last: [R] int32; full: [R]
// uint8; lead < 0 = no lead
int rrx_count_stats(RRX_COUNT_HEAD, int seeded, int lead, int nullable, void* cnt, void* first,
                    void* last, void* full, void* stream) {
  int bad = check_rows(data, stride, L, R);
  if (bad == 0) bad = check_plan(k, n_br, m, n);
  if (bad != 0) return bad;
  return by_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    return launch(count_stats_kernel<K>, R, stream, RRX_COUNT_ARGS, seeded, lead, nullable,
                  static_cast<int32_t*>(cnt), static_cast<int32_t*>(first),
                  static_cast<int32_t*>(last), static_cast<uint8_t*>(full));
  });
}

// flags: [ceil((L+2)/32)][R] uint32, bit t = step t's accept flag
int rrx_count_flags(RRX_COUNT_HEAD, int seeded, void* flags, void* stream) {
  int bad = check_rows(data, stride, L, R);
  if (bad == 0) bad = check_plan(k, n_br, m, n);
  if (bad != 0) return bad;
  return by_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    return launch(count_flags_kernel<K>, R, stream, RRX_COUNT_ARGS, seeded,
                  static_cast<uint32_t*>(flags));
  });
}

// hits: [ceil((L+2)/32)][R] uint32, bit t = a match starts at max(t-1, 0)
int rrx_count_reverse(RRX_COUNT_HEAD, void* hits, void* stream) {
  int bad = check_rows(data, stride, L, R);
  if (bad == 0) bad = check_plan(k, n_br, m, n);
  if (bad != 0) return bad;
  return by_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    return launch(count_reverse_kernel<K>, R, stream, RRX_COUNT_ARGS,
                  static_cast<uint32_t*>(hits));
  });
}

}  // extern "C"
