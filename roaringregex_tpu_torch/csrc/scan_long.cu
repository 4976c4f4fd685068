// One long string on Hopper (sm_90a): the matmul tier's step over windows of
// a single string, each window from its own entry state, for record tiles
// of up to 256 states (one thread per window). scan_long_wide.cu runs the
// same four entry points for tiles of 257..1024 states, one warp per window.
//
// Replaces five Pallas TPU kernels of the JAX package (all in
// roaringregex_tpu/ops/scan_pallas.py, called by ops/longstring.py's
// FastLongScanner):
//   rrx_long_carry    <- _carry_kernel_lb (via _carry_call_b)
//   rrx_long_flags    <- _flags_v0_kernel_lb (via _flags_v0_call_b)
//   rrx_long_count    <- _count_v0_kernel_lb (via _count_v0_call_b) and, with
//                        a final-state output, _count_v0_final_kernel_lb
//                        (via _count_v0f_call_b)
//   rrx_long_reverse  <- _reverse_kernel_lb (via _rev_call_b)
//
// Geometry (scan_long.cuh). The string is data[0, n) on the card, read in
// place (no window copy). Its global stream has step 0 = BOS, step i+1 =
// byte i, step n+1 = EOS; steps outside [0, n+1] are dead (zero mask row).
// Window w of nw covers T local steps; local step t is global step
// g = (w / rep) * block + t - lead (rep > 1 gives rep windows over the same
// steps: the summary pass's basis pseudo-records). So `^` and `$` fire only
// where the global stream has them (the first and last window), whatever
// the window cut. Windows own the
// local steps [lead, lead + block): the flag and hit bits of owned steps land
// at bit g of one flat bit array (block a multiple of 32, so windows write
// disjoint words and need no atomics), and the counts sum over them.
//
// What each computes per window, with the step of scan_nfa.cuh:
// - carry: v = v0[w] (or 0), then every local step with the seed
//   gate[w] && (seeded || g < 2); writes the final state vout[w].
// - flags: the same walk; bit g of flags = the accept flag of owned step t.
// - count: the same walk; cnt[w] = accept flags of owned steps with g < n,
//   tail[w] = an accept flag at an owned step with g == n or g == n+1 (both
//   end at n: FastLongScanner._merge_counts adds one for the pair); with a
//   vout pointer also the final state (the speculative windows' exits).
// - reverse: from the zero state at local step T-1 down to 0, R = OR of
//   pred[u] over u in (R | acc) & mask[sym]; bit g of hits = the initial
//   state is in R after owned step t (a match can start at max(g-1, 0)).
//
// Design, and what bounds it on this card: one thread per window, the state
// set in W = ceil(s_tile/32) <= 8 registers and the tile's rows in shared
// memory, as in scan_nfa.cu. Windows of ~4 KB make 2^18 threads for 1 GiB,
// enough to fill the card's 132 x 2,048 thread slots. The string is read 16
// bytes at a time where a chunk lies inside [0, n) (byte by byte in the last
// partial chunk), so each byte is read once per window that covers it (1 +
// lead/block times overall). HBM traffic is ~1 byte per byte plus 1 bit per
// step of flag or hit words, far under the integer work: every step is a
// dependent chain (popcount(v) shared row loads, ORs, the accept test), so a
// pass is bound by integer issue and that chain's latency.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan_core.cuh"
#include "scan_nfa.cuh"
#include "scan_long.cuh"

namespace {

using namespace rrx;

#define LONG_HEAD                                                                            \
  const uint8_t *__restrict__ data, long long n, int nw, int block, int lead, int T, int rep, \
      const uint32_t *__restrict__ tab_g, int S

#define LONG_BEGIN                                                  \
  extern __shared__ uint32_t smem[];                                \
  const Nfa<W> nfa = load_nfa<W>(smem, tab_g, S);                   \
  const int w = blockIdx.x * blockDim.x + threadIdx.x;              \
  if (w >= nw) return;                                              \
  Window win = window(data, n, block, lead, T, rep, w)

// The forward walk of one window from v0[w] (or the empty set; bits past
// the tile's S states are not states and are dropped): f(t, v) after each
// step.
template <int W, class F>
__device__ __forceinline__ void walk_window(const Nfa<W>& nfa, Window& win, int S,
                                            const uint32_t* __restrict__ v0,
                                            const uint8_t* __restrict__ gate, int seeded, int w,
                                            uint32_t (&v)[W], F&& f) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int live = S - 32 * k;  // states of word k
    const uint32_t m = live >= 32 ? ~0u : (live <= 0 ? 0u : (1u << live) - 1u);
    v[k] = v0 != nullptr ? v0[(size_t)w * W + k] & m : 0u;
  }
  const bool gw = gate == nullptr || gate[w] != 0;
#pragma unroll 1
  for (int t = 0; t < win.T; ++t) {
    nfa.fwd(v, gw && (seeded || t < win.t_seed_end), win.sym(t));
    f(t, v);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
long_carry_kernel(LONG_HEAD, const uint32_t* __restrict__ v0, const uint8_t* __restrict__ gate,
                  int seeded, uint32_t* __restrict__ vout) {
  LONG_BEGIN;
  uint32_t v[W];
  walk_window(nfa, win, S, v0, gate, seeded, w, v, [](int, const uint32_t(&)[W]) {});
#pragma unroll
  for (int k = 0; k < W; ++k) vout[(size_t)w * W + k] = v[k];
}

template <int W>
__global__ void __launch_bounds__(kThreads)
long_flags_kernel(LONG_HEAD, const uint32_t* __restrict__ v0, const uint8_t* __restrict__ gate,
                  int seeded, uint32_t* __restrict__ flags) {
  LONG_BEGIN;
  const int hi = min(T, lead + block);
  uint32_t* out = flags + (size_t)(w / rep) * (block >> 5);  // bit g of the flat array
  uint32_t word = 0u;
  uint32_t v[W];
  walk_window(nfa, win, S, v0, gate, seeded, w, v, [&](int t, const uint32_t(&vv)[W]) {
    if (t < lead || t >= hi) return;
    const int j = t - lead;
    word |= (nfa.accepts(vv) ? 1u : 0u) << (j & 31);
    if ((j & 31) == 31 || t == hi - 1) {
      out[j >> 5] = word;
      word = 0u;
    }
  });
}

template <int W>
__global__ void __launch_bounds__(kThreads)
long_count_kernel(LONG_HEAD, const uint32_t* __restrict__ v0, const uint8_t* __restrict__ gate,
                  int seeded, int32_t* __restrict__ cnt_o, uint8_t* __restrict__ tail_o,
                  uint32_t* __restrict__ vout) {
  LONG_BEGIN;
  const int hi = min(T, lead + block);
  const int t_eos = win.t_eos;
  int cnt = 0;
  bool tail = false;
  uint32_t v[W];
  walk_window(nfa, win, S, v0, gate, seeded, w, v, [&](int t, const uint32_t(&vv)[W]) {
    if (t < lead || t >= hi || !nfa.accepts(vv)) return;
    cnt += t < t_eos - 1 ? 1 : 0;
    tail = tail || t == t_eos - 1 || t == t_eos;
  });
  cnt_o[w] = cnt;
  tail_o[w] = tail ? 1 : 0;
  if (vout != nullptr) {
#pragma unroll
    for (int k = 0; k < W; ++k) vout[(size_t)w * W + k] = v[k];
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
long_reverse_kernel(LONG_HEAD, uint32_t* __restrict__ hits) {
  LONG_BEGIN;
  const int hi = min(T, lead + block);
  uint32_t* out = hits + (size_t)(w / rep) * (block >> 5);
  uint32_t rs[W];
  clear(rs);
  uint32_t word = 0u;
  // the chunk cache reads forward; walking down, each 16-byte chunk is
  // loaded once all the same
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    nfa.rev(rs, win.sym(t));
    if (t < lead || t >= hi) continue;
    const int j = t - lead;
    word |= (rs[0] & 1u) << (j & 31);
    if ((j & 31) == 0) {  // walking down, bit j closes word j / 32
      out[j >> 5] = word;
      word = 0u;
    }
  }
}

template <class K, class... Args>
int launch_long(K kernel, int nw, int S, int W, void* stream, Args... args) {
  if (nw == 0) return 0;
  const size_t smem = nfa_smem_bytes(S, W);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const int blocks = (nw + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int occupancy_long(K kernel, int S, int W, int* blocks_per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, nfa_smem_bytes(S, W)));
}

}  // namespace

namespace rrx {

int long_occupancy(int kernel, int s_tile, int* blocks_per_sm) {
  return by_words(s_tile, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    switch (kernel) {
      case 0:
        return occupancy_long(long_carry_kernel<W>, s_tile, W, blocks_per_sm);
      case 1:
        return occupancy_long(long_flags_kernel<W>, s_tile, W, blocks_per_sm);
      case 2:
        return occupancy_long(long_count_kernel<W>, s_tile, W, blocks_per_sm);
      case 3:
        return occupancy_long(long_reverse_kernel<W>, s_tile, W, blocks_per_sm);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

}  // namespace rrx

#define RRX_LONG_HEAD                                                                       \
  const void *data, long long n, int nw, int block, int lead, int T, int rep, const void *tab, \
      int s_tile
#define RRX_LONG_ARGS \
  static_cast<const uint8_t*>(data), n, nw, block, lead, T, rep, static_cast<const uint32_t*>(tab), s_tile

extern "C" {

// v0: [nw][W] uint32 or null (empty set); gate: [nw] uint8 or null (all
// windows gated); vout: [nw][W] uint32
int rrx_long_carry(RRX_LONG_HEAD, const void* v0, const void* gate, int seeded, void* vout,
                   void* stream) {
  const int bad = check_long(data, n, nw, block, lead, T, rep);
  if (bad != 0) return bad;
  return by_words(s_tile, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    return launch_long(long_carry_kernel<W>, nw, s_tile, W, stream, RRX_LONG_ARGS,
                       static_cast<const uint32_t*>(v0), static_cast<const uint8_t*>(gate),
                       seeded, static_cast<uint32_t*>(vout));
  });
}

// flags: flat bit array over the windows' owned steps, bit g of word g / 32
// (nw / rep * block / 32 words)
int rrx_long_flags(RRX_LONG_HEAD, const void* v0, const void* gate, int seeded, void* flags,
                   void* stream) {
  const int bad = check_long(data, n, nw, block, lead, T, rep);
  if (bad != 0) return bad;
  if (T != lead + block) return static_cast<int>(cudaErrorInvalidValue);
  return by_words(s_tile, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    return launch_long(long_flags_kernel<W>, nw, s_tile, W, stream, RRX_LONG_ARGS,
                       static_cast<const uint32_t*>(v0), static_cast<const uint8_t*>(gate),
                       seeded, static_cast<uint32_t*>(flags));
  });
}

// cnt: [nw] int32; tail: [nw] uint8; vout: [nw][W] uint32 or null
int rrx_long_count(RRX_LONG_HEAD, const void* v0, const void* gate, int seeded, void* cnt,
                   void* tail, void* vout, void* stream) {
  const int bad = check_long(data, n, nw, block, lead, T, rep);
  if (bad != 0) return bad;
  return by_words(s_tile, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    return launch_long(long_count_kernel<W>, nw, s_tile, W, stream, RRX_LONG_ARGS,
                       static_cast<const uint32_t*>(v0), static_cast<const uint8_t*>(gate),
                       seeded, static_cast<int32_t*>(cnt), static_cast<uint8_t*>(tail),
                       static_cast<uint32_t*>(vout));
  });
}

// hits: flat bit array as rrx_long_flags's
int rrx_long_reverse(RRX_LONG_HEAD, void* hits, void* stream) {
  const int bad = check_long(data, n, nw, block, lead, T, rep);
  if (bad != 0) return bad;
  if (T < lead + block) return static_cast<int>(cudaErrorInvalidValue);
  return by_words(s_tile, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    return launch_long(long_reverse_kernel<W>, nw, s_tile, W, stream, RRX_LONG_ARGS,
                       static_cast<uint32_t*>(hits));
  });
}

}  // extern "C"
