// Container tier on Hopper (sm_90a): match statistics, forward flags and
// candidate starts of multiblock and sparse programs whose follow matrix is
// kept as 128 x 128 blocks (ops/scan_sparse.py, device_sparse_tables).
//
// Replaces the six Pallas TPU call sites of the JAX package's container
// kernels, all in roaringregex_tpu/ops/scan_pallas.py. The byte path:
//   rrx_sparse_stats   <- _sparse_match_kernel_b   (via _match_call_b :3136)
//   rrx_sparse_flags   <- _sparse_flags_kernel_b   (via _flags_call_b :3194)
//   rrx_sparse_reverse <- _sparse_reverse_kernel_b (via _reverse_call_b :3243)
// and the stream-fed methods of SparseScanner (inherited by BitbandScanner),
// whose symbol masks come from a mask stream instead of bytes:
//   rrx_sparse_stream_stats   <- _sparse_match_kernel   (via _match_call :849)
//   rrx_sparse_stream_flags   <- _sparse_flags_kernel   (via _flags_call :900)
//   rrx_sparse_stream_reverse <- _sparse_reverse_kernel (via _reverse_call :941)
//
// What they compute. A record's state set is W = lanes / 32 uint32 words
// (bit s % 32 of word s / 32 = state s), nb = lanes / 128 blocks of 4 words.
// The follow matrix F is split into partial blocks (explicit 128 x 128 bit
// blocks) and full blocks (all ones). Output block o of one expansion is
//     y_o = OR over o's entries (s, k) of
//             k >= 0: the rows of partial block k selected by the live bits
//                     of source block s (row i = the outputs of source i)
//             k < 0:  all ones when source block s has a live bit.
// Forward step (tables tab_f, meta_f: sources are row blocks of F):
//     v = expand(v | gate * {state 0}) & mask[sym]
// Reverse step (tab_r, meta_r: F transposed, rows = the sources of an
// output):
//     R = expand((R | acc) & mask[sym]);  hit = state 0 in R
// sym is the byte at step t (byte t-1), BOS at step 0, EOS at step len+1;
// meta's symbol rows give each its mask row (a byte in no run has none, a
// zero mask); steps past EOS are dead, change no output and are not run.
// Per record r with len = clamp(lengths[r], 0, L):
// - stats: the seed ORs in at every step when seeded, at steps t < 2 when
//   not; per accept channel c a flag has end e = min(t, len): cnt counts
//   flags with e != last (the `$` step's duplicate), except for a nullable
//   seeded scan whose cnt is len+1; first keeps the first e, last the
//   latest, full is a flag at t >= len; nullable starts first = 0, cnt =
//   len+1 and last = len (seeded) or cnt = 1 and last = 0, full = (len ==
//   0). Outputs [R][C].
// - flags: every step's raw flags as words [Wt][R*C], bit t of column r*C
//   + c in word t/32, Wt = ceil((L+2)/32), words past EOS zero.
// - reverse: hit words [Wt][R], bit t = state 0 is in R after step t (a
//   match can start at max(t-1, 0)).
//
// Design, and what bounds it on this card:
// - One warp per record, 16 warps per block, and no more blocks than are
//   resident at once: each block copies the table once and its warps take
//   records from a counter in global memory until none is left. The
//   record's state lives in two buffers of W words in shared memory (the
//   current and the next state), so every lane reads any source block with
//   one broadcast 16-byte load. For a live source block, lane l takes bit l
//   of each of its four words and ORs the partial block's row of that bit
//   (one 16-byte load) into its own 4-word sum; __reduce_or_sync joins the
//   lanes' sums once per output block. A source block with no live bit,
//   and (forward) an output block whose mask words are zero for the step's
//   symbol, cost one uniform test each and nothing else: the work follows
//   the live states.
// - The table (the partial blocks, 2 KB each, the mask rows and the accept
//   rows) is copied into shared memory when it fits beside the meta and the
//   state buffers (227 KB a block; config 13's 78 blocks are 156 KB), else
//   read from global memory through L1 / L2 (the cap of 120 partial blocks
//   is 240 KB). The launcher takes the form from the wrapper
//   (ops/scan_sparse.table_form) and refuses a shared form that does not fit.
// - The accept test runs on the channels' union row, folded into the
//   expansion; only on a step where it fires does each lane test its
//   channels (c = lane, lane + 32, ...) and update their statistics or flag
//   words in global memory, so the per-channel bookkeeping of a 100-pattern
//   MultiPattern costs nothing on the many steps without a match.
// - An unseeded scan (fullmatch) whose state is empty after step 1 can
//   accept nothing later: the walk stops there.
// - A step is a chain of shared loads, ORs and warp reductions, so a pass is
//   bound by integer and shared-memory issue; HBM carries one input byte per
//   step (all lanes read the same 16-byte chunk) and 1 bit per step of flag
//   or hit words.
// - The stream-fed kernels run the same step with the mask of output block o
//   read from the record's stream row (words[t][r][4o .. 4o+3], one 16-byte
//   load that every lane of the warp shares) where the byte kernels look up
//   the symbol's row; an output block whose stream mask is zero costs that
//   load and nothing else. They walk every step t < T of the stream as the
//   JAX kernels do (the rows past a record's EOS are zero, so those steps
//   only seed and clear), with the unseeded stop above, and take one accept
//   channel (the JAX kernels read one accept row; a scanner with channels
//   raises before it gets here). Their input is 4 W bytes a record-step
//   instead of one byte, so HBM carries 4 W times the byte kernels' input:
//   104-192 bytes per input byte at W = 26-48.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan_core.cuh"

namespace {

using namespace rrx;

constexpr int kWarps = 16;  // records per block
constexpr int kSpThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxBlocks = 32;  // 4096 lanes
constexpr int kBlockWords = 512;  // one partial block: 128 rows of 4 words
// meta: [nb, n_part, n_ent, n_mask, C, W, n_acc, 0 | symbol rows | nb + 1
// entry offsets | (source block, partial block or -1) per entry], padded to
// a multiple of 4 words (ops/scan_sparse._meta)
constexpr int kMetaSyms = 8;
constexpr int kMetaPtr = kMetaSyms + kSyms;
constexpr int kMetaEnt = kMetaPtr + kMaxBlocks + 1;
constexpr size_t kSmemLimit = 232448;

// One direction's tables as a kernel reads them: tab is shared memory in
// the shared form and global memory in the global form; meta is always in
// shared memory.
struct Sp {
  const uint4* blk;   // [n_part][128] rows
  const uint4* mask;  // [n_mask][nb]
  const uint4* acc;   // [n_acc][nb]: forward the union then the channels
  const int* meta;
  const int2* ent;  // [n_ent] (source block, partial block or -1)
  int nb, W, C;
};

inline size_t sparse_smem_bytes(int n_tab, int n_meta, int W, bool global_tab) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(n_meta) + 2 * kWarps * W + (global_tab ? 0 : n_tab));
}

template <bool kGlobal>
__device__ __forceinline__ uint4 ld(const uint4* p) {
  if (kGlobal) return __ldg(p);
  return *p;
}

__device__ __forceinline__ bool nz(const uint4& a) { return (a.x | a.y | a.z | a.w) != 0u; }

__device__ __forceinline__ uint4 and4(const uint4& a, const uint4& b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// Copies the meta (and, in the shared form, the table) into shared memory.
// Every thread of a block that holds a record calls it (it ends in
// __syncthreads) before any thread returns.
template <bool kGlobal>
__device__ __forceinline__ Sp load_sp(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                      const int32_t* __restrict__ meta_g, int n_meta) {
  int* meta = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < n_meta; i += blockDim.x) meta[i] = meta_g[i];
  const int nb = meta_g[0], n_part = meta_g[1], n_mask = meta_g[3], C = meta_g[4];
  const int W = meta_g[5], n_acc = meta_g[6];
  // the table, in 16-byte words, after the meta and the state buffers
  const int n_tab4 = n_part * (kBlockWords / 4) + (n_mask + n_acc) * nb;
  const uint4* tab = reinterpret_cast<const uint4*>(tab_g);
  if (!kGlobal) {
    uint4* t = reinterpret_cast<uint4*>(smem + n_meta + 2 * kWarps * W);
    for (int i = threadIdx.x; i < n_tab4; i += blockDim.x) t[i] = __ldg(tab + i);
    tab = t;
  }
  __syncthreads();
  Sp sp;
  sp.blk = tab;
  sp.mask = tab + n_part * (kBlockWords / 4);
  sp.acc = sp.mask + n_mask * nb;
  sp.meta = meta;
  sp.ent = reinterpret_cast<const int2*>(meta + kMetaEnt);
  sp.nb = nb;
  sp.W = W;
  sp.C = C;
  return sp;
}

// The warp's two state buffers (16-byte aligned: n_meta and W are
// multiples of 4).
__device__ __forceinline__ uint32_t* warp_buf(uint32_t* smem, int n_meta, int W, int warp,
                                              int which) {
  return smem + n_meta + (2 * warp + which) * W;
}

// One expansion of src into dst (both [nb] 16-byte blocks of one warp's
// buffers). Forward (kFwd): the seed ORs state 0 into source block 0 when
// gate, and each output block is masked by the step's mask row mrow ([nb]
// 16-byte words; null: no row, all zero), skipping an output block whose
// mask is zero; the union accept row's test comes back in acc_hit. The row
// is the table's (a symbol's row: shared or global with the table) or,
// kStream, the record's row of the mask stream in global memory. Reverse:
// no mask (src is already masked). Returns whether any state of dst is live
// (forward) or state 0 is (reverse). Lane 0 writes dst; the caller syncs
// the warp.
template <bool kGlobal, bool kFwd, bool kStream = false>
__device__ __forceinline__ bool expand(const Sp& sp, const uint4* src, uint4* dst, bool gate,
                                       const uint4* mrow, bool& acc_hit, int lane) {
  bool live = false;
  acc_hit = false;
  const int* ptr = sp.meta + kMetaPtr;
  for (int o = 0; o < sp.nb; ++o) {
    uint4 m = make_uint4(kFull, kFull, kFull, kFull);
    if (kFwd) m = mrow != nullptr ? ld<kGlobal || kStream>(mrow + o) : make_uint4(0, 0, 0, 0);
    uint4 y = make_uint4(0, 0, 0, 0);
    if (nz(m)) {
      uint4 a = make_uint4(0, 0, 0, 0);
      bool full = false;
      for (int e = ptr[o]; e < ptr[o + 1]; ++e) {
        const int2 en = sp.ent[e];
        uint4 x = src[en.x];
        if (kFwd && gate && en.x == 0) x.x |= 1u;
        if (!nz(x)) continue;
        if (en.y < 0) {
          full = true;  // the full entries come first: nothing can add to it
          break;
        }
        const uint4* rows = sp.blk + en.y * 128 + lane;
        if ((x.x >> lane) & 1u) {
          const uint4 q = ld<kGlobal>(rows);
          a.x |= q.x; a.y |= q.y; a.z |= q.z; a.w |= q.w;
        }
        if ((x.y >> lane) & 1u) {
          const uint4 q = ld<kGlobal>(rows + 32);
          a.x |= q.x; a.y |= q.y; a.z |= q.z; a.w |= q.w;
        }
        if ((x.z >> lane) & 1u) {
          const uint4 q = ld<kGlobal>(rows + 64);
          a.x |= q.x; a.y |= q.y; a.z |= q.z; a.w |= q.w;
        }
        if ((x.w >> lane) & 1u) {
          const uint4 q = ld<kGlobal>(rows + 96);
          a.x |= q.x; a.y |= q.y; a.z |= q.z; a.w |= q.w;
        }
      }
      if (full) {
        y = m;
      } else {
        y = make_uint4(__reduce_or_sync(kFull, a.x), __reduce_or_sync(kFull, a.y),
                       __reduce_or_sync(kFull, a.z), __reduce_or_sync(kFull, a.w));
        y = and4(y, m);
      }
    }
    if (lane == 0) dst[o] = y;
    if (kFwd) {
      live = live || nz(y);
      acc_hit = acc_hit || nz(and4(y, ld<kGlobal>(sp.acc + o)));
    } else if (o == 0) {
      live = (y.x & 1u) != 0u;
    }
  }
  return live;
}

// The mask row of a symbol (null: a symbol in no run, a zero mask).
__device__ __forceinline__ const uint4* sym_row(const Sp& sp, int sym) {
  const int mr = sp.meta[kMetaSyms + sym];
  return mr >= 0 ? sp.mask + mr * sp.nb : nullptr;
}

// Channel c's accept test on the warp's state buffer v.
template <bool kGlobal>
__device__ __forceinline__ bool channel_hit(const Sp& sp, const uint4* v, int c) {
  const uint4* row = sp.acc + (1 + c) * sp.nb;
  for (int o = 0; o < sp.nb; ++o) {
    if (nz(and4(v[o], ld<kGlobal>(row + o)))) return true;
  }
  return false;
}

#define RRX_SP_PARAMS                                                                  \
  const uint8_t *data, long long stride, int L, const int32_t *lengths, int R,         \
      const uint32_t *tab_g, const int32_t *meta_g, int n_meta, const int32_t *live,    \
      int32_t *next
#define RRX_SP_SETUP                                                                   \
  extern __shared__ __align__(16) uint32_t smem[];                                     \
  /* the records below live (all R without it); a block with none skips */            \
  /* the table load: the test is uniform across the block, so it may */               \
  /* come before load_sp's barrier */                                                  \
  const int n_rec = live != nullptr ? min(R, *live) : R;                               \
  if (static_cast<int>(blockIdx.x) * kWarps >= n_rec) return;                          \
  const Sp sp = load_sp<kGlobal>(smem, tab_g, meta_g, n_meta);                         \
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;                          \
  uint4* const buf_a = reinterpret_cast<uint4*>(warp_buf(smem, n_meta, sp.W, warp, 0)); \
  uint4* const buf_b = reinterpret_cast<uint4*>(warp_buf(smem, n_meta, sp.W, warp, 1));

// The records of one warp: the grid is at most what is resident at once,
// so that a block copies the table once however many records it scans;
// each warp starts at its own index and then takes the next unclaimed
// record from the launch's counter (next, zero at launch), so that a few
// long-lived records (an unseeded scan's matches) do not pile up on a few
// warps.
#define RRX_SP_RECORDS                                                                 \
  for (int r = static_cast<int>(blockIdx.x) * kWarps + warp; r < n_rec;                 \
       r = next_record(next, lane))

// The next unclaimed record index, the same on every lane of the warp.
__device__ __forceinline__ int next_record(int32_t* next, int lane) {
  int r = 0;
  if (lane == 0) r = atomicAdd(next, 1) + static_cast<int>(gridDim.x) * kWarps;
  return __shfl_sync(kFull, r, 0);
}

// The start of one record: its row and length, and its state buffer
// cleared.
__device__ __forceinline__ Row begin_record(const uint8_t* data, long long stride, int L,
                                            const int32_t* lengths, int r, uint4* va, int nb,
                                            int lane) {
  for (int i = lane; i < nb; i += 32) va[i] = make_uint4(0, 0, 0, 0);
  __syncwarp();
  return record(data, stride, L, lengths, r);
}

// The forward walk t = 0 .. len+1 (sym = BOS, the bytes, EOS): f(t, sym)
// returns false to stop (the rest of the steps change no output).
template <class F>
__device__ __forceinline__ void walk_fwd_until(const uint4* row, int len, F&& f) {
  uint4 q{};
#pragma unroll 1
  for (int t = 0; t <= len + 1; ++t) {
    int sym = t == 0 ? kBos : kEos;
    if (t >= 1 && t <= len) {
      const int j = t - 1;
      if ((j & 15) == 0) q = __ldg(row + (j >> 4));
      sym = byte_at(q, j & 15);
    }
    if (!f(t, sym)) return;
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kSpThreads)
    sp_stats_kernel(RRX_SP_PARAMS, int seeded, int nullable, int32_t* cnt_o, int32_t* first_o,
                    int32_t* last_o, uint8_t* full_o) {
  RRX_SP_SETUP
  const int C = sp.C;
  RRX_SP_RECORDS {
    uint4 *va = buf_a, *vb = buf_b;
    const Row rec = begin_record(data, stride, L, lengths, r, va, sp.nb, lane);
    const int len = rec.len;
    const long long base = static_cast<long long>(r) * C;
    for (int c = lane; c < C; c += 32) {
      cnt_o[base + c] = nullable ? (seeded ? len + 1 : 1) : 0;
      first_o[base + c] = nullable ? 0 : -1;
      last_o[base + c] = nullable ? (seeded ? len : 0) : -1;
      full_o[base + c] = static_cast<uint8_t>(nullable && len == 0);
    }
    walk_fwd_until(rec.row, len, [&](int t, int sym) {
      const bool gate = seeded || t < 2;
      bool hit;
      const bool alive = expand<kGlobal, true>(sp, va, vb, gate, sym_row(sp, sym), hit,
                                               lane);
      __syncwarp();
      if (hit) {
        const int e = min(t, len);
        for (int c = lane; c < C; c += 32) {
          if (C > 1 && !channel_hit<kGlobal>(sp, vb, c)) continue;
          const long long o = base + c;
          if (!(nullable && seeded) && e != last_o[o]) cnt_o[o] += 1;
          if (first_o[o] < 0) first_o[o] = e;
          last_o[o] = e;
          if (t >= len) full_o[o] = 1;
        }
      }
      uint4* tmp = va;
      va = vb;
      vb = tmp;
      return seeded || t < 1 || alive;
    });
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kSpThreads)
    sp_flags_kernel(RRX_SP_PARAMS, int seeded, uint32_t* words) {
  RRX_SP_SETUP
  const int C = sp.C;
  const int Wt = (L + 2 + 31) >> 5;
  const long long cols = static_cast<long long>(R) * C;
  RRX_SP_RECORDS {
    uint4 *va = buf_a, *vb = buf_b;
    const Row rec = begin_record(data, stride, L, lengths, r, va, sp.nb, lane);
    const int len = rec.len;
    const long long base = static_cast<long long>(r) * C;
    for (int i = lane; i < Wt * C; i += 32) words[(i / C) * cols + base + i % C] = 0u;
    __syncwarp();
    walk_fwd_until(rec.row, len, [&](int t, int sym) {
      const bool gate = seeded || t < 2;
      bool hit;
      const bool alive = expand<kGlobal, true>(sp, va, vb, gate, sym_row(sp, sym), hit,
                                               lane);
      __syncwarp();
      if (hit) {
        for (int c = lane; c < C; c += 32) {
          if (C > 1 && !channel_hit<kGlobal>(sp, vb, c)) continue;
          words[(t >> 5) * cols + base + c] |= 1u << (t & 31);
        }
      }
      uint4* tmp = va;
      va = vb;
      vb = tmp;
      return seeded || t < 1 || alive;
    });
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kSpThreads)
    sp_reverse_kernel(RRX_SP_PARAMS, uint32_t* hits) {
  RRX_SP_SETUP
  const int Wt = (L + 2 + 31) >> 5;
  RRX_SP_RECORDS {
    uint4 *va = buf_a, *vb = buf_b;
    const Row rec = begin_record(data, stride, L, lengths, r, va, sp.nb, lane);
    const int len = rec.len;
    for (int i = ((len + 1) >> 5) + 1 + lane; i < Wt; i += 32) {
      hits[static_cast<long long>(i) * R + r] = 0u;
    }
    uint32_t word = 0;
    walk_steps_rev(rec.row, len, [&](int t, int sym) {
      // vb = (R | acc) & mask[sym], then R = expand(vb) into va
      const int mr = sp.meta[kMetaSyms + sym];
      for (int o = lane; o < sp.nb; o += 32) {
        uint4 x = make_uint4(0, 0, 0, 0);
        if (mr >= 0) {
          const uint4 a = ld<kGlobal>(sp.acc + o), v = va[o];
          x = and4(make_uint4(v.x | a.x, v.y | a.y, v.z | a.z, v.w | a.w),
                   ld<kGlobal>(sp.mask + mr * sp.nb + o));
        }
        vb[o] = x;
      }
      __syncwarp();
      bool unused;
      const bool h = expand<kGlobal, false>(sp, vb, va, false, nullptr, unused, lane);
      __syncwarp();
      word |= (h ? 1u : 0u) << (t & 31);
      if ((t & 31) == 0) {
        if (lane == 0) hits[static_cast<long long>(t >> 5) * R + r] = word;
        word = 0;
      }
    });
  }
}

// ---- the stream-fed kernels: the mask of step t is the record's row of the
// mask stream words[t][r][0 .. W) (16-byte words, nb of them), every step
// t < T of the stream is run (the stream's rows past a record's EOS are
// zero), and an unseeded scan stops at its first empty state past step 1.
// One accept channel: the forward table's union row.
#define RRX_SPS_PARAMS                                                                 \
  const uint4 *words, int T, int R, const uint32_t *tab_g, const int32_t *meta_g,     \
      int n_meta, int32_t *next

// Record r's stream row at step t.
__device__ __forceinline__ const uint4* stream_row(const uint4* words, int R, int nb, int r,
                                                   int t) {
  return words + (static_cast<size_t>(t) * R + r) * nb;
}

template <bool kGlobal>
__global__ void __launch_bounds__(kSpThreads)
    sp_stream_stats_kernel(RRX_SPS_PARAMS, const int32_t* lengths, int seeded, int nullable,
                           int32_t* cnt_o, int32_t* first_o) {
  const int32_t* const live = nullptr;
  RRX_SP_SETUP
  const bool dedup = !(nullable && seeded);
  RRX_SP_RECORDS {
    uint4 *va = buf_a, *vb = buf_b;
    for (int i = lane; i < sp.nb; i += 32) va[i] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    const int len = lengths[r];
    int cnt = nullable ? (seeded ? len + 1 : 1) : 0;
    int first = nullable ? 0 : -1;
    int last = nullable ? (seeded ? len : 0) : -1;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      bool hit;
      const bool alive = expand<kGlobal, true, true>(
          sp, va, vb, seeded || t < 2, stream_row(words, R, sp.nb, r, t), hit, lane);
      __syncwarp();
      if (hit) {
        const int e = min(t, len);
        cnt += (dedup && e != last) ? 1 : 0;
        first = first < 0 ? e : first;
        last = e;
      }
      uint4* tmp = va;
      va = vb;
      vb = tmp;
      // unseeded: past the last seed step an empty state set accepts nothing
      if (!seeded && t >= 1 && !alive) break;
    }
    if (lane == 0) {
      cnt_o[r] = cnt;
      first_o[r] = first;
    }
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kSpThreads)
    sp_stream_flags_kernel(RRX_SPS_PARAMS, int seeded, uint32_t* flags) {
  const int32_t* const live = nullptr;
  RRX_SP_SETUP
  const int Wt = (T + 31) >> 5;
  RRX_SP_RECORDS {
    uint4 *va = buf_a, *vb = buf_b;
    for (int i = lane; i < sp.nb; i += 32) va[i] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    uint32_t word = 0u;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      bool hit;
      const bool alive = expand<kGlobal, true, true>(
          sp, va, vb, seeded || t < 2, stream_row(words, R, sp.nb, r, t), hit, lane);
      __syncwarp();
      word |= (hit ? 1u : 0u) << (t & 31);
      const bool closes = (t & 31) == 31 || t == T - 1;  // walking up, bit t closes word t/32
      if (closes) {
        if (lane == 0) flags[static_cast<size_t>(t >> 5) * R + r] = word;
        word = 0u;
      }
      uint4* tmp = va;
      va = vb;
      vb = tmp;
      if (!seeded && t >= 1 && !alive) {
        // the rest of the flags are zero: this word, then the words after it
        if (!closes && lane == 0) flags[static_cast<size_t>(t >> 5) * R + r] = word;
        for (int i = (t >> 5) + 1 + lane; i < Wt; i += 32) {
          flags[static_cast<size_t>(i) * R + r] = 0u;
        }
        break;
      }
    }
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kSpThreads)
    sp_stream_reverse_kernel(RRX_SPS_PARAMS, uint32_t* hits) {
  const int32_t* const live = nullptr;
  RRX_SP_SETUP
  RRX_SP_RECORDS {
    uint4 *va = buf_a, *vb = buf_b;
    for (int i = lane; i < sp.nb; i += 32) va[i] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    uint32_t word = 0u;
#pragma unroll 1
    for (int t = T - 1; t >= 0; --t) {
      // vb = (R | acc) & m_t, then R = expand(vb) into va
      const uint4* m = stream_row(words, R, sp.nb, r, t);
      for (int o = lane; o < sp.nb; o += 32) {
        const uint4 a = ld<kGlobal>(sp.acc + o), v = va[o];
        vb[o] = and4(make_uint4(v.x | a.x, v.y | a.y, v.z | a.z, v.w | a.w), __ldg(m + o));
      }
      __syncwarp();
      bool unused;
      const bool h = expand<kGlobal, false>(sp, vb, va, false, nullptr, unused, lane);
      __syncwarp();
      word |= (h ? 1u : 0u) << (t & 31);
      if ((t & 31) == 0) {  // walking down, bit t closes word t/32
        if (lane == 0) hits[static_cast<size_t>(t >> 5) * R + r] = word;
        word = 0u;
      }
    }
  }
}

// The launchers' checks: the row layout (check_rows), and the meta's and
// the table's lengths and W (multiples of 4 words, which keeps the state
// buffers and the table's shared copy 16-byte aligned; at most 128 state
// words).
int check_sp(const void* data, long long stride, int L, int R, int n_tab, int n_meta, int W) {
  if (n_meta < kMetaEnt || (n_meta & 3) != 0 || (n_tab & 3) != 0 || W < 4 || (W & 3) != 0 ||
      W > 4 * kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return check_rows(data, stride, L, R);
}

// The stream-fed launchers' checks: the stream's shape and alignment (16-byte
// rows: W a multiple of 4) and the tables' (check_sp without the rows).
int check_sp_stream(const void* words, int T, int R, int n_tab, int n_meta, int W) {
  if (T < 0 || R < 0 || (reinterpret_cast<uintptr_t>(words) & 15u) != 0 ||
      (words == nullptr && static_cast<long long>(T) * R > 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return check_sp(nullptr, 16, 0, 0, n_tab, n_meta, W);
}

// One block per kWarps records, but no more blocks than fit on the card at
// once: each block then walks its share of the records (RRX_SP_RECORDS)
// and copies the table once.
template <class K, class... Args>
int launch_sp(K kernel, int R, size_t smem, void* stream, Args... args) {
  if (R == 0) return 0;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  int dev = 0, n_sm = 0, per_sm = 0;
  e = static_cast<int>(cudaGetDevice(&dev));
  if (e == 0) {
    e = static_cast<int>(cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev));
  }
  if (e == 0) {
    e = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSpThreads, smem));
  }
  if (e != 0) return e;
  const int blocks = min((R + kWarps - 1) / kWarps, max(1, n_sm * per_sm));
  kernel<<<blocks, kSpThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int occupancy_sp(K kernel, size_t smem, int* blocks_per_sm) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kSpThreads, smem));
}

}  // namespace

#define RRX_SP_HEAD                                                                        \
  const void *data, long long stride, int L, const void *lengths, int R, const void *tab, \
      int n_tab, const void *meta, int n_meta, int W, int global_tab, const void *live,   \
      void *next
#define RRX_SP_ARGS                                                                       \
  static_cast<const uint8_t*>(data), stride, L, static_cast<const int32_t*>(lengths), R, \
      static_cast<const uint32_t*>(tab), static_cast<const int32_t*>(meta), n_meta,      \
      static_cast<const int32_t*>(live), static_cast<int32_t*>(next)

extern "C" {

// Every entry point: the rows (data, stride, L, lengths, R), the table of
// its direction (tab [n_tab] int32 words, 16-byte aligned; meta [n_meta]
// int32; W state words), the form (global_tab: 0 the table copied into
// shared memory, 1 read from global memory), then live: null, or a device
// int32 count past which every record returns at once with its outputs
// unwritten (the prefilter's compacted and full passes), and next: a
// device int32 set to 0, the record counter the warps take work from.
//
// tab: the forward table (ops/scan_sparse.SparseTables.tab_f); cnt, first,
// last: [R][C] int32; full: [R][C] uint8
int rrx_sparse_stats(RRX_SP_HEAD, int seeded, int nullable, void* cnt,
                     void* first, void* last, void* full, void* stream) {
  const int bad = check_sp(data, stride, L, R, n_tab, n_meta, W);
  if (bad != 0) return bad;
  const size_t smem = sparse_smem_bytes(n_tab, n_meta, W, global_tab != 0);
  auto args = [&](auto k) {
    return launch_sp(k, R, smem, stream, RRX_SP_ARGS, seeded, nullable,
                     static_cast<int32_t*>(cnt), static_cast<int32_t*>(first),
                     static_cast<int32_t*>(last), static_cast<uint8_t*>(full));
  };
  return global_tab ? args(sp_stats_kernel<true>) : args(sp_stats_kernel<false>);
}

// words: [ceil((L+2)/32)][R*C] uint32
int rrx_sparse_flags(RRX_SP_HEAD, int seeded, void* words, void* stream) {
  const int bad = check_sp(data, stride, L, R, n_tab, n_meta, W);
  if (bad != 0) return bad;
  const size_t smem = sparse_smem_bytes(n_tab, n_meta, W, global_tab != 0);
  auto args = [&](auto k) {
    return launch_sp(k, R, smem, stream, RRX_SP_ARGS, seeded, static_cast<uint32_t*>(words));
  };
  return global_tab ? args(sp_flags_kernel<true>) : args(sp_flags_kernel<false>);
}

// tab: the reverse table (SparseTables.tab_r); hits: [ceil((L+2)/32)][R]
int rrx_sparse_reverse(RRX_SP_HEAD, void* hits, void* stream) {
  const int bad = check_sp(data, stride, L, R, n_tab, n_meta, W);
  if (bad != 0) return bad;
  const size_t smem = sparse_smem_bytes(n_tab, n_meta, W, global_tab != 0);
  auto args = [&](auto k) {
    return launch_sp(k, R, smem, stream, RRX_SP_ARGS, static_cast<uint32_t*>(hits));
  };
  return global_tab ? args(sp_reverse_kernel<true>) : args(sp_reverse_kernel<false>);
}

// The stream-fed container kernels. Every entry point: the mask stream
// words [T][R][W] uint32 (16-byte aligned; ops/scan_packed
// .mask_stream_from_bytes on the program's stream tables), then the table of
// its direction, its meta and W, the form and next as above (no live), its
// own arguments and the stream. One accept channel (the wrapper refuses
// tables of more).
#define RRX_SPS_HEAD                                                                     \
  const void *words, int T, int R, const void *tab, int n_tab, const void *meta,         \
      int n_meta, int W, int global_tab, void *next
#define RRX_SPS_ARGS                                                                     \
  static_cast<const uint4*>(words), T, R, static_cast<const uint32_t*>(tab),              \
      static_cast<const int32_t*>(meta), n_meta, static_cast<int32_t*>(next)

// lengths: [R] int32; cnt, first: [R] int32
int rrx_sparse_stream_stats(RRX_SPS_HEAD, const void* lengths, int seeded, int nullable,
                            void* cnt, void* first, void* stream) {
  const int bad = check_sp_stream(words, T, R, n_tab, n_meta, W);
  if (bad != 0) return bad;
  const size_t smem = sparse_smem_bytes(n_tab, n_meta, W, global_tab != 0);
  auto args = [&](auto k) {
    return launch_sp(k, R, smem, stream, RRX_SPS_ARGS, static_cast<const int32_t*>(lengths),
                     seeded, nullable, static_cast<int32_t*>(cnt), static_cast<int32_t*>(first));
  };
  return global_tab ? args(sp_stream_stats_kernel<true>) : args(sp_stream_stats_kernel<false>);
}

// flags: [ceil(T/32)][R] uint32, bit t = step t's accept flag
int rrx_sparse_stream_flags(RRX_SPS_HEAD, int seeded, void* flags, void* stream) {
  const int bad = check_sp_stream(words, T, R, n_tab, n_meta, W);
  if (bad != 0) return bad;
  const size_t smem = sparse_smem_bytes(n_tab, n_meta, W, global_tab != 0);
  auto args = [&](auto k) {
    return launch_sp(k, R, smem, stream, RRX_SPS_ARGS, seeded, static_cast<uint32_t*>(flags));
  };
  return global_tab ? args(sp_stream_flags_kernel<true>) : args(sp_stream_flags_kernel<false>);
}

// tab: the reverse table; hits: [ceil(T/32)][R] uint32, bit t = state 0 is in
// R after step t
int rrx_sparse_stream_reverse(RRX_SPS_HEAD, void* hits, void* stream) {
  const int bad = check_sp_stream(words, T, R, n_tab, n_meta, W);
  if (bad != 0) return bad;
  const size_t smem = sparse_smem_bytes(n_tab, n_meta, W, global_tab != 0);
  auto args = [&](auto k) {
    return launch_sp(k, R, smem, stream, RRX_SPS_ARGS, static_cast<uint32_t*>(hits));
  };
  return global_tab ? args(sp_stream_reverse_kernel<true>)
                    : args(sp_stream_reverse_kernel<false>);
}

// Resident blocks per SM (theoretical occupancy) of a container kernel for
// a table of n_tab words, a meta of n_meta and W state words: 0 stats,
// 1 flags, 2 reverse; the stream-fed ones 3 stats, 4 flags, 5 reverse.
int rrx_sparse_occupancy(int kernel, int n_tab, int n_meta, int W, int global_tab,
                         int* blocks_per_sm) {
  const size_t smem = sparse_smem_bytes(n_tab, n_meta, W, global_tab != 0);
  switch (kernel * 2 + (global_tab ? 1 : 0)) {
    case 0:
      return occupancy_sp(sp_stats_kernel<false>, smem, blocks_per_sm);
    case 1:
      return occupancy_sp(sp_stats_kernel<true>, smem, blocks_per_sm);
    case 2:
      return occupancy_sp(sp_flags_kernel<false>, smem, blocks_per_sm);
    case 3:
      return occupancy_sp(sp_flags_kernel<true>, smem, blocks_per_sm);
    case 4:
      return occupancy_sp(sp_reverse_kernel<false>, smem, blocks_per_sm);
    case 5:
      return occupancy_sp(sp_reverse_kernel<true>, smem, blocks_per_sm);
    case 6:
      return occupancy_sp(sp_stream_stats_kernel<false>, smem, blocks_per_sm);
    case 7:
      return occupancy_sp(sp_stream_stats_kernel<true>, smem, blocks_per_sm);
    case 8:
      return occupancy_sp(sp_stream_flags_kernel<false>, smem, blocks_per_sm);
    case 9:
      return occupancy_sp(sp_stream_flags_kernel<true>, smem, blocks_per_sm);
    case 10:
      return occupancy_sp(sp_stream_reverse_kernel<false>, smem, blocks_per_sm);
    case 11:
      return occupancy_sp(sp_stream_reverse_kernel<true>, smem, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int rrx_sparse_threads_per_block() { return kSpThreads; }

}  // extern "C"
