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
//   records from a counter in global memory until none is left.
// - rrx_sparse_stats and _flags (step_regs) and rrx_sparse_reverse
//   (step_rev_regs) keep the record's state in registers: lane l holds
//   state words l + 32 j (j < ceil(W / 32) <= 4;
//   lanes past W hold zero and join every vote), so block 8 j + g sits in
//   lanes 4 g .. 4 g + 3 of slot j. The forward seed row (the expansion of
//   state 0, live at every step of a seeded scan) is ORed in from
//   registers. In both directions (walk_live, over the walk tables of the
//   direction: the reverse ones are F transposed) each source block with a
//   live state (a ballot of the lanes' words) takes one of two forms by its
//   live count, a warp-uniform popcount:
//   - at most walk_max live states (ops/scan_sparse.WALK_MAX, fixed by
//     chip_smoke.py's sweep on log text and chain records): each live
//     state's own list of nonzero partial rows (built on the host from
//     prog.sparse_partition), each row one 4-byte load and OR by the four
//     lanes that own its output block: ~6 warp instructions a live state
//     and ~8 a live row;
//   - more: the block-parallel form (lane l takes bit l of the block's four
//     words, shuffled from their lanes, and ORs the 16-byte rows of its
//     bits; __reduce_or_sync per partial block), ~35 instructions a partial
//     block whatever its live count: the cheaper form for the chains of a
//     counter, which keep tens to 128 states of a block live.
//   A live source block also sets U's full output blocks. Rows of an output
//   block that the step's mask zeroes are skipped, and a symbol whose mask
//   is zero clears the state without a walk. The mask, the union accept test
//   (one __any_sync) and the liveness test run per lane; only on a step where
//   the union fires does the warp write its state into its buffer of W words
//   in shared memory for the per-channel tests. The step is bound by
//   instruction issue and follows the live states: K120's log text keeps ~5
//   live (the seed included) in ~3.5 of 7 source blocks, ~150 instructions
//   a step; the memory carries one input byte a step.
// - The reverse step R = expand((R | acc) & mask[sym]) is taken as
//   expand(R & mask[sym]) | E[row]: the expansion distributes over OR, and
//   E[row] = expand(acc & mask[row]) is one row per mask row built on the
//   host (the reverse walk tables' head; K120: 28 rows of 28 words). The
//   accept set, live at every step, then costs one row load and OR a step
//   instead of a walk of every accepting state, and the walk visits only the live
//   partial matches of R & mask[sym]. The hit (state 0 in R) is bit 0 of
//   lane 0's first word: no vote; lane 0 stores the hit word every 32 steps.
// - Not tensor cores: a step is a bit-vector times a bit-matrix per record.
//   An int8 wgmma over 64 records in lockstep would do lanes^2 multiply-adds
//   a record-step (826^2 for K120) to obtain what ~5 row ORs give, and
//   records of different lengths would wait for each other.
// - Only the stream-fed kernels (rows 11-13 of PERF.md's table) still run
//   expand: the state in two buffers of W words in shared memory (the
//   current and the next), every entry of every output block visited (a
//   source block with no live bit costs a uniform test), for a live one
//   each lane's 4 bits tested, 4 predicated 16-byte row loads and 16 ORs, 4
//   __reduce_or_sync an output block and a __syncwarp a step: ~35
//   instructions an entry whatever the live count (~1,250 scheduler cycles
//   a K120 step, measured on rrx_sparse_reverse before it took the register
//   step).
// - The table (the partial blocks, 2 KB each, the mask rows and the accept
//   rows) and, for the walk kernels, the walk tables are copied into shared
//   memory when they fit beside the meta and the state buffers (227 KB a
//   block; config 13's 78 blocks are 156 KB, its walk tables 26 KB), else
//   read from global memory through L1 / L2 (the cap of 120 partial blocks
//   is 240 KB). The launcher takes the form from the wrapper
//   (ops/scan_sparse.table_form, per kind of kernel) and refuses a shared
//   form that does not fit.
// - The accept test runs on the channels' union row; only on a step where
//   it fires does each lane test its channels (c = lane, lane + 32, ...) and
//   update their statistics or flag words in global memory, so the
//   per-channel bookkeeping of a 100-pattern MultiPattern costs nothing on
//   the many steps without a match.
// - An unseeded scan (fullmatch) whose state is empty after step 1 can
//   accept nothing later: the walk stops there.
// - The stream-fed kernels run expand with the mask of output block o read
//   from the record's stream row (words[t][r][4o .. 4o+3], one 16-byte
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
// shared memory. The walk tables (rrx_sparse_stats and _flags: the forward
// ones; rrx_sparse_reverse: the reverse ones; null in the stream-fed
// kernels) live where the table does.
struct Sp {
  const uint4* blk;   // [n_part][128] rows
  const uint4* mask;  // [n_mask][nb]
  const uint4* acc;   // [n_acc][nb]: forward the union then the channels
  const int* meta;
  const int2* ent;  // [n_ent] (source block, partial block or -1)
  int nb, W, C;
  // walk: [the head rows, W words each | nb full masks | n_mask block
  // masks | nb + 1 source-block offsets | n_part source-block entries |
  // lanes + 1 state offsets | the state entries], padded to a multiple of 4
  // words (ops/scan_sparse._walk)
  const uint32_t* seed;   // forward: [W] the expansion of {state 0}; reverse:
                          // [n_mask][W] E, the expansion of acc & mask[row]
  const uint32_t* full;   // [nb] bit o: U maps source block s onto output block o
  const uint32_t* mblk;   // [n_mask] bit o: mask row r is nonzero in output block o
  const int* sptr;        // [nb + 1] each source block's partial blocks in sent
  const int* sent;        // [n_part] partial block << 5 | its output block
  const int* ptr;         // [lanes + 1] each state's nonzero partial rows in rent
  const int* rent;        // row (partial block * 128 + state's row) << 5 | output block
};

inline size_t sparse_smem_bytes(int n_tab, int n_meta, int W, bool global_tab) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(n_meta) + 2 * kWarps * W + (global_tab ? 0 : n_tab));
}

// The walk kernels: the meta, bufs channel buffers of W words per warp
// (rrx_sparse_stats and _flags one, rrx_sparse_reverse none) and, in the
// shared form, the walk tables and the table.
inline size_t walk_smem_bytes(int n_tab, int n_meta, int n_walk, int W, bool global_tab,
                              int bufs) {
  return sizeof(uint32_t) * (static_cast<size_t>(n_meta) + bufs * kWarps * W +
                             (global_tab ? 0 : static_cast<size_t>(n_walk) + n_tab));
}

// A load from the table or the walk tables: through the read-only path in
// the global form, from shared memory in the shared form.
template <bool kGlobal, class T>
__device__ __forceinline__ T ld(const T* p) {
  if (kGlobal) return __ldg(p);
  return *p;
}

__device__ __forceinline__ bool nz(const uint4& a) { return (a.x | a.y | a.z | a.w) != 0u; }

__device__ __forceinline__ uint4 and4(const uint4& a, const uint4& b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// Copies the meta (and, in the shared form, the walk tables and the table)
// into shared memory after the meta and bufs state buffers of W words per
// warp. The walk tables' head is one row (forward) or, rev_walk, one row
// per mask row (reverse). Every thread of a block that holds a record calls
// it (it ends in __syncthreads) before any thread returns.
template <bool kGlobal>
__device__ __forceinline__ Sp load_sp(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                      const int32_t* __restrict__ meta_g, int n_meta, int bufs,
                                      const int32_t* __restrict__ walk_g = nullptr,
                                      int n_walk = 0, bool rev_walk = false) {
  int* meta = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < n_meta; i += blockDim.x) meta[i] = meta_g[i];
  const int nb = meta_g[0], n_part = meta_g[1], n_mask = meta_g[3], C = meta_g[4];
  const int W = meta_g[5], n_acc = meta_g[6];
  // the walk tables, then the table, in 16-byte words, after the meta and
  // the state buffers
  const int n_tab4 = n_part * (kBlockWords / 4) + (n_mask + n_acc) * nb;
  const uint4* tab = reinterpret_cast<const uint4*>(tab_g);
  const uint32_t* walk = reinterpret_cast<const uint32_t*>(walk_g);
  if (!kGlobal) {
    uint32_t* w = smem + n_meta + bufs * kWarps * W;
    for (int i = threadIdx.x; i < n_walk; i += blockDim.x) w[i] = __ldg(walk + i);
    if (walk != nullptr) walk = w;
    uint4* t = reinterpret_cast<uint4*>(w + n_walk);
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
  if (walk != nullptr) {
    sp.seed = walk;
    sp.full = walk + (rev_walk ? n_mask : 1) * W;
    sp.mblk = sp.full + nb;
    sp.sptr = reinterpret_cast<const int*>(sp.mblk + n_mask);
    sp.sent = sp.sptr + nb + 1;
    sp.ptr = sp.sent + n_part;
    sp.rent = sp.ptr + 32 * W + 1;
  }
  return sp;
}

// The warp's two state buffers of the stream-fed kernels (16-byte aligned:
// n_meta and W are multiples of 4).
__device__ __forceinline__ uint32_t* warp_buf(uint32_t* smem, int n_meta, int W, int warp,
                                              int which) {
  return smem + n_meta + (2 * warp + which) * W;
}

// One expansion of src into dst (both [nb] 16-byte blocks of one warp's
// buffers), the step of the stream-fed kernels. Forward (kFwd,
// rrx_sparse_stream_stats and _flags): the seed ORs state 0 into source block 0
// when gate, and each output block is masked by the record's row of the
// mask stream mrow ([nb] 16-byte words in global memory), skipping an
// output block whose mask is zero; the union accept row's test comes back
// in acc_hit. Reverse (rrx_sparse_stream_reverse): no mask (src is already
// masked). Returns whether any
// state of dst is live (forward) or state 0 is (reverse). Lane 0 writes
// dst; the caller syncs the warp.
template <bool kGlobal, bool kFwd>
__device__ __forceinline__ bool expand(const Sp& sp, const uint4* src, uint4* dst, bool gate,
                                       const uint4* mrow, bool& acc_hit, int lane) {
  bool live = false;
  acc_hit = false;
  const int* ptr = sp.meta + kMetaPtr;
  for (int o = 0; o < sp.nb; ++o) {
    uint4 m = make_uint4(kFull, kFull, kFull, kFull);
    if (kFwd) m = __ldg(mrow + o);
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
  const Sp sp = load_sp<kGlobal>(smem, tab_g, meta_g, n_meta, 2);                      \
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

// ---- the register steps of rrx_sparse_stats, _flags and _reverse: the
// record's state in registers, lane l holding state words l + 32 j in v[j]
// (j < NJ = ceil(W / 32); zero past W). Word w is word w % 4 of block w / 4,
// so block 8 j + g lives in lanes 4 g .. 4 g + 3 of slot j.

// y[jj] |= x for a slot index known only at run time (NJ is at most 4).
template <int NJ>
__device__ __forceinline__ void or_slot(uint32_t (&y)[NJ], int jj, uint32_t x) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j == jj) y[j] |= x;
  }
}

// The expansion of x over one direction's walk tables, shared by both
// steps: per source block with a live state (a ballot over the lanes'
// words), with at most walk_max live states each live state's nonzero
// partial rows (sp.ptr / sp.rent) are ORed into y by the lanes that own
// their output words, one 4-byte load each; with more, the block-parallel
// form (lane l takes bit l of the block's four words, 16-byte row loads,
// __reduce_or_sync per partial block) as in expand. Rows and partial blocks
// whose output block is not in ob are skipped. Returns the output blocks
// that U sets whole (those of the live source blocks).
template <int NJ, bool kGlobal>
__device__ __forceinline__ uint32_t walk_live(const Sp& sp, const uint32_t (&x)[NJ],
                                              uint32_t (&y)[NJ], uint32_t ob, int walk_max,
                                              int lane) {
  const int grp = lane >> 2, sub = lane & 3;
  const uint32_t* blk32 = reinterpret_cast<const uint32_t*>(sp.blk);
  uint32_t full = 0u;  // output blocks set whole by U
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const uint32_t xj = x[j];
    unsigned lw = __ballot_sync(kFull, xj != 0u);  // the live words of slot j
    if (lw == 0u) continue;
    int pc = __popc(xj);  // live states of this lane's block
    pc += __shfl_xor_sync(kFull, pc, 1);
    pc += __shfl_xor_sync(kFull, pc, 2);
    const unsigned dense = __ballot_sync(kFull, pc > walk_max);
    while (lw != 0u) {
      const int src = __ffs(lw) - 1;
      const int s = 8 * j + (src >> 2);  // its source block
      full |= ld<kGlobal>(sp.full + s);
      if ((dense >> src) & 1u) {
        // the block-parallel form, once for the block's four words
        const int q = src & ~3;
        lw &= ~(0xFu << q);
        const uint32_t x0 = __shfl_sync(kFull, xj, q), x1 = __shfl_sync(kFull, xj, q + 1);
        const uint32_t x2 = __shfl_sync(kFull, xj, q + 2), x3 = __shfl_sync(kFull, xj, q + 3);
        const int e1 = ld<kGlobal>(sp.sptr + s + 1);
        for (int e = ld<kGlobal>(sp.sptr + s); e < e1; ++e) {
          const int en = ld<kGlobal>(sp.sent + e);
          const int o = en & 31;
          if (((ob >> o) & 1u) == 0u) continue;
          const uint4* rows = sp.blk + (en >> 5) * 128 + lane;
          uint4 a = make_uint4(0, 0, 0, 0);
          if ((x0 >> lane) & 1u) {
            const uint4 r = ld<kGlobal>(rows);
            a.x |= r.x; a.y |= r.y; a.z |= r.z; a.w |= r.w;
          }
          if ((x1 >> lane) & 1u) {
            const uint4 r = ld<kGlobal>(rows + 32);
            a.x |= r.x; a.y |= r.y; a.z |= r.z; a.w |= r.w;
          }
          if ((x2 >> lane) & 1u) {
            const uint4 r = ld<kGlobal>(rows + 64);
            a.x |= r.x; a.y |= r.y; a.z |= r.z; a.w |= r.w;
          }
          if ((x3 >> lane) & 1u) {
            const uint4 r = ld<kGlobal>(rows + 96);
            a.x |= r.x; a.y |= r.y; a.z |= r.z; a.w |= r.w;
          }
          const uint32_t r0 = __reduce_or_sync(kFull, a.x), r1 = __reduce_or_sync(kFull, a.y);
          const uint32_t r2 = __reduce_or_sync(kFull, a.z), r3 = __reduce_or_sync(kFull, a.w);
          if ((o & 7) == grp) or_slot(y, o >> 3, sub == 0 ? r0 : sub == 1 ? r1 : sub == 2 ? r2 : r3);
        }
      } else {
        // the live-state walk over this word's bits
        lw &= lw - 1u;
        uint32_t b = __shfl_sync(kFull, xj, src);
        const int base = 32 * (32 * j + src);
        while (b != 0u) {
          const int st = base + __ffs(b) - 1;
          b &= b - 1u;
          const int e1 = ld<kGlobal>(sp.ptr + st + 1);
          for (int e = ld<kGlobal>(sp.ptr + st); e < e1; ++e) {
            const int en = ld<kGlobal>(sp.rent + e);
            const int o = en & 31;
            if (((ob >> o) & 1u) != 0u && (o & 7) == grp) {
              or_slot(y, o >> 3, ld<kGlobal>(blk32 + (en >> 5) * 4 + sub));
            }
          }
        }
      }
    }
  }
  return full;
}

// One forward step: v = expand(v | gate * {state 0}) & mask[sym]. The seed
// row (seed, this lane's words of the expansion of {state 0}) stands for the
// gate, so state 0 enters the walk only when it is live itself; walk_live
// expands v, skipping the output blocks that the step's mask zeroes, and a
// symbol with a zero mask clears the state at once. Returns whether a state
// is live; hit: the union accept row meets v.
template <int NJ, bool kGlobal>
__device__ __forceinline__ bool step_regs(const Sp& sp, uint32_t (&v)[NJ],
                                          const uint32_t (&seed)[NJ],
                                          const uint32_t (&acc)[NJ], bool gate, int sym,
                                          int walk_max, int lane, bool& hit) {
  const int mr = sp.meta[kMetaSyms + sym];
  const uint32_t mb = mr >= 0 ? ld<kGlobal>(sp.mblk + mr) : 0u;
  hit = false;
  if (mb == 0u) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) v[j] = 0u;
    return false;
  }
  const int grp = lane >> 2;
  uint32_t y[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) y[j] = gate ? seed[j] : 0u;
  const uint32_t full = walk_live<NJ, kGlobal>(sp, v, y, mb, walk_max, lane);
  const uint32_t* mask32 = reinterpret_cast<const uint32_t*>(sp.mask) + mr * sp.W;
  bool live = false, acc_hit = false;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int w = lane + 32 * j;
    const uint32_t m = w < sp.W ? ld<kGlobal>(mask32 + w) : 0u;
    const uint32_t z = (((full >> (8 * j + grp)) & 1u) != 0u ? kFull : y[j]) & m;
    v[j] = z;
    live = live || z != 0u;
    acc_hit = acc_hit || (z & acc[j]) != 0u;
  }
  hit = __any_sync(kFull, acc_hit);
  return __any_sync(kFull, live);
}

// One reverse step on the reverse walk tables (F transposed): R =
// expand((R | acc) & mask[sym]) = expand(R & mask[sym]) | E[row], the
// expansion distributing over OR, with E[row] = expand(acc & mask[row]) one
// precomputed row per mask row (the walk tables' head, sp.seed). walk_live
// expands only u = R & mask[sym], the live partial matches; a symbol with a
// zero mask (whose E row is zero too) clears the state at once. The step's
// hit (state 0 is in R) is bit 0 of lane 0's slot 0.
template <int NJ, bool kGlobal>
__device__ __forceinline__ void step_rev_regs(const Sp& sp, uint32_t (&R)[NJ], int sym,
                                              int walk_max, int lane) {
  const int mr = sp.meta[kMetaSyms + sym];
  const uint32_t mb = mr >= 0 ? ld<kGlobal>(sp.mblk + mr) : 0u;
  if (mb == 0u) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) R[j] = 0u;
    return;
  }
  const uint32_t* mask32 = reinterpret_cast<const uint32_t*>(sp.mask) + mr * sp.W;
  const uint32_t* e32 = sp.seed + mr * sp.W;
  uint32_t u[NJ], y[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int w = lane + 32 * j;
    u[j] = w < sp.W ? R[j] & ld<kGlobal>(mask32 + w) : 0u;
    y[j] = w < sp.W ? ld<kGlobal>(e32 + w) : 0u;
  }
  const uint32_t full = walk_live<NJ, kGlobal>(sp, u, y, kFull, walk_max, lane);
  const int grp = lane >> 2;
#pragma unroll
  for (int j = 0; j < NJ; ++j) R[j] = ((full >> (8 * j + grp)) & 1u) != 0u ? kFull : y[j];
}

// This lane's words of the seed row and of the union accept row.
template <int NJ, bool kGlobal>
__device__ __forceinline__ void lane_rows(const Sp& sp, int lane, uint32_t (&seed)[NJ],
                                          uint32_t (&acc)[NJ]) {
  const uint32_t* acc32 = reinterpret_cast<const uint32_t*>(sp.acc);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int w = lane + 32 * j;
    seed[j] = w < sp.W ? ld<kGlobal>(sp.seed + w) : 0u;
    acc[j] = w < sp.W ? ld<kGlobal>(acc32 + w) : 0u;
  }
}

// Writes the state into the warp's channel buffer (W words) for the
// per-channel accept tests; the caller syncs the warp.
template <int NJ>
__device__ __forceinline__ void spill(const uint32_t (&v)[NJ], uint32_t* buf, int W, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (lane + 32 * j < W) buf[lane + 32 * j] = v[j];
  }
}

#define RRX_SPW_PARAMS                                                                 \
  RRX_SP_PARAMS, const int32_t *walk_g, int n_walk, int walk_max
#define RRX_SPW_SETUP                                                                  \
  extern __shared__ __align__(16) uint32_t smem[];                                     \
  const int n_rec = live != nullptr ? min(R, *live) : R;                               \
  if (static_cast<int>(blockIdx.x) * kWarps >= n_rec) return;                          \
  const Sp sp = load_sp<kGlobal>(smem, tab_g, meta_g, n_meta, 1, walk_g, n_walk);      \
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;                          \
  uint32_t* const buf = smem + n_meta + warp * sp.W;                                   \
  uint32_t seed[NJ], acc[NJ];                                                          \
  lane_rows<NJ, kGlobal>(sp, lane, seed, acc);

template <int NJ, bool kGlobal>
__global__ void __launch_bounds__(kSpThreads)
    sp_stats_kernel(RRX_SPW_PARAMS, int seeded, int nullable, int32_t* cnt_o, int32_t* first_o,
                    int32_t* last_o, uint8_t* full_o) {
  RRX_SPW_SETUP
  const int C = sp.C;
  RRX_SP_RECORDS {
    const Row rec = record(data, stride, L, lengths, r);
    const int len = rec.len;
    const long long base = static_cast<long long>(r) * C;
    for (int c = lane; c < C; c += 32) {
      cnt_o[base + c] = nullable ? (seeded ? len + 1 : 1) : 0;
      first_o[base + c] = nullable ? 0 : -1;
      last_o[base + c] = nullable ? (seeded ? len : 0) : -1;
      full_o[base + c] = static_cast<uint8_t>(nullable && len == 0);
    }
    uint32_t v[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) v[j] = 0u;
    walk_fwd_until(rec.row, len, [&](int t, int sym) {
      bool hit;
      const bool alive = step_regs<NJ, kGlobal>(sp, v, seed, acc, seeded || t < 2, sym,
                                                walk_max, lane, hit);
      if (hit) {
        if (C > 1) {
          spill(v, buf, sp.W, lane);
          __syncwarp();
        }
        const int e = min(t, len);
        for (int c = lane; c < C; c += 32) {
          if (C > 1 && !channel_hit<kGlobal>(sp, reinterpret_cast<const uint4*>(buf), c)) continue;
          const long long o = base + c;
          if (!(nullable && seeded) && e != last_o[o]) cnt_o[o] += 1;
          if (first_o[o] < 0) first_o[o] = e;
          last_o[o] = e;
          if (t >= len) full_o[o] = 1;
        }
        if (C > 1) __syncwarp();
      }
      return seeded || t < 1 || alive;
    });
  }
}

template <int NJ, bool kGlobal>
__global__ void __launch_bounds__(kSpThreads)
    sp_flags_kernel(RRX_SPW_PARAMS, int seeded, uint32_t* words) {
  RRX_SPW_SETUP
  const int C = sp.C;
  const int Wt = (L + 2 + 31) >> 5;
  const long long cols = static_cast<long long>(R) * C;
  RRX_SP_RECORDS {
    const Row rec = record(data, stride, L, lengths, r);
    const int len = rec.len;
    const long long base = static_cast<long long>(r) * C;
    for (int i = lane; i < Wt * C; i += 32) words[(i / C) * cols + base + i % C] = 0u;
    __syncwarp();
    uint32_t v[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) v[j] = 0u;
    walk_fwd_until(rec.row, len, [&](int t, int sym) {
      bool hit;
      const bool alive = step_regs<NJ, kGlobal>(sp, v, seed, acc, seeded || t < 2, sym,
                                                walk_max, lane, hit);
      if (hit) {
        if (C > 1) {
          spill(v, buf, sp.W, lane);
          __syncwarp();
        }
        for (int c = lane; c < C; c += 32) {
          if (C > 1 && !channel_hit<kGlobal>(sp, reinterpret_cast<const uint4*>(buf), c)) continue;
          words[(t >> 5) * cols + base + c] |= 1u << (t & 31);
        }
        if (C > 1) __syncwarp();
      }
      return seeded || t < 1 || alive;
    });
  }
}

template <int NJ, bool kGlobal>
__global__ void __launch_bounds__(kSpThreads)
    sp_reverse_kernel(RRX_SPW_PARAMS, uint32_t* hits) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_rec = live != nullptr ? min(R, *live) : R;
  if (static_cast<int>(blockIdx.x) * kWarps >= n_rec) return;
  const Sp sp = load_sp<kGlobal>(smem, tab_g, meta_g, n_meta, 0, walk_g, n_walk, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Wt = (L + 2 + 31) >> 5;
  RRX_SP_RECORDS {
    const Row rec = record(data, stride, L, lengths, r);
    const int len = rec.len;
    for (int i = ((len + 1) >> 5) + 1 + lane; i < Wt; i += 32) {
      hits[static_cast<long long>(i) * R + r] = 0u;
    }
    uint32_t v[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) v[j] = 0u;
    uint32_t word = 0;  // lane 0's is the record's
    walk_chunks_rev(rec.row, len, [&](int t, int sym) {
      step_rev_regs<NJ, kGlobal>(sp, v, sym, walk_max, lane);
      word |= (v[0] & 1u) << (t & 31);
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
      const bool alive = expand<kGlobal, true>(
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
      const bool alive = expand<kGlobal, true>(
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

// The walk kernels' checks: check_sp's and the walk tables' length (a
// multiple of 4 words, keeping the table's shared copy 16-byte aligned).
int check_walk(const void* data, long long stride, int L, int R, int n_tab, int n_meta,
               int n_walk, int W) {
  if (n_walk < W + 32 * W + 1 || (n_walk & 3) != 0) return static_cast<int>(cudaErrorInvalidValue);
  return check_sp(data, stride, L, R, n_tab, n_meta, W);
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

// The walk kernels for W state words (NJ = ceil(W / 32) registers a lane)
// and the table's form.
using StatsKernel = decltype(&sp_stats_kernel<1, false>);
using FlagsKernel = decltype(&sp_flags_kernel<1, false>);
using ReverseKernel = decltype(&sp_reverse_kernel<1, false>);

StatsKernel stats_kernel(int W, bool global_tab) {
  static const StatsKernel ks[4][2] = {{sp_stats_kernel<1, false>, sp_stats_kernel<1, true>},
                                       {sp_stats_kernel<2, false>, sp_stats_kernel<2, true>},
                                       {sp_stats_kernel<3, false>, sp_stats_kernel<3, true>},
                                       {sp_stats_kernel<4, false>, sp_stats_kernel<4, true>}};
  return ks[(W + 31) / 32 - 1][global_tab ? 1 : 0];
}

FlagsKernel flags_kernel(int W, bool global_tab) {
  static const FlagsKernel ks[4][2] = {{sp_flags_kernel<1, false>, sp_flags_kernel<1, true>},
                                       {sp_flags_kernel<2, false>, sp_flags_kernel<2, true>},
                                       {sp_flags_kernel<3, false>, sp_flags_kernel<3, true>},
                                       {sp_flags_kernel<4, false>, sp_flags_kernel<4, true>}};
  return ks[(W + 31) / 32 - 1][global_tab ? 1 : 0];
}

ReverseKernel reverse_kernel(int W, bool global_tab) {
  static const ReverseKernel ks[4][2] = {
      {sp_reverse_kernel<1, false>, sp_reverse_kernel<1, true>},
      {sp_reverse_kernel<2, false>, sp_reverse_kernel<2, true>},
      {sp_reverse_kernel<3, false>, sp_reverse_kernel<3, true>},
      {sp_reverse_kernel<4, false>, sp_reverse_kernel<4, true>}};
  return ks[(W + 31) / 32 - 1][global_tab ? 1 : 0];
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
// Then the walk tables of the kernel's direction (walk [n_walk] int32, a
// multiple of 4 words: ops/scan_sparse.SparseTables.walk_f for
// rrx_sparse_stats and rrx_sparse_flags, .walk_r for rrx_sparse_reverse)
// and walk_max, the live-state count up to which a source block is walked
// state by state (ops/scan_sparse.WALK_MAX).
//
// tab: the forward table (ops/scan_sparse.SparseTables.tab_f); cnt, first,
// last: [R][C] int32; full: [R][C] uint8
int rrx_sparse_stats(RRX_SP_HEAD, const void* walk, int n_walk, int walk_max, int seeded,
                     int nullable, void* cnt, void* first, void* last, void* full,
                     void* stream) {
  const int bad = check_walk(data, stride, L, R, n_tab, n_meta, n_walk, W);
  if (bad != 0) return bad;
  const size_t smem = walk_smem_bytes(n_tab, n_meta, n_walk, W, global_tab != 0, 1);
  return launch_sp(stats_kernel(W, global_tab != 0), R, smem, stream, RRX_SP_ARGS,
                   static_cast<const int32_t*>(walk), n_walk, walk_max, seeded, nullable,
                   static_cast<int32_t*>(cnt), static_cast<int32_t*>(first),
                   static_cast<int32_t*>(last), static_cast<uint8_t*>(full));
}

// words: [ceil((L+2)/32)][R*C] uint32
int rrx_sparse_flags(RRX_SP_HEAD, const void* walk, int n_walk, int walk_max, int seeded,
                     void* words, void* stream) {
  const int bad = check_walk(data, stride, L, R, n_tab, n_meta, n_walk, W);
  if (bad != 0) return bad;
  const size_t smem = walk_smem_bytes(n_tab, n_meta, n_walk, W, global_tab != 0, 1);
  return launch_sp(flags_kernel(W, global_tab != 0), R, smem, stream, RRX_SP_ARGS,
                   static_cast<const int32_t*>(walk), n_walk, walk_max, seeded,
                   static_cast<uint32_t*>(words));
}

// tab: the reverse table (SparseTables.tab_r); hits: [ceil((L+2)/32)][R]
int rrx_sparse_reverse(RRX_SP_HEAD, const void* walk, int n_walk, int walk_max, void* hits,
                       void* stream) {
  const int bad = check_walk(data, stride, L, R, n_tab, n_meta, n_walk, W);
  if (bad != 0) return bad;
  const size_t smem = walk_smem_bytes(n_tab, n_meta, n_walk, W, global_tab != 0, 0);
  return launch_sp(reverse_kernel(W, global_tab != 0), R, smem, stream, RRX_SP_ARGS,
                   static_cast<const int32_t*>(walk), n_walk, walk_max,
                   static_cast<uint32_t*>(hits));
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
// a table of n_tab words, a meta of n_meta, walk tables of n_walk (the walk
// kernels only: the forward ones for stats and flags, the reverse ones for
// reverse) and W state words: 0 stats, 1 flags, 2 reverse; the stream-fed
// ones 3 stats, 4 flags, 5 reverse.
int rrx_sparse_occupancy(int kernel, int n_tab, int n_meta, int n_walk, int W, int global_tab,
                         int* blocks_per_sm) {
  if (W < 4 || W > 4 * kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  const bool g = global_tab != 0;
  const size_t smem = sparse_smem_bytes(n_tab, n_meta, W, g);
  const size_t smem_w = walk_smem_bytes(n_tab, n_meta, n_walk, W, g, 1);
  switch (kernel * 2 + (g ? 1 : 0)) {
    case 0:
    case 1:
      return occupancy_sp(stats_kernel(W, g), smem_w, blocks_per_sm);
    case 2:
    case 3:
      return occupancy_sp(flags_kernel(W, g), smem_w, blocks_per_sm);
    case 4:
    case 5:
      return occupancy_sp(reverse_kernel(W, g), walk_smem_bytes(n_tab, n_meta, n_walk, W, g, 0),
                          blocks_per_sm);
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
