// The matmul tier's set-form step, shared by scan_nfa.cu (records),
// scan_long.cu (windows of one long string) and scan_stream.cu (records fed
// a mask stream, the mask row in registers): one record tile of s_tile <=
// 256 states as W = ceil(s_tile/32) u32 words per row, the rows in shared
// memory and the state set in W registers.
//
//     forward:  v = (OR of follow[s] over s in v | seed) & mask[sym]
//     reverse:  R = OR of pred[u] over u in (R | acc) & mask[sym]
//
// sym is a byte (0..255), kBos, kEos or kDead (a step outside the stream,
// whose mask row is zero). The table is [(2 S + kSyms + P) * W] words:
// follow [S][W], pred [S][W], mask [kSyms][W], P accept rows [P][W]
// (scan_pallas.nfa_tables).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "scan_core.cuh"

namespace rrx {

// Shared memory of a tile with P accept rows and `extra` words after them.
inline size_t nfa_smem_bytes(int S, int W, int P = 1, int extra = 0) {
  return sizeof(uint32_t) * (static_cast<size_t>((2 * S + kSyms + P) * W) + extra);
}


template <int W>
struct Nfa {
  const uint32_t* follow;  // shared [S][W]
  const uint32_t* pred;    // shared [S][W]
  const uint32_t* mask;    // shared [kSyms][W]
  uint32_t acc[W];

  // y |= OR of rows[s] over the states s of x (rows: follow or pred)
  __device__ __forceinline__ static void or_rows(uint32_t (&y)[W], const uint32_t (&x)[W],
                                                 const uint32_t* rows) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t b = x[w];
      while (b != 0u) {
        const uint32_t* f = rows + (32 * w + __ffs(b) - 1) * W;
        b &= b - 1u;
#pragma unroll
        for (int k = 0; k < W; ++k) y[k] |= f[k];
      }
    }
  }

  // v = (OR of follow[s] over s in v | gate ? follow[0] : 0) & m, the mask
  // row m in registers (the stream-fed kernels read it from the stream)
  __device__ __forceinline__ void fwd_row(uint32_t (&v)[W], bool gate,
                                          const uint32_t (&m)[W]) const {
    uint32_t y[W];
#pragma unroll
    for (int k = 0; k < W; ++k) y[k] = gate ? follow[k] : 0u;
    or_rows(y, v, follow);
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = y[k] & m[k];
  }

  // v = (OR of follow[s] over s in v | gate ? follow[0] : 0) & mask[sym]
  __device__ __forceinline__ void fwd(uint32_t (&v)[W], bool gate, int sym) const {
    uint32_t y[W];
#pragma unroll
    for (int k = 0; k < W; ++k) y[k] = gate ? follow[k] : 0u;
    or_rows(y, v, follow);
    const uint32_t* m = mask + sym * W;
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = y[k] & m[k];
  }

  // v = (OR of follow[s] over s in v | seed) & mask[sym]
  __device__ __forceinline__ void fwd_seed(uint32_t (&v)[W], const uint32_t (&seed)[W],
                                           int sym) const {
    uint32_t y[W];
#pragma unroll
    for (int k = 0; k < W; ++k) y[k] = seed[k];
    or_rows(y, v, follow);
    const uint32_t* m = mask + sym * W;
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = y[k] & m[k];
  }

  // r = OR of pred[u] over u in (r | acc) & m, the mask row m in registers
  __device__ __forceinline__ void rev_row(uint32_t (&r)[W], const uint32_t (&m)[W]) const {
    uint32_t x[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      x[k] = (r[k] | acc[k]) & m[k];
      r[k] = 0u;
    }
    or_rows(r, x, pred);
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
    or_rows(r, x, pred);
  }

  __device__ __forceinline__ bool accepts(const uint32_t (&v)[W]) const {
    uint32_t a = 0u;
#pragma unroll
    for (int k = 0; k < W; ++k) a |= v[k] & acc[k];
    return a != 0u;
  }
};

// a & row != 0 for a row of W words (in shared memory)
template <int W>
__device__ __forceinline__ bool meets(const uint32_t (&a)[W], const uint32_t* row) {
  uint32_t x = 0u;
#pragma unroll
  for (int k = 0; k < W; ++k) x |= a[k] & row[k];
  return x != 0u;
}

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

// Copies the tile's rows (P accept rows) into dynamic shared memory, then
// `n_extra` words of extra_g after them. Every thread of the block calls it
// (it ends in __syncthreads) before any thread returns. nfa.acc is the union
// of the accept rows.
template <int W>
__device__ __forceinline__ Nfa<W> load_nfa(uint32_t* smem, const uint32_t* __restrict__ tab_g,
                                           int S, int P = 1,
                                           const uint32_t* __restrict__ extra_g = nullptr,
                                           int n_extra = 0) {
  const int n = (2 * S + kSyms + P) * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = tab_g[i];
  for (int i = threadIdx.x; i < n_extra; i += blockDim.x) smem[n + i] = extra_g[i];
  __syncthreads();
  Nfa<W> nfa{smem, smem + S * W, smem + 2 * S * W, {}};
#pragma unroll
  for (int k = 0; k < W; ++k) nfa.acc[k] = 0u;
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int k = 0; k < W; ++k) nfa.acc[k] |= smem[(2 * S + kSyms + p) * W + k];
  }
  return nfa;
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

}  // namespace rrx
