// The window geometry of one long string, shared by scan_long.cu (one
// thread per window, tiles of up to 256 states) and scan_long_wide.cu (one
// warp per window, tiles of 257..1024 states): the string data[0, n) read in
// place; global step 0 = BOS, i + 1 = byte i, n + 1 = EOS, dead outside;
// window w's local step t is global step (w / rep) * block + t - lead.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_core.cuh"
#include "scan_nfa.cuh"

namespace rrx {

// One window's view of the global stream.
struct Window {
  const uint8_t* data;
  long long n;
  long long base;  // global byte index of local step 0 (byte of step t: base + t)
  int T;
  int t_bos;       // local step of BOS (-1 before the window, T after it)
  int t_eos;       // local step of EOS, clamped to [-2, T + 2]
  int t_seed_end;  // unseeded: the seed fires at local steps < t_seed_end (g < 2)
  uint4 q;         // the 16-byte chunk that holds the last byte read
  long long qc;    // its chunk index, -1 before the first read

  __device__ __forceinline__ int byte(long long i) {
    const long long c = i >> 4;
    if (c != qc) {
      qc = c;
      if (16 * c + 16 <= n) {
        q = __ldg(reinterpret_cast<const uint4*>(data) + c);
      } else {  // the string's last, partial chunk: only bytes < n exist
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
        for (int k = 0; k < 16 && 16 * c + k < n; ++k) {
          wd[k >> 2] |= static_cast<uint32_t>(__ldg(data + 16 * c + k)) << (8 * (k & 3));
        }
        q = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
    return byte_at(q, static_cast<int>(i & 15));
  }

  // The symbol of local step t.
  __device__ __forceinline__ int sym(int t) {
    if (t < t_bos) return kDead;
    if (t == t_bos) return kBos;
    if (t < t_eos) return byte(base + t);
    return t == t_eos ? kEos : kDead;
  }
};

__device__ __forceinline__ int clamp_ll(long long x, int lo, int hi) {
  return static_cast<int>(x < lo ? lo : (x > hi ? hi : x));
}

__device__ __forceinline__ Window window(const uint8_t* data, long long n, int block, int lead,
                                         int T, int rep, int w) {
  const long long g0 = static_cast<long long>(w / rep) * block - lead;  // global step of t = 0
  Window win;
  win.data = data;
  win.n = n;
  win.base = g0 - 1;
  win.T = T;
  win.t_bos = clamp_ll(-g0, -1, T);
  win.t_eos = clamp_ll(n + 1 - g0, -2, T + 2);
  win.t_seed_end = clamp_ll(2 - g0, 0, T);
  win.q = make_uint4(0u, 0u, 0u, 0u);
  win.qc = -1;
  return win;
}

inline int check_long(const void* data, long long n, int nw, int block, int lead, int T, int rep) {
  if (n < 0 || nw < 0 || block < 32 || block % 32 != 0 || lead < 0 || T < 0 || rep < 1 ||
      (reinterpret_cast<uintptr_t>(data) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace rrx
