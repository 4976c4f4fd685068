"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources under ``roaringregex_tpu_torch/csrc/`` are compiled at first
use into one shared library with a plain C interface: one nvcc per
``*.cu`` source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu

then one link, ``nvcc -gencode ... -shared -o librrx_kernels.so <objs>``.
The output lands in ``build/kernels/`` beside the package (or in
``$RRX_TORCH_BUILD_DIR``), keyed by a hash of the sources, the headers
they include (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged tree loads the library built before. A missing
nvcc or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ARCH_FLAGS + ("-shared",)
LIB_NAME = "librrx_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_HEAD = [
    _P, ctypes.c_longlong, _I, _P, _I,  # data, stride, L, lengths, R
    _P, _P, _I, ctypes.c_uint,  # tab, deltas, n_delta, acc
]
_NFA_HEAD = [
    _P, ctypes.c_longlong, _I, _P, _I,  # data, stride, L, lengths, R
    _P, _I,  # tab, s_tile
]
_COUNT_HEAD = [
    _P, ctypes.c_longlong, _I, _P, _I,  # data, stride, L, lengths, R
    _P, _I, _I, _I, _I,  # tab, k, n_br, m, n
]
_LONG_HEAD = [
    _P, ctypes.c_longlong, _I, _I, _I, _I, _I,  # data, n, nw, block, lead, T, rep
    _P, _I,  # tab, s_tile
]
_BB_HEAD = [
    _P, ctypes.c_longlong, _I, _P, _I,  # data, stride, L, lengths, R
    _P, _P, _I, _I, _P,  # tab, meta, W, n_rows, live
]
_SP_HEAD = [
    _P, ctypes.c_longlong, _I, _P, _I,  # data, stride, L, lengths, R
    _P, _I, _P, _I, _I, _I, _P, _P,  # tab, n_tab, meta, n_meta, W, global_tab, live, next
]
_BAND = [_P, _I, _P, _I]  # band, nd, offsets, lanes
_STREAM_HEAD = [_P, _I, _I, _P, _I]  # words [T][R][W], T, R, tab, s_tile
# words [T][R][W], T, R, tab, n_tab, meta, n_meta, W, global_tab, next
_SP_STREAM_HEAD = [_P, _I, _I, _P, _I, _P, _I, _I, _I, _P]
_STATS_TAIL = [_I, _I, _I, _P, _P, _P, _P]  # seeded, lead, nullable, cnt, first, last, full
# every entry point: its head, its own arguments, then the stream. The
# order of the first fifteen and of the four long-string kernels (17-20) is
# rrx_occupancy's kernel index (the P-channel forms have
# rrx_occupancy_channels).
ARGTYPES = {
    "rrx_swar_stats": _HEAD + _STATS_TAIL + [_P],
    "rrx_word_stats": _HEAD + [_I, _P] + _STATS_TAIL + [_P],  # P, accs, then stats
    "rrx_swar_reverse": _HEAD + [_P, _P],  # hits
    "rrx_swar_lazy_spans": _HEAD + [_P, _I, _P, _P, _P, _P],  # hits, cap, starts, ends, cnt
    "rrx_swar_anchor_end": _HEAD + [_P, _I, _P, _P],  # starts, longest, end
    "rrx_swar_greedy_spans": _HEAD + [_P, _I, _P, _P, _P, _P, _P],  # ... cnt, over
    "rrx_nfa_stats": _NFA_HEAD + [_I] + _STATS_TAIL + [_P],  # P, then stats
    "rrx_nfa_reverse": _NFA_HEAD + [_P, _P],  # hits
    "rrx_nfa_anchor_end": _NFA_HEAD + [_P, _I, _P, _P],  # starts, longest, end
    "rrx_nfa_lazy_spans": _NFA_HEAD + [_P, _I, _P, _P, _P, _P],  # hits, cap, starts, ends, cnt
    # hits, cap, nullable, starts, ends, cnt, over
    "rrx_nfa_greedy_spans": _NFA_HEAD + [_P, _I, _I, _P, _P, _P, _P, _P],
    "rrx_nfa_flags": _NFA_HEAD + [_I, _P, _P],  # seeded, flags
    "rrx_count_stats": _COUNT_HEAD + _STATS_TAIL + [_P],
    "rrx_count_flags": _COUNT_HEAD + [_I, _P, _P],  # seeded, flags
    "rrx_count_reverse": _COUNT_HEAD + [_P, _P],  # hits
    "rrx_nfa_reverse_mb": _NFA_HEAD + [_I, _P, _P, _P],  # P, span, hits
    # P, span, hits, cap, starts, ends, cnt, scratch
    "rrx_nfa_lazy_spans_mb": _NFA_HEAD + [_I, _P, _P, _I, _P, _P, _P, _P, _P],
    # one long string's windows: v0, gate, seeded, then each kernel's outputs
    "rrx_long_carry": _LONG_HEAD + [_P, _P, _I, _P, _P],  # vout
    "rrx_long_flags": _LONG_HEAD + [_P, _P, _I, _P, _P],  # flags
    "rrx_long_count": _LONG_HEAD + [_P, _P, _I, _P, _P, _P, _P],  # cnt, tail, vout
    "rrx_long_reverse": _LONG_HEAD + [_P, _P],  # hits
    # the bitband tier (scan_bitband.cu): its own rrx_bitband_occupancy index
    # C, seeded, nullable, cnt, first, last, full, then the spec's diagonal
    # offsets and triangle gaps (counts and host int arrays)
    "rrx_bitband_stats": _BB_HEAD + [_I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P],
    # C, seeded, words, then the spec's offsets and gaps as for stats
    "rrx_bitband_flags": _BB_HEAD + [_I, _I, _P, _I, _P, _I, _P, _P],
    # hits, next (the record counter), then the spec's offsets and gaps as
    # for stats
    "rrx_bitband_reverse": _BB_HEAD + [_P, _P, _I, _P, _I, _P, _P],
    "rrx_bitband_anchor_end": _BB_HEAD + [_P, _I, _P, _P],  # starts, longest, end
    # hits, cap, longest, starts, ends, cnt, over
    "rrx_bitband_spans": _BB_HEAD + [_P, _I, _I, _P, _P, _P, _P, _P],
    # the container tier (scan_sparse.cu): rrx_sparse_occupancy's index
    # walk, n_walk, walk_max, seeded, nullable, cnt, first, last, full
    "rrx_sparse_stats": _SP_HEAD + [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "rrx_sparse_flags": _SP_HEAD + [_P, _I, _I, _I, _P, _P],  # walk, n_walk, walk_max, seeded, words
    "rrx_sparse_reverse": _SP_HEAD + [_P, _I, _I, _P, _P],  # walk, n_walk, walk_max, hits
    # the dense multiblock tier (scan_nfa_wide.cu, tiles of 257..1024
    # states): scan_nfa.cu's arguments, then the record counter (next);
    # rrx_nfa_wide_occupancy's index is rrx_occupancy's (stats, reverse,
    # anchor end, lazy spans, greedy spans, flags)
    # P, stats, then the band table, its offsets and the lanes a record (the
    # band step), next; occupancy index 0 at the tile's lanes, 9 at 32
    "rrx_nfa_wide_stats": _NFA_HEAD + [_I] + _STATS_TAIL + _BAND + [_P, _P],
    # hits, then the band table, its offset count and the offsets (the band
    # step), next
    "rrx_nfa_wide_reverse": _NFA_HEAD + [_P, _P, _I, _P, _P, _P],
    "rrx_nfa_wide_anchor_end": _NFA_HEAD + [_P, _I, _P, _P, _P],  # starts, longest, end, next
    # hits, cap, starts, ends, cnt, next
    "rrx_nfa_wide_lazy_spans": _NFA_HEAD + [_P, _I, _P, _P, _P, _P, _P],
    # hits, cap, nullable, starts, ends, cnt, over, next
    "rrx_nfa_wide_greedy_spans": _NFA_HEAD + [_P, _I, _I, _P, _P, _P, _P, _P, _P],
    # seeded, flags, then the band table, its offsets and the lanes a record
    # (the band step), next; occupancy index 5 at the tile's lanes, 8 at 32
    "rrx_nfa_wide_flags": _NFA_HEAD + [_I, _P] + _BAND + [_P, _P],
    # the multi-channel span kernels at tiles of 257..1024 states: as
    # rrx_nfa_reverse_mb / rrx_nfa_lazy_spans_mb, then next; occupancy
    # indices 6 and 7 of rrx_nfa_wide_occupancy
    # P, span, hits, then the band table and its offsets (the band step), next
    "rrx_nfa_wide_reverse_mb": _NFA_HEAD + [_I, _P, _P] + _BAND[:3] + [_P, _P],
    # P, span, hits, cap, starts, ends, cnt, scratch, then the band table,
    # its offsets and the lanes a record (32), next
    "rrx_nfa_wide_lazy_spans_mb": _NFA_HEAD + [_I, _P, _P, _I, _P, _P, _P, _P] + _BAND
    + [_P, _P],
    # one long string's windows at tiles of 257..1024 states
    # (scan_long_wide.cu): the arguments of the rrx_long_* kernels, in
    # rrx_long_wide_occupancy's order
    "rrx_long_wide_carry": _LONG_HEAD + [_P, _P, _I, _P, _P],  # vout
    # flags, count and reverse (the band step) then take the band table, the
    # number of its offsets, the offsets (a host int array) and the lanes a
    # window
    "rrx_long_wide_flags": _LONG_HEAD + [_P, _P, _I, _P] + _BAND + [_P],  # flags
    # cnt, tail, vout
    "rrx_long_wide_count": _LONG_HEAD + [_P, _P, _I, _P, _P, _P] + _BAND + [_P],
    "rrx_long_wide_reverse": _LONG_HEAD + [_P] + _BAND + [_P],  # hits
    # the stream-fed kernels (scan_stream.cu): the mask stream's head, each
    # kernel's arguments, then the record counter of the warp form (next);
    # rrx_stream_occupancy's index is this order
    # lengths, P, seeded, nullable, cnt, first, last, next
    "rrx_stream_stats": _STREAM_HEAD + [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    "rrx_stream_flags": _STREAM_HEAD + [_I, _P, _P, _P],  # seeded, flags, next
    "rrx_stream_reverse": _STREAM_HEAD + [_P, _P, _P],  # hits, next
    # lengths, starts, longest, end, next
    "rrx_stream_first_end": _STREAM_HEAD + [_P, _P, _I, _P, _P, _P],
    # the slotted multi-pattern SWAR scan (scan_bits.cu): P slots, their
    # accept masks [P], seeded, cnt, first, last, full
    "rrx_swar_multi_stats": _HEAD + [_I, _P, _I, _P, _P, _P, _P, _P],
    # the stream-fed container kernels (scan_sparse.cu): words [T][R][W], T,
    # then the container head without the rows (R, tab, n_tab, meta, n_meta,
    # W, global_tab, next), each kernel's arguments and the stream
    # lengths, seeded, nullable, cnt, first
    "rrx_sparse_stream_stats": _SP_STREAM_HEAD + [_P, _I, _I, _P, _P, _P],
    "rrx_sparse_stream_flags": _SP_STREAM_HEAD + [_I, _P, _P],  # seeded, flags
    "rrx_sparse_stream_reverse": _SP_STREAM_HEAD + [_P, _P],  # hits
}
KERNELS = tuple(ARGTYPES)


def _build_dir() -> Path:
    env = os.environ.get("RRX_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "roaringregex_tpu_torch are built from source at first use"
    )


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


class BuildInfo:
    """What the last build did: library path, seconds, nvcc's -Xptxas -v
    report (registers, shared memory and spills per kernel)."""

    path: str = ""
    seconds: float = 0.0
    built: bool = False
    ptxas: str = ""


BUILD = BuildInfo()


def build() -> Path:
    """Compile the sources unless a library for their hash exists; return
    the library's path."""
    out_dir = _build_dir() / source_hash()
    lib = out_dir / LIB_NAME
    BUILD.path = str(lib)
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        srcs = _sources()
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in cmds]
        outs = [p.communicate() for p in procs]  # every compile runs to its end
        built = os.path.join(tmp, LIB_NAME)
        link = [nvcc, *LINK_FLAGS, "-o", built, *objs]
        for cmd, p, (out, err) in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        BUILD.seconds = time.perf_counter() - t0
        BUILD.ptxas = "".join(err for _, err in outs)
        BUILD.built = True
        os.replace(built, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.rrx_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.rrx_occupancy.restype = _I
    lib.rrx_occupancy_channels.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.rrx_occupancy_channels.restype = _I
    lib.rrx_bitband_occupancy.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.rrx_bitband_occupancy.restype = _I
    lib.rrx_sparse_occupancy.argtypes = [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.rrx_sparse_occupancy.restype = _I
    lib.rrx_sparse_threads_per_block.argtypes = []
    lib.rrx_sparse_threads_per_block.restype = _I
    lib.rrx_bitband_threads_per_block.argtypes = []
    lib.rrx_bitband_threads_per_block.restype = _I
    lib.rrx_nfa_wide_occupancy.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.rrx_nfa_wide_occupancy.restype = _I
    lib.rrx_long_wide_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.rrx_long_wide_occupancy.restype = _I
    lib.rrx_stream_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rrx_stream_occupancy.restype = _I
    lib.rrx_nfa_wide_threads_per_block.argtypes = []
    lib.rrx_nfa_wide_threads_per_block.restype = _I
    lib.rrx_threads_per_block.argtypes = []
    lib.rrx_threads_per_block.restype = _I
    lib.rrx_error_string.argtypes = [_I]
    lib.rrx_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().rrx_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
