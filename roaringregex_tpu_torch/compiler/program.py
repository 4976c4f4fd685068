"""Compiled program: the tiered, alphabet-compressed NFA tables.

The port's counterpart of ``roaringregex_tpu/compiler/program.py``. The
tables (follow matrix ``F``, per-class state masks ``Bc``, ``accept``, the
byte -> class map) are the program's parameters: the scan tiers build
their kernel tables from them on the host. Tier selection and padding
(``tier``, ``s_tile``, ``G``) are kept identical to the JAX package so
that the same pattern takes the same route in both. The multiblock and
sparse tiers also carry the block-sparse follow layout (``fblocks``,
``fblock_rows``, ``fblock_cols``: the follow matrix as its nonzero 128 x
128 blocks) and its container split ``sparse_partition``, which the
engine's multiblock routing rule reads (``_multiblock_container_wins``)
and the container tier's tables are built from
(``ops/scan_sparse.device_sparse_tables``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .nfa import NFA, build_nfa
from .parser import BOS, EOS, NSYM

BLOCK = 128

# smallest tile that holds every state of a record (the JAX package's
# lane-packing tiles; kept so tier routing matches)
TILES = (8, 16, 32, 64, 128, 256, 384, 512, 640, 768, 896, 1024)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class DeviceProgram:
    """Host-side numpy tables of one compiled pattern."""

    nfa: NFA
    tier: str
    s_pad: int
    n_classes: int
    c_pad: int
    class_of_sym: np.ndarray  # [NSYM + 1] int32; index NSYM = dead symbol
    byte_class: np.ndarray  # [256] int32
    F: Optional[np.ndarray]  # [s_pad, s_pad] uint8; None on the sparse tier
    Bc: np.ndarray  # [c_pad, s_pad] uint8
    accept: np.ndarray  # [s_pad] uint8
    # block-sparse follow layout (multiblock and sparse tiers; None else)
    fblocks: Optional[np.ndarray] = field(default=None)  # [nnz, BLOCK, BLOCK] uint8
    fblock_rows: Optional[np.ndarray] = field(default=None)  # [nnz] int32
    fblock_cols: Optional[np.ndarray] = field(default=None)  # [nnz] int32
    s_tile: int = 0
    lanes: int = 0
    G: int = 0

    @property
    def Bc_words(self) -> np.ndarray:
        """[c_pad, W_tile] uint32: per-class symbol mask of one tile,
        bit-packed in state order (W_tile = ceil(s_tile/32), min 1)."""
        if getattr(self, "_Bc_words", None) is None:
            wt = max(1, self.s_tile // 32)
            out = np.zeros((self.c_pad, wt), dtype=np.uint64)
            Bt = self.Bc[:, : self.s_tile]
            for k in range(self.c_pad):
                for s in np.nonzero(Bt[k])[0]:
                    out[k, s // 32] |= np.uint64(1) << np.uint64(s % 32)
            self._Bc_words = out.astype(np.uint32)
        return self._Bc_words

    @property
    def seed_row(self) -> np.ndarray:
        """[lanes] uint8: 1 at each record's initial-state lane (g * s_tile)."""
        if getattr(self, "_seed", None) is None:
            s = np.zeros(self.lanes, dtype=np.uint8)
            s[:: self.s_tile] = 1
            self._seed = s
        return self._seed

    @property
    def sparse_partition(self):
        """Container split of the block-sparse follow matrix: (pblocks [np,
        128, 128] uint8, prow [np], pcol [np], U [nb, nb] uint8). All-ones
        blocks go into the map ``U``; the partial blocks stay explicit (one
        zero block when there is none)."""
        if getattr(self, "_spart", None) is None:
            nb = self.s_pad // BLOCK
            full = self.fblocks.reshape(len(self.fblocks), -1).all(axis=1)
            U = np.zeros((nb, nb), dtype=np.uint8)
            U[self.fblock_rows[full], self.fblock_cols[full]] = 1
            keep = ~full
            pblocks = self.fblocks[keep]
            prow = self.fblock_rows[keep]
            pcol = self.fblock_cols[keep]
            if len(pblocks) == 0:
                pblocks = np.zeros((1, BLOCK, BLOCK), np.uint8)
                prow = np.zeros(1, np.int32)
                pcol = np.zeros(1, np.int32)
            self._spart = (pblocks, prow, pcol, U)
        return self._spart

    @property
    def pattern(self) -> str:
        return self.nfa.pattern

    @property
    def uses_anchor(self) -> bool:
        """True iff some position is labeled ``^`` or ``$``. Anchor-free
        programs are inert to BOS/EOS steps injected at any offset, which
        the overlapped-window scan relies on."""
        B = self.nfa.symtab
        return bool(B[BOS].any() or B[EOS].any())

    @property
    def horizon(self) -> Optional[int]:
        """Longest path length in the follow graph, or None if cyclic: when
        finite, every match spans at most ``horizon`` bytes."""
        if getattr(self, "_horizon", None) is None:
            S = self.n_states
            fm = self.nfa.follow_matrix
            adj = [np.nonzero(fm[s][:S])[0] for s in range(S)]
            color = np.zeros(S, np.int8)  # 0 new, 1 on stack, 2 done
            depth = np.zeros(S, np.int64)
            cyclic = False
            for root in range(S):
                if color[root]:
                    continue
                stack = [(root, 0)]
                while stack:
                    u, it = stack[-1]
                    if it == 0:
                        color[u] = 1
                    nxt = adj[u]
                    if it < len(nxt):
                        stack[-1] = (u, it + 1)
                        v = int(nxt[it])
                        if color[v] == 1:
                            cyclic = True
                            stack.clear()
                            break
                        if color[v] == 0:
                            stack.append((v, 0))
                        else:
                            depth[u] = max(depth[u], depth[v] + 1)
                    else:
                        color[u] = 2
                        stack.pop()
                        if stack:
                            p = stack[-1][0]
                            depth[p] = max(depth[p], depth[u] + 1)
                if cyclic:
                    break
            self._horizon = -1 if cyclic else int(depth.max(initial=0))
        return None if self._horizon < 0 else self._horizon

    @property
    def n_states(self) -> int:
        return self.nfa.n_states

    @property
    def nullable(self) -> bool:
        return self.nfa.nullable

    @property
    def bos_class(self) -> int:
        return int(self.class_of_sym[BOS])

    @property
    def eos_class(self) -> int:
        return int(self.class_of_sym[EOS])

    @property
    def byte_runs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Maximal constant runs of the byte -> class map with a nonzero
        class: (lo[R], hi[R], cls[R]) int32. Class 0 is the dead class."""
        if getattr(self, "_runs", None) is None:
            bc = self.byte_class
            lo, hi, cl = [], [], []
            r = 0
            while r < 256:
                c = bc[r]
                e = r
                while e + 1 < 256 and bc[e + 1] == c:
                    e += 1
                if c != 0:
                    lo.append(r)
                    hi.append(e)
                    cl.append(int(c))
                r = e + 1
            self._runs = (
                np.asarray(lo, np.int32),
                np.asarray(hi, np.int32),
                np.asarray(cl, np.int32),
            )
        return self._runs


def compile_program(pattern_or_nfa) -> DeviceProgram:
    nfa = (
        pattern_or_nfa
        if isinstance(pattern_or_nfa, NFA)
        else build_nfa(pattern_or_nfa)
    )
    S = nfa.n_states

    from ..utils.config import get_config

    dense_max = min(get_config().dense_max, max(TILES))
    if S <= BLOCK:
        tier, s_pad = "dense128", BLOCK
    elif S <= 2 * BLOCK:
        tier, s_pad = "dense256", 2 * BLOCK
    elif S <= dense_max:
        tier, s_pad = "multiblock", _round_up(S, BLOCK)
    else:
        tier, s_pad = "sparse", _round_up(S, BLOCK)

    if tier == "sparse":
        s_tile, lanes, G = s_pad, s_pad, 1
    else:
        s_tile = next(t for t in TILES if S <= t)
        lanes = max(s_pad, BLOCK)
        G = lanes // s_tile

    # alphabet equivalence classes: symbols with identical state-mask rows
    # share a class; class 0 is the all-zero (dead) row
    B = nfa.symtab  # [NSYM, S] uint8
    rows: Dict[bytes, int] = {}
    class_of_sym = np.zeros(NSYM + 1, dtype=np.int32)
    class_rows: List[np.ndarray] = []

    def _class_id(row: np.ndarray) -> int:
        key = row.tobytes()
        if key not in rows:
            rows[key] = len(class_rows)
            class_rows.append(row)
        return rows[key]

    _class_id(np.zeros(S, dtype=np.uint8))
    for sym in range(NSYM):
        class_of_sym[sym] = _class_id(B[sym])
    class_of_sym[NSYM] = 0

    n_classes = len(class_rows)
    c_pad = max(32, _round_up(n_classes, 32))

    byte_class = np.zeros(256, dtype=np.int32)
    byte_class[:128] = class_of_sym[:128]  # bytes >= 0x80 stay dead

    Bc = np.zeros((c_pad, s_pad), dtype=np.uint8)
    for k, row in enumerate(class_rows):
        Bc[k, :S] = row
    accept = np.zeros(s_pad, dtype=np.uint8)
    accept[:S] = nfa.accept_vec

    F = None
    fblocks = fb_rows = fb_cols = None
    if tier != "sparse":
        F = np.zeros((s_pad, s_pad), dtype=np.uint8)
        F[:S, :S] = nfa.follow_matrix
    if tier in ("sparse", "multiblock"):
        fblocks, fb_rows, fb_cols = _block_sparse_follow(nfa, s_pad)

    return DeviceProgram(
        nfa=nfa,
        tier=tier,
        s_pad=s_pad,
        n_classes=n_classes,
        c_pad=c_pad,
        class_of_sym=class_of_sym,
        byte_class=byte_class,
        F=F,
        Bc=Bc,
        accept=accept,
        fblocks=fblocks,
        fblock_rows=fb_rows,
        fblock_cols=fb_cols,
        s_tile=s_tile,
        lanes=lanes,
        G=G,
    )


def _block_sparse_follow(nfa: NFA, s_pad: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The follow matrix as its nonzero BLOCK x BLOCK blocks (fblocks [nnz,
    BLOCK, BLOCK] uint8, rows [nnz], cols [nnz] int32, in block-row-major
    order), built from the edge list without the dense S x S matrix; one
    zero block for a program without edges."""
    nb = s_pad // BLOCK
    e = nfa.get_edges()
    if len(e) == 0:
        return (
            np.zeros((1, BLOCK, BLOCK), np.uint8),
            np.zeros(1, np.int32),
            np.zeros(1, np.int32),
        )
    key = (e[:, 0] // BLOCK).astype(np.int64) * nb + e[:, 1] // BLOCK
    order = np.argsort(key, kind="stable")
    es, ks = e[order], key[order]
    uniq, starts = np.unique(ks, return_index=True)
    bounds = np.append(starts, len(es))
    fblocks = np.zeros((len(uniq), BLOCK, BLOCK), dtype=np.uint8)
    for n in range(len(uniq)):
        sub = es[bounds[n] : bounds[n + 1]]
        fblocks[n, sub[:, 0] % BLOCK, sub[:, 1] % BLOCK] = 1
    return fblocks, (uniq // nb).astype(np.int32), (uniq % nb).astype(np.int32)


def from_reference(obj) -> DeviceProgram:
    """The port's DeviceProgram built from any object that carries the
    JAX package's ``DeviceProgram`` fields (numpy tables plus an ``nfa``
    with ``pattern``, ``n_states``, ``labels``, ``get_edges()``,
    ``accept_set`` and ``nullable``). Duck-typed: imports nothing of the
    JAX package, and copies every array so the two never share memory."""
    ref = obj.nfa
    nfa = NFA(
        pattern=str(ref.pattern),
        n_states=int(ref.n_states),
        labels=[frozenset(int(c) for c in lab) for lab in ref.labels],
        edges=np.array(ref.get_edges(), dtype=np.int32).reshape(-1, 2),
        accept_set={int(p) for p in ref.accept_set},
        nullable=bool(ref.nullable),
    )

    def arr(x, dtype):
        return None if x is None else np.array(x, dtype=dtype)

    return DeviceProgram(
        nfa=nfa,
        tier=str(obj.tier),
        s_pad=int(obj.s_pad),
        n_classes=int(obj.n_classes),
        c_pad=int(obj.c_pad),
        class_of_sym=arr(obj.class_of_sym, np.int32),
        byte_class=arr(obj.byte_class, np.int32),
        F=arr(obj.F, np.uint8),
        Bc=arr(obj.Bc, np.uint8),
        accept=arr(obj.accept, np.uint8),
        fblocks=arr(getattr(obj, "fblocks", None), np.uint8),
        fblock_rows=arr(getattr(obj, "fblock_rows", None), np.int32),
        fblock_cols=arr(getattr(obj, "fblock_cols", None), np.int32),
        s_tile=int(obj.s_tile),
        lanes=int(obj.lanes),
        G=int(obj.G),
    )
