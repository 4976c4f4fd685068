"""Container tier: the block-sparse ("roaring container") scan of multiblock
and sparse programs whose follow matrix does not decompose into bitband
diagonals.

The port of ``roaringregex_tpu/ops/scan_pallas.py``'s ``SparseScanner``
(``scan_pallas.py:775-845``): its byte path (``_add_sparse_byte_path``
:3125-3289) and its stream-fed methods (``_match_call`` :849,
``_flags_call`` :900, ``_reverse_call`` :941: ``match_stats``,
``forward_flags`` and ``reverse_hits`` over a mask stream, which the JAX
``BitbandScanner`` inherits; here :class:`StreamMethods`). The follow matrix F of ``lanes`` states (a multiple of 128) is
split into 128 x 128 blocks by ``prog.sparse_partition``: the all-ones
blocks go into the map U [nb, nb] (nb = lanes / 128), the other nonzero
blocks stay explicit as partial blocks ``pb`` [np, 128, 128] at (prow,
pcol). One forward step of a record's state set v is

    y = Fᵀ·(v | seed);   v = y & mask(sym)

with, per output (column) block c, y_c = OR over the partial blocks k of
column c of ``pb[k]ᵀ·v_prow[k]``, and all of y_c set when some U[r, c]
has a live state in row block r. The reverse (candidate-start) step masks,
then expands through F untransposed: ``R = F·((R | acc) & mask(sym))``,
hit = state 0 in R. ``sym`` is BOS at step 0, byte t - 1 at step t, EOS at
step len + 1; steps past EOS are dead; bytes in no run of the byte ->
class map (bytes >= 0x80) have a zero mask. Unseeded scans inject the seed
(state 0) at steps 0 and 1, seeded scans at every step.

The TPU's layouts (the [lanes, B] bf16 state, the batched ``dot_general``
over the partial blocks, ``cls_spec``'s mask-by-matmul for stats and
``byte_spec``'s bit masks for flags and reverse, the (T_chunk, B_blk)
grid) are a layout of this function and have no counterpart here: one mask
table serves all three kernels, and the parity boundary is the scanner
methods' outputs. The CUDA kernels (``csrc/scan_sparse.cu``) run one warp
per record: ``rrx_sparse_stats``, ``_flags`` and ``_reverse`` with the
state in registers, walking the live states of sparse source blocks
through per-state row lists (:func:`_walk`; the reverse over F transposed,
with the accept set's expansion ORed in from one precomputed row per mask
row), the stream-fed ones with the state in shared memory; the plain
PyTorch versions
here step [R, lanes] bool planes through the blocks of
``sparse_partition`` (0/1 float32 products, exact: every sum is at most
128). The stream-fed kernels (``rrx_sparse_stream_stats``, ``_flags``,
``_reverse``) run the same step with the mask of step t read from the
record's row of the mask stream (``scan_packed.mask_stream_from_bytes``,
[T, B, W] int32, W = lanes / 32) instead of the symbol's row, over every
step of the stream, with one accept set: a scanner with accept channels
raises in all three (the JAX kernels read one accept row, channel 0's).
Each wrapper runs its plain version for a CPU tensor only and launches its
kernel (counted in ``.launches``) for a CUDA tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..compiler.program import BLOCK, DeviceProgram
from . import scan_bits as sb
from .scan_bitband import flags_plain as _channel_flags
from .scan_bitband import stats_plain as _channel_stats
from .scan_pallas import _Scanner, _with_flag0

MAX_LANES = 4096  # 32 blocks: the kernels' out_ptr row
# the kernels' fixed geometry (csrc/scan_sparse.cu): records per block, and
# the shared memory a block may use
WARPS = 16
SMEM_LIMIT = 232448
# rrx_sparse_stats, _flags and _reverse walk a source block state by state
# when it holds at most this many live states, else run the block-parallel
# form (csrc/scan_sparse.cu, walk_live; chip_smoke.py phase 7's sweeps)
WALK_MAX = 4
# meta: [nb, n_part, n_ent, n_mask, C, W, n_acc, 0 | 259 symbol rows | nb +
# 1 entry offsets per output block | (source block, partial block or -1 for
# a full one) per entry], padded to a multiple of 4 words
META_SYMS = 8
META_PTR = META_SYMS + sb.N_SYMS
META_ENT = META_PTR + MAX_LANES // BLOCK + 1


class SparseTables(NamedTuple):
    """One program's container tables, on the device for the kernels and
    as numpy for the plain versions.

    ``tab_f`` / ``tab_r`` [n_part * 512 + (n_mask + n_acc) * W] int32
    (uint32 bit patterns): the partial blocks as 128 rows of 4 words each
    (forward: row i of block k = the targets of source i, ``pb[k][i]``;
    reverse: row j = the sources of target j, ``pb[k][:, j]``), then the
    mask rows (BOS, EOS, one per byte run), then the accept rows (forward:
    the channels' union, then the C channels; reverse: the program's accept
    set). ``meta_f`` / ``meta_r``: the header, the symbol -> mask row map
    and, per output block, its entries (source block, partial block or -1
    for a full U block), the full ones first. ``walk_f``: the forward
    walk tables of ``rrx_sparse_stats`` and ``_flags``; ``walk_r``: the
    reverse walk tables of ``rrx_sparse_reverse``, over F transposed, whose
    head is one row per mask row, E[row] = F·(acc & mask[row])
    (:func:`_walk`).
    ``part`` is ``prog.sparse_partition`` and ``masks`` / ``accs`` /
    ``acc`` the rows as bool planes: the plain versions expand from
    those."""

    tab_f: torch.Tensor
    tab_r: torch.Tensor
    meta_f: torch.Tensor
    meta_r: torch.Tensor
    walk_f: torch.Tensor
    walk_r: torch.Tensor
    W: int
    C: int
    part: tuple
    sym_row: np.ndarray  # [N_SYMS] int64, -1 = no mask row (a zero mask)
    masks: np.ndarray  # [n_mask, lanes] bool
    accs: np.ndarray  # [C, lanes] bool
    acc: np.ndarray  # [lanes] bool, the program's accept set

    def plain(self, dev) -> "_Plain":
        """The stepper of the plain versions on ``dev``."""
        return _Plain.of(self, dev)


def _pack_rows(bits: np.ndarray) -> np.ndarray:
    """[..., n] 0/1 (n a multiple of 32) -> [..., n / 32] uint32, bit s %
    32 of word s // 32."""
    b = np.packbits(np.asarray(bits, np.uint8), axis=-1, bitorder="little")
    return np.ascontiguousarray(b).view("<u4").astype(np.uint32)


def _meta(nb: int, part_src, part_out, U_src_out, sym_row, n_mask: int, C: int,
          n_acc: int, W: int) -> np.ndarray:
    """The meta header and entry lists of one direction: ``part_src`` /
    ``part_out`` [np] the source and output block of each partial block,
    ``U_src_out`` [nb, nb] the full-block map indexed (source, output)."""
    ents = []
    ptr = [0]
    for o in range(nb):
        ents += [(int(s), -1) for s in np.nonzero(U_src_out[:, o])[0]]
        ents += [(int(part_src[k]), k) for k in np.nonzero(part_out == o)[0]]
        ptr.append(len(ents))
    meta = np.zeros(-(-(META_ENT + 2 * len(ents)) // 4) * 4, np.int32)
    meta[:7] = (nb, len(part_src), len(ents), n_mask, C, W, n_acc)
    meta[META_SYMS:META_PTR] = sym_row
    meta[META_PTR : META_PTR + nb + 1] = ptr
    meta[META_ENT : META_ENT + 2 * len(ents)] = np.asarray(ents, np.int32).reshape(-1)
    return meta


def _expand_np(x: np.ndarray, pbits: np.ndarray, prow, pcol, Ub: np.ndarray) -> np.ndarray:
    """[n, lanes] bool: each row of ``x`` expanded through a partition
    (partial block k from source block prow[k] to output block pcol[k],
    ``pbits[k]`` indexed (source, output); the full blocks ``Ub`` indexed
    (source, output)): the forward step's expansion of the partition of F,
    the reverse step's of F transposed."""
    n, lanes = x.shape
    xb = x.reshape(n, lanes // BLOCK, BLOCK)
    y = np.zeros_like(xb)
    for k in range(len(prow)):
        y[:, pcol[k]] |= (xb[:, prow[k]].astype(np.int64) @ pbits[k].astype(np.int64)) > 0
    y |= ((xb.any(axis=2).astype(np.int64) @ Ub.astype(np.int64)) > 0)[:, :, None]
    return y.reshape(n, lanes)


def _walk(nb: int, W: int, pbits: np.ndarray, prow, pcol, Ub: np.ndarray,
          masks: np.ndarray, head: np.ndarray) -> np.ndarray:
    """The walk tables of one direction (``csrc/scan_sparse.cu``, Sp), over
    a partition given as :func:`_expand_np` takes it (the reverse tables:
    F transposed, ``pbits.transpose(0, 2, 1)`` with ``prow`` and ``pcol``
    swapped and ``Ub.T``), uint32, padded to a multiple of 4 words: the
    ``head`` rows ([n_head, lanes] bool: the forward seed row, the
    expansion of {state 0}; the reverse E rows, one per mask row) as W
    words each; per source block s the bit mask of the output blocks that
    U sets whole; per mask row the bit mask of its nonzero output blocks;
    per source block its partial blocks (k << 5 | output block), by
    offsets; per state its nonzero partial rows ((k * 128 + row) << 5 |
    output block), by offsets."""
    lanes = 32 * W
    bits = np.int64(1) << np.arange(nb, dtype=np.int64)  # bit o of a block mask
    full = Ub.astype(np.int64) @ bits
    mblk = masks.reshape(len(masks), nb, BLOCK).any(axis=2).astype(np.int64) @ bits
    by_src = np.argsort(prow, kind="stable")
    sptr = np.concatenate([[0], np.cumsum(np.bincount(prow, minlength=nb))])
    sent = (by_src << 5) | pcol[by_src]
    ks, rows = np.nonzero(pbits.any(axis=2))  # the nonzero partial rows
    st = BLOCK * prow[ks] + rows  # their source states
    by_st = np.argsort(st, kind="stable")
    ptr = np.concatenate([[0], np.cumsum(np.bincount(st, minlength=lanes))])
    rent = (((BLOCK * ks + rows) << 5) | pcol[ks])[by_st]
    walk = np.concatenate([_pack_rows(head).reshape(-1).astype(np.int64), full, mblk, sptr, sent,
                           ptr, rent])
    return np.pad(walk, (0, -len(walk) % 4)).astype(np.uint32)


def device_sparse_tables(prog: DeviceProgram, device, accept_map=None) -> SparseTables:
    """The container tables of ``prog`` on ``device``, with the accept
    channels of ``accept_map`` ([lanes, C] 0/1) or the program's accept set
    (C = 1)."""
    lanes = prog.s_pad
    if prog.fblocks is None or lanes % BLOCK or lanes > MAX_LANES:
        raise ValueError(f"{prog.pattern!r}: tier {prog.tier}, {lanes} lanes: the container "
                         f"kernels take multiblock and sparse programs of at most {MAX_LANES}")
    nb, W = lanes // BLOCK, lanes // 32
    pb, prow, pcol, U = prog.sparse_partition
    prow, pcol = np.asarray(prow, np.int64), np.asarray(pcol, np.int64)
    Bw = np.asarray(prog.Bc_words, np.uint32)  # [c_pad, W]
    lo, hi, cl = prog.byte_runs
    mask_w = np.concatenate([Bw[[prog.bos_class, prog.eos_class]], Bw[np.asarray(cl, np.int64)]])
    sym_row = np.full(sb.N_SYMS, -1, np.int64)
    for i, (a, b) in enumerate(zip(lo, hi)):
        sym_row[int(a) : int(b) + 1] = 2 + i
    sym_row[sb.SYM_BOS], sym_row[sb.SYM_EOS] = 0, 1
    acc = np.asarray(prog.accept[:lanes]) != 0
    accs = (np.asarray(accept_map).T != 0) if accept_map is not None else acc[None, :]
    C = accs.shape[0]
    if C < 1:
        raise ValueError("an accept map of 0 channels")
    pbits = np.asarray(pb) != 0
    acc_rows = np.concatenate([accs.any(axis=0)[None], accs])  # the union, then the channels
    tab_f = np.concatenate([_pack_rows(pbits).reshape(-1), mask_w.reshape(-1),
                            _pack_rows(acc_rows).reshape(-1)])
    tab_r = np.concatenate([_pack_rows(pbits.transpose(0, 2, 1)).reshape(-1), mask_w.reshape(-1),
                            _pack_rows(acc[None]).reshape(-1)])
    Ub = np.asarray(U) != 0
    n_mask = len(mask_w)
    meta_f = _meta(nb, prow, pcol, Ub, sym_row, n_mask, C, 1 + C, W)
    meta_r = _meta(nb, pcol, prow, Ub.T, sym_row, n_mask, 1, 1, W)

    def dev_i32(a):
        a = np.ascontiguousarray(a).astype(np.uint32)
        return torch.from_numpy(a.view(np.int32)).to(device)

    masks = np.unpackbits(mask_w.view(np.uint8), axis=1, bitorder="little").astype(bool)
    state0 = np.zeros((1, lanes), bool)
    state0[0, 0] = True
    walk_f = _walk(nb, W, pbits, prow, pcol, Ub, masks, _expand_np(state0, pbits, prow, pcol, Ub))
    # the reverse step R' = F·(R & mask) | E[row]: F·((R | acc) & mask),
    # since the expansion distributes over OR
    rev = (pbits.transpose(0, 2, 1), pcol, prow, Ub.T)
    walk_r = _walk(nb, W, *rev, masks, _expand_np(acc[None] & masks, *rev))
    return SparseTables(dev_i32(tab_f), dev_i32(tab_r), dev_i32(meta_f), dev_i32(meta_r),
                        dev_i32(walk_f), dev_i32(walk_r), W, C, (pbits, prow, pcol, Ub), sym_row,
                        masks, accs, acc)


# ---------------------------------------------------------------------------
# Plain PyTorch versions ([R, lanes] bool planes)
# ---------------------------------------------------------------------------


class _Plain(NamedTuple):
    """The plain versions' stepper: the partial blocks as float32 [np,
    128, 128] at (prow, pcol), U [nb, nb] float32, the symbol masks M
    [N_SYMS, lanes] bool (dead rows zero), the channels' accept rows accs
    [C, lanes] and the program's accept set acc [lanes]."""

    pb: torch.Tensor
    prow: torch.Tensor
    pcol: torch.Tensor
    U: torch.Tensor
    M: torch.Tensor
    accs: torch.Tensor
    acc: torch.Tensor

    @classmethod
    def of(cls, tables: SparseTables, dev) -> "_Plain":
        pb, prow, pcol, U = tables.part
        lanes = tables.masks.shape[1]
        M = np.zeros((sb.N_SYMS, lanes), bool)
        has = tables.sym_row >= 0
        M[has] = tables.masks[tables.sym_row[has]]
        t = lambda x, dt: torch.from_numpy(np.asarray(x)).to(dev, dt)  # noqa: E731
        return cls(t(pb, torch.float32), t(prow, torch.int64), t(pcol, torch.int64),
                   t(U, torch.float32), t(M, torch.bool), t(tables.accs, torch.bool),
                   t(tables.acc, torch.bool))

    def _expand(self, v: torch.Tensor, rev: bool) -> torch.Tensor:
        """y = Fᵀ·v (rev: F·v) through the containers: each partial block's
        product from its source block, ORed into its output block, and every
        output block of a full block whose source block has a live state."""
        R, lanes = v.shape
        nb = lanes // BLOCK
        vb = v.reshape(R, nb, BLOCK).to(torch.float32)
        src, out = (self.pcol, self.prow) if rev else (self.prow, self.pcol)
        prod = "rnj,nij->rni" if rev else "rni,nij->rnj"
        part = (torch.einsum(prod, vb[:, src], self.pb) > 0).to(torch.float32)
        y = torch.zeros_like(vb).index_add_(1, out, part) > 0
        live = vb.amax(dim=2)  # [R, nb]: a block has a live state
        full = (live @ (self.U.T if rev else self.U)) > 0
        return (y | full[:, :, None]).reshape(R, lanes)

    # the stepper of the channel loops (scan_bitband) and scan_bits' reverse
    def empty(self, R: int, dev) -> torch.Tensor:
        return torch.zeros((R, self.M.shape[1]), dtype=torch.bool, device=dev)

    def step(self, v: torch.Tensor, gate: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """v' = Fᵀ·(v | gate · seed) & mask[sym] (the seed is state 0)."""
        return self.step_mask(v, gate, self.M[sym])

    def step_mask(self, v: torch.Tensor, gate: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """v' = Fᵀ·(v | gate · seed) & mask, with ``mask`` [R, lanes] bool."""
        v = v.clone()
        v[:, 0] |= gate
        return self._expand(v, False) & mask

    def flags(self, v: torch.Tensor) -> torch.Tensor:
        """[R, C] bool: a state of accept channel c is live."""
        return (v[:, None, :] & self.accs[None]).any(dim=2)

    def rev(self, r: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """R' = F·((R | acc) & mask[sym])."""
        return self.rev_mask(r, self.M[sym])

    def rev_mask(self, r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """R' = F·((R | acc) & mask), with ``mask`` [R, lanes] bool."""
        return self._expand((r | self.acc) & mask, True)

    def start(self, r: torch.Tensor) -> torch.Tensor:
        """[R] bool: state 0 is in R."""
        return r[:, 0]


def sparse_stats_plain(data, lengths, tables: SparseTables, *, seeded: bool, nullable: bool):
    """Plain version of ``rrx_sparse_stats`` (the TPU's
    ``_sparse_match_kernel_b``): the channel loop of
    ``scan_bitband.stats_plain`` (the seed gate, the `$` dedup e != last,
    the nullable starts, full = a flag at t >= len) over the container
    stepper. Returns (cnt, first, last, full), each [R, C]."""
    return _channel_stats(data, lengths, tables, seeded=seeded, nullable=nullable)


def sparse_flags_plain(data, lengths, tables: SparseTables, *, seeded: bool):
    """Plain version of ``rrx_sparse_flags`` (the TPU's
    ``_sparse_flags_kernel_b``): every step's raw accept flags per channel
    as flag words [Wt, R * C] int32, bit t of column r * C + c in word t //
    32 (``scan_bitband.flags_plain``'s loop on the container stepper)."""
    return _channel_flags(data, lengths, tables, seeded=seeded)


def sparse_reverse_plain(data, lengths, tables: SparseTables):
    """Plain version of ``rrx_sparse_reverse`` (the TPU's
    ``_sparse_reverse_kernel_b``): ``scan_bits.reverse_plain`` on the
    container stepper, hit words [Wt, R] int32."""
    return sb.reverse_plain(data, lengths, tables)


# The stream-fed plain versions: the JAX package's _sparse_match_kernel,
# _sparse_flags_kernel and _sparse_reverse_kernel, one record a row, over
# every step of a mask stream words [T, B, W] int32 (bit s of word s // 32:
# state s may take the step's symbol; ``scan_packed.mask_stream_from_bytes``
# on the program's ``stream_tables``), with one accept set: the channels'
# union (the wrappers refuse more than one channel).


def _stream_masks(tables: SparseTables, words: torch.Tensor, t: int) -> torch.Tensor:
    from .scan_packed import unpack_bits

    return unpack_bits(words[t], tables.masks.shape[1])


def sparse_stream_stats_plain(tables: SparseTables, words: torch.Tensor, lengths, *,
                              seeded: bool, nullable: bool):
    """Plain version of ``rrx_sparse_stream_stats``: the seed (state 0)
    ORs in at every step when seeded, at steps t < 2 when not; a step whose
    state meets the accept set has end e = min(t, len): cnt counts the e
    that differ from the last one (not for a nullable seeded scan), first
    keeps the first e; nullable starts cnt = len + 1 (seeded) or 1, first
    = 0, last = len (seeded) or 0. Returns (cnt, first, any), each [B]."""
    _check_stream(words, tables)
    T, B, _ = words.shape
    dev = words.device
    pt = tables.plain(dev)
    acc = pt.accs.any(dim=0)
    ln = torch.as_tensor(lengths, device=dev).reshape(-1).to(torch.int64)
    v = pt.empty(B, dev)
    if nullable:
        cnt = ln + 1 if seeded else torch.ones_like(ln)
        first = torch.zeros_like(ln)
        last = ln.clone() if seeded else torch.zeros_like(ln)
    else:
        cnt = torch.zeros_like(ln)
        first = torch.full_like(ln, -1)
        last = torch.full_like(ln, -1)
    for t in range(T):
        gate = torch.full((B,), seeded or t < 2, dtype=torch.bool, device=dev)
        v = pt.step_mask(v, gate, _stream_masks(tables, words, t))
        fl = (v & acc).any(dim=1)
        e = ln.clamp(max=t)
        if not (nullable and seeded):
            cnt = cnt + (fl & (e != last)).to(torch.int64)
        first = torch.where((first < 0) & fl, e, first)
        last = torch.where(fl, e, last)
    cnt = cnt.to(torch.int32)
    return cnt, first.to(torch.int32), cnt > 0


def sparse_stream_flags_plain(tables: SparseTables, words: torch.Tensor, *, seeded: bool):
    """Plain version of ``rrx_sparse_stream_flags``: the loop of
    :func:`sparse_stream_stats_plain` keeping every step's accept flag as
    flag words [ceil(T / 32), B] int32, bit t of record b in word t // 32."""
    _check_stream(words, tables)
    T, B, _ = words.shape
    dev = words.device
    pt = tables.plain(dev)
    acc = pt.accs.any(dim=0)
    v = pt.empty(B, dev)
    fw = torch.zeros((-(-T // 32), B), dtype=torch.int64, device=dev)
    for t in range(T):
        gate = torch.full((B,), seeded or t < 2, dtype=torch.bool, device=dev)
        v = pt.step_mask(v, gate, _stream_masks(tables, words, t))
        fw[t >> 5] |= (v & acc).any(dim=1).to(torch.int64) << (t & 31)
    return sb._as_i32(fw)


def sparse_stream_reverse_plain(tables: SparseTables, words: torch.Tensor):
    """Plain version of ``rrx_sparse_stream_reverse``: from step T - 1 down
    to 0, R = F·((R | acc) & m_t); hit words [ceil(T / 32), B] int32, bit
    t = state 0 is in R after step t (a match can start at max(t - 1, 0))."""
    _check_stream(words, tables)
    T, B, _ = words.shape
    dev = words.device
    pt = tables.plain(dev)
    r = pt.empty(B, dev)
    hw = torch.zeros((-(-T // 32), B), dtype=torch.int64, device=dev)
    for t in range(T - 1, -1, -1):
        r = pt.rev_mask(r, _stream_masks(tables, words, t))
        hw[t >> 5] |= pt.start(r).to(torch.int64) << (t & 31)
    return sb._as_i32(hw)


# ---------------------------------------------------------------------------
# Counted launchers
# ---------------------------------------------------------------------------


# the container kernels by their step and table direction: "walk"
# (rrx_sparse_stats, _flags), "walk_r" (rrx_sparse_reverse), "stream"
# (rrx_sparse_stream_stats, _flags) and "stream_r"
# (rrx_sparse_stream_reverse)
KINDS = ("walk", "walk_r", "stream", "stream_r")


def _direction(tables: SparseTables, kind: str):
    """(table, meta, walk tables or None) of the kernels of ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    walk = {"walk": tables.walk_f, "walk_r": tables.walk_r}.get(kind)
    if kind.endswith("_r"):
        return tables.tab_r, tables.meta_r, walk
    return tables.tab_f, tables.meta_f, walk


def smem_bytes(tables: SparseTables, kind: str, global_tab: bool) -> int:
    """Shared memory of one block of the container kernels of ``kind``
    (``csrc/scan_sparse.cu``): the meta header, then for the walk kernels
    one channel buffer of W words per warp (the forward ones only) and, in
    the shared form, the walk tables and the table (walk_smem_bytes); for
    the stream-fed kernels each warp's two state buffers and, in the shared
    form, the table (sparse_smem_bytes)."""
    tab, meta, walk = _direction(tables, kind)
    if walk is not None:
        words = meta.numel() + (WARPS * tables.W if kind == "walk" else 0) + (
            0 if global_tab else walk.numel() + tab.numel())
    else:
        words = meta.numel() + 2 * WARPS * tables.W + (0 if global_tab else tab.numel())
    return 4 * words


def table_form(tables: SparseTables, kind: str = "walk") -> str:
    """The table's form for the kernels of ``kind``: "shared" when it fits
    a block's shared memory beside what else the block holds there
    (:func:`smem_bytes`), else "global" (read through L1 / L2)."""
    return "shared" if smem_bytes(tables, kind, False) <= SMEM_LIMIT else "global"


def _launch(entry: str, data, lengths, tables: SparseTables, kind: str, live, form,
            *tail) -> None:
    """Launch the walk kernel ``entry`` (``kind`` "walk" or "walk_r") with
    the container head of its direction (table, meta, the table's form),
    ``live``: None, or a [1] int32 tensor on the card, the record count past
    which every record returns at once, its outputs unwritten (the
    prefilter's compacted and full passes: ``ScanEngine._prefilter_apply``),
    the record counter and the walk tables, then ``tail``. ``form``:
    "shared", "global" or None (:func:`table_form` of ``kind``)."""
    if live is not None and (live.dtype != torch.int32 or live.numel() != 1):
        raise ValueError(f"live must be a [1] int32 tensor, got {tuple(live.shape)} {live.dtype}")
    form = form or table_form(tables, kind)
    if form not in ("shared", "global"):
        raise ValueError(f"form must be 'shared' or 'global', got {form!r}")
    tab, meta, walk = _direction(tables, kind)
    # the record counter the kernel's warps take work from
    next_rec = torch.zeros(1, dtype=torch.int32, device=data.device)
    sb.launch(entry, data, lengths, tab, int(tab.numel()), meta, int(meta.numel()), tables.W,
              int(form == "global"), live, next_rec, walk, int(walk.numel()), *tail)


def sparse_stats(data, lengths, tables: SparseTables, *, seeded: bool, nullable: bool,
                 live=None, form=None, walk_max: int = WALK_MAX):
    """(cnt, first, last, full), each [R, C] (``rrx_sparse_stats`` on a
    CUDA tensor, counted in ``sparse_stats.launches``;
    :func:`sparse_stats_plain` on a CPU tensor). ``form`` forces the
    table's form ("shared" or "global"; None: :func:`table_form`), so that
    ``chip_smoke.py`` holds both to the plain versions on every program;
    ``walk_max`` sets the step's choice between its two forms (its sweep
    there; the outputs do not depend on it)."""
    if data.device.type == "cpu":
        return sparse_stats_plain(data, lengths, tables, seeded=seeded, nullable=nullable)
    R, dev = data.shape[0], data.device
    outs = [torch.empty((R, tables.C), dtype=torch.int32, device=dev) for _ in range(3)]
    full = torch.empty((R, tables.C), dtype=torch.uint8, device=dev)
    _launch("rrx_sparse_stats", data, lengths, tables, "walk", live, form, int(walk_max),
            int(seeded), int(nullable), *outs, full)
    sparse_stats.launches += 1
    return (*outs, full.view(torch.bool))


def sparse_flags(data, lengths, tables: SparseTables, *, seeded: bool, live=None, form=None,
                 walk_max: int = WALK_MAX):
    """Flag words [Wt, R * C] int32 (``rrx_sparse_flags`` on a CUDA tensor,
    counted; :func:`sparse_flags_plain` on a CPU tensor). ``form`` and
    ``walk_max``: as :func:`sparse_stats`."""
    if data.device.type == "cpu":
        return sparse_flags_plain(data, lengths, tables, seeded=seeded)
    R, L = data.shape
    words = torch.empty((sb.hit_words(L), R * tables.C), dtype=torch.int32, device=data.device)
    _launch("rrx_sparse_flags", data, lengths, tables, "walk", live, form, int(walk_max),
            int(seeded), words)
    sparse_flags.launches += 1
    return words


def sparse_reverse(data, lengths, tables: SparseTables, live=None, form=None,
                   walk_max: int = WALK_MAX):
    """Hit words [Wt, R] int32 (``rrx_sparse_reverse`` on a CUDA tensor,
    counted; :func:`sparse_reverse_plain` on a CPU tensor). ``form`` and
    ``walk_max``: as :func:`sparse_stats`, on the reverse walk tables."""
    if data.device.type == "cpu":
        return sparse_reverse_plain(data, lengths, tables)
    R, L = data.shape
    hits = torch.empty((sb.hit_words(L), R), dtype=torch.int32, device=data.device)
    _launch("rrx_sparse_reverse", data, lengths, tables, "walk_r", live, form, int(walk_max), hits)
    sparse_reverse.launches += 1
    return hits


def _check_stream(words: torch.Tensor, tables: SparseTables) -> None:
    if words.dim() != 3 or words.shape[2] != tables.W or words.dtype != torch.int32:
        raise ValueError(f"a mask stream of {32 * tables.W} lanes is [T, B, {tables.W}] int32, "
                         f"got {tuple(words.shape)} {words.dtype}")
    if tables.C != 1:
        raise ValueError(f"the stream-fed container kernels read one accept set, the tables "
                         f"have {tables.C} channels")


def _launch_stream(entry: str, words: torch.Tensor, tables: SparseTables, reverse: bool, form,
                   *tail) -> None:
    """Launch ``entry`` on the current stream of ``words``' card: (words, T,
    R), the container head of one direction (table, meta, W, the table's
    form: ``form`` or :func:`table_form`), the record counter, then
    ``tail`` (tensors by pointer, ints as they are). A refused launch
    raises."""
    from . import _build

    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on a CUDA tensor, got {dev}")
    words = words.contiguous()
    if words.data_ptr() % 16:
        raise ValueError(f"{entry}: the mask stream must be 16-byte aligned")
    form = form or table_form(tables, "stream_r" if reverse else "stream")
    if form not in ("shared", "global"):
        raise ValueError(f"form must be 'shared' or 'global', got {form!r}")
    tab, meta, _ = _direction(tables, "stream_r" if reverse else "stream")
    for x in tail:
        if isinstance(x, torch.Tensor) and (x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{entry}: a {tuple(x.shape)} argument on {x.device} "
                             f"(contiguous: {x.is_contiguous()}), words on {dev}")
    T, R, _ = words.shape
    next_rec = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in tail]
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(words.data_ptr(), T, R, tab.data_ptr(), int(tab.numel()),
                                   meta.data_ptr(), int(meta.numel()), tables.W,
                                   int(form == "global"), next_rec.data_ptr(), *ptrs, stream)
    _build.check(code, entry)


def sparse_stream_stats(tables: SparseTables, words: torch.Tensor, lengths, *, seeded: bool,
                        nullable: bool, form=None):
    """(cnt, first, any), each [B], of the mask stream ``words`` [T, B, W]
    (``rrx_sparse_stream_stats`` on a CUDA tensor, counted in
    ``sparse_stream_stats.launches``; :func:`sparse_stream_stats_plain` on a
    CPU tensor). ``form``: as :func:`sparse_stats`."""
    _check_stream(words, tables)
    if words.device.type == "cpu":
        return sparse_stream_stats_plain(tables, words, lengths, seeded=seeded,
                                         nullable=nullable)
    _, R, _ = words.shape
    dev = words.device
    ln = torch.as_tensor(lengths, device=dev).reshape(-1).to(torch.int32).contiguous()
    if ln.numel() != R:
        raise ValueError(f"lengths must hold one value per record ({R}), got {ln.numel()}")
    cnt, first = (torch.empty(R, dtype=torch.int32, device=dev) for _ in range(2))
    _launch_stream("rrx_sparse_stream_stats", words, tables, False, form, ln, int(seeded),
                   int(nullable), cnt, first)
    sparse_stream_stats.launches += 1
    return cnt, first, cnt > 0


def sparse_stream_flags(tables: SparseTables, words: torch.Tensor, *, seeded: bool, form=None):
    """Flag words [ceil(T / 32), B] int32 of the mask stream
    (``rrx_sparse_stream_flags`` on a CUDA tensor, counted;
    :func:`sparse_stream_flags_plain` on a CPU tensor)."""
    _check_stream(words, tables)
    if words.device.type == "cpu":
        return sparse_stream_flags_plain(tables, words, seeded=seeded)
    T, R, _ = words.shape
    fw = torch.empty((-(-T // 32), R), dtype=torch.int32, device=words.device)
    _launch_stream("rrx_sparse_stream_flags", words, tables, False, form, int(seeded), fw)
    sparse_stream_flags.launches += 1
    return fw


def sparse_stream_reverse(tables: SparseTables, words: torch.Tensor, form=None):
    """Hit words [ceil(T / 32), B] int32 of the mask stream
    (``rrx_sparse_stream_reverse`` on a CUDA tensor, counted;
    :func:`sparse_stream_reverse_plain` on a CPU tensor)."""
    _check_stream(words, tables)
    if words.device.type == "cpu":
        return sparse_stream_reverse_plain(tables, words)
    T, R, _ = words.shape
    hw = torch.empty((-(-T // 32), R), dtype=torch.int32, device=words.device)
    _launch_stream("rrx_sparse_stream_reverse", words, tables, True, form, hw)
    sparse_stream_reverse.launches += 1
    return hw


for _w in (sparse_stats, sparse_flags, sparse_reverse, sparse_stream_stats, sparse_stream_flags,
           sparse_stream_reverse):
    _w.launches = 0


class StreamMethods:
    """The stream-fed methods of the container-table scanners (the JAX
    ``SparseScanner``'s, which its ``BitbandScanner`` inherits): match
    statistics, forward flags and reverse hits of a mask stream ``words``
    [T, B, W] int32 (``scan_packed.mask_stream_from_bytes`` on
    ``scan_packed.stream_tables(prog)``), T = L + 2 for a batch of width L,
    on the container kernels ``rrx_sparse_stream_*`` (their plain versions
    on the CPU). A scanner with accept channels raises in all three: the
    JAX kernels read one accept row, which would answer channel 0 only.
    ``_stream_tables()`` gives the container tables."""

    def _stream_tables(self) -> SparseTables:
        raise NotImplementedError

    def match_stats(self, words, len_g, *, seeded: bool):
        """(cnt, first, any) of the mask stream, each shaped [B_rows, G]
        like ``len_g`` (G = 1 on this tier)."""
        self._one_channel("match_stats")
        len_g = torch.as_tensor(len_g, device=self.device)
        outs = sparse_stream_stats(self._stream_tables(), words, len_g.reshape(-1), seeded=seeded,
                                   nullable=self.nullable)
        return tuple(x.reshape(len_g.shape[0], -1) for x in outs)

    def forward_flags(self, words, *, seeded: bool):
        """[B, T + 1] bool accept flags of the mask stream; column 0 is the
        program's nullability."""
        self._one_channel("forward_flags")
        fw = sparse_stream_flags(self._stream_tables(), words, seeded=seeded)
        return _with_flag0(sb.hit_bits(fw, words.shape[0]), bool(self.prog.nullable))

    def reverse_hits(self, words):
        """[B, T] bool: column j is set iff some match starts at max(j - 1,
        0)."""
        self._one_channel("reverse_hits")
        return sb.hit_bits(sparse_stream_reverse(self._stream_tables(), words), words.shape[0])


# ---------------------------------------------------------------------------
# Scanner
# ---------------------------------------------------------------------------


class SparseScanner(StreamMethods, _Scanner):
    """Match statistics, forward flags and reverse hits of a multiblock or
    sparse program on the container tier, on ``device``: the CUDA kernels
    of ``csrc/scan_sparse.cu`` on a CUDA device, their plain PyTorch
    versions on the CPU. Named after the JAX package's scanner of the same
    methods and outputs.

    ``accept_map`` ([lanes, C] 0/1) gives the scan C accept channels:
    ``match_stats_b`` and ``forward_flags_b`` then return per-channel
    results and the primitives that read one accept set raise. As in the
    JAX package there are no anchored kernels (``has_anchor`` is False: the
    engine answers anchored rescans with ``scan_xla.first_end_from`` and
    ``Pattern`` takes spans in host rounds) and no window plan. Every
    method takes the prefilter's ``live`` (see ``_launch``; the plain
    versions ignore it). The kernels write flag and hit words, so
    ``flags_words_b`` and ``hits_words_b`` serve the bitmaps directly.
    ``match_stats``, ``forward_flags`` and ``reverse_hits`` take a mask
    stream instead of bytes (:class:`StreamMethods`)."""

    has_anchor = False
    CHANNEL_METHODS = "match_stats_b and forward_flags_b"

    def __init__(self, prog: DeviceProgram, device, accept_map=None, nullable=None):
        super().__init__(prog, device, nullable)
        self.tables = device_sparse_tables(prog, self.device, accept_map)
        self.channels = accept_map is not None
        self.P = self.tables.C

    @property
    def n_partial(self) -> int:
        return len(self.tables.part[1])

    def _stream_tables(self) -> SparseTables:
        return self.tables

    def match_stats_b(self, data, len_g, *, seeded: bool, lead: int = 0, live=None):
        """(cnt, first, last, full, any), each [B, C] (C = 1 without an
        accept map). There is no windowed mode (``lead`` must be 0)."""
        if lead:
            raise ValueError("the container tier has no windowed mode (lead must be 0)")
        data, _, lengths = self._batch(data, len_g)
        cnt, first, last, full = sparse_stats(data, lengths, self.tables, seeded=seeded,
                                              nullable=self.nullable, live=live)
        return cnt, first, last, full, cnt > 0

    def forward_flags_b(self, data, len_g, *, seeded: bool, live=None):
        """[B * C, T + 1] bool accept flags (record-major, channel-minor),
        T = L + 2: column 0 is the program's nullability, column t + 1 the
        flag of step t."""
        data, _, lengths = self._batch(data, len_g)
        words = sparse_flags(data, lengths, self.tables, seeded=seeded, live=live)
        return _with_flag0(sb.hit_bits(words, data.shape[1] + 2), self.prog.nullable)

    def flags_words_b(self, data, len_g, *, seeded: bool, live=None):
        """([B, Wt] int32 words, T = L + 2): bit t = step t's accept flag."""
        self._one_channel("flags_words_b")
        data, _, lengths = self._batch(data, len_g)
        words = sparse_flags(data, lengths, self.tables, seeded=seeded, live=live)
        return words.T, data.shape[1] + 2

    def hits_words_b(self, data, len_g, live=None):
        """([B, Wt] int32 words, T = L + 2): bit t = reverse start hit at
        step t (a match can start at max(t - 1, 0))."""
        self._one_channel("hits_words_b")
        data, _, lengths = self._batch(data, len_g)
        return sparse_reverse(data, lengths, self.tables, live).T, data.shape[1] + 2

    def reverse_hits_b(self, data, len_g, live=None):
        """[B, L + 2] bool candidate-start hits."""
        words, T = self.hits_words_b(data, len_g, live)
        return sb.hit_bits(words.T, T)

