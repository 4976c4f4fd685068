"""Bitband tier: the band + rank-1 + triangle bit decomposition of a
multiblock or sparse program's follow matrix.

The port of ``roaringregex_tpu/ops/scan_bitband.py``. A record's state set
is W u32 words (bit s % 32 of word s // 32 = state s; W = ceil(s_pad / 32)
rounded up to a multiple of 8). One automaton step ``y = Fᵀ·v`` becomes:

* **band**: edges sharing one offset d = dst - src collapse to
  ``y |= shift_up(v, d) & dmask_d``, a cross-word funnel shift and an AND
  with the diagonal's destination mask;
* **rank-1 columns**: residual high-in-degree destinations become ``y[dst]
  |= any(v & rowmask)``;
* **triangle families**: the optional tail of ``X{m,n}`` ("every exit of
  copy i reaches every first of copy j > i") is one exclusive prefix-OR
  over the exit set E and, per family of gap g, ``y |= T_g & shift_up(P,
  g)``, inside the word window ``tri_win`` that holds E and every target.

Forward steps expand, then mask: ``v = expand(v | seed) & mask(sym)``. The
reverse (candidate-start) pass masks, then expands, with the follow
matrix transposed: ``R = expand_rev((R | acc) & mask(sym))``, hit = the
initial state is in R. ``sym`` is a byte at step t (byte t - 1), BOS at
step 0, EOS at step len + 1; steps past EOS are dead; bytes in no run of
the byte -> class map (bytes >= 0x80) have a zero mask.

The numpy host code (``bitband_spec``, ``_tri_structure``,
``build_bitband_tables``) is the JAX package's, unchanged. The TPU's
layouts (``[W, B]`` sublane vectors, the f32 triangular matrix of its MXU
word scan, the ``[T, C, B]`` int8 flags) are a layout of the same function
and have no counterpart here: the parity boundary is the scanner methods'
outputs. The CUDA kernels (``csrc/scan_bitband.cu``) run one warp per
record; the plain PyTorch versions here step [R, W] int64 words masked to
32 bits, as ``_expand`` does. Each wrapper runs its plain version for a
CPU tensor only and launches its kernel (counted in ``.launches``) for a
CUDA tensor.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compiler.program import DeviceProgram
from . import scan_bits as sb
from .scan_pallas import _Scanner, _with_flag0

MASK32 = sb.MASK32
MAX_TRI_FAMILIES = 6
# the JAX package's RRX_BITBAND_MAX_DIAGS / RRX_BITBAND_MAX_RANK1 /
# RRX_SPARSE_LANES_MAX defaults: the decomposition's limits and the lane
# cap of the sparse tier's bitband route (engine._big_tier)
BITBAND_MAX_DIAGS = 16
BITBAND_MAX_RANK1 = 16
SPARSE_LANES_MAX = 4096
# the kernels' fixed table capacities (csrc/scan_bitband.cu): meta holds
# [8 counts | MAX_DIAGS offsets | MAX_RANK1 columns | 8 gaps | 259 symbol rows]
MAX_DIAGS = 32
MAX_RANK1 = 32
MAX_CHANNELS = 32  # one lane of the record's warp per accept channel
MAX_WORDS = 128  # four state words per lane
META_DIAGS = 8
META_RANK1 = META_DIAGS + MAX_DIAGS
META_GAPS = META_RANK1 + MAX_RANK1
META_SYMS = META_GAPS + 8
META_LEN = META_SYMS + sb.N_SYMS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BitbandSpec(NamedTuple):
    """Static per-program plan (the JAX package's ``BitbandSpec``)."""

    W: int  # padded word count (multiple of 8)
    diags: Tuple[int, ...]  # band offsets d = dst - src
    rank1: Tuple[Tuple[int, int], ...]  # (dst_word, dst_bit) per column term
    tri_gaps: Tuple[int, ...]  # triangle families (gap g: target p receives
    # any exit q with q < p - g)
    tri_win: Tuple[int, int]  # word range [lo_w, hi_w) holding E and targets
    runs: Tuple[Tuple[int, int], ...]  # byte runs (lo, hi)
    bos_nz: bool  # BOS mask has any bit (^ patterns)
    eos_nz: bool  # EOS mask has any bit ($ patterns)


def bitband_spec(
    prog: DeviceProgram,
    max_diags: int = BITBAND_MAX_DIAGS,
    max_rank1: int = BITBAND_MAX_RANK1,
) -> Optional[BitbandSpec]:
    """Band + rank-1 + triangle decomposition of the follow matrix, or
    None when the structure does not fit (the JAX package's
    ``bitband_spec``, unchanged).

    1. **Diagonals**: offsets ``d = dst - src`` carrying >= max(8, S/8)
       edges.
    2. **Triangle**: the residual edges of an ``X{m,n}`` optional tail
       (every exit of copy i reaches every first of copy j > i), applied
       as one exclusive prefix-OR over the exit set plus a per-family gap
       shift; every (exit, target) pair the prefix lights must be a real
       follow edge.
    3. **Rank-1 columns**: destinations that defeat the triangle check
       fall back to exact per-column terms ``y[dst] |= any(v &
       in_edges(dst))``.
    """
    if prog.tier not in ("sparse", "multiblock"):
        return None
    if max_diags <= 0:
        return None
    e = prog.nfa.get_edges()
    if len(e) == 0:
        return None
    src = e[:, 0].astype(np.int64)
    dst = e[:, 1].astype(np.int64)
    S = prog.n_states
    offs_all, cnt_all = np.unique(dst - src, return_counts=True)
    thr = max(8, S // 8)
    big = offs_all[cnt_all >= thr]
    if len(big) > max_diags:
        order = np.argsort(-cnt_all[cnt_all >= thr])
        big = big[order[:max_diags]]
    elif len(big) == 0 and len(offs_all) <= max_diags:
        big = offs_all  # small automata: everything fits on diagonals
    diags = tuple(sorted(int(d) for d in big))
    resid = ~np.isin(dst - src, big)
    rank1: list = []
    tri_gaps: Tuple[int, ...] = ()
    tri_exits = tri_fams = None
    if resid.any():
        F = prog.nfa.follow_matrix
        rank1_set: set = set()
        while True:
            keep = resid & ~np.isin(dst, sorted(rank1_set))
            rs, rd = src[keep], dst[keep]
            if len(rs) == 0:
                break
            E = np.unique(rs)
            fams: dict = {}
            bad_dst = None
            for p in np.unique(rd):
                rin = rs[rd == p]
                g = int(p - rin.max() - 1)
                elow = E[E < p - g]
                if not F[elow, p].all():
                    bad_dst = int(p)
                    break
                fams.setdefault(g, []).append(int(p))
            if bad_dst is None and len(fams) <= MAX_TRI_FAMILIES:
                tri_gaps = tuple(sorted(fams))
                tri_exits = E
                tri_fams = fams
                break
            if bad_dst is None:
                # too many families: demote the smallest family
                g_small = min(fams, key=lambda g: len(fams[g]))
                bad = fams[g_small]
            else:
                bad = [bad_dst]
            rank1_set.update(bad)
            if len(rank1_set) > max_rank1:
                return None
        rank1 = sorted(rank1_set)
    W = _round_up(max(1, prog.s_pad // 32), 8)
    lo, hi, _cl = prog.byte_runs
    runs = tuple((int(a), int(b)) for a, b in zip(lo, hi))
    bos_nz = bool(np.asarray(prog.Bc_words[prog.bos_class]).any())
    eos_nz = bool(np.asarray(prog.Bc_words[prog.eos_class]).any())
    tri_win = (0, W)
    if tri_gaps:
        members = np.concatenate(
            [tri_exits] + [np.asarray(v) for v in tri_fams.values()]
        )
        lo_w = (int(members.min()) // 32) // 8 * 8
        hi_w = min(W, -(-(int(members.max()) // 32 + 1) // 8) * 8)
        tri_win = (lo_w, hi_w)
    return BitbandSpec(
        W=W,
        diags=diags,
        rank1=tuple((int(c) // 32, int(c) % 32) for c in rank1),
        tri_gaps=tri_gaps,
        tri_win=tri_win,
        runs=runs,
        bos_nz=bos_nz,
        eos_nz=eos_nz,
    )


def _tri_structure(prog: DeviceProgram, spec: BitbandSpec):
    """(exit positions E, {gap: [target positions]}) of the triangle term,
    recomputed from the spec (the JAX package's ``_tri_structure``)."""
    e = prog.nfa.get_edges()
    src = e[:, 0].astype(np.int64)
    dst = e[:, 1].astype(np.int64)
    r1cols = [w * 32 + b for (w, b) in spec.rank1]
    keep = ~np.isin(dst - src, spec.diags) & ~np.isin(dst, r1cols)
    rs, rd = src[keep], dst[keep]
    E = np.unique(rs)
    fams: dict = {g: [] for g in spec.tri_gaps}
    for p in np.unique(rd):
        rin = rs[rd == p]
        g = int(p - rin.max() - 1)
        fams[g].append(int(p))
    return E, fams


def _pack_states(cols: np.ndarray, W: int) -> np.ndarray:
    out = np.zeros(W, np.uint32)
    for c in cols:
        out[int(c) // 32] |= np.uint32(1) << np.uint32(int(c) % 32)
    return out


def _pack_words(words: np.ndarray, W: int) -> np.ndarray:
    out = np.zeros(W, np.uint32)
    out[: len(words)] = words
    return out


def build_bitband_tables(
    prog: DeviceProgram, spec: BitbandSpec, accept_np: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(tabs_f, tabs_r): stacked [K*W, 1] uint32 mask tables (the JAX
    package's ``build_bitband_tables``, unchanged).

    Forward layout (row blocks of W words each): 0 BOS mask, 1 EOS mask,
    2 seed (initial states), then one symbol mask per byte run, the
    forward diagonal masks (destination-indexed), the rank-1 row masks
    (source-indexed), with ``tri_gaps`` the exit mask E and one target mask
    per family, then the C accept-channel masks. Reverse layout: the same
    header and runs, the reverse diagonal masks (source-indexed), the same
    rank-1 and triangle masks, then the accept seed and the initial-state
    mask."""
    W = spec.W
    e = prog.nfa.get_edges()
    src = e[:, 0].astype(np.int64) if len(e) else np.zeros(0, np.int64)
    dst = e[:, 1].astype(np.int64) if len(e) else np.zeros(0, np.int64)
    r1cols = [w * 32 + b for (w, b) in spec.rank1]

    Bw = prog.Bc_words
    _lo, _hi, cl = prog.byte_runs
    header = [
        _pack_words(np.asarray(Bw[prog.bos_class]), W),
        _pack_words(np.asarray(Bw[prog.eos_class]), W),
        _pack_states(np.nonzero(np.asarray(prog.seed_row))[0], W),
    ]
    run_masks = [_pack_words(np.asarray(Bw[int(c)]), W) for c in cl]

    fdiag, rdiag = [], []
    for d in spec.diags:
        on = dst - src == d
        fdiag.append(_pack_states(dst[on], W))
        rdiag.append(_pack_states(src[on], W))
    rmasks = [_pack_states(src[dst == c], W) for c in r1cols]
    tri_masks = []
    if spec.tri_gaps:
        E, fams = _tri_structure(prog, spec)
        tri_masks.append(_pack_states(E, W))
        for g in spec.tri_gaps:
            tri_masks.append(_pack_states(np.asarray(fams[g]), W))

    acc_rows = [
        _pack_states(np.nonzero(accept_np[:, c])[0], W)
        for c in range(accept_np.shape[1])
    ]
    tabs_f = np.concatenate(
        header + run_masks + fdiag + rmasks + tri_masks + acc_rows
    )
    acc_seed = _pack_states(np.nonzero(np.asarray(prog.accept))[0], W)
    init_mask = _pack_states(np.nonzero(np.asarray(prog.seed_row))[0], W)
    tabs_r = np.concatenate(
        header + run_masks + rdiag + rmasks + tri_masks
        + [acc_seed, init_mask]
    )
    return tabs_f[:, None], tabs_r[:, None]


def _acc_off(spec: BitbandSpec) -> int:
    """Row-block index of the first accept mask (after header, runs,
    diagonals, rank-1 rows and triangle masks)."""
    n_tri = (1 + len(spec.tri_gaps)) if spec.tri_gaps else 0
    return 3 + len(spec.runs) + len(spec.diags) + len(spec.rank1) + n_tri


def _static_words(words: np.ndarray):
    """((word, mask), ...) of a packed row's nonzero words."""
    nz = np.nonzero(words)[0]
    return tuple((int(w), int(words[w])) for w in nz)


# ---------------------------------------------------------------------------
# Device tables
# ---------------------------------------------------------------------------


class BitbandTables(NamedTuple):
    """Device copy of one program's bitband tables: ``tab_f`` [(K_f + 1) *
    W] int32 (uint32 bit patterns; the JAX forward table, then the anchored
    rescan's accept row), ``tab_r`` [(K_r + 3 + n_runs) * W] int32 (the JAX
    reverse table, then the E rows of ``rrx_bitband_reverse``'s register
    step: :func:`with_e_rows`),
    ``meta`` [META_LEN] int32 (the counts n_runs, n_diags, n_rank1, n_fam,
    tri_lo, tri_hi, C; the diagonal offsets, rank-1 columns as state
    indices and gaps; and the row of each of the 259 symbols: 3 + run for a
    byte in a run, 0 for BOS, 1 for EOS, -1 for a byte in no run and the
    dead step). ``acc_static`` / ``anchor_static``: the accept channels'
    and the rescan's accept rows as static (word, mask) lists when they are
    few (the JAX scanner's ``acc_static`` / ``_anchor_acc_static``), else
    None: the plain versions then test the rows with an AND + OR-fold over
    all W words, the kernels always do."""

    tab_f: torch.Tensor
    tab_r: torch.Tensor
    meta: torch.Tensor
    spec: BitbandSpec
    C: int
    acc_static: Optional[tuple]
    anchor_static: Optional[tuple]

    def plain(self, dev) -> "_Plain":
        """The stepper of the plain versions on ``dev``."""
        return _Plain.of(self, dev)


def bitband_meta(spec: BitbandSpec, prog: DeviceProgram, C: int) -> np.ndarray:
    """[META_LEN] int32 header of the kernels (see :class:`BitbandTables`)."""
    if len(spec.diags) > MAX_DIAGS or len(spec.rank1) > MAX_RANK1:
        raise ValueError(f"{prog.pattern!r}: {len(spec.diags)} diagonals and {len(spec.rank1)} "
                         f"rank-1 columns; the kernels hold at most {MAX_DIAGS} and {MAX_RANK1}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{C} accept channels; the kernels hold 1..{MAX_CHANNELS}")
    if spec.W > MAX_WORDS:
        raise ValueError(f"W = {spec.W} state words; the kernels hold at most {MAX_WORDS}")
    meta = np.zeros(META_LEN, np.int32)
    lo, hi = spec.tri_win
    meta[:7] = (len(spec.runs), len(spec.diags), len(spec.rank1), len(spec.tri_gaps), lo, hi, C)
    meta[META_DIAGS : META_DIAGS + len(spec.diags)] = spec.diags
    meta[META_RANK1 : META_RANK1 + len(spec.rank1)] = [w * 32 + b for w, b in spec.rank1]
    meta[META_GAPS : META_GAPS + len(spec.tri_gaps)] = spec.tri_gaps
    sym_row = np.full(sb.N_SYMS, -1, np.int32)
    for i, (a, b) in enumerate(spec.runs):
        sym_row[a : b + 1] = 3 + i
    sym_row[sb.SYM_BOS], sym_row[sb.SYM_EOS] = 0, 1
    meta[META_SYMS:] = sym_row
    return meta


def device_bitband_tables(prog: DeviceProgram, spec: BitbandSpec, device,
                          accept_map=None) -> BitbandTables:
    """The tables of ``prog`` under ``spec`` on ``device``, with the accept
    channels of ``accept_map`` ([lanes, C] 0/1) or the program's accept
    set, and the static accept lists as the JAX scanner builds them."""
    W = spec.W
    if accept_map is not None:
        acc_np = np.asarray(accept_map)
    else:
        acc = np.zeros(prog.s_pad, np.uint8)
        acc[: len(prog.accept)] = prog.accept
        acc_np = acc[:, None]
    C = acc_np.shape[1]
    tf, tr = build_bitband_tables(prog, spec, acc_np)
    accs = [_static_words(_pack_states(np.nonzero(acc_np[:, c])[0], W)) for c in range(C)]
    acc_static = tuple(accs) if sum(len(a) for a in accs) <= 8 else None
    paw = _pack_states(np.nonzero(np.asarray(prog.accept))[0], W)
    anchor_static = (_static_words(paw),) if len(np.nonzero(paw)[0]) <= 8 else None
    # the anchored rescan's accept row: the program's accept set where the
    # JAX scanner reads it as static words, else accept channel 0
    anchor_row = paw if anchor_static is not None else tf[_acc_off(spec) * W :][:W, 0]
    tab_f = np.concatenate([tf[:, 0], anchor_row])

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())

    tables = with_e_rows(BitbandTables(i32(tab_f), i32(tr[:, 0]), i32(bitband_meta(spec, prog, C)),
                                       spec, C, acc_static, anchor_static))
    return tables._replace(tab_f=tables.tab_f.to(device), tab_r=tables.tab_r.to(device),
                           meta=tables.meta.to(device))


def _rev_rows(spec: BitbandSpec) -> int:
    """Rows of the JAX reverse table: the header, runs, reverse diagonals,
    rank-1 and triangle rows, then the accept seed and the initial-state
    mask."""
    return _acc_off(spec) + 2


def with_e_rows(tables: BitbandTables) -> BitbandTables:
    """``tables`` with the E rows of ``rrx_bitband_reverse``'s register step
    after its reverse table's ``_rev_rows`` rows: one per header row r < 3 +
    n_runs (BOS, EOS, the seed row's slot, the runs), E[r] = expand_rev(acc
    & row r), computed by the plain stepper, and zero for the seed row (no
    symbol maps to it). The reverse step expand_rev((R | acc) & mask[sym])
    is then expand_rev(R & mask[sym]) | E[row], the expansion distributing
    over OR, and a step whose R & mask[sym] is empty leaves R = E[row]."""
    sp = tables.spec
    base = tables.tab_r[: _rev_rows(sp) * sp.W]
    pt = tables._replace(tab_r=base).plain("cpu")
    x = pt.tr[_acc_off(sp)] & pt.tr[: 3 + len(sp.runs)]
    x[2] = 0
    E = sb._as_i32(pt.expand(x, True)).reshape(-1).to(base.device)
    return tables._replace(tab_r=torch.cat([base, E]))


# ---------------------------------------------------------------------------
# Plain PyTorch versions ([R, W] int64 words masked to 32 bits)
# ---------------------------------------------------------------------------


def _prefix_excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix-OR over the bit positions of the last dimension's
    words: out bit p = OR of x bits q < p (in-word ``(x | -x) << 1``,
    cross-word the OR of lower words)."""
    e_in = ((x | (-x & MASK32)) << 1) & MASK32
    nz = (x != 0).to(torch.int64)
    lower = (torch.cumsum(nz, dim=-1) - nz) > 0
    return e_in | torch.where(lower, MASK32, 0)


def _suffix_excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive suffix-OR over the last dimension: out bit p = OR of x
    bits q > p."""
    a = x
    for s in (1, 2, 4, 8, 16):
        a = a | (a >> s)
    e_in = a >> 1
    nz = (x != 0).to(torch.int64)
    upper = (torch.flip(torch.cumsum(torch.flip(nz, [-1]), dim=-1), [-1]) - nz) > 0
    return e_in | torch.where(upper, MASK32, 0)


class _Band(NamedTuple):
    """Shifts of packed [R, n] words by d states toward higher indices (d <
    0: toward lower), zero-filled at both ends (the JAX package's
    ``_shift_up`` / ``_shift_down``), several at once: word w of shift i
    reads words ``main[i, w]`` and ``carry[i, w]`` of the state padded by n
    + 1 zero words on each side, joined as ((main << sl) >> sr) | ((carry
    << cl) >> cr) masked to 32 bits (sl = d % 32 and cr = 32 - d % 32 for d
    > 0; sr and cl mirrored for d < 0), then ANDed with its mask row."""

    main: torch.Tensor  # [nd, W] int64
    carry: torch.Tensor
    sl: torch.Tensor  # [nd, 1] int64
    sr: torch.Tensor
    cl: torch.Tensor
    cr: torch.Tensor
    masks: torch.Tensor  # [nd, W] int64

    @classmethod
    def of(cls, diags, W: int, masks: torch.Tensor) -> "_Band":
        dev = masks.device
        d = torch.tensor(diags, dtype=torch.int64, device=dev).reshape(-1, 1)
        e = d.abs()
        dw, db = (e // 32).clamp(max=W), e % 32
        up = d > 0
        w = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
        main = W + 1 + w + torch.where(up, -dw, dw)
        carry = main + torch.where(up, -1, 1)
        zero = torch.zeros_like(db)
        return cls(main, carry, torch.where(up, db, zero), torch.where(up, zero, db),
                   torch.where(up, zero, 32 - db), torch.where(up, 32 - db, zero), masks)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """[R, n]: OR over i of shift i, ANDed with mask row i, of x [R, n]
        (the same words for every shift) or of x[:, i] (x [R, nd, n])."""
        n = x.shape[-1]
        xp = torch.nn.functional.pad(x, (n + 1, n + 1))
        if x.dim() == 2:
            main, carry = xp[:, self.main], xp[:, self.carry]  # [R, nd, n]
        else:
            main = xp.gather(2, self.main.expand(x.shape[0], -1, -1))
            carry = xp.gather(2, self.carry.expand(x.shape[0], -1, -1))
        t = (((main << self.sl) >> self.sr) | ((carry << self.cl) >> self.cr)) & self.masks
        while t.shape[1] > 1:  # OR-reduce pairwise
            if t.shape[1] % 2:
                t = torch.nn.functional.pad(t, (0, 0, 0, 1))
            t = t[:, 0::2] | t[:, 1::2]
        if t.shape[1] == 0:
            return torch.zeros((x.shape[0], n), dtype=torch.int64, device=x.device)
        return t[:, 0] & MASK32


class _Plain(NamedTuple):
    """One program's tables as the plain versions use them: row blocks of
    [W] int64 words (``tf`` forward, ``tr`` reverse), the symbol -> row map
    ``sym_row`` [259] int64, the spec, the static accept lists and the
    diagonals of both directions."""

    tf: torch.Tensor  # [K_f + 1, W]
    tr: torch.Tensor  # [K_r, W]
    sym_row: torch.Tensor
    spec: BitbandSpec
    C: int
    acc_static: Optional[tuple]
    anchor_static: Optional[tuple]
    band_f: _Band  # the diagonals, forward and reverse
    band_r: _Band
    tri_f: Optional[_Band]  # the families' gap shifts inside the window
    tri_r: Optional[_Band]

    @classmethod
    def of(cls, tables: BitbandTables, dev) -> "_Plain":
        sp = tables.spec
        W = sp.W
        tf = (tables.tab_f.to(dev).to(torch.int64) & MASK32).reshape(-1, W)
        tr = (tables.tab_r.to(dev).to(torch.int64) & MASK32).reshape(-1, W)
        sym_row = tables.meta.to(dev).to(torch.int64)[META_SYMS:]
        d0, nd = 3 + len(sp.runs), len(sp.diags)
        tri_f = tri_r = None
        if sp.tri_gaps:
            lo, hi = sp.tri_win
            t0 = d0 + nd + len(sp.rank1)
            fams = tf[t0 + 1 : t0 + 1 + len(sp.tri_gaps), lo:hi]
            tri_f = _Band.of(sp.tri_gaps, hi - lo, fams)
            tri_r = _Band.of(tuple(-g for g in sp.tri_gaps), hi - lo,
                             torch.full_like(fams, MASK32))
        return cls(tf, tr, sym_row, sp, tables.C, tables.acc_static, tables.anchor_static,
                   _Band.of(sp.diags, W, tf[d0 : d0 + nd]),
                   _Band.of(tuple(-d for d in sp.diags), W, tr[d0 : d0 + nd]), tri_f, tri_r)

    # row blocks
    @property
    def _d0(self) -> int:
        return 3 + len(self.spec.runs)

    @property
    def _r0(self) -> int:
        return self._d0 + len(self.spec.diags)

    @property
    def _t0(self) -> int:
        return self._r0 + len(self.spec.rank1)

    def mask(self, sym: torch.Tensor) -> torch.Tensor:
        """[R, W] symbol masks of a [R] symbol vector (0 for no row)."""
        row = self.sym_row[sym]
        m = self.tf[row.clamp(min=0)]
        return torch.where((row >= 0)[:, None], m, 0)

    def expand(self, v: torch.Tensor, rev: bool) -> torch.Tensor:
        """One step y = Fᵀ v (F v with ``rev``): the JAX ``_expand``."""
        sp, tab = self.spec, (self.tr if rev else self.tf)
        y = (self.band_r if rev else self.band_f).apply(v)
        for i, (wj, bj) in enumerate(sp.rank1):
            rm = tab[self._r0 + i]
            if rev:
                bit = ((v[:, wj] >> bj) & 1) != 0
                y |= torch.where(bit[:, None], rm, 0)
            else:
                hasb = ((v & rm) != 0).any(dim=1)
                y[:, wj] |= hasb.to(torch.int64) << bj
        if sp.tri_gaps:
            # the triangle on its word window, zero-filled at its edges
            lo, hi = sp.tri_win
            vs = v[:, lo:hi]
            Eb = tab[self._t0, lo:hi]
            if rev:
                # exit q receives any target p with p > q + g: each family's
                # suffix-OR, shifted down by its gap
                fams = tab[self._t0 + 1 : self._t0 + 1 + len(sp.tri_gaps), lo:hi]
                acc = Eb & self.tri_r.apply(_suffix_excl(vs[:, None, :] & fams))
            else:
                # target p receives any exit q with q < p - g
                acc = self.tri_f.apply(_prefix_excl(vs & Eb))
            y[:, lo:hi] |= acc
        return y

    def flags(self, v: torch.Tensor) -> torch.Tensor:
        """[R, C] bool accept flags (static words where the JAX scanner
        has them, else the AND + OR-fold of the accept rows)."""
        if self.acc_static is not None:
            cols = []
            for words in self.acc_static:
                f = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
                for w, msk in words:
                    f = f | ((v[:, w] & msk) != 0)
                cols.append(f)
            return torch.stack(cols, dim=1)
        a0 = _acc_off(self.spec)
        return ((v[:, None, :] & self.tf[a0 : a0 + self.C][None]) != 0).any(dim=2)

    # the stepper of scan_bits' span-path plain versions
    def empty(self, R: int, dev) -> torch.Tensor:
        return torch.zeros((R, self.spec.W), dtype=torch.int64, device=dev)

    def step(self, v: torch.Tensor, gate: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """v' = expand(v | gate · seed) & mask[sym]."""
        v = v | torch.where(gate[:, None], self.tf[2], 0)
        return self.expand(v, False) & self.mask(sym)

    def accepts(self, v: torch.Tensor) -> torch.Tensor:
        """[R] bool: the anchored rescan's accept test."""
        if self.anchor_static is not None:
            f = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
            for w, msk in self.anchor_static[0]:
                f = f | ((v[:, w] & msk) != 0)
            return f
        return ((v & self.tf[-1]) != 0).any(dim=1)

    def cleared(self, v: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
        return torch.where(done[:, None], 0, v)

    def rev(self, r: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """R' = expand_rev((R | acc) & mask[sym])."""
        a0 = _acc_off(self.spec)
        return self.expand((r | self.tr[a0]) & self.mask(sym), True)

    def start(self, r: torch.Tensor) -> torch.Tensor:
        """[R] bool: an initial state is in R."""
        return ((r & self.tr[_acc_off(self.spec) + 1]) != 0).any(dim=1)


def stats_plain(data, lengths, tables: BitbandTables, *, seeded: bool, nullable: bool):
    """Plain version of ``rrx_bitband_stats`` (the TPU's
    ``_bitband_match_kernel_b``): a loop over the L + 2 stream steps,
    vectorised over records and accept channels. Returns (cnt, first,
    last, full), each [R, C]. ``tables`` gives the stepper
    (``tables.plain(device)``: ``empty``, ``step``, ``flags``) and ``C``;
    the container tier's tables run the same loop (``scan_sparse``).

    Per step: the seed ORs in at every step when seeded, at steps t < 2
    when not; a channel's flag has end e = min(t, len): cnt counts flags
    whose e differs from the channel's last one (the `$` step's duplicate),
    except for a nullable seeded scan whose cnt is len + 1; first keeps the
    first e, last the latest, full is a flag at t >= len. Nullable starts:
    first = 0, and (seeded) cnt = len + 1, last = len or (unseeded) cnt = 1,
    last = 0; full starts as len == 0."""
    sb._check_inputs(data, lengths)
    R, L = data.shape
    dev = data.device
    i64 = torch.int64
    ln = sb._lengths(data, lengths)
    pt = tables.plain(dev)
    lnc = ln[:, None].expand(R, tables.C)
    v = pt.empty(R, dev)
    if nullable:
        cnt = lnc + 1 if seeded else torch.ones_like(lnc)
        last = lnc.clone() if seeded else torch.zeros_like(lnc)
        first = torch.zeros_like(lnc)
        full = lnc == 0
    else:
        cnt = torch.zeros_like(lnc)
        first = torch.full_like(lnc, -1)
        last = torch.full_like(lnc, -1)
        full = torch.zeros_like(lnc, dtype=torch.bool)
    for t in range(L + 2):
        gate = torch.full((R,), seeded or t < 2, dtype=torch.bool, device=dev)
        v = pt.step(v, gate, sb._sym(data, ln, t))
        fl = pt.flags(v)
        e = lnc.clamp(max=t)
        if not (nullable and seeded):
            cnt = cnt + (fl & (e != last)).to(i64)
        first = torch.where(fl & (first < 0), e, first)
        last = torch.where(fl, e, last)
        full = full | (fl & (t >= lnc))
    i32 = torch.int32
    return cnt.to(i32), first.to(i32), last.to(i32), full


def flags_plain(data, lengths, tables: BitbandTables, *, seeded: bool):
    """Plain version of ``rrx_bitband_flags`` (the TPU's
    ``_bitband_flags_kernel_b``): the loop of :func:`stats_plain` keeping
    every step's raw accept flags as flag words [Wt, R * C] int32, bit t of
    column r * C + c in word t // 32 (Wt = ceil((L + 2) / 32)). Steps past
    EOS are dead and flag nothing."""
    sb._check_inputs(data, lengths)
    R, L = data.shape
    dev = data.device
    ln = sb._lengths(data, lengths)
    pt = tables.plain(dev)
    v = pt.empty(R, dev)
    words = torch.zeros((sb.hit_words(L), R * tables.C), dtype=torch.int64, device=dev)
    for t in range(L + 2):
        gate = torch.full((R,), seeded or t < 2, dtype=torch.bool, device=dev)
        v = pt.step(v, gate, sb._sym(data, ln, t))
        words[t >> 5] |= pt.flags(v).reshape(-1).to(torch.int64) << (t & 31)
    return sb._as_i32(words)


# ---------------------------------------------------------------------------
# Counted launchers
# ---------------------------------------------------------------------------


def _launch(entry: str, data, lengths, tables: BitbandTables, tab: torch.Tensor, live,
            *tail) -> None:
    """Launch ``entry`` with the bitband head (table, meta, W, rows) and
    ``live``: None, or a [1] int32 tensor on the card, the record count
    past which every record returns at once, its outputs unwritten (the
    prefilter's compacted and full passes: ``ScanEngine._prefilter_apply``)."""
    if live is not None and (live.dtype != torch.int32 or live.numel() != 1):
        raise ValueError(f"live must be a [1] int32 tensor, got {tuple(live.shape)} {live.dtype}")
    sb.launch(entry, data, lengths, tab, tables.meta, int(tables.spec.W),
              int(tab.numel() // tables.spec.W), live, *tail)


def bitband_stats(data, lengths, tables: BitbandTables, *, seeded: bool, nullable: bool,
                  live=None):
    """(cnt, first, last, full), each [R, C] (``rrx_bitband_stats`` on a
    CUDA tensor, counted in ``bitband_stats.launches``; :func:`stats_plain`
    on a CPU tensor)."""
    if data.device.type == "cpu":
        return stats_plain(data, lengths, tables, seeded=seeded, nullable=nullable)
    R, dev = data.shape[0], data.device
    outs = [torch.empty((R, tables.C), dtype=torch.int32, device=dev) for _ in range(3)]
    full = torch.empty((R, tables.C), dtype=torch.uint8, device=dev)
    _launch("rrx_bitband_stats", data, lengths, tables, tables.tab_f, live, int(tables.C),
            int(seeded), int(nullable), *outs, full, *_plan_args(tables.spec))
    bitband_stats.launches += 1
    return (*outs, full.view(torch.bool))


def bitband_flags(data, lengths, tables: BitbandTables, *, seeded: bool, live=None):
    """Flag words [Wt, R * C] int32 (``rrx_bitband_flags`` on a CUDA
    tensor, counted; :func:`flags_plain` on a CPU tensor). The kernel runs
    the stats kernel's register step and takes the spec's offsets and gaps
    as it does."""
    if data.device.type == "cpu":
        return flags_plain(data, lengths, tables, seeded=seeded)
    R, L = data.shape
    words = torch.empty((sb.hit_words(L), R * tables.C), dtype=torch.int32, device=data.device)
    _launch("rrx_bitband_flags", data, lengths, tables, tables.tab_f, live, int(tables.C),
            int(seeded), words, *_plan_args(tables.spec))
    bitband_flags.launches += 1
    return words


def _plan_args(spec: BitbandSpec) -> tuple:
    """The register steps' plan arguments: the spec's diagonal offsets and
    triangle gaps as counts and host int arrays of MAX_DIAGS and
    MAX_TRI_FAMILIES (the launcher's reg_plan takes them)."""
    return (len(spec.diags), (ctypes.c_int * MAX_DIAGS)(*spec.diags), len(spec.tri_gaps),
            (ctypes.c_int * MAX_TRI_FAMILIES)(*spec.tri_gaps))


def bitband_reverse(data, lengths, tables: BitbandTables, live=None):
    """Hit words [Wt, R] int32 (``rrx_bitband_reverse`` on a CUDA tensor,
    counted; ``scan_bits.reverse_plain`` on the bitband stepper for a CPU
    tensor). The kernel reads the E rows after the reverse table
    (:func:`with_e_rows`) and the spec's offsets and gaps."""
    if data.device.type == "cpu":
        return sb.reverse_plain(data, lengths, tables)
    sp = tables.spec
    if tables.tab_r.numel() != (_rev_rows(sp) + 3 + len(sp.runs)) * sp.W:
        raise ValueError("rrx_bitband_reverse reads the E rows after the reverse table: "
                         "build the tables with device_bitband_tables or with_e_rows")
    R, L = data.shape
    hits = torch.empty((sb.hit_words(L), R), dtype=torch.int32, device=data.device)
    # the record counter the kernel's warps take work from
    next_rec = torch.zeros(1, dtype=torch.int32, device=data.device)
    _launch("rrx_bitband_reverse", data, lengths, tables, tables.tab_r, live, hits, next_rec,
            *_plan_args(sp))
    bitband_reverse.launches += 1
    return hits


def bitband_anchor_end(data, lengths, tables: BitbandTables, starts, *, longest: bool,
                       live=None):
    """End [R] int32 of the anchored rescan from ``starts`` (-1 =
    inactive): the first (lazy) or last (``longest``) accepting end
    (``rrx_bitband_anchor_end`` on a CUDA tensor, counted;
    ``scan_bits.anchor_plain`` for a CPU tensor)."""
    if data.device.type == "cpu":
        return sb.anchor_plain(data, lengths, tables, starts, longest=longest)
    sb._check_rows("starts", starts, data, (torch.int32, torch.int64))
    end = torch.empty(data.shape[0], dtype=torch.int32, device=data.device)
    _launch("rrx_bitband_anchor_end", data, lengths, tables, tables.tab_f, live,
            starts.to(torch.int32).contiguous(), int(longest), end)
    bitband_anchor_end.launches += 1
    return end


def bitband_spans(data, lengths, tables: BitbandTables, hits, cap: int, *, longest: bool,
                  live=None):
    """(starts [R, cap], ends [R, cap], cnt [R], over [R] bool): the span
    rounds of the TPU's ``_bb_spans_call`` (first start s >= pos from the
    hit words, the anchored lazy or longest end e from s, emit if e >= s,
    pos = max(e, s + 1), at most cap rounds; over = still going after
    them), in each record's own warp (``rrx_bitband_spans`` on a CUDA
    tensor, counted; ``scan_bits.greedy_spans_plain`` for a CPU tensor)."""
    if data.device.type == "cpu":
        return sb.greedy_spans_plain(data, lengths, tables, hits, cap, longest=longest)
    sb._check_hits(hits, data)
    sb._check_cap(cap)
    R = data.shape[0]
    starts, ends, cnt = sb._span_buffers(R, cap, data.device)
    over = torch.empty(R, dtype=torch.uint8, device=data.device)
    _launch("rrx_bitband_spans", data, lengths, tables, tables.tab_f, live, hits.contiguous(),
            int(cap), int(longest), starts, ends, cnt, over)
    bitband_spans.launches += 1
    return starts, ends, cnt, over.view(torch.bool)


for _w in (bitband_stats, bitband_flags, bitband_reverse, bitband_anchor_end, bitband_spans):
    _w.launches = 0


# ---------------------------------------------------------------------------
# Scanner
# ---------------------------------------------------------------------------


class BitbandScanner(_Scanner):
    """Match statistics, forward flags, reverse hits, anchored rescans and
    lazy and greedy spans of a multiblock or sparse program whose follow
    matrix decomposes (``bitband_spec``), on ``device``: the CUDA kernels
    of ``csrc/scan_bitband.cu`` on a CUDA device, their plain PyTorch
    versions on the CPU. Named after the JAX package's scanner of the same
    methods and outputs.

    ``accept_map`` ([lanes, C] 0/1) gives the scan C accept channels:
    ``match_stats_b`` and ``forward_flags_b`` then return per-channel
    results and the primitives that read one accept set raise.
    ``has_anchor`` (one channel, not nullable) enables the anchored rescans
    and the span rounds, as in the JAX scanner. There is no window plan
    (``byte_window_ok`` is False: the JAX ``SparseScanner``'s).

    The stream-fed methods ``match_stats``, ``forward_flags`` and
    ``reverse_hits`` (a mask stream in place of bytes) run on the container
    kernels, as the JAX ``BitbandScanner`` inherits them from its
    ``SparseScanner``: ``scan_sparse.StreamMethods``'s, on the program's
    container tables, built at the first stream call (the byte route pays
    nothing for them)."""

    byte_window_ok = False
    CHANNEL_METHODS = "match_stats_b and forward_flags_b"

    def __init__(self, prog: DeviceProgram, device, spec: BitbandSpec, accept_map=None,
                 nullable=None):
        super().__init__(prog, device, nullable)
        self.bspec = spec
        self.tables = device_bitband_tables(prog, spec, self.device, accept_map)
        self.channels = accept_map is not None
        self.P = self.tables.C
        self.acc_static = self.tables.acc_static
        self._anchor_acc_static = self.tables.anchor_static
        self.has_anchor = self.tables.C == 1 and not self.nullable
        self._sparse = None  # the container tables of the stream-fed methods

    def _anchored(self, what: str) -> None:
        self._one_channel(what)
        if not self.has_anchor:
            raise ValueError(f"{what}: the bitband span rounds run only for a non-nullable "
                             f"program ({self.prog.pattern!r} is nullable)")

    def match_stats_b(self, data, len_g, *, seeded: bool, lead: int = 0, live=None):
        """(cnt, first, last, full, any), each [B, C] (C = 1 without an
        accept map). There is no windowed mode (``lead`` must be 0).
        ``live`` (every method): see ``_launch``; the plain versions ignore
        it."""
        if lead:
            raise ValueError("the bitband tier has no windowed mode (lead must be 0)")
        data, len_g, lengths = self._batch(data, len_g)
        cnt, first, last, full = bitband_stats(data, lengths, self.tables, seeded=seeded,
                                               nullable=self.nullable, live=live)
        return cnt, first, last, full, cnt > 0

    def forward_flags_b(self, data, len_g, *, seeded: bool, live=None):
        """[B * C, T + 1] bool accept flags (record-major, channel-minor),
        T = L + 2: column 0 is the program's nullability, column t + 1 the
        flag of step t."""
        data, _, lengths = self._batch(data, len_g)
        words = bitband_flags(data, lengths, self.tables, seeded=seeded, live=live)
        return _with_flag0(sb.hit_bits(words, data.shape[1] + 2), self.prog.nullable)

    def flags_words_b(self, data, len_g, *, seeded: bool, live=None):
        """([B, Wt] int32 words, T = L + 2): bit t = step t's accept flag."""
        self._one_channel("flags_words_b")
        data, _, lengths = self._batch(data, len_g)
        words = bitband_flags(data, lengths, self.tables, seeded=seeded, live=live)
        return words.T, data.shape[1] + 2

    def hits_words_b(self, data, len_g, live=None):
        """([B, Wt] int32 words, T = L + 2): bit t = reverse start hit at
        step t (a match can start at max(t - 1, 0))."""
        self._one_channel("hits_words_b")
        data, _, lengths = self._batch(data, len_g)
        return bitband_reverse(data, lengths, self.tables, live).T, data.shape[1] + 2

    def reverse_hits_b(self, data, len_g, live=None):
        """[B, L + 2] bool candidate-start hits."""
        words, T = self.hits_words_b(data, len_g, live)
        return sb.hit_bits(words.T, T)

    def anchor_end_b(self, data, len_g, starts_g, *, longest: bool, live=None):
        """Anchored-rescan end per record, shaped like ``len_g``."""
        self._anchored("anchor_end_b")
        data, len_g, lengths = self._batch(data, len_g)
        starts = torch.as_tensor(starts_g, device=self.device).reshape(-1).to(torch.int32)
        end = bitband_anchor_end(data, lengths, self.tables, starts, longest=longest, live=live)
        return end.reshape(len_g.shape)

    def _spans(self, data, len_g, cap: int, longest: bool, live):
        data, _, lengths = self._batch(data, len_g)
        hits = bitband_reverse(data, lengths, self.tables, live)
        return bitband_spans(data, lengths, self.tables, hits, cap, longest=longest, live=live)

    def lazy_spans_b(self, data, len_g, *, cap: int, live=None):
        """(starts [B, cap], ends [B, cap], cnt [B]): lazy spans in rounds,
        -1 past the count; cnt <= cap (the rounds stop at cap)."""
        self._anchored("lazy_spans_b")
        s, e, c, _ = self._spans(data, len_g, cap, False, live)
        return s, e, c

    def greedy_spans_b(self, data, len_g, *, cap: int, live=None):
        """(starts, ends, cnt, over): greedy (leftmost-longest) spans;
        ``over`` = still going after cap rounds."""
        self._anchored("greedy_spans_b")
        return self._spans(data, len_g, cap, True, live)

    # -- stream-fed methods: the container kernels (scan_sparse.StreamMethods)
    def _stream_tables(self):
        if self._sparse is None:
            from .scan_sparse import device_sparse_tables

            self._sparse = device_sparse_tables(self.prog, self.device)
        return self._sparse

    def match_stats(self, words, len_g, *, seeded: bool):
        """(cnt, first, any) of the mask stream, each shaped like ``len_g``."""
        from .scan_sparse import StreamMethods

        return StreamMethods.match_stats(self, words, len_g, seeded=seeded)

    def forward_flags(self, words, *, seeded: bool):
        """[B, T + 1] bool accept flags of the mask stream; column 0 is the
        program's nullability."""
        from .scan_sparse import StreamMethods

        return StreamMethods.forward_flags(self, words, seeded=seeded)

    def reverse_hits(self, words):
        """[B, T] bool: column j is set iff some match starts at max(j - 1,
        0)."""
        from .scan_sparse import StreamMethods

        return StreamMethods.reverse_hits(self, words)
