"""Matmul tier (dense programs of up to 1024 states) and counting tier.

The port of ``roaringregex_tpu/ops/scan_pallas.py``'s byte path
(``_add_byte_path``): match statistics, forward accept flags, reverse
start hits, anchored rescans, and lazy and greedy spans; and of its
``CountScanner`` (the run-length tier, at the end of this module: see
:class:`CountScanner`). Every dense program that the SWAR and
u32-word specs reject runs here (33..256 states: the dense128 and dense256
tiers), and so do the SWAR tier's nullable spans and nullable windowed
scans and the u32-word tier's spans and windowed scans, as in the JAX
package, whose ``SwarScanner`` and ``WordScanner`` subclass
``PallasScanner``; so does every multiblock program (257..1024 states)
that the engine keeps on the dense multiblock matmul (banded or not: the
TPU's ``diag_ks`` form is a layout of the same step; the wide window
kernels' flags, count and reverse and the wide record kernels' flags,
reverse and reverse_mb take its diagonals as lane shifts,
:func:`band_split`).

On the TPU one step is ``y = F_bdᵀ·v (+ c0)`` in bf16 on the MXU over G
records packed into 128 or 256 lanes, ``v = y ∘ mask(byte)``, with a
boolean renorm once per slab. In set form the same step of one record is

    y = OR of follow[s] over s in v  |  (seed gate ? follow[0] : 0)
    v = y & mask[sym]

and the reverse (candidate-start) step is

    R = OR of pred[u] over u in (R | acc) & mask[sym];   hit = 0 in R

with ``sym`` a byte (0..255), 256 = BOS, 257 = EOS, 258 = a dead step past
EOS. :func:`nfa_tables` builds one record tile's rows as u32 bit words
(``W = ceil(s_tile / 32)`` <= 32 words per row) from ``prog.F``,
``prog.Bc_words`` and ``prog.byte_class``. For tiles of up to
``REG_S_TILE`` = 256 states (W <= 8 words) the CUDA kernels of
``csrc/scan_nfa.cu`` keep a record's state set in registers and the whole
table in shared memory, one thread per record; for tiles of 257..1024
states (W = 12..32) those of ``csrc/scan_nfa_wide.cu`` run one warp per
record, lane l holding state word l, with one direction's rows (follow or
pred) in shared memory. The wrappers below pick the form by ``s_tile``.
Forward flags travel as flag
words in the layout of the hit words (``scan_bits``): [W, R] int32, bit t
of record r in word t // 32; ``flags_words_b`` and ``hits_words_b`` hand
them out transposed, as the TPU's bit-packed producers do, and their first
L + 2 bits are ``forward_flags_b``'s and ``reverse_hits_b``'s (the TPU's
words path, which needs a slab unroll that divides 32, always applies
here). The TPU's packing (G records per
lane block, the block-diagonal ``F_bd``, ``cls_spec``'s mask-by-matmul,
the banded ``dks`` form, the bf16 counts) is a layout of this same
function: the parity boundary is the scanner methods' outputs. Only the
diagonals have a counterpart here, in the band split of the wide window
and record kernels (:func:`band_split`).

The plain PyTorch versions hold a state set as a [R, s_tile] bool plane
and step it with a 0/1 float32 product (exact: every sum is at most 1024,
under float32's 2^24),
so they need no uint32 arithmetic; the table words are unpacked through
int64 masked to 32 bits. The match-statistics and flags versions are
here; the span path's (reverse, anchored rescan, lazy and greedy spans) are
``scan_bits``'s, which run on this tier's stepper (``NfaTables.plain``).

A multi-pattern program (``MultiPattern``'s combined automaton, the
patterns' positions disjoint) carries P accept rows, one per pattern:
``match_stats_b`` reduces per channel, and ``lazy_spans_mb`` runs one
reverse pass and one span pass for all P patterns (``rrx_nfa_reverse_mb``,
``rrx_nfa_lazy_spans_mb`` up to 256 states; ``rrx_nfa_wide_reverse_mb``,
``rrx_nfa_wide_lazy_spans_mb`` at 257..1024, one warp per record, lane p
keeping channel p's bookkeeping). The long-string window kernels (one long
string, ``ops/longstring.py``) likewise run ``csrc/scan_long.cu`` up to 256
states and ``csrc/scan_long_wide.cu`` (one warp per window) past them. The
scanner's stream-fed methods (``match_stats``, ``forward_flags``,
``reverse_hits``, ``first_end_from``: the JAX ``PallasScanner``'s methods
over a precomputed mask stream) run ``scan_packed``'s primitives on the
same tables, on the kernels of ``csrc/scan_stream.cu``. Not ported:
K-chaining (``chain_target``, off by default).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..compiler.program import DeviceProgram
from . import scan_bits as sb

N_SYMS = sb.N_SYMS
MAX_S_TILE = 1024  # 32 state words: one per lane of a warp (scan_nfa_wide.cu)
REG_S_TILE = 256  # the widest tile whose state set scan_nfa.cu keeps in 8 registers
# accept channels whose per-record bookkeeping the multi-channel kernels
# keep in registers; above it, in per-thread rows of global scratch
MB_REG_CHANNELS = 8
# the same for the wide multi-channel kernels: lane p of the record's warp
# keeps channel p's
WIDE_REG_CHANNELS = 32
# scan_nfa_wide.cu: warps of a block, and the shared memory a block may have
WIDE_WARPS = 32
WIDE_SMEM_LIMIT = 232448
# the JAX package's default of ``banded_max_diags`` (RRX_BANDED_MAX_DIAGS):
# the most diagonals a band split keeps (the wide window kernels hold each
# in a register), also read by the engine's multiblock routing rule
BANDED_MAX_DIAGS = 8


class NfaTables(NamedTuple):
    """Device copy of one record tile's rows: [(2 S + N_SYMS + P) * W]
    int32 (uint32 bit patterns): follow [S][W], pred [S][W], mask
    [N_SYMS][W], acc [P][W]. Without an accept map P = 1 and the acc row
    is the program's accept set; with one (``channels``) row p is accept
    channel p's."""

    tab: torch.Tensor
    s_tile: int
    P: int = 1
    channels: bool = False
    # past REG_S_TILE states, set by :func:`with_band`: the band split of
    # the follow rows for the wide window kernels' flags, count and reverse
    # (:func:`band_table`), its offsets, and the lanes of a warp that step
    # one window or record (16 where W <= 16: two a warp); then the wide
    # record reverses' split (reverse and reverse_mb) and its offsets, the
    # record flags' split and its offsets, and whether the dead step's mask
    # row is not zero (the record reverses, which end each record at its
    # EOS step, refuse such tables)
    band: torch.Tensor | None = None
    diags: tuple = ()
    band_lanes: int = 32
    rec_band: torch.Tensor | None = None
    rec_diags: tuple = ()
    fwd_band: torch.Tensor | None = None
    fwd_diags: tuple = ()
    dead_row: bool = False

    def plain(self, dev) -> "_Plain":
        """The stepper of the plain versions on ``dev``."""
        return _Plain.of(self, dev)


def _words(s_tile: int) -> int:
    return -(-s_tile // 32)


def _pack_rows(bits: np.ndarray, W: int) -> np.ndarray:
    """[n, S] 0/1 -> [n, W] uint32, bit s of row i in word s // 32."""
    n, S = bits.shape
    out = np.zeros((n, W), np.uint64)
    for s in range(S):
        out[:, s // 32] |= bits[:, s].astype(np.uint64) << np.uint64(s % 32)
    return out.astype(np.uint32)


def _unpack_rows(rows: np.ndarray, S: int) -> np.ndarray:
    """[n, W] uint32 -> [n, S] bool: the inverse of :func:`_pack_rows`."""
    bits = (rows[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(rows.shape[0], -1)[:, :S] != 0


def nfa_tables(prog: DeviceProgram, accept_map=None, P: int = 1) -> np.ndarray:
    """[2 S + N_SYMS + P, W] uint32 rows of one record tile (S = s_tile):
    follow[s] (the states that follow s), pred[u] (the states that u
    follows: the transpose, for the reverse pass), mask[sym] for the 259
    symbols (bytes >= 0x80, whose class is dead, and the dead step have
    zero rows; BOS and EOS are rows of their own, never bytes), then the
    accept rows: the program's accept set, or with ``accept_map`` ([lanes,
    G * P] 0/1, the first record tile's rows s < S) one row per channel.
    The initial state is bit 0."""
    S = prog.s_tile
    if prog.F is None or not 1 <= S <= MAX_S_TILE:
        raise ValueError(f"{prog.pattern!r}: s_tile {S} ({prog.tier}) has no matmul-tier tables")
    W = _words(S)
    F = np.asarray(prog.F[:S, :S]) != 0
    Bw = np.asarray(prog.Bc_words, np.uint32)  # [c_pad, W]
    mask = np.zeros((N_SYMS, W), np.uint32)
    mask[:256] = Bw[np.asarray(prog.byte_class)]
    mask[0x80:256] = 0
    mask[sb.SYM_BOS] = Bw[prog.bos_class]
    mask[sb.SYM_EOS] = Bw[prog.eos_class]
    if accept_map is None:
        acc = _pack_rows((np.asarray(prog.accept)[:S] != 0)[None, :], W)
    else:
        acc = _pack_rows((np.asarray(accept_map)[:S, :P] != 0).T, W)
    return np.concatenate([_pack_rows(F, W), _pack_rows(F.T, W), mask, acc])


def device_nfa_tables(prog: DeviceProgram, device, accept_map=None, P: int = 1) -> NfaTables:
    """The tile's rows on ``device`` and, past ``REG_S_TILE`` states, the
    band split of its follow rows (:func:`with_band`)."""
    tab = nfa_tables(prog, accept_map, P)
    tables = NfaTables(torch.from_numpy(tab.reshape(-1).view(np.int32).copy()).to(device),
                       prog.s_tile, P if accept_map is not None else 1, accept_map is not None)
    return with_band(tables, rows=tab) if prog.s_tile > REG_S_TILE else tables


def span_channels(sgm, posm, P: int, s_tile: int) -> np.ndarray:
    """[P, 2, W] uint32 span-channel rows of the first record tile from
    ``MultiPattern``'s tables (``sgm`` [G * P, lanes]: follow[0] restricted
    to pattern p's positions; ``posm`` [lanes, P]: pattern p's positions).
    In set form one row per channel serves the TPU's ``sgm`` and ``c0m``
    alike: both are follow[0] restricted to pattern p's positions (``c0m =
    c0 * posm``, ``c0`` = follow[0]), the reverse pass's candidate-start
    projection and the span pass's seed. The second row is ``posm``, the
    kill mask of an emitted channel's threads."""
    S, W = s_tile, _words(s_tile)
    sg = _pack_rows(np.asarray(sgm)[:P, :S] != 0, W)
    pm = _pack_rows(np.asarray(posm)[:S, :P].T != 0, W)
    return np.stack([sg, pm], axis=1)


def counting_plan(prog: DeviceProgram):
    """The JAX package's run-length plan of ``X{m,n}`` with a fixed-length
    body (``roaringregex_tpu/ops/scan_pallas.py`` ``counting_plan``,
    unchanged, on the port's parser): ``(m, n_or_0, branches)``, or None
    for another shape. ``branches`` holds R <= 4 branch bodies of one
    length k <= 8, each a tuple of per-position byte-run tuples. The engine
    sends such programs of one record per row to :class:`CountScanner`."""
    from ..compiler.parser import BOS, EOS, Alt, Concat, Lit, Repeat, parse

    try:
        node = parse(prog.pattern)
    except Exception:
        return None
    while isinstance(node, Concat) and len(node.parts) == 1:
        node = node.parts[0]
    if not isinstance(node, Repeat):
        return None
    child = node.child
    while isinstance(child, Concat) and len(child.parts) == 1:
        child = child.parts[0]
    alts = list(child.parts) if isinstance(child, Alt) else [child]
    if not 1 <= len(alts) <= 4:
        return None

    def branch_body(b):
        while isinstance(b, Concat) and len(b.parts) == 1:
            b = b.parts[0]
        parts = list(b.parts) if isinstance(b, Concat) else [b]
        if not 1 <= len(parts) <= 8:
            return None
        body = []
        for p in parts:
            while isinstance(p, Concat) and len(p.parts) == 1:
                p = p.parts[0]
            if not isinstance(p, Lit):
                return None
            syms = p.syms
            if BOS in syms or EOS in syms:
                return None
            bs = sorted(syms)
            runs = []
            lo = prev = bs[0]
            for b2 in bs[1:]:
                if b2 == prev + 1:
                    prev = b2
                else:
                    runs.append((lo, prev))
                    lo = prev = b2
            runs.append((lo, prev))
            body.append(tuple(runs))
        return tuple(body)

    branches = []
    for a in alts:
        bb = branch_body(a)
        if bb is None:
            return None
        branches.append(bb)
    k = len(branches[0])
    if any(len(b) != k for b in branches[1:]):
        return None  # unequal branch lengths: stride-k chain breaks
    branches = tuple(dict.fromkeys(branches))  # dedup identical branches
    if k == 1:
        # single-position branches are one merged class (OR of runs)
        branches = (tuple(r for b in branches for r in b[0]),)
        branches = ((branches[0],),)
    n = 0 if node.hi is None else int(node.hi)
    return int(node.lo), n, branches


def banded_offsets(ft: np.ndarray, max_diags: int):
    """Nonzero diagonal offsets of a transposed follow matrix (the JAX
    package's ``banded_offsets``, unchanged), or None if there are more
    than ``max_diags`` (or none at all). Offset d means y[i] += ft[i, i-d]
    * v[i-d]. The engine's multiblock routing rule reads this
    (``ScanEngine._multiblock_container_wins``); the port's own diagonal
    form is :func:`band_split`'s."""
    if max_diags <= 0:
        return None
    ii, jj = np.nonzero(np.asarray(ft))
    if ii.size == 0:
        return None
    ks = sorted(set(int(d) for d in (ii - jj)))
    return tuple(ks) if len(ks) <= max_diags else None


class BandSplit(NamedTuple):
    """A follow matrix split into diagonals and a residual: every edge s ->
    s + d lies on exactly one kept diagonal d or in the residual rows."""

    offsets: tuple  # the kept offsets d = dst - src, ascending
    diags: np.ndarray  # [nd, W] uint32: bit s of row k set iff s -> s + offsets[k]
    follow: np.ndarray  # [S, W] uint32: the residual follow rows
    pred: np.ndarray  # [S, W] uint32: their transpose (the residual pred rows)


def band_split(F: np.ndarray, max_diags: int = BANDED_MAX_DIAGS) -> BandSplit:
    """The band split of one tile's [S, S] follow matrix (F[s, u]: u
    follows s), ``bitband_spec``'s diagonal rule (``scan_bitband.py``): the
    offsets d = u - s that carry at least max(8, n // 8) edges, row 0 (the
    seed row) counted like any other, the most populated first, at most
    ``max_diags`` (0: every edge in the residual); n is the program's
    states, 1 + the highest state an edge touches. The diagonals become
    lane shifts of the state words in the wide window kernels, the rest is
    walked (``csrc/scan_nfa_wide.cuh`` ``Band``); the TPU's banded form
    (``banded_offsets``) keeps every diagonal or none."""
    F = np.asarray(F) != 0
    S = F.shape[0]
    W = _words(S)
    src, dst = np.nonzero(F)
    d_all = dst - src
    offsets: tuple = ()
    if src.size and max_diags > 0:
        n = int(max(src.max(), dst.max())) + 1
        offs, cnt = np.unique(d_all, return_counts=True)
        keep = cnt >= max(8, n // 8)
        order = sorted(zip(-cnt[keep], offs[keep]))[:max_diags]
        offsets = tuple(sorted(int(d) for _, d in order))
    on = np.isin(d_all, offsets)
    diags = np.zeros((len(offsets), S), bool)
    for k, d in enumerate(offsets):
        diags[k, src[on & (d_all == d)]] = True
    R = np.zeros((S, S), bool)
    R[src[~on], dst[~on]] = True
    return BandSplit(offsets, _pack_rows(diags, W), _pack_rows(R, W), _pack_rows(R.T, W))


def band_table(split: BandSplit) -> np.ndarray:
    """[(2 BANDED_MAX_DIAGS + 3) W + 2 S W] uint32, the device layout the band
    kernels read (``scan_long_wide.cu``): the diagonals' source masks and
    their destination masks (the sources moved by the offset), each
    BANDED_MAX_DIAGS rows, zero past nd; the states s >= 1 with a nonzero
    residual follow row, the states with a residual in-edge from some s >=
    1 (one row each); a flag row (word 0, bit 0: an edge enters state 0);
    then the residual follow rows [S][W] without row 0 and their transpose
    [S][W]. The kernels apply the seed row (follow[0]) whole: forward when
    the seed fires or state 0 is live, reverse as state 0's pred test
    (state 0 precedes u iff u is in follow[0]), so row 0's residual is
    never walked."""
    S, W = split.follow.shape
    nd = len(split.offsets)
    if nd > BANDED_MAX_DIAGS:
        raise ValueError(f"{nd} diagonals: the band kernels hold at most {BANDED_MAX_DIAGS}")
    dm = np.zeros((2, BANDED_MAX_DIAGS, S), bool)
    for k, d in enumerate(split.offsets):
        src = np.flatnonzero(_unpack_rows(split.diags[k:k + 1], S)[0])
        dm[0, k, src] = dm[1, k, src + d] = True
    res = _unpack_rows(split.follow, S)
    enter0 = bool(res[:, 0].any()) or any(
        d <= 0 and (int(words[-d // 32]) >> (-d % 32)) & 1
        for d, words in zip(split.offsets, split.diags))
    res[0] = False
    live = _pack_rows(np.stack([res.any(axis=1), res.any(axis=0)]), W)
    flags = np.zeros((1, W), np.uint32)
    flags[0, 0] = int(enter0)
    return np.concatenate([_pack_rows(dm.reshape(-1, S), W), live, flags, _pack_rows(res, W),
                           _pack_rows(res.T, W)]).reshape(-1)


def with_band(tables: NfaTables, max_diags: int | None = None, *, rows=None) -> NfaTables:
    """``tables`` with the band splits of its follow rows on their device
    (``rows``: the host rows of ``nfa_tables``, else read back from the
    device), for the wide window kernels' flags, count and reverse and the
    wide record kernels' stats, flags, reverse, reverse_mb and
    lazy_spans_mb (tiles past ``REG_S_TILE`` states). A tile of at most 16
    state words runs two windows a warp, one on each half, and so do the
    record flags and the one-channel record stats (the record reverses and
    the multi-channel kernels: one record a warp).

    ``max_diags`` None: the window kernels keep the diagonals of
    ``band_split`` where they carry at least half the edges outside the
    seed row (keyword lists and runs carry all, an optional suffix after
    them most); otherwise they walk every edge. Where the residual holds
    most edges, the walk runs anyway and the diagonals' shifts come on top
    of it, not in its place (x(ab|c){300,340}y: 35% on four diagonals, its
    count slower with them than with every edge walked; K60 with an
    optional suffix, 75% on one, 3x faster with it; ``PERF.md``). The
    record reverses keep every diagonal ``band_split`` finds (the record
    reverse of K60+, 10% of its edges on one, 1.6x faster with it;
    ``PERF.md``). The record flags keep it where it is one diagonal
    (keyword lists, runs: K60+'s flags 2.1x faster with it) and walk every
    edge where it is several (the copies of a counted repetition: the
    forward set of x(ab|c){300,}y is one thread through them, which is
    cheaper to walk than four diagonals are to shift; ``PERF.md``); the
    record stats and lazy_spans_mb, which step forward as the flags do,
    read the flags' split. An int forces that split on all three.

    The record reverse ends each record at its EOS step, where the plain
    reverse walks on over the dead steps past it: ``dead_row`` records
    whether the dead step's mask row is not zero (``nfa_tables`` builds it
    zero), and ``nfa_reverse`` refuses such tables. The record flags need
    no zero row: they set no flag bit past a record's EOS step."""
    S, W = tables.s_tile, _words(tables.s_tile)
    if rows is None:
        rows = tables.tab.cpu().numpy().view(np.uint32).reshape(-1, W)
    rows = np.asarray(rows, np.uint32)
    F = _unpack_rows(rows[:S], S)
    rec = split = fwd = band_split(F, BANDED_MAX_DIAGS if max_diags is None else max_diags)
    if max_diags is None:
        walk_all = band_split(F, 0)
        if 2 * int(_unpack_rows(split.follow[1:], S).sum()) > int(F[1:].sum()):
            split = walk_all
        if len(rec.offsets) > 1:
            fwd = walk_all
    tabs: dict = {}  # a split is fixed by its offsets: one device table each

    def on_device(sp: BandSplit) -> torch.Tensor:
        if sp.offsets not in tabs:
            tabs[sp.offsets] = torch.from_numpy(
                band_table(sp).view(np.int32).copy()).to(tables.tab.device)
        return tabs[sp.offsets]

    return tables._replace(band=on_device(split), diags=split.offsets,
                           band_lanes=16 if W <= 16 else 32, rec_band=on_device(rec),
                           rec_diags=rec.offsets, fwd_band=on_device(fwd),
                           fwd_diags=fwd.offsets,
                           dead_row=bool(rows[2 * S + sb.SYM_DEAD].any()))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _bit_rows(words: torch.Tensor, S: int) -> torch.Tensor:
    """[n, W] int64 words (uint32 bit patterns) -> [n, S] bool."""
    sh = torch.arange(32, dtype=torch.int64, device=words.device)
    return ((words[:, :, None] >> sh) & 1).reshape(words.shape[0], -1)[:, :S] != 0


class _Plain(NamedTuple):
    """One tile's rows as 0/1 planes: F [S, S] float32 (F[s, u] = u
    follows s), P [S, S] float32 (P[u, s] = u follows s), f0 [S] bool
    (follow[0]), M [N_SYMS, S] bool, acc [S] bool (the union of the accept
    rows), accs [P, S] bool (one row per accept channel)."""

    F: torch.Tensor
    P: torch.Tensor
    f0: torch.Tensor
    M: torch.Tensor
    acc: torch.Tensor
    accs: torch.Tensor

    @classmethod
    def of(cls, tables: NfaTables, dev) -> "_Plain":
        S, W = tables.s_tile, _words(tables.s_tile)
        words = (tables.tab.to(dev).to(torch.int64) & sb.MASK32).reshape(-1, W)
        bits = _bit_rows(words, S)
        F, P = bits[:S], bits[S : 2 * S]
        accs = bits[2 * S + N_SYMS :]
        return cls(F.to(torch.float32), P.to(torch.float32), F[0],
                   bits[2 * S : 2 * S + N_SYMS], accs.any(dim=0), accs)

    def empty(self, R: int, dev) -> torch.Tensor:
        return torch.zeros((R, self.F.shape[0]), dtype=torch.bool, device=dev)

    def step(self, v: torch.Tensor, gate: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """v' = (OR of follow[s] over s in v | gate · follow[0]) & mask[sym]."""
        y = (v.to(torch.float32) @ self.F) > 0
        return (y | (gate[:, None] & self.f0)) & self.M[sym]

    def accepts(self, v: torch.Tensor) -> torch.Tensor:
        return (v & self.acc).any(dim=1)

    def cleared(self, v: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
        return v & ~done[:, None]

    def rev(self, r: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """R' = OR of pred[u] over u in (R | acc) & mask[sym]."""
        m = (r | self.acc) & self.M[sym]
        return (m.to(torch.float32) @ self.P) > 0

    def start(self, r: torch.Tensor) -> torch.Tensor:
        """[R] bool: the initial state is in R."""
        return r[:, 0]


def stats_plain(data, lengths, tables: NfaTables, *, seeded: bool, lead: int,
                nullable: bool):
    """Plain version of ``rrx_nfa_stats``, in the order of the TPU's
    ``_match_kernel_b``: a loop over the L + 2 stream steps, vectorised over
    records and accept channels. Returns (cnt, first, last, full), each
    [R, P] for tables with accept channels and [R] for one channel.

    Per step: the seed gate is every step when seeded, steps t < n_seed = 2
    when not; a channel's accept flag counts only past ``lead``; its end is
    e = min(t, len); cnt counts flags whose e differs from the channel's
    last one (the `$` step's duplicate of e == len), except for a nullable
    seeded scan whose cnt is len + 1 from the start; first keeps the first
    e, last the latest, full is a flag at t >= len. Nullable starts: first
    = 0, and (seeded) cnt = len + 1, last = len or (unseeded) cnt = 1, last
    = 0; full starts as len == 0."""
    sb._check_inputs(data, lengths)
    R, L = data.shape
    dev = data.device
    i64 = torch.int64
    ln = sb._lengths(data, lengths)
    pt = _Plain.of(tables, dev)
    accs = pt.accs.to(torch.float32).T  # [S, P]
    lnc = ln[:, None].expand(R, accs.shape[1])
    lead = lead if lead > 0 else -1
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
        fl = ((v.to(torch.float32) @ accs) > 0) & (t > lead)
        e = lnc.clamp(max=t)
        if not (nullable and seeded):
            cnt = cnt + (fl & (e != last)).to(i64)
        first = torch.where(fl & (first < 0), e, first)
        last = torch.where(fl, e, last)
        full = full | (fl & (t >= lnc))
    i32 = torch.int32
    out = (cnt.to(i32), first.to(i32), last.to(i32), full)
    return out if tables.channels else tuple(x[:, 0].contiguous() for x in out)


def flags_plain(data, lengths, tables: NfaTables, *, seeded: bool):
    """Plain version of ``rrx_nfa_flags`` (the TPU's ``_flags_kernel_b``):
    the loop of :func:`stats_plain` with its seed gate, keeping the raw
    accept flag of every step (no lead, no `$` dedup) as flag words [W, R]
    int32, bit t of record r in word t // 32. Steps past EOS are dead and
    flag nothing."""
    sb._check_inputs(data, lengths)
    R, L = data.shape
    dev = data.device
    ln = sb._lengths(data, lengths)
    pt = tables.plain(dev)
    v = pt.empty(R, dev)
    words = torch.zeros((sb.hit_words(L), R), dtype=torch.int64, device=dev)
    for t in range(L + 2):
        gate = torch.full((R,), seeded or t < 2, dtype=torch.bool, device=dev)
        v = pt.step(v, gate, sb._sym(data, ln, t))
        words[t >> 5] |= pt.accepts(v).to(torch.int64) << (t & 31)
    return sb._as_i32(words)


def _span_planes(span: torch.Tensor, S: int):
    """[P, 2, W] span-channel rows -> (sg [P, S] bool, posm [P, S] bool)."""
    P, _, W = span.shape
    bits = _bit_rows(span.to(torch.int64).reshape(-1, W) & sb.MASK32, S).reshape(P, 2, S)
    return bits[:, 0], bits[:, 1]


def _check_span(tables: NfaTables, span: torch.Tensor, data: torch.Tensor) -> None:
    want = (tables.P, 2, _words(tables.s_tile))
    if not tables.channels or tuple(span.shape) != want or span.dtype != torch.int32:
        raise ValueError(f"span rows must be {want} int32 for tables with accept channels, "
                         f"got {tuple(span.shape)} {span.dtype} (channels: {tables.channels})")
    if span.device != data.device:
        raise ValueError(f"span rows on {span.device}, data on {data.device}")


def _check_hits_mb(hits: torch.Tensor, data: torch.Tensor, P: int) -> None:
    R, L = data.shape
    want = (P, sb.hit_words(L), R)
    if tuple(hits.shape) != want or hits.dtype != torch.int32 or hits.device != data.device:
        raise ValueError(f"hits must be {want} int32 on {data.device}, got "
                         f"{tuple(hits.shape)} {hits.dtype} on {hits.device}")


def reverse_mb_plain(data, lengths, tables: NfaTables, span: torch.Tensor):
    """Plain version of ``rrx_nfa_reverse_mb`` (the TPU's
    ``_reverse_kernel_mb``): the reverse step of :func:`scan_bits.reverse_plain`
    over the combined automaton, with the union of the accept rows joining
    at every step, and per channel p the hit ``x & sg_p != 0`` of ``x =
    (R | acc) & mask[sym]``, taken before R is updated: a match of pattern
    p can start at max(t - 1, 0). (State 0 is in no mask row, so the union
    of the channel rows steps as the program's accept set does.) Returns
    hit words [P, W, R] int32: channel p's block is the single-channel
    layout."""
    sb._check_inputs(data, lengths)
    _check_span(tables, span, data)
    R, L = data.shape
    dev = data.device
    ln = sb._lengths(data, lengths)
    pt = _Plain.of(tables, dev)
    sg = _span_planes(span.to(dev), tables.s_tile)[0].to(torch.float32).T  # [S, P]
    rs = pt.empty(R, dev)
    words = torch.zeros((tables.P, sb.hit_words(L), R), dtype=torch.int64, device=dev)
    for t in range(L + 1, -1, -1):
        x = (rs | pt.acc) & pt.M[sb._sym(data, ln, t)]
        hit = (x.to(torch.float32) @ sg) > 0  # [R, P]
        rs = (x.to(torch.float32) @ pt.P) > 0
        words[:, t >> 5] |= hit.T.to(torch.int64) << (t & 31)
    return sb._as_i32(words)


def lazy_spans_mb_plain(data, lengths, tables: NfaTables, span: torch.Tensor,
                        hits: torch.Tensor, cap: int):
    """Plain version of ``rrx_nfa_lazy_spans_mb`` (the TPU's
    ``_span_kernel_mb`` and the compaction after it): one forward walk in
    which every channel runs the claim/anchor/emit loop of
    :func:`scan_bits.lazy_spans_plain` on its own hit words and in its own
    (disjoint) position subspace of the combined automaton. Per step and
    channel p: claim sp = max(t - 1, 0) when idle, hit and pos <= sp <=
    len; seed sg_p at step cur + 1 (steps <= 1 when cur == 0); emit (cur, e
    = min(t, len)) on p's accept row with e >= cur, then pos = max(e, cur +
    1), cur idle, and p's positions (posm_p) are cleared from the state.
    After the EOS step an idle channel with pos <= len and hit bit len + 1
    emits the empty match (len, len), as ``scan_bits.lazy_spans_plain``
    does. Nullable channels come out meaningless (state 0 is in no channel
    row).
    Returns (starts [R, P, cap], ends [R, P, cap], -1 past the count; cnt
    [R, P], which counts past cap)."""
    sb._check_inputs(data, lengths)
    _check_span(tables, span, data)
    P = tables.P
    _check_hits_mb(hits, data, P)
    sb._check_cap(cap)
    R, L = data.shape
    dev = data.device
    i64, f32 = torch.int64, torch.float32
    ln = sb._lengths(data, lengths)
    lnc = ln[:, None]
    pt = _Plain.of(tables, dev)
    sg, posm = (x.to(f32) for x in _span_planes(span.to(dev), tables.s_tile))
    accs = pt.accs.to(f32).T  # [S, P]
    v = pt.empty(R, dev)
    pos = torch.zeros((R, P), dtype=i64, device=dev)
    cur = torch.full((R, P), -1, dtype=i64, device=dev)
    cnt = torch.zeros((R, P), dtype=i64, device=dev)
    sbuf = torch.full((R, P, cap + 1), -1, dtype=i64, device=dev)  # column cap: overflow
    ebuf = torch.full((R, P, cap + 1), -1, dtype=i64, device=dev)
    for t in range(L + 2):
        sp = max(t - 1, 0)
        hit = ((hits[:, t >> 5, :].to(i64) >> (t & 31)) & 1).T != 0  # [R, P]
        claim = (cur < 0) & hit & (pos <= sp) & (sp <= lnc)
        cur = torch.where(claim, sp, cur)
        gate = (cur >= 0) & ((cur == t - 1) | ((cur == 0) & (t <= 1)))
        y = ((v.to(f32) @ pt.F) > 0) | ((gate.to(f32) @ sg) > 0)
        v = y & pt.M[sb._sym(data, ln, t)]
        fl = (v.to(f32) @ accs) > 0
        e = lnc.clamp(max=t)
        done = fl & (cur >= 0) & (e >= cur)
        slot = torch.where(done, cnt.clamp(max=cap), cap)[..., None]
        sbuf.scatter_(2, slot, torch.where(done, cur, -1)[..., None])
        ebuf.scatter_(2, slot, torch.where(done, e, -1).expand(R, P)[..., None])
        cnt += done.to(i64)
        pos = torch.where(done, torch.maximum(e, cur + 1), pos)
        cur = torch.where(done, -1, cur)
        v = v & ~((done.to(f32) @ posm) > 0)
    # per channel, the empty match at len after a span that ended at the EOS
    # step (see scan_bits.lazy_spans_plain)
    t_eos = ln + 1
    word = hits.to(i64).gather(1, (t_eos >> 5).expand(P, R)[:, None, :])[:, 0, :]  # [P, R]
    done = (cur < 0) & (pos <= lnc) & (((word >> (t_eos & 31)) & 1) != 0).T
    slot = torch.where(done, cnt.clamp(max=cap), cap)[..., None]
    sbuf.scatter_(2, slot, torch.where(done, lnc, -1)[..., None])
    ebuf.scatter_(2, slot, torch.where(done, lnc, -1)[..., None])
    cnt += done.to(i64)
    i32 = torch.int32
    return sbuf[..., :cap].to(i32), ebuf[..., :cap].to(i32), cnt.to(i32)


# ---------------------------------------------------------------------------
# Counted wrappers: a CUDA tensor goes to the kernel, a CPU tensor to the
# plain version
# ---------------------------------------------------------------------------


def _launch(entry: str, data, lengths, tables: NfaTables, *tail) -> None:
    sb.launch(entry, data, lengths, tables.tab, int(tables.s_tile), *tail)


def _band_tail(entry: str, band, diags: tuple, S: int) -> tuple:
    """(band table, offset count, offsets as a host int array of
    BANDED_MAX_DIAGS) for a band-step launch; refuses tables without the
    split."""
    if band is None:
        raise ValueError(f"{entry}: tables of {S} states without a band split (with_band)")
    return band, len(diags), (ctypes.c_int * BANDED_MAX_DIAGS)(*diags)


def _check_dead_row(entry: str, tables: NfaTables) -> None:
    """Refuse, past ``REG_S_TILE`` states, tables whose dead step's mask row
    is not zero for a record reverse: its kernel ends each record at its
    EOS step, where the plain version walks on over the dead steps."""
    if tables.s_tile > REG_S_TILE and tables.dead_row:
        raise ValueError(f"{entry}: tables of {tables.s_tile} states whose dead step's mask row "
                         "is not zero (the kernel ends each record at its EOS step)")


def _run(name: str, wrapper, data, lengths, tables: NfaTables, *tail,
         channels: bool = False, band: str = "", lanes: int = 0) -> None:
    """Launch ``rrx_nfa_<name>`` for a tile of up to ``REG_S_TILE`` states
    (counted in ``wrapper.launches``, or with ``channels`` in
    ``wrapper.channel_launches``) or ``rrx_nfa_wide_<name>`` for 257..1024
    states (one warp per record, counted in ``wrapper.wide_launches``),
    which also takes its record counter and, on the band step, a band split
    before it: with ``band="rec"`` the record reverses' (``rec_band``), with
    ``band="fwd"`` the record flags' (``fwd_band``) and the lanes a record
    (``lanes``, else the tables' ``band_lanes``)."""
    if tables.s_tile > REG_S_TILE:
        if band:
            tail += _band_tail(f"rrx_nfa_wide_{name}", getattr(tables, f"{band}_band"),
                               getattr(tables, f"{band}_diags"), tables.s_tile)
        if band == "fwd":
            tail += (int(lanes or tables.band_lanes),)
        nxt = torch.zeros(1, dtype=torch.int32, device=data.device)
        _launch(f"rrx_nfa_wide_{name}", data, lengths, tables, *tail, nxt)
        wrapper.wide_launches += 1
    else:
        _launch(f"rrx_nfa_{name}", data, lengths, tables, *tail)
        if channels:
            wrapper.channel_launches += 1
        else:
            wrapper.launches += 1


def _check_wide_smem(what: str, tables: NfaTables) -> None:
    """Refuse, past ``REG_S_TILE`` states, a multi-channel wide kernel whose
    shared memory (one direction's rows, the mask and accept rows, the
    span-channel rows and a state buffer per warp: ``scan_nfa_wide.cu``)
    passes the 227 KB a block may have."""
    S, W, P = tables.s_tile, _words(tables.s_tile), tables.P
    need = 4 * ((S + N_SYMS + 3 * P) * W + WIDE_WARPS * W)
    if S > REG_S_TILE and need > WIDE_SMEM_LIMIT:
        raise ValueError(f"{what}: {P} channels on a tile of {S} states need {need} bytes of "
                         f"shared memory a block, past the card's {WIDE_SMEM_LIMIT} (227 KB)")


def nfa_stats(data, lengths, tables: NfaTables, *, seeded: bool, lead: int = 0,
              nullable: bool = False):
    """(cnt, first, last, full), each [R, P] for tables with accept
    channels, else [R]. On a CUDA tensor ``rrx_nfa_stats`` (counted in
    ``nfa_stats.launches``, or in ``nfa_stats.channel_launches`` for its
    P-channel kernel, P > 1) or, past 256 states, ``rrx_nfa_wide_stats``
    (any P, counted in ``nfa_stats.wide_launches``) on the tables' record
    flags' band split (``fwd_band``, ``fwd_diags``) at ``band_lanes`` lanes
    a record for one channel, 32 for P > 1; :func:`stats_plain` on a CPU
    tensor. Past 256 states it refuses tables without that split."""
    if data.device.type == "cpu":
        return stats_plain(data, lengths, tables, seeded=seeded, lead=lead, nullable=nullable)
    R, dev = data.shape[0], data.device
    shape = (R, tables.P) if tables.channels else (R,)
    outs = [torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(3)]
    full = torch.empty(shape, dtype=torch.uint8, device=dev)
    _run("stats", nfa_stats, data, lengths, tables, int(tables.P), int(seeded),
         int(lead if lead > 0 else -1), int(nullable), *outs, full, channels=tables.P > 1,
         band="fwd", lanes=32 if tables.P > 1 else 0)
    return (*outs, full.view(torch.bool))


def nfa_flags(data, lengths, tables: NfaTables, *, seeded: bool):
    """Flag words [W, R] int32 (``rrx_nfa_flags``, or past 256 states
    ``rrx_nfa_wide_flags`` on the tables' record flags' band split
    (``fwd_band``, ``fwd_diags``) at ``band_lanes`` lanes a record, on a
    CUDA tensor; :func:`flags_plain` on a CPU tensor)."""
    if data.device.type == "cpu":
        return flags_plain(data, lengths, tables, seeded=seeded)
    R, L = data.shape
    words = torch.empty((sb.hit_words(L), R), dtype=torch.int32, device=data.device)
    _run("flags", nfa_flags, data, lengths, tables, int(seeded), words, band="fwd")
    return words


def nfa_reverse(data, lengths, tables: NfaTables):
    """Hit words [W, R] int32 (``rrx_nfa_reverse``, or past 256 states
    ``rrx_nfa_wide_reverse`` on the tables' record reverses' band split
    (``rec_band``, ``rec_diags``), on a CUDA tensor;
    ``scan_bits.reverse_plain`` on a CPU tensor). Past 256 states it
    refuses tables whose dead step's mask row is not zero
    (``dead_row``)."""
    if data.device.type == "cpu":
        return sb.reverse_plain(data, lengths, tables)
    _check_dead_row("rrx_nfa_wide_reverse", tables)
    R, L = data.shape
    hits = torch.empty((sb.hit_words(L), R), dtype=torch.int32, device=data.device)
    _run("reverse", nfa_reverse, data, lengths, tables, hits, band="rec")
    return hits


def nfa_anchor_end(data, lengths, tables: NfaTables, starts, *, longest: bool):
    """End [R] int32 of the anchored rescan from ``starts`` (-1 = inactive)
    (``rrx_nfa_anchor_end``, or past 256 states ``rrx_nfa_wide_anchor_end``,
    on a CUDA tensor; ``scan_bits.anchor_plain`` on a CPU tensor)."""
    if data.device.type == "cpu":
        return sb.anchor_plain(data, lengths, tables, starts, longest=longest)
    sb._check_rows("starts", starts, data, (torch.int32, torch.int64))
    end = torch.empty(data.shape[0], dtype=torch.int32, device=data.device)
    _run("anchor_end", nfa_anchor_end, data, lengths, tables,
         starts.to(torch.int32).contiguous(), int(longest), end)
    return end


def nfa_lazy_spans(data, lengths, tables: NfaTables, hits, cap: int):
    """(starts [R, cap], ends [R, cap], cnt [R]) (``rrx_nfa_lazy_spans``,
    or past 256 states ``rrx_nfa_wide_lazy_spans``, on a CUDA tensor;
    ``scan_bits.lazy_spans_plain`` on a CPU tensor)."""
    if data.device.type == "cpu":
        return sb.lazy_spans_plain(data, lengths, tables, hits, cap)
    sb._check_hits(hits, data)
    sb._check_cap(cap)
    starts, ends, cnt = sb._span_buffers(data.shape[0], cap, data.device)
    _run("lazy_spans", nfa_lazy_spans, data, lengths, tables, hits.contiguous(), int(cap),
         starts, ends, cnt)
    return starts, ends, cnt


def nfa_greedy_spans(data, lengths, tables: NfaTables, hits, cap: int, *, nullable: bool):
    """(starts [R, cap], ends [R, cap], cnt [R], over [R] bool)
    (``rrx_nfa_greedy_spans``, or past 256 states
    ``rrx_nfa_wide_greedy_spans``, on a CUDA tensor;
    ``scan_bits.greedy_spans_plain`` on a CPU tensor)."""
    if data.device.type == "cpu":
        return sb.greedy_spans_plain(data, lengths, tables, hits, cap, nullable=nullable)
    sb._check_hits(hits, data)
    sb._check_cap(cap)
    R = data.shape[0]
    starts, ends, cnt = sb._span_buffers(R, cap, data.device)
    over = torch.empty(R, dtype=torch.uint8, device=data.device)
    _run("greedy_spans", nfa_greedy_spans, data, lengths, tables, hits.contiguous(), int(cap),
         int(nullable), starts, ends, cnt, over)
    return starts, ends, cnt, over.view(torch.bool)


def nfa_reverse_mb(data, lengths, tables: NfaTables, span: torch.Tensor):
    """Hit words [P, W, R] int32 of every accept channel from one reverse
    pass (``rrx_nfa_reverse_mb``, counted in ``nfa_reverse_mb.launches``,
    or past 256 states ``rrx_nfa_wide_reverse_mb`` on the tables' record
    reverses' band split, counted in ``nfa_reverse_mb.wide_launches``, on
    a CUDA tensor; :func:`reverse_mb_plain` on a CPU tensor). Past 256
    states it refuses tables whose dead step's mask row is not zero
    (``dead_row``)."""
    if data.device.type == "cpu":
        return reverse_mb_plain(data, lengths, tables, span)
    _check_span(tables, span, data)
    _check_wide_smem("nfa_reverse_mb", tables)
    _check_dead_row("rrx_nfa_wide_reverse_mb", tables)
    R, L = data.shape
    hits = torch.empty((tables.P, sb.hit_words(L), R), dtype=torch.int32, device=data.device)
    _run("reverse_mb", nfa_reverse_mb, data, lengths, tables, int(tables.P), span.contiguous(),
         hits, band="rec")
    return hits


def nfa_lazy_spans_mb(data, lengths, tables: NfaTables, span: torch.Tensor, hits, cap: int):
    """(starts [R, P, cap], ends [R, P, cap], cnt [R, P]): every channel's
    lazy spans from one forward pass (``rrx_nfa_lazy_spans_mb``, counted in
    ``nfa_lazy_spans_mb.launches``, or past 256 states
    ``rrx_nfa_wide_lazy_spans_mb`` on the tables' record flags' band split
    at 32 lanes a record, counted in ``nfa_lazy_spans_mb.wide_launches``,
    on a CUDA tensor; :func:`lazy_spans_mb_plain` on a CPU tensor). Above
    ``MB_REG_CHANNELS`` channels (``WIDE_REG_CHANNELS`` for the wide
    kernel) the kernel keeps each record's (cur, pos) per channel in a
    scratch row [R, P, 2] allocated here. Past 256 states it refuses tables
    without the split."""
    if data.device.type == "cpu":
        return lazy_spans_mb_plain(data, lengths, tables, span, hits, cap)
    _check_span(tables, span, data)
    P = tables.P
    _check_hits_mb(hits, data, P)
    sb._check_cap(cap)
    _check_wide_smem("nfa_lazy_spans_mb", tables)
    R, dev = data.shape[0], data.device
    starts = torch.empty((R, P, cap), dtype=torch.int32, device=dev)
    ends = torch.empty((R, P, cap), dtype=torch.int32, device=dev)
    cnt = torch.empty((R, P), dtype=torch.int32, device=dev)
    in_regs = WIDE_REG_CHANNELS if tables.s_tile > REG_S_TILE else MB_REG_CHANNELS
    scratch = torch.empty((R, P, 2) if P > in_regs else (1,), dtype=torch.int32, device=dev)
    _run("lazy_spans_mb", nfa_lazy_spans_mb, data, lengths, tables, int(P), span.contiguous(),
         hits.contiguous(), int(cap), starts, ends, cnt, scratch, band="fwd", lanes=32)
    return starts, ends, cnt


for _w in (nfa_stats, nfa_flags, nfa_reverse, nfa_anchor_end, nfa_lazy_spans,
           nfa_greedy_spans, nfa_reverse_mb, nfa_lazy_spans_mb):
    _w.launches = 0
nfa_stats.channel_launches = 0
for _w in (nfa_stats, nfa_flags, nfa_reverse, nfa_anchor_end, nfa_lazy_spans, nfa_greedy_spans,
           nfa_reverse_mb, nfa_lazy_spans_mb):
    _w.wide_launches = 0


def _with_flag0(bits: torch.Tensor, nullable: bool) -> torch.Tensor:
    """[B, T] step flags -> [B, T + 1] with the program's nullability as
    column 0 (the JAX package's forward-flags layout)."""
    flag0 = torch.full((bits.shape[0], 1), nullable, dtype=torch.bool, device=bits.device)
    return torch.cat([flag0, bits], dim=1)


class _Scanner:
    """What every scanner of this module shares: the program, the device,
    the nullability (``nullable`` overrides the program's), the accept
    channels (P = 1 unless an accept map is set) and the batch unpacking.
    Every method takes ``data`` [B, L] uint8 and ``len_g`` [B_rows, G] (G
    is only the JAX package's packing: records are rows of ``data`` in
    ``len_g``'s row-major order)."""

    P = 1
    channels = False  # an accept map gives the scan P accept channels
    CHANNEL_METHODS = "match_stats_b and lazy_spans_mb"

    def __init__(self, prog: DeviceProgram, device, nullable=None):
        self.prog = prog
        self.device = torch.device(device)
        self.nullable = prog.nullable if nullable is None else bool(nullable)

    def _one_channel(self, what: str) -> None:
        """Raise for a primitive that reads one accept set when the scanner
        has accept channels: it must not answer from their union."""
        if self.channels:
            raise ValueError(
                f"{what}: this {type(self).__name__} of {self.prog.pattern!r} has {self.P} accept "
                "channels (a multi-pattern program) and the primitive reads one accept set; only "
                f"{self.CHANNEL_METHODS} take channels"
            )

    def _batch(self, data, len_g):
        data = torch.as_tensor(data, device=self.device)
        len_g = torch.as_tensor(len_g, device=self.device)
        return data, len_g, len_g.reshape(-1).to(torch.int32)

    def forward_flags_b(self, data, len_g, *, seeded: bool):
        """[B, T + 1] bool accept flags, T = L + 2: column 0 is the
        program's nullability, column t + 1 the flag of step t."""
        self._one_channel("forward_flags_b")
        words, T = self.flags_words_b(data, len_g, seeded=seeded)
        return _with_flag0(sb.hit_bits(words.T, T), self.nullable)

    def reverse_hits_b(self, data, len_g):
        """[B, L + 2] bool candidate-start hits: step t set = a match can
        start at max(t - 1, 0)."""
        self._one_channel("reverse_hits_b")
        words, T = self.hits_words_b(data, len_g)
        return sb.hit_bits(words.T, T)


class PallasScanner(_Scanner):
    """Match statistics, forward flags, reverse hits, anchored rescans,
    and lazy and greedy spans of a dense program of up to 1024 states on
    ``device``, run on a CUDA device by the kernels of ``csrc/scan_nfa.cu``
    (tiles of up to 256 states, one thread per record) or of
    ``csrc/scan_nfa_wide.cu`` (the dense multiblock tier, 257..1024 states,
    one warp per record), and by their plain PyTorch versions on the CPU.
    Named after the JAX package's scanner of the same methods and outputs;
    ``SwarScanner`` and ``WordScanner`` subclass it as there.

    ``accept_map`` ([lanes, G * P] 0/1, a multi-pattern program's accept
    channels, as ``MultiPattern`` builds it) gives the scan P accept rows:
    ``match_stats_b`` then returns per-channel statistics and, once
    :meth:`set_span_channels` has run, ``lazy_spans_mb`` every channel's
    lazy spans; the single-channel primitives raise."""

    has_anchor = True  # anchored-rescan and span kernels

    def __init__(self, prog: DeviceProgram, device, accept_map=None, nullable=None):
        super().__init__(prog, device, nullable)
        if accept_map is not None:
            self.channels = True
            self.P = np.asarray(accept_map).shape[1] // max(prog.G, 1)
        self.nfa = device_nfa_tables(prog, self.device, accept_map, self.P)
        self.span = None  # [P, 2, W] span-channel rows (set_span_channels)

    def match_stats_b(self, data, len_g, *, seeded: bool, lead: int = 0):
        """(cnt, first, last, full, any), each [B_rows, G * P] (``len_g``'s
        shape for one channel): record-major, channel-minor. ``lead`` > 0:
        records are overlapped windows whose first ``lead`` steps only warm
        the state up (no flag counts there)."""
        data, len_g, lengths = self._batch(data, len_g)
        cnt, first, last, full = nfa_stats(
            data, lengths, self.nfa, seeded=seeded, lead=lead, nullable=self.nullable
        )
        sl = lambda x: x.reshape(len_g.shape[0], len_g.shape[1] * self.P)  # noqa: E731
        cnt = sl(cnt)
        return cnt, sl(first), sl(last), sl(full), cnt > 0

    def flags_words_b(self, data, len_g, *, seeded: bool):
        """([B, Wt] int32 words, T = L + 2): bit t of a record's words is
        step t's accept flag (uint32 bit patterns; bits past T are 0)."""
        self._one_channel("flags_words_b")
        data, _, lengths = self._batch(data, len_g)
        return nfa_flags(data, lengths, self.nfa, seeded=seeded).T, data.shape[1] + 2

    def hits_words_b(self, data, len_g):
        """([B, Wt] int32 words, T = L + 2): bit t = reverse start hit at
        step t (a match can start at max(t - 1, 0))."""
        self._one_channel("hits_words_b")
        data, _, lengths = self._batch(data, len_g)
        return nfa_reverse(data, lengths, self.nfa).T, data.shape[1] + 2

    def anchor_end_b(self, data, len_g, starts_g, *, longest: bool):
        """Anchored-rescan end per record, shaped like ``len_g``: the first
        end from ``starts_g`` (-1 = inactive), or the last with
        ``longest``; -1 when none."""
        self._one_channel("anchor_end_b")
        data, len_g, lengths = self._batch(data, len_g)
        starts = torch.as_tensor(starts_g, device=self.device).reshape(-1).to(torch.int32)
        end = nfa_anchor_end(data, lengths, self.nfa, starts, longest=longest)
        return end.reshape(len_g.shape)

    def lazy_spans_b(self, data, len_g, *, cap: int):
        """(starts [B, cap], ends [B, cap], cnt [B]): lazy (leftmost-
        shortest) spans, -1 past the count; cnt counts past cap. Refused
        for a nullable program, as in the JAX package: its lazy spans are
        the empty match at every position, which the API answers without
        a scan."""
        self._one_channel("lazy_spans_b")
        if self.nullable:
            raise ValueError(
                f"lazy spans of the nullable program {self.prog.pattern!r} are the empty "
                "match at every position (Pattern.finditer_batch answers them without a scan)"
            )
        data, _, lengths = self._batch(data, len_g)
        hits = nfa_reverse(data, lengths, self.nfa)
        return nfa_lazy_spans(data, lengths, self.nfa, hits, cap)

    def greedy_spans_b(self, data, len_g, *, cap: int):
        """(starts [B, cap], ends [B, cap], cnt [B], over [B] bool): greedy
        (leftmost-longest, POSIX) spans; ``over`` = more spans than cap. A
        nullable program falls back to the empty match where no longer one
        starts."""
        self._one_channel("greedy_spans_b")
        data, _, lengths = self._batch(data, len_g)
        hits = nfa_reverse(data, lengths, self.nfa)
        return nfa_greedy_spans(data, lengths, self.nfa, hits, cap, nullable=self.nullable)

    # -- multi-pattern span channels ----------------------------------------
    def set_span_channels(self, sgm, posm, P: int) -> None:
        """Install the per-pattern span-channel tables (``MultiPattern``):
        ``sgm`` [G * P, lanes] first-position projections, ``posm`` [lanes,
        P] position masks (see :func:`span_channels`). Enables
        :meth:`lazy_spans_mb`."""
        if not self.channels or P != self.P:
            raise ValueError(f"span channels for {P} patterns on a scanner with "
                             f"{self.P if self.channels else 'no'} accept channels")
        rows = span_channels(sgm, posm, P, self.prog.s_tile)
        self.span = torch.from_numpy(rows.view(np.int32).copy()).to(self.device)

    def lazy_spans_mb(self, data, len_g, *, cap: int):
        """Every channel's lazy spans from one combined scan: one channel
        reverse pass and one channel span pass, two launches whatever P.
        Returns (starts [Bn, P, cap], ends [Bn, P, cap], -1 past the count;
        count [Bn, P], which counts past cap); nullable channels' rows are
        meaningless (the API substitutes the closed-form empty-match
        spans)."""
        if self.span is None:
            raise ValueError("lazy_spans_mb needs set_span_channels first")
        data, _, lengths = self._batch(data, len_g)
        hits = nfa_reverse_mb(data, lengths, self.nfa, self.span)
        return nfa_lazy_spans_mb(data, lengths, self.nfa, self.span, hits, cap)

    # -- stream-fed methods: a mask stream in place of bytes ------------------
    # ``words`` is the port's mask stream [T, B, Wt] int32
    # (``scan_packed.mask_stream_from_bytes``); the methods run
    # ``scan_packed``'s primitives on this scanner's tables, which launch the
    # kernels of ``csrc/scan_stream.cu`` on a CUDA tensor (the JAX package's
    # ``_match_kernel``, ``_flags_kernel``, ``_reverse_kernel`` and
    # ``_first_end_kernel``) and run their plain versions on a CPU tensor.
    def match_stats(self, words, len_g, *, seeded: bool):
        """(cnt, first, any) from the mask stream, each shaped [B_rows, G *
        P] like ``match_stats_b``'s (per channel with an accept map)."""
        from . import scan_packed as sp

        len_g = torch.as_tensor(len_g, device=self.device)
        outs = sp.match_stats(self.nfa, words, len_g.reshape(-1), seeded=seeded,
                              nullable=self.nullable)
        return tuple(x.reshape(len_g.shape[0], -1) for x in outs)

    def forward_flags(self, words, *, seeded: bool):
        """[B, T + 1] bool accept flags of the mask stream; column 0 is the
        program's nullability."""
        from . import scan_packed as sp

        self._one_channel("forward_flags")
        fl = sp.forward_flags(self.nfa, words, seeded=seeded)
        fl[:, 0] = bool(self.prog.nullable)
        return fl

    def reverse_hits(self, words):
        """[B, T] bool: column j is set iff some match starts at max(j - 1,
        0)."""
        from . import scan_packed as sp

        self._one_channel("reverse_hits")
        return sp.reverse_hits(self.nfa, words)

    def first_end_from(self, words, len_g, starts_g):
        """Lazy anchored end per record from ``starts_g`` (-1 = inactive),
        shaped like ``len_g``; -1 when none."""
        from . import scan_packed as sp

        self._one_channel("first_end_from")
        len_g = torch.as_tensor(len_g, device=self.device)
        end = sp.first_end_from(self.nfa, words, len_g.reshape(-1),
                                torch.as_tensor(starts_g, device=self.device).reshape(-1))
        return end.reshape(len_g.shape)


# ---------------------------------------------------------------------------
# One long string: windows of a single string from entry states
# ---------------------------------------------------------------------------


class LongGeom(NamedTuple):
    """Windows over one string of ``n`` bytes (``ops/longstring.py``): ``nw``
    windows of ``T`` local steps; window w's local step t is global stream
    step g = (w // rep) * block + t - lead (global step 0 = BOS, i + 1 =
    byte i, n + 1 = EOS, dead outside). A window owns its local steps [lead,
    lead + block): the flag and hit bits of owned steps land at bit g of one
    flat bit array, and the counts sum over them. ``rep`` > 1 runs rep
    windows over the same steps (the summary pass's basis
    pseudo-records)."""

    n: int
    nw: int
    block: int
    lead: int
    T: int
    rep: int = 1

    @property
    def words(self) -> int:
        """Words of the flat flag / hit bit array."""
        return -(-self.nw // self.rep) * (self.block // 32)


def _check_long(data: torch.Tensor, geom: LongGeom) -> None:
    if data.dim() != 1 or data.dtype != torch.uint8 or data.numel() != geom.n:
        raise ValueError(f"data must be [n] uint8 with n = {geom.n}, got {tuple(data.shape)} "
                         f"{data.dtype}")
    if geom.block < 32 or geom.block % 32 or geom.lead < 0 or geom.T < 0 or geom.rep < 1:
        raise ValueError(f"bad window geometry {geom}")
    if geom.n > (1 << 31) - 1:
        raise ValueError(f"a string of {geom.n} bytes: stream offsets are int32 (at most "
                         f"{(1 << 31) - 1} bytes)")


def _long_steps(data: torch.Tensor, geom: LongGeom):
    """(g [T, nw] int64 global step, sym [T, nw] int64 symbol) of every
    window's local steps, built once for a whole walk."""
    dev = data.device
    w0 = torch.arange(geom.nw, dtype=torch.int64, device=dev) // geom.rep * geom.block
    g = torch.arange(geom.T, dtype=torch.int64, device=dev)[:, None] + (w0 - geom.lead)[None, :]
    ext = torch.cat([data, data.new_zeros(1)]).to(torch.int64)
    byte = ext[(g - 1).clamp(0, geom.n)]
    n = geom.n
    sym = torch.where(g == 0, sb.SYM_BOS, torch.where(
        (g >= 1) & (g <= n), byte, torch.where(g == n + 1, sb.SYM_EOS, sb.SYM_DEAD)))
    return g, sym


def _state_rows(v0, geom: LongGeom, tables: NfaTables, dev) -> torch.Tensor:
    """[nw, W] int32 entry states (or None: empty) -> [nw, S] bool."""
    S = tables.s_tile
    if v0 is None:
        return torch.zeros((geom.nw, S), dtype=torch.bool, device=dev)
    want = (geom.nw, _words(S))
    if tuple(v0.shape) != want:
        raise ValueError(f"entry states must be {want}, got {tuple(v0.shape)}")
    return _bit_rows(v0.to(dev).to(torch.int64) & sb.MASK32, S)


def _state_words(v: torch.Tensor, S: int) -> torch.Tensor:
    """[nw, S] bool -> [nw, W] int32 (uint32 bit patterns)."""
    nw = v.shape[0]
    W = _words(S)
    vv = torch.zeros((nw, W * 32), dtype=torch.int64, device=v.device)
    vv[:, :S] = v.to(torch.int64)
    sh = torch.arange(32, dtype=torch.int64, device=v.device)
    return sb._as_i32((vv.reshape(nw, W, 32) << sh).sum(dim=2))


def _long_walk(data, geom: LongGeom, tables: NfaTables, v0, gate, seeded: bool):
    """Yields (t, v [nw, S] bool) after each local step of every window: the
    forward step of :func:`stats_plain` from the entry states, seeded where
    ``gate`` (every window when None) and, unseeded, only at g < 2."""
    dev = data.device
    pt = tables.plain(dev)
    v = _state_rows(v0, geom, tables, dev)
    gw = (torch.ones(geom.nw, dtype=torch.bool, device=dev) if gate is None
          else gate.to(dev).to(torch.bool))
    g, sym = _long_steps(data, geom)
    seeds = gw[None, :] & (g < 2) if not seeded else gw[None, :].expand(geom.T, geom.nw)
    for t in range(geom.T):
        v = pt.step(v, seeds[t], sym[t])
        yield t, v


def _owned_bits(flags: torch.Tensor) -> torch.Tensor:
    """[nw, block] bool bits of the windows' owned steps -> the flat words
    [nw * block / 32] int32 (window w's owned step j is bit w * block + j)."""
    sh = torch.arange(32, dtype=torch.int64, device=flags.device)
    words = (flags.to(torch.int64).reshape(-1, 32) << sh).sum(dim=1)
    return sb._as_i32(words)


def long_carry_plain(data, geom: LongGeom, tables: NfaTables, v0=None, gate=None, *,
                     seeded: bool):
    """Plain version of ``rrx_long_carry`` (the TPU's ``_carry_kernel_lb``):
    each window's final state set [nw, W] int32 after its T steps."""
    _check_long(data, geom)
    v = _state_rows(v0, geom, tables, data.device)
    for _, v in _long_walk(data, geom, tables, v0, gate, seeded):
        pass
    return _state_words(v, tables.s_tile)


def long_flags_plain(data, geom: LongGeom, tables: NfaTables, v0=None, gate=None, *,
                     seeded: bool):
    """Plain version of ``rrx_long_flags`` (the TPU's
    ``_flags_v0_kernel_lb``): the accept flags of the owned steps as the
    flat bit array [words] int32, bit g = global step g."""
    _check_long(data, geom)
    if geom.T != geom.lead + geom.block or geom.rep != 1:
        raise ValueError(f"flags windows need T = lead + block and rep 1, got {geom}")
    dev = data.device
    pt = tables.plain(dev)
    fl = torch.zeros((geom.nw, geom.block), dtype=torch.bool, device=dev)
    for t, v in _long_walk(data, geom, tables, v0, gate, seeded):
        if t >= geom.lead:
            fl[:, t - geom.lead] = pt.accepts(v)
    return _owned_bits(fl)


def long_count_plain(data, geom: LongGeom, tables: NfaTables, v0=None, gate=None, *,
                     seeded: bool, final: bool = False):
    """Plain version of ``rrx_long_count`` (the TPU's ``_count_v0_kernel_lb``
    and, with ``final``, ``_count_v0_final_kernel_lb``): per window, cnt
    [nw] int32 = accept flags of owned steps with g < n, tail [nw] bool = an
    accept flag at an owned step with g == n or n + 1, and with ``final``
    the final state set [nw, W] int32 (else None)."""
    _check_long(data, geom)
    dev = data.device
    pt = tables.plain(dev)
    cnt = torch.zeros(geom.nw, dtype=torch.int64, device=dev)
    tail = torch.zeros(geom.nw, dtype=torch.bool, device=dev)
    v = _state_rows(v0, geom, tables, dev)
    hi = min(geom.T, geom.lead + geom.block)
    g, _ = _long_steps(data, geom)
    body, eos_side = g < geom.n, (g == geom.n) | (g == geom.n + 1)
    for t, v in _long_walk(data, geom, tables, v0, gate, seeded):
        if not geom.lead <= t < hi:
            continue
        fl = pt.accepts(v)
        cnt += (fl & body[t]).to(torch.int64)
        tail |= fl & eos_side[t]
    vout = _state_words(v, tables.s_tile) if final else None
    return cnt.to(torch.int32), tail, vout


def long_reverse_plain(data, geom: LongGeom, tables: NfaTables):
    """Plain version of ``rrx_long_reverse`` (the TPU's
    ``_reverse_kernel_lb``): each window walks its T steps down from the
    empty set with the reverse step of :func:`scan_bits.reverse_plain`; bit
    g of the flat hit array [words] int32 = the initial state is in the set
    after owned step g (a match can start at max(g - 1, 0))."""
    _check_long(data, geom)
    if geom.T < geom.lead + geom.block or geom.rep != 1:
        raise ValueError(f"reverse windows need T >= lead + block and rep 1, got {geom}")
    dev = data.device
    pt = tables.plain(dev)
    rs = pt.empty(geom.nw, dev)
    hit = torch.zeros((geom.nw, geom.block), dtype=torch.bool, device=dev)
    _, sym = _long_steps(data, geom)
    for t in range(geom.T - 1, -1, -1):
        rs = pt.rev(rs, sym[t])
        if geom.lead <= t < geom.lead + geom.block:
            hit[:, t - geom.lead] = pt.start(rs)
    return _owned_bits(hit)


def _long_launch(entry: str, data: torch.Tensor, geom: LongGeom, tables: NfaTables,
                 *args) -> None:
    """Launch a long-string entry point on the current stream of ``data``'s
    card: (data, n, nw, block, lead, T, rep, tab, s_tile), ``args``
    (tensors by pointer, None as a null pointer, ints as they are), then the
    stream. A refused launch raises."""
    from . import _build

    _check_long(data, geom)
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on a CUDA tensor, got {dev}")
    if not data.is_contiguous() or data.data_ptr() % 16:
        data = data.clone()  # the kernels read 16 aligned bytes at a time
    for x in args:
        if isinstance(x, torch.Tensor) and (x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{entry}: a {tuple(x.shape)} argument on {x.device} "
                             f"(contiguous: {x.is_contiguous()}), data on {dev}")
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(data.data_ptr(), geom.n, geom.nw, geom.block, geom.lead,
                                   geom.T, geom.rep, tables.tab.data_ptr(),
                                   int(tables.s_tile), *ptrs, stream)
    _build.check(code, entry)


def _long_inputs(geom: LongGeom, tables: NfaTables, v0, gate, dev):
    if v0 is not None:
        want = (geom.nw, _words(tables.s_tile))
        if tuple(v0.shape) != want or v0.dtype != torch.int32:
            raise ValueError(f"entry states must be {want} int32, got {tuple(v0.shape)} {v0.dtype}")
    if gate is not None and (gate.dim() != 1 or gate.numel() != geom.nw):
        raise ValueError(f"gate must be [{geom.nw}], got {tuple(gate.shape)}")
    return (None if v0 is None else v0.contiguous(),
            None if gate is None else gate.to(torch.uint8).contiguous())


def _long_run(name: str, wrapper, data, geom: LongGeom, tables: NfaTables, *args) -> None:
    """Launch ``rrx_long_<name>`` for a tile of up to ``REG_S_TILE`` states
    (one thread per window, counted in ``wrapper.launches``) or
    ``rrx_long_wide_<name>`` for 257..1024 states (one warp per window, or
    two at 16 lanes a window, counted in ``wrapper.wide_launches``); flags,
    count and reverse there take the tables' band split."""
    if tables.s_tile > REG_S_TILE:
        if name != "carry":
            args += (*_band_tail(f"rrx_long_wide_{name}", tables.band, tables.diags,
                                 tables.s_tile), int(tables.band_lanes))
        _long_launch(f"rrx_long_wide_{name}", data, geom, tables, *args)
        wrapper.wide_launches += 1
    else:
        _long_launch(f"rrx_long_{name}", data, geom, tables, *args)
        wrapper.launches += 1


def long_carry(data, geom: LongGeom, tables: NfaTables, v0=None, gate=None, *, seeded: bool):
    """Final states [nw, W] int32 (``rrx_long_carry``, or past 256 states
    ``rrx_long_wide_carry``, on a CUDA tensor; :func:`long_carry_plain` on a
    CPU tensor)."""
    if data.device.type == "cpu":
        return long_carry_plain(data, geom, tables, v0, gate, seeded=seeded)
    v0, gate = _long_inputs(geom, tables, v0, gate, data.device)
    vout = torch.empty((geom.nw, _words(tables.s_tile)), dtype=torch.int32, device=data.device)
    _long_run("carry", long_carry, data, geom, tables, v0, gate, int(seeded), vout)
    return vout


def long_flags(data, geom: LongGeom, tables: NfaTables, v0=None, gate=None, *, seeded: bool):
    """Flat flag words [words] int32 (``rrx_long_flags``, or past 256 states
    ``rrx_long_wide_flags``, on a CUDA tensor; :func:`long_flags_plain` on a
    CPU tensor)."""
    if data.device.type == "cpu":
        return long_flags_plain(data, geom, tables, v0, gate, seeded=seeded)
    if geom.T != geom.lead + geom.block or geom.rep != 1:
        raise ValueError(f"flags windows need T = lead + block and rep 1, got {geom}")
    v0, gate = _long_inputs(geom, tables, v0, gate, data.device)
    flags = torch.empty(geom.words, dtype=torch.int32, device=data.device)
    _long_run("flags", long_flags, data, geom, tables, v0, gate, int(seeded), flags)
    return flags


def long_count(data, geom: LongGeom, tables: NfaTables, v0=None, gate=None, *, seeded: bool,
               final: bool = False):
    """(cnt [nw] int32, tail [nw] bool, final states [nw, W] int32 or None)
    (``rrx_long_count``, or past 256 states ``rrx_long_wide_count``, on a
    CUDA tensor; :func:`long_count_plain` on a CPU tensor)."""
    if data.device.type == "cpu":
        return long_count_plain(data, geom, tables, v0, gate, seeded=seeded, final=final)
    v0, gate = _long_inputs(geom, tables, v0, gate, data.device)
    dev = data.device
    cnt = torch.empty(geom.nw, dtype=torch.int32, device=dev)
    tail = torch.empty(geom.nw, dtype=torch.uint8, device=dev)
    vout = (torch.empty((geom.nw, _words(tables.s_tile)), dtype=torch.int32, device=dev)
            if final else None)
    _long_run("count", long_count, data, geom, tables, v0, gate, int(seeded), cnt, tail, vout)
    return cnt, tail.view(torch.bool), vout


def long_reverse(data, geom: LongGeom, tables: NfaTables):
    """Flat hit words [words] int32 (``rrx_long_reverse``, or past 256
    states ``rrx_long_wide_reverse``, on a CUDA tensor;
    :func:`long_reverse_plain` on a CPU tensor)."""
    if data.device.type == "cpu":
        return long_reverse_plain(data, geom, tables)
    if geom.T < geom.lead + geom.block or geom.rep != 1:
        raise ValueError(f"reverse windows need T >= lead + block and rep 1, got {geom}")
    hits = torch.empty(geom.words, dtype=torch.int32, device=data.device)
    _long_run("reverse", long_reverse, data, geom, tables, hits)
    return hits


for _w in (long_carry, long_flags, long_count, long_reverse):
    _w.launches = 0
    _w.wide_launches = 0


# ---------------------------------------------------------------------------
# Counting tier: the run-length recurrence of X{m,n}
# ---------------------------------------------------------------------------


class CountTables(NamedTuple):
    """Device copy of a counting plan: ``tab`` [256] int32 (uint32 bit
    patterns), bit ``br * k + q`` of byte b set when b is in branch br's
    position-q class; the body length k, the number of branches, m and n
    (0 = unbounded)."""

    tab: torch.Tensor
    k: int
    n_br: int
    m: int
    n: int

    @property
    def ones(self) -> int:
        """Bit ``br * k`` of every branch: its first position."""
        return sum(1 << (br * self.k) for br in range(self.n_br))

    @property
    def tops(self) -> int:
        """Bit ``br * k + k - 1`` of every branch: its last position."""
        return self.ones << (self.k - 1)

    @property
    def mm(self) -> int:
        return max(self.m, 1)

    @property
    def cap(self) -> int:
        return self.n or self.mm


def count_tables(plan) -> np.ndarray:
    """[256] uint32 class bits of a counting plan ``(m, n, branches)``."""
    _, _, branches = plan
    k = len(branches[0])
    tab = np.zeros(256, np.uint32)
    for br, body in enumerate(branches):
        for q, runs in enumerate(body):
            for lo, hi in runs:
                tab[lo : hi + 1] |= np.uint32(1 << (br * k + q))
    return tab


def device_count_tables(plan, device) -> CountTables:
    m, n, branches = plan
    tab = torch.from_numpy(count_tables(plan).view(np.int32).copy()).to(device)
    return CountTables(tab, len(branches[0]), len(branches), int(m), int(n))


def _count_h(data, ln, tab, t: int) -> torch.Tensor:
    """[R] int64 class bits of stream step t: the byte's bits on steps 1..len,
    0 on BOS, EOS and past them."""
    R, L = data.shape
    if not 1 <= t <= L:
        return torch.zeros(R, dtype=torch.int64, device=data.device)
    return torch.where(t <= ln, tab[data[:, t - 1].to(torch.int64)], 0)


def _count_fwd_plain(data, ln, ct: CountTables, *, seeded: bool):
    """Yields (t, flag [R] bool) for the stream steps t = 0 .. L + 1: the
    TPU's ``_count_step`` and ``_count_unseeded_fl``, vectorised over
    records, in int64. The prefix-progress bits of every branch advance as
    x = ((x << 1) | ones) & h; a branch's top bit is a body end (occ)."""
    R, L = data.shape
    dev = data.device
    tab = ct.tab.to(dev).to(torch.int64) & sb.MASK32
    k, mm, cap, n = ct.k, ct.mm, ct.cap, ct.n
    x = torch.zeros(R, dtype=torch.int64, device=dev)
    rb = [torch.zeros(R, dtype=torch.int64, device=dev)] * k  # r[t-k] .. r[t-1]
    ab = [torch.ones(R, dtype=torch.int64, device=dev)] * k  # ap[t-k] .. ap[t-1]
    for t in range(L + 2):
        x = ((x << 1) | ct.ones) & _count_h(data, ln, tab, t)
        occ = (x & ct.tops) != 0
        x = x & ~ct.tops
        r = torch.where(occ, (rb[0] + 1).clamp(max=cap), 0)
        rb = rb[1:] + [r]
        if seeded:
            yield t, r >= mm
            continue
        ap = torch.ones_like(r) if t < 1 else torch.where(occ, ab[0], 0)
        if k == 1:
            ap = torch.where(t > ln, ab[0], ap)  # the dead tail passes through
        ab = ab[1:] + [ap]
        fl = (ap > 0) & (t >= mm * k) & (t <= ln)
        if k > 1 and t % k:
            fl = torch.zeros_like(fl)
        if n and t > n * k:
            fl = torch.zeros_like(fl)
        yield t, fl


def count_stats_plain(data, lengths, ct: CountTables, *, seeded: bool, lead: int,
                      nullable: bool):
    """Plain version of ``rrx_count_stats`` (the TPU's
    ``_count_match_kernel``, per-step form): (cnt, first, last, full) [R]
    from the flags of :func:`_count_fwd_plain`, accumulated as
    :func:`stats_plain` accumulates the matmul tier's."""
    sb._check_inputs(data, lengths)
    ln = sb._lengths(data, lengths)
    lead = lead if lead > 0 else -1
    if nullable:
        cnt = ln + 1 if seeded else torch.ones_like(ln)
        last = ln.clone() if seeded else torch.zeros_like(ln)
        first = torch.zeros_like(ln)
        full = ln == 0
    else:
        cnt = torch.zeros_like(ln)
        first = torch.full_like(ln, -1)
        last = torch.full_like(ln, -1)
        full = torch.zeros_like(ln, dtype=torch.bool)
    for t, fl in _count_fwd_plain(data, ln, ct, seeded=seeded):
        fl = fl & (t > lead)
        e = ln.clamp(max=t)
        if not (nullable and seeded):
            cnt += (fl & (e != last)).to(torch.int64)
        first = torch.where(fl & (first < 0), e, first)
        last = torch.where(fl, e, last)
        full = full | (fl & (t >= ln))
    i32 = torch.int32
    return cnt.to(i32), first.to(i32), last.to(i32), full


def count_flags_plain(data, lengths, ct: CountTables, *, seeded: bool):
    """Plain version of ``rrx_count_flags`` (the TPU's
    ``_count_flags_kernel``): flag words [W, R] int32, bit t = step t's
    flag."""
    sb._check_inputs(data, lengths)
    R, L = data.shape
    ln = sb._lengths(data, lengths)
    words = torch.zeros((sb.hit_words(L), R), dtype=torch.int64, device=data.device)
    for t, fl in _count_fwd_plain(data, ln, ct, seeded=seeded):
        words[t >> 5] |= fl.to(torch.int64) << (t & 31)
    return sb._as_i32(words)


def count_reverse_plain(data, lengths, ct: CountTables):
    """Plain version of ``rrx_count_reverse`` (the TPU's
    ``_count_reverse_kernel``): walking from step L + 1 down to 0, the
    suffix-progress bits y = ((y >> 1) | tops) & h give a body copy
    starting at t (bit 0 of a branch), r_rev[t] = occ ? min(r_rev[t + k] +
    1, max(m, 1)) : 0, and a hit at t iff r_rev[t] >= max(m, 1). Returns hit
    words [W, R] int32 (bit t = a match starts at max(t - 1, 0))."""
    sb._check_inputs(data, lengths)
    R, L = data.shape
    dev = data.device
    ln = sb._lengths(data, lengths)
    tab = ct.tab.to(dev).to(torch.int64) & sb.MASK32
    mm = ct.mm
    y = torch.zeros(R, dtype=torch.int64, device=dev)
    rb = [torch.zeros(R, dtype=torch.int64, device=dev)] * ct.k  # r_rev[t+1] .. r_rev[t+k]
    words = torch.zeros((sb.hit_words(L), R), dtype=torch.int64, device=dev)
    for t in range(L + 1, -1, -1):
        y = ((y >> 1) | ct.tops) & _count_h(data, ln, tab, t)
        occ = (y & ct.ones) != 0
        y = y & ~ct.ones
        r = torch.where(occ, (rb[-1] + 1).clamp(max=mm), 0)
        rb = [r] + rb[:-1]
        words[t >> 5] |= (r >= mm).to(torch.int64) << (t & 31)
    return sb._as_i32(words)


def _count_launch(entry: str, data, lengths, ct: CountTables, *tail) -> None:
    sb.launch(entry, data, lengths, ct.tab, ct.k, ct.n_br, ct.m, ct.n, *tail)


def count_stats(data, lengths, ct: CountTables, *, seeded: bool, lead: int = 0,
                nullable: bool = False):
    """(cnt, first, last, full) [R] (``rrx_count_stats``, counted in
    ``count_stats.launches``, on a CUDA tensor; :func:`count_stats_plain`
    on a CPU tensor)."""
    if data.device.type == "cpu":
        return count_stats_plain(data, lengths, ct, seeded=seeded, lead=lead, nullable=nullable)
    R, dev = data.shape[0], data.device
    outs = [torch.empty(R, dtype=torch.int32, device=dev) for _ in range(3)]
    full = torch.empty(R, dtype=torch.uint8, device=dev)
    _count_launch("rrx_count_stats", data, lengths, ct, int(seeded),
                  int(lead if lead > 0 else -1), int(nullable), *outs, full)
    count_stats.launches += 1
    return (*outs, full.view(torch.bool))


def count_flags(data, lengths, ct: CountTables, *, seeded: bool):
    """Flag words [W, R] int32 (``rrx_count_flags`` on a CUDA tensor,
    :func:`count_flags_plain` on a CPU tensor)."""
    if data.device.type == "cpu":
        return count_flags_plain(data, lengths, ct, seeded=seeded)
    R, L = data.shape
    words = torch.empty((sb.hit_words(L), R), dtype=torch.int32, device=data.device)
    _count_launch("rrx_count_flags", data, lengths, ct, int(seeded), words)
    count_flags.launches += 1
    return words


def count_reverse(data, lengths, ct: CountTables):
    """Hit words [W, R] int32 (``rrx_count_reverse`` on a CUDA tensor,
    :func:`count_reverse_plain` on a CPU tensor)."""
    if data.device.type == "cpu":
        return count_reverse_plain(data, lengths, ct)
    R, L = data.shape
    hits = torch.empty((sb.hit_words(L), R), dtype=torch.int32, device=data.device)
    _count_launch("rrx_count_reverse", data, lengths, ct, hits)
    count_reverse.launches += 1
    return hits


for _w in (count_stats, count_flags, count_reverse):
    _w.launches = 0


class CountScanner(_Scanner):
    """Run-length scanner for a whole-pattern ``X{m,n}`` with a
    fixed-length body (:func:`counting_plan`): match statistics (with
    ``lead``), forward flags and reverse hits on the CUDA kernels of
    ``csrc/scan_count.cu``, one thread per record and one int per record
    for the run, no follow table at all. The JAX package's scanner of the
    same methods and outputs; its packing of 32 records per sublane row is
    a TPU layout with no counterpart here. It has no anchored-rescan or
    span kernels (``has_anchor = False``): the engine answers anchored
    rescans with ``scan_xla.first_end_from`` and the API takes host rounds
    over ``starts_bitmap`` for spans."""

    has_anchor = False

    def __init__(self, prog: DeviceProgram, plan, device, nullable=None):
        super().__init__(prog, device, nullable)
        self.m, self.n, self.body = plan
        self.k = len(self.body[0])
        self.R = len(self.body)
        self.tables = device_count_tables(plan, self.device)

    def match_stats_b(self, data, len_g, *, seeded: bool, lead: int = 0):
        """(cnt, first, last, full, any), each shaped like ``len_g``.
        ``lead`` > 0: no flag counts at steps <= lead."""
        data, len_g, lengths = self._batch(data, len_g)
        cnt, first, last, full = count_stats(
            data, lengths, self.tables, seeded=seeded, lead=lead, nullable=self.nullable
        )
        sl = lambda x: x.reshape(len_g.shape)  # noqa: E731
        cnt = sl(cnt)
        return cnt, sl(first), sl(last), sl(full), cnt > 0

    def flags_words_b(self, data, len_g, *, seeded: bool):
        """([B, Wt] int32 words, T = L + 2): bit t of a record's words is
        step t's flag of the run-length recurrence (bits past T are 0)."""
        data, _, lengths = self._batch(data, len_g)
        return count_flags(data, lengths, self.tables, seeded=seeded).T, data.shape[1] + 2

    def hits_words_b(self, data, len_g):
        """([B, Wt] int32 words, T = L + 2): bit t = a match of at least
        one body copy can start at max(t - 1, 0)."""
        data, _, lengths = self._batch(data, len_g)
        return count_reverse(data, lengths, self.tables).T, data.shape[1] + 2
