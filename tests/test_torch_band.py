"""The band split of a wide tile (``scan_pallas.band_split``) and the band
step that the wide window kernels' flags, count and reverse and the wide
record kernels (stats, flags, reverse, reverse_mb, lazy_spans_mb) run on it
(``csrc/scan_nfa_wide.cuh`` ``Band``), numpy and torch only, on the CPU.

- The split is an exact partition of the follow matrix: every edge lies on
  one kept diagonal or in the residual rows, no bit at or past S is set,
  for the long-string programs of 257..1024 states and for random tables
  with diagonals planted at offsets -70 .. 64; K60 keeps (1,), the chain
  x(ab|c){300,340}y (1, 2, 3, 4), and at most ``BANDED_MAX_DIAGS``.
- A word-level model of the kernel's step (lanes of 32, or halves of 16
  holding two windows; shuffles that return the lane's own word out of
  range, then zero fill; funnel shifts; the residual rows walked), computed
  from the split and the table the kernels read (``band_table``), equals
  the plain stepper's forward and reverse step (``NfaTables.plain``) on
  random state sets.
- ``_long_run`` hands the wide flags, count and reverse kernels the band
  table, its offsets and the lanes a window (carry none), and refuses
  tables without a band split.
- The record reverse on the band step (``rrx_nfa_wide_reverse``): a
  record-level model (one record a warp of 32 lanes, the bytes walked down
  by a model of ``walk_chunks_rev``, the hit bit the seed row's vote, each
  hit word stored when it closes and the words past the record's EOS step
  zeroed) equals ``scan_bits.reverse_plain`` on x(ab|c){300,}y, K60+ and
  planted tiles with a residual, each with its diagonals kept and with
  every edge walked, on records of length 0, at the 16-byte chunk edges
  and full. ``nfa_reverse`` hands the kernel the band table and its
  offsets past 256 states and refuses tables without a band split.
- The record flags on the band step (``rrx_nfa_wide_flags``, on its own
  split: one diagonal kept, else every edge walked): a
  record-level model (G = 32 lanes a record, or G = 16 and two records a
  warp walked to the longer one by a model of ``walk_chunks_pair``, each
  half with its own EOS step and dead steps after it; the step skipped to
  the seed row alone where the warp holds no live state; each flag word
  stored when it closes, the EOS word after the walk where the walk ended
  first, the words past it zeroed; an odd R's last half writing nothing)
  equals ``flags_plain``, seeded and unseeded, on K60+, x(ab|c){300,}y and
  planted tiles, in both splits, on pairs of unequal lengths (0, the chunk
  edges, full). The multi-channel reverse on the band step
  (``rrx_nfa_wide_reverse_mb``): a model (the union's s0 vote, the
  channels tested only where it fires, lane p's open hit word for p < 32,
  global words past that) equals ``reverse_mb_plain`` on the P = 3 union
  of K40+, cat|dog and [0-9]{3}, its `$` form and 40 channels on K40+'s
  tile. ``nfa_flags`` and ``nfa_reverse_mb`` hand the kernels the record
  split, its offsets and (flags) the lanes a record past 256 states.
- The record stats on the band step (``rrx_nfa_wide_stats``: the flags'
  split, walker, step and skip): a record-level model (the statistics of
  each half in registers, an accept counted only up to the half's own EOS
  step and its state cleared from there, the unseeded stop once the warp
  holds no live state) equals ``stats_plain`` seeded and unseeded, with
  lead 0 and 3, nullable and not, on the flags' tiles and pairs, in both
  splits and at both lane counts; with P channels (32 lanes a record, the
  channels tested where the union fires) on the P = 3 union, its `$` form
  and 40 channels. The multi-channel lazy spans on the band step
  (``rrx_nfa_wide_lazy_spans_mb``: the channels' seed words into the
  step, the step skipped while the state is empty and no channel seeds)
  equal ``lazy_spans_mb_plain`` on the same three channel sets at caps 1,
  2 and 16, in both splits. ``nfa_stats`` and ``nfa_lazy_spans_mb`` hand
  the kernels the record flags' split, its offsets and the lanes a record
  (32 for P > 1) past 256 states, and refuse tables without it.

Every comparison is exact.
"""
import functools

import numpy as np
import pytest
import torch

from roaringregex_tpu_torch.compiler.program import compile_program
from roaringregex_tpu_torch.ops import scan_pallas as spl
from test_torch_api_pallas import _keywords


def _kw(n: int, plus: str = "") -> str:
    return "(" + "|".join(_keywords(n)) + ")" + plus


PROGRAMS = {
    "K60": _kw(60), "K120": _kw(120), "run": "[a-z]{300}x", "chain": "x(ab|c){300,340}y",
    "K60+": _kw(60, "+"), "chain+": "x(ab|c){300,}y",
}
PLANTED = (-70, -33, -1, 0, 1, 31, 32, 64)
M32 = np.uint64(0xFFFFFFFF)


@functools.lru_cache(maxsize=None)
def _prog_tables(name: str):
    prog = compile_program(PROGRAMS[name])
    assert prog.s_tile > spl.REG_S_TILE
    return prog, spl.device_nfa_tables(prog, "cpu")


def _follow(tables: spl.NfaTables) -> np.ndarray:
    S, W = tables.s_tile, spl._words(tables.s_tile)
    rows = tables.tab.numpy().view(np.uint32).reshape(-1, W)
    return spl._unpack_rows(rows[:S], S)


@functools.lru_cache(maxsize=None)
def _random_tables(S: int, seed: int, residual: bool = True,
                   dead: bool = True) -> spl.NfaTables:
    """A hand-built tile: diagonals planted at PLANTED (each edge kept with
    probability 0.6), random residual edges (or the seed row only), random
    mask rows (bytes >= 0x80 zero, and the dead step's unless ``dead``) and
    a random accept row."""
    rng = np.random.default_rng(seed)
    W = spl._words(S)
    F = np.zeros((S, S), bool)
    for d in PLANTED:
        src = np.arange(max(0, -d), min(S, S - d))
        keep = src[rng.random(src.size) < 0.6]
        F[keep, keep + d] = True
    if residual:
        F |= rng.random((S, S)) < 0.004
    else:
        F[0] = rng.random(S) < 0.2
    mbits = rng.random((spl.N_SYMS, S)) < 0.7
    mbits[0x80:256] = False
    if not dead:  # the dead step's row is zero, as nfa_tables builds it
        mbits[spl.sb.SYM_DEAD] = False
    acc = spl._pack_rows((rng.random(S) < 0.05)[None, :], W)
    tab = np.concatenate([spl._pack_rows(F, W), spl._pack_rows(F.T, W),
                          spl._pack_rows(mbits, W), acc])
    t = spl.NfaTables(torch.from_numpy(tab.reshape(-1).view(np.int32).copy()), S)
    return spl.with_band(t, spl.BANDED_MAX_DIAGS, rows=tab)


def _assert_partition(F: np.ndarray, split: spl.BandSplit):
    S, W = F.shape[0], spl._words(F.shape[0])
    parts = []
    for d, words in zip(split.offsets, split.diags):
        src = spl._unpack_rows(words[None, :], S)[0]
        part = np.zeros_like(F)
        s = np.flatnonzero(src)
        assert ((s + d >= 0) & (s + d < S)).all(), f"diagonal {d} has a source past the tile"
        part[s, s + d] = True
        parts.append(part)
    res = spl._unpack_rows(split.follow, S)
    parts.append(res)
    assert (spl._unpack_rows(split.pred, S) == res.T).all()
    total = np.sum(parts, axis=0)
    assert total.max() <= 1, "an edge lies in two parts"
    assert ((total == 1) == F).all(), "the parts' union is not the follow matrix"
    for rows in [split.diags, split.follow, split.pred]:
        if S % 32 and len(rows):
            assert (rows[:, W - 1] >> np.uint32(S % 32) == 0).all(), "a bit at or past S"


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_band_split_partitions_programs(name):
    prog, tables = _prog_tables(name)
    F = _follow(tables)
    split = spl.band_split(F)
    _assert_partition(F, split)
    assert len(split.offsets) <= spl.BANDED_MAX_DIAGS
    want = {"K60": (1,), "K120": (1,), "run": (1,), "chain": (1, 2, 3, 4), "K60+": (1,),
            "chain+": (1, 2, 3, 4)}[name]
    assert split.offsets == want
    assert tables.band_lanes == (16 if spl._words(prog.s_tile) <= 16 else 32)
    # keyword lists and runs: only the seed row is left; the tables keep
    # the diagonals where they carry at least half the edges outside the
    # seed row, else walk every edge
    bare = name in ("K60", "K120", "run")
    res = spl._unpack_rows(split.follow, prog.s_tile)[1:]
    assert res.any() != bare
    assert (2 * res.sum() <= F[1:].sum()) == (name not in ("chain", "K60+"))
    assert tables.diags == (() if name in ("chain", "K60+") else split.offsets)
    # the record reverses keep the diagonals whatever the residual; the
    # record flags keep one diagonal and walk every edge past one
    assert tables.rec_diags == split.offsets
    assert tables.rec_band is tables.band or name in ("chain", "K60+")
    assert tables.fwd_diags == (split.offsets if len(split.offsets) == 1 else ())
    assert tables.fwd_band is (tables.rec_band if len(split.offsets) == 1 else
                               tables.band if name == "chain" else tables.fwd_band)
    empty = spl.band_split(F, 0)
    assert empty.offsets == () and (spl._unpack_rows(empty.follow, prog.s_tile) == F).all()


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "seed-row-only"])
@pytest.mark.parametrize("S", [384, 512, 1024])
def test_band_split_partitions_planted(S, residual):
    tables = _random_tables(S, S, residual)
    F = _follow(tables)
    split = spl.band_split(F)
    _assert_partition(F, split)
    assert split.offsets == PLANTED  # 8 planted, each far above the threshold
    W, K = spl._words(S), spl.BANDED_MAX_DIAGS
    assert tables.band[(2 * K + 2) * W].item() == 1  # state 1 -> state 0 on d = -1
    for md in (0, 3):
        part = spl.band_split(F, md)
        _assert_partition(F, part)
        assert len(part.offsets) == md


def test_band_split_keeps_the_most_populated():
    """Twelve diagonals over the threshold: the cap keeps the eight with
    the most edges, returned in ascending order; one below the threshold is
    left to the residual."""
    S = 512
    F = np.zeros((S, S), bool)
    offs = (-200, -90, -40, -5, -2, 3, 7, 11, 50, 120, 250, 300)
    fill = dict(zip(offs, (100, 90, 300, 80, 250, 200, 70, 150, 60, 180, 120, 110)))
    for d, n in fill.items():
        src = np.arange(max(0, -d), min(S, S - d))[:n]
        F[src, src + d] = True
    F[np.arange(40), np.arange(40) + 400] = True  # 40 edges at +400: under 511 // 8
    split = spl.band_split(F)
    _assert_partition(F, split)
    top = sorted(sorted(fill, key=lambda d: -fill[d])[:8])
    assert split.offsets == tuple(top)
    assert len(split.offsets) == spl.BANDED_MAX_DIAGS


def test_band_table_layout():
    """band_table: the diagonal rows (zero past nd), the states with a
    residual row to walk in each direction, the flag of an edge into state
    0, then both residual matrices without the seed row; the tables of a
    narrow tile carry none."""
    tables = spl.with_band(_prog_tables("chain")[1], spl.BANDED_MAX_DIAGS)
    S, W = tables.s_tile, spl._words(tables.s_tile)
    split = spl.band_split(_follow(tables))
    flat = tables.band.numpy().view(np.uint32)
    K = spl.BANDED_MAX_DIAGS
    assert flat.size == (2 * K + 3) * W + 2 * S * W
    dm = flat[: 2 * K * W].reshape(2, K, W)
    nd = len(split.offsets)
    assert (dm[0, :nd] == split.diags).all() and not dm[:, nd:].any()
    for k, d in enumerate(split.offsets):  # the destinations: the sources moved by d
        src = spl._unpack_rows(dm[0, k:k + 1], S)[0]
        assert (spl._unpack_rows(dm[1, k:k + 1], S)[0] == np.roll(src, d)).all()
    live = flat[2 * K * W:(2 * K + 2) * W].reshape(2, W)
    enter0 = flat[(2 * K + 2) * W:(2 * K + 3) * W]
    res = flat[(2 * K + 3) * W:].reshape(2, S, W)
    want = spl._unpack_rows(split.follow, S)
    want[0] = False  # the seed row is applied whole, never walked
    assert (spl._unpack_rows(res[0], S) == want).all()
    assert (spl._unpack_rows(res[1], S) == want.T).all()
    assert (spl._unpack_rows(live, S) == np.stack([want.any(1), want.any(0)])).all()
    assert enter0[0] == int(_follow(tables)[:, 0].any()) and not enter0[1:].any()
    narrow = spl.device_nfa_tables(compile_program(_kw(20)), "cpu")
    assert narrow.s_tile <= spl.REG_S_TILE and narrow.band is None and narrow.diags == ()


# ---------------------------------------------------------------------------
# A word-level model of the band step
# ---------------------------------------------------------------------------


LANES = np.arange(32)


def _shfl(xs, src, G):
    """The hardware's shuffle of the warp's words ``xs`` from lane ``src``
    (per lane, a 5-bit lane operand within its group of G lanes): a source
    out of the group gives the lane's own word."""
    seg = LANES & ~(G - 1)
    ok = (src >= seg) & (src <= seg + G - 1)
    return np.where(ok, xs[np.where(ok, src, LANES)], xs)


def _up(xs, q, r, G):
    """Band::up: the group's words moved up by 32 q + r states (shuffles
    up by q and by q + 1, a 5-bit operand: 32 wraps to 0)."""
    j = LANES % G
    a = np.where(j >= q, _shfl(xs, LANES - (q & 31), G), np.uint64(0))
    b = np.where(j > q, _shfl(xs, LANES - ((q + 1) & 31), G), np.uint64(0))
    return ((a << np.uint64(r)) | (b >> np.uint64(32 - r))) & M32 if r else a


def _down(xs, q, r, G):
    """Band::down: moved down by 32 q + r states."""
    j = LANES % G
    a = np.where(j + q < G, _shfl(xs, LANES + (q & 31), G), np.uint64(0))
    b = np.where(j + q + 1 < G, _shfl(xs, LANES + ((q + 1) & 31), G), np.uint64(0))
    return ((a >> np.uint64(r)) | (b << np.uint64(32 - r))) & M32 if r else a


def _diags(offsets, reverse: bool):
    """band_diags of scan_long_wide.cu: (row, q, r, up) per kept diagonal,
    the ups first."""
    out = []
    for want_up in (True, False):
        for row, d in enumerate(offsets):
            e = -d if reverse else d
            if (e >= 0) == want_up:
                out.append((row, abs(e) >> 5, abs(e) & 31, want_up))
    return out


class _Model:
    """One warp of the band step on the tables' band table: G lanes a
    window, 32 // G windows."""

    def __init__(self, tables: spl.NfaTables, G: int):
        S, W = tables.s_tile, spl._words(tables.s_tile)
        self.S, self.W, self.G = S, W, G
        flat = tables.band.numpy().view(np.uint32).astype(np.uint64)
        K = spl.BANDED_MAX_DIAGS
        self.dm = flat[: 2 * K * W].reshape(2, K, W)  # sources, destinations
        self.res = flat[2 * K * W:(2 * K + 2) * W].reshape(2, W)
        self.rows = flat[(2 * K + 3) * W:].reshape(2, S, W)
        tab = tables.tab.numpy().view(np.uint32).astype(np.uint64).reshape(-1, W)
        self.seed, self.mask = tab[0], tab[2 * S:2 * S + spl.N_SYMS]
        self.acc = np.bitwise_or.reduce(tab[2 * S + spl.N_SYMS:], axis=0)  # the P rows' union
        self.offsets = tables.diags
        self.enter0 = bool(flat[(2 * K + 2) * W] & np.uint64(1))

    def lanes(self, words):
        """[32 // G, W] words -> the warp's 32 lane words."""
        xs = np.zeros(32, np.uint64)
        for h, wd in enumerate(words):
            xs[h * self.G:h * self.G + self.W] = wd
        return xs

    def words(self, xs):
        return np.stack([xs[h * self.G:h * self.G + self.W] for h in range(32 // self.G)])

    def walk(self, xs, pred):
        """Lane j of each window ORs word j of the residual row of every
        live state of its window's set."""
        out = []
        for x in self.words(xs):
            live = np.flatnonzero(spl._unpack_rows(x[None, :].astype(np.uint32), self.S)[0])
            out.append(np.bitwise_or.reduce(self.rows[int(pred), live], axis=0) if live.size
                       else np.zeros(self.W, np.uint64))
        return self.lanes(out)

    def per_lane(self, row):
        return self.lanes([row] * (32 // self.G))

    def fwd(self, v, gates, syms):
        """The seed row where the seed fires or state 0 is live, the
        diagonals, the residual rows s >= 1 walked."""
        return self.fwd_seeded(v, [g or bool(wd[0] & np.uint64(1)) for g, wd in zip(gates, v)],
                               syms)

    def fwd_seeded(self, v, seed, syms):
        """``fwd`` with the seed row applied to the windows where ``seed``
        is set (``Band::fwd``'s seed argument)."""
        return self.fwd_word(v, [self.seed if f else np.zeros(self.W, np.uint64) for f in seed],
                             syms)

    def fwd_word(self, v, seed_words, syms):
        """The step with a seed word per window (``Band::fwd_word``): the
        seed words, the diagonals, the residual rows s >= 1 walked."""
        xs = self.lanes(v)
        y = self.lanes(seed_words)
        for row, q, r, up in _diags(self.offsets, False):  # shifted, then the destinations
            y |= (_up(xs, q, r, self.G) if up else _down(xs, q, r, self.G)) \
                & self.per_lane(self.dm[1, row])
        y |= self.walk(xs & self.per_lane(self.res[0]), False)
        return self.words(y & self.lanes([self.mask[s] for s in syms]))

    def rev(self, r_words, syms):
        """The diagonals shifted back, the residual pred rows walked, state
        0 iff x meets the seed row."""
        xw = (r_words | self.acc) & np.stack([self.mask[s] for s in syms])
        xs = self.lanes(xw)
        y = self.walk(xs & self.per_lane(self.res[1]), True)
        for row, q, r, up in _diags(self.offsets, True):
            y |= (_up(xs, q, r, self.G) if up else _down(xs, q, r, self.G)) \
                & self.per_lane(self.dm[0, row])
        out = self.words(y)
        for h, x in enumerate(xw):
            out[h, 0] |= np.uint64(bool((x & self.seed).any()))
        return out


def _bits(words, S):
    return torch.from_numpy(spl._unpack_rows(np.asarray(words, np.uint32), S))


# (program or None, planted tile, state words): lanes of 32 for all, halves
# of 16 (two windows a warp) where W <= 16
TILES = [("K60", None, 16), ("run", None, 12), ("chain", None, 32), ("K60+", None, 16),
         ("chain+", None, 32), (None, 384, 12), (None, 512, 16), (None, 1024, 32)]
CASES = [(name, S, G) for name, S, W in TILES for G in (32, 16) if G == 32 or W <= 16]


@pytest.mark.parametrize("keep", [True, False], ids=["diagonals", "walk-all"])
@pytest.mark.parametrize("name,S,G", CASES,
                         ids=[f"{c[0] or f'planted{c[1]}'}-G{c[2]}" for c in CASES])
def test_band_step_model_matches_plain(name, S, G, keep):
    """Each tile with its diagonals kept, and with every edge walked (the
    default of a program with a residual outside the seed row)."""
    tables = _prog_tables(name)[1] if name else _random_tables(S, S)
    tables = spl.with_band(tables, spl.BANDED_MAX_DIAGS if keep else 0)
    S, W = tables.s_tile, spl._words(tables.s_tile)
    assert G == 32 or W <= 16
    rng = np.random.default_rng(S + G)
    model = _Model(tables, G)
    pt = tables.plain("cpu")
    nwin = 32 // G
    for trial in range(4):
        dens = (0.02, 0.3, 0.0, 0.6)[trial]
        v = spl._pack_rows(rng.random((nwin, S)) < dens, W).astype(np.uint64)
        if trial == 2:
            v[:, 0] |= np.uint64(1)  # state 0 live: its own (residual) row
        syms = [int(s) for s in rng.integers(0, spl.N_SYMS, size=nwin)]
        syms[0] = int(rng.choice([spl.sb.SYM_BOS, spl.sb.SYM_EOS, ord("a"), ord("x")]))
        gates = [bool(g) for g in rng.random(nwin) < 0.5]
        sym_t = torch.tensor(syms)
        got = model.fwd(v, gates, syms)
        want = pt.step(_bits(v, S), torch.tensor(gates), sym_t)
        assert torch.equal(_bits(got, S), want), f"forward, trial {trial}"
        got_r = model.rev(v, syms)
        want_r = pt.rev(_bits(v, S), sym_t)
        assert torch.equal(_bits(got_r, S), want_r), f"reverse, trial {trial}"


# ---------------------------------------------------------------------------
# What the wide window wrappers hand the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["flags", "count", "reverse", "carry"])
def test_long_run_passes_the_band(name, monkeypatch):
    """At a wide tile ``_long_run`` hands rrx_long_wide_flags, _count and
    _reverse the band table, its offset count, the offsets (a host int
    array of BANDED_MAX_DIAGS) and the lanes a window after their own
    arguments, and carry (the Wide step) none; without a band split the
    three raise, as the kernels take no other form."""
    calls = []
    monkeypatch.setattr(spl, "_long_launch", lambda entry, *a: calls.append((entry, a)))
    tables = _prog_tables("K60")[1]  # W = 16: two windows a warp
    geom = spl.LongGeom(300, 2, 256, 0, 256)
    data = torch.zeros(300, dtype=torch.uint8)
    own = ("tail", "args")  # stand-ins for the kernel's own arguments
    wrapper = getattr(spl, f"long_{name}")
    before = wrapper.wide_launches
    spl._long_run(name, wrapper, data, geom, tables, *own)
    assert wrapper.wide_launches == before + 1
    (entry, args), = calls
    assert entry == f"rrx_long_wide_{name}"
    assert args[:2] == (data, geom) and args[2] is tables and args[3:5] == own
    if name == "carry":
        assert args[5:] == ()
        return
    band, nd, offs, lanes = args[5:]
    assert band is tables.band and nd == len(tables.diags) == 1
    assert list(offs) == [1] + [0] * (spl.BANDED_MAX_DIAGS - 1) and lanes == 16
    wide32 = tables._replace(band_lanes=32)
    spl._long_run(name, wrapper, data, geom, wide32, *own)
    assert calls[-1][1][-1] == 32
    with pytest.raises(ValueError, match="without a band split"):
        spl._long_run(name, wrapper, data, geom, tables._replace(band=None), *own)
    assert wrapper.wide_launches == before + 2


# ---------------------------------------------------------------------------
# The record reverse on the band step (rrx_nfa_wide_reverse)
# ---------------------------------------------------------------------------


def _walk_chunks_rev(row: np.ndarray, n: int):
    """``walk_chunks_rev`` of ``csrc/scan_core.cuh`` on one record of n
    bytes (its row padded to 16-byte chunks): (t, sym) from the EOS step t
    = n + 1 down to the BOS step t = 0. A chunk is one 128-bit word (byte 0
    lowest), loaded one chunk ahead; the last one is shifted up until byte
    n - 1 is its top byte, then each step takes the top byte and shifts the
    chunk up by 8 bits."""
    mask = (1 << 128) - 1
    chunk = lambda c: int.from_bytes(row[16 * c:16 * c + 16].tobytes(), "little")  # noqa: E731
    nc = (n + 15) >> 4
    nq = chunk(nc - 1) if nc > 0 else 0
    t = n + 1
    for c in range(nc, -2, -1):
        q, k, fixed = nq, 1, spl.sb.SYM_BOS if c < 0 else spl.sb.SYM_EOS
        if 0 <= c < nc:
            k, fixed = min(16, n - 16 * c), -1
            nq = chunk(max(c - 1, 0))
            q = (q << (8 * (16 - k))) & mask
        for _ in range(k):
            yield t, fixed if fixed >= 0 else q >> 120
            q = (q << 8) & mask
            t -= 1


def _reverse_records(tables: spl.NfaTables, data: np.ndarray, lengths: np.ndarray):
    """``wide_reverse_kernel`` on the model: one record a warp (32 lanes),
    its bytes walked down by ``walk_chunks_rev``, per step R = the band
    step's reverse (``Band::rev``) and the hit bit s0 = x meets follow[0]
    (x = (R | acc) & mask[sym]), which is also state 0 of the new R; lane 0
    stores each hit word when bit 0 closes it, and the words past (len +
    1) / 32 are zeroed. The hit words start as garbage (``torch.empty``).
    The band table is the record reverse's (``rec_band``)."""
    model = _Model(tables._replace(band=tables.rec_band, diags=tables.rec_diags), 32)
    R, L = data.shape
    Wt = spl.sb.hit_words(L)
    hits = np.random.default_rng(1).integers(0, 1 << 32, size=(Wt, R), dtype=np.uint64)
    row = np.zeros(((L + 15) // 16) * 16, np.uint8)
    for r in range(R):
        n = int(min(max(lengths[r], 0), L))
        hits[((n + 1) >> 5) + 1:, r] = 0
        row[:L] = data[r]
        rs, word = np.zeros((1, model.W), np.uint64), 0
        for t, sym in _walk_chunks_rev(row, n):
            x = (rs[0] | model.acc) & model.mask[sym]
            s0 = bool((x & model.seed).any())
            rs = model.rev(rs, [sym])
            assert bool(rs[0, 0] & np.uint64(1)) == s0, "state 0 of R is not the hit bit"
            word |= int(s0) << (t & 31)
            if t & 31 == 0:
                hits[t >> 5, r] = word
                word = 0
    return spl.sb._as_i32(torch.from_numpy(hits.astype(np.int64)))


# record lengths: empty, the chunk edges, and a full row (L a multiple of 16)
EDGE_LENGTHS = (0, 1, 15, 16, 17, 31, 32, 33, 47, 48)


def _reverse_batch(name, S: int):
    """Records over the program's bytes (every byte below 0x80 for a planted
    tile) at EDGE_LENGTHS and full rows, with its matches planted: chains
    x(ab|c){k}y of 300-303 tokens, runs of K60's keywords."""
    rng = np.random.default_rng(S + len(name or ""))
    if name == "chain+":
        L = 352
        data = rng.choice(np.frombuffer(b"xabcy", np.uint8), size=(14, L)).astype(np.uint8)
        for r, at in ((10, 0), (11, 9), (12, 30)):
            body = b"".join(rng.choice([b"ab", b"c"], size=300 + at // 10, p=[0.05, 0.95]))
            w = (b"x" + body + b"y")[: L - at]
            data[r, at:at + len(w)] = np.frombuffer(w, np.uint8)
        lengths = np.array(EDGE_LENGTHS + (L, 330, L - 5, L), np.int32)
        lengths[12] = min(L, 30 + 2 + len(body))
        return data, lengths
    L = 64
    if name == "K60+":
        words = [w.encode() for w in _keywords(60)]
        data = rng.choice(np.frombuffer(b"abcdefgilmnorstuwx ", np.uint8), size=(14, L))
        for r in range(2, 14, 2):
            w = b"".join(words[int(i)] for i in rng.integers(0, 60, size=3))[: L - 4]
            data[r, 3:3 + len(w)] = np.frombuffer(w, np.uint8)
    else:
        data = rng.integers(0, 0x80, size=(14, L))
        data[5, 2] = 0xC3  # a byte >= 0x80 (no mask row: the state dies)
    lengths = np.array(EDGE_LENGTHS + (L, L - 1, 40, L), np.int32)
    return data.astype(np.uint8), lengths


# (program or planted tile of S states): the default split, then the other
RECORD_TILES = [("chain+", None), ("K60+", None), (None, 384), (None, 1024)]


@pytest.mark.parametrize("keep", [True, False], ids=["diagonals", "walk-all"])
@pytest.mark.parametrize("name,S", RECORD_TILES,
                         ids=[n or f"planted{S}" for n, S in RECORD_TILES])
def test_record_reverse_model_matches_plain(name, S, keep):
    """The record reverse on the band step (one record a warp, the bytes by
    ``walk_chunks_rev``, hit words with a zeroed tail) equals
    ``scan_bits.reverse_plain`` on x(ab|c){300,}y (four diagonals), K60+
    (one) and planted tiles with a residual (and a zero dead-step row),
    with the diagonals kept (the record reverse's default) and every edge
    walked; records of length 0, at the chunk edges and full."""
    tables = _prog_tables(name)[1] if name else _random_tables(S, S, dead=False)
    tables = spl.with_band(tables, spl.BANDED_MAX_DIAGS if keep else 0)
    data, lengths = _reverse_batch(name, tables.s_tile)
    got = _reverse_records(tables, data, lengths)
    want = spl.sb.reverse_plain(torch.from_numpy(data), torch.from_numpy(lengths), tables)
    assert torch.equal(got, want)
    assert want.any(), "no hit bit: the batch shows nothing"
    if name is None:
        assert len(tables.rec_diags) == (len(PLANTED) if keep else 0)


def test_walk_chunks_rev_order():
    """The reverse walker's steps: len + 1 (EOS) down to 0 (BOS), byte t - 1
    at step t, for every length 0..50 of a 64-byte row."""
    row = np.arange(64, dtype=np.uint8) + 100
    for n in range(51):
        steps = list(_walk_chunks_rev(row, n))
        want = [(n + 1, spl.sb.SYM_EOS)] + [(t, int(row[t - 1])) for t in range(n, 0, -1)] + [
            (0, spl.sb.SYM_BOS)]
        assert steps == want, n


@pytest.mark.parametrize("name", ["chain+", "K60+", "narrow"])
def test_nfa_reverse_passes_the_band(name, monkeypatch):
    """Past 256 states ``nfa_reverse`` launches rrx_nfa_wide_reverse with
    the hit words, the record reverse's band table (its diagonals kept even
    where the window kernels walk every edge: K60+), its offset count and
    the offsets (a host int array of BANDED_MAX_DIAGS), then the zeroed
    record counter, and counts the launch; it refuses tables without that
    split. A narrow
    tile launches rrx_nfa_reverse with the hit words alone. The meta device
    stands in for the card."""
    calls = []
    monkeypatch.setattr(spl, "_launch", lambda entry, *a: calls.append((entry, a)))
    tables = (spl.device_nfa_tables(compile_program(_kw(20)), "cpu") if name == "narrow"
              else _prog_tables(name)[1])
    data = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(4, dtype=torch.int32, device="meta")
    wide = tables.s_tile > spl.REG_S_TILE
    counter = "wide_launches" if wide else "launches"
    before = getattr(spl.nfa_reverse, counter)
    hits = spl.nfa_reverse(data, lengths, tables)
    assert getattr(spl.nfa_reverse, counter) == before + 1
    assert tuple(hits.shape) == (spl.sb.hit_words(32), 4) and hits.dtype == torch.int32
    (entry, args), = calls
    assert args[:3] == (data, lengths, tables) and args[3] is hits
    if not wide:
        assert entry == "rrx_nfa_reverse" and len(args) == 4
        return
    assert entry == "rrx_nfa_wide_reverse"
    band, nd, offs, nxt = args[4:]
    assert band is tables.rec_band and nd == len(tables.rec_diags)
    assert tables.rec_diags == {"chain+": (1, 2, 3, 4), "K60+": (1,)}[name]
    assert len(offs) == spl.BANDED_MAX_DIAGS and list(offs)[:nd] == list(tables.rec_diags)
    assert not any(list(offs)[nd:])
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (1,)
    with pytest.raises(ValueError, match="without a band split"):
        spl.nfa_reverse(data, lengths, tables._replace(rec_band=None))
    assert spl.nfa_reverse.wide_launches == before + 1


@pytest.mark.parametrize("max_diags", [None, 0, spl.BANDED_MAX_DIAGS])
def test_record_reverse_needs_a_zero_dead_row(max_diags, monkeypatch):
    """The record reverse stops at each record's EOS step, where the plain
    reverse walks on over the dead steps: ``with_band`` marks tables whose
    dead step's mask row is not zero (``dead_row``), and ``nfa_reverse``
    refuses them, launching nothing; the window kernels' split and the
    record kernels' split (which the forward flags read too) are built
    either way."""
    calls = []
    monkeypatch.setattr(spl, "_launch", lambda entry, *a: calls.append(entry))
    data = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(4, dtype=torch.int32, device="meta")
    for dead in (True, False):
        tables = spl.with_band(_random_tables(384, 7, dead=dead), max_diags)
        assert tables.band is not None and tables.rec_band is not None
        assert tables.dead_row == dead
        if dead:
            with pytest.raises(ValueError, match="dead step's mask row"):
                spl.nfa_reverse(data, lengths, tables)
        else:
            spl.nfa_reverse(data, lengths, tables)
    assert calls == ["rrx_nfa_wide_reverse"]


# ---------------------------------------------------------------------------
# The record flags and the multi-channel reverse on the band step
# (rrx_nfa_wide_flags, rrx_nfa_wide_reverse_mb)
# ---------------------------------------------------------------------------


def _walk_chunks_pair(row: np.ndarray, n: int, n_max: int):
    """``walk_chunks_pair`` of ``csrc/scan_core.cuh`` for one half: (t, sym)
    for t = 0 .. n_max + 1, sym the half's own symbol (BOS at 0, byte t - 1
    for t <= n, EOS at n + 1, the dead step past it). The half's chunks are
    loaded one ahead (its last one again once its record is done) and each
    step takes the bottom byte of the chunk and shifts it down by 8 bits."""
    chunk = lambda c: int.from_bytes(row[16 * c:16 * c + 16].tobytes(), "little")  # noqa: E731
    own = (n + 15) >> 4
    nq = chunk(0) if own > 0 else 0
    yield 0, spl.sb.SYM_BOS
    for c in range((n_max + 15) >> 4):
        q = nq
        if own > 0:
            nq = chunk(min(c + 1, own - 1))
        for b in range(min(16, n_max - 16 * c)):
            t = 1 + 16 * c + b
            byte = q & 0xFF
            q >>= 8
            yield t, byte if t <= n else (spl.sb.SYM_EOS if t == n + 1 else spl.sb.SYM_DEAD)
    yield n_max + 1, spl.sb.SYM_EOS if n_max == n else spl.sb.SYM_DEAD


def _flags_records(tables: spl.NfaTables, data: np.ndarray, lengths: np.ndarray, G: int,
                   seeded: bool):
    """``wide_flags_kernel<G>`` on the model: 32 // G records a warp from
    the record band split (``rec_band``), both walked to the longer one,
    each with its own EOS and dead steps; where no window holds a live
    state the step is the seed row alone (the record flags' split,
    ``fwd_band``); a flag bit only up to the
    record's EOS step; each word stored when bit 31 closes it (up to the
    EOS word), the EOS word after the walk where the walk ended first; the
    words past the EOS word zeroed. A half past the last record steps
    record R - 1 and writes nothing. The flag words start as garbage.
    Returns (flags, steps skipped, steps taken)."""
    model = _Model(tables._replace(band=tables.fwd_band, diags=tables.fwd_diags), G)
    R, L = data.shape
    Wt = spl.sb.hit_words(L)
    flags = np.random.default_rng(2).integers(0, 1 << 32, size=(Wt, R), dtype=np.uint64)
    rows = np.zeros((R, ((L + 15) // 16) * 16), np.uint8)
    rows[:, :L] = data
    npair = 32 // G
    skipped = taken = 0
    for u in range(-(-R // npair)):
        rs = [u * npair + h for h in range(npair)]
        act = [r < R for r in rs]
        rs = [r if a else R - 1 for r, a in zip(rs, act)]
        ns = [int(min(max(lengths[r], 0), L)) for r in rs]
        n_max = max(ns)
        eos = [n + 1 for n in ns]
        for h, r in enumerate(rs):
            if act[h]:
                flags[(eos[h] >> 5) + 1:, r] = 0
        walks = [list(_walk_chunks_pair(rows[r], n, n_max)) for r, n in zip(rs, ns)]
        v = np.zeros((npair, model.W), np.uint64)
        word = [0] * npair
        for i in range(n_max + 2):
            t = walks[0][i][0]
            assert all(w[i][0] == t for w in walks)
            syms = [w[i][1] for w in walks]
            gate = seeded or t < 2
            if v.any():
                seed = [gate or (model.enter0 and bool(wd[0] & np.uint64(1))) for wd in v]
                v = model.fwd_seeded(v, seed, syms)
                taken += 1
            else:
                v = np.stack([(model.seed if gate else np.zeros(model.W, np.uint64))
                              & model.mask[sym] for sym in syms])
                skipped += 1
            for h in range(npair):
                if t <= eos[h]:
                    word[h] |= int(bool((v[h] & model.acc).any())) << (t & 31)
            if t & 31 == 31:
                for h, r in enumerate(rs):
                    if act[h] and t - 31 <= eos[h]:
                        flags[t >> 5, r] = word[h]
                    word[h] = 0
        for h, r in enumerate(rs):
            if act[h] and (eos[h] | 31) > n_max + 1:
                flags[eos[h] >> 5, r] = word[h]
    return spl.sb._as_i32(torch.from_numpy(flags.astype(np.int64))), skipped, taken


def _pair_batch(name, S: int):
    """``_reverse_batch``'s records, an odd count, two of them with an EOS
    step at bit 31 of a word (lengths 30 and 62), paired shortest with
    longest so that the two records of a warp differ: 0 beside a full row,
    31 (its EOS word closing after its EOS step) beside 62."""
    data, lengths = _reverse_batch(None if name == "cycle" else name, S)
    lengths[1:3] = (30, 62)
    order = np.argsort(lengths, kind="stable")
    order = np.delete(order, np.flatnonzero(~np.isin(lengths[order], (0, 30, 31, 62, 64)))[0])
    lo, hi = order[: len(order) // 2], order[len(order) // 2:][::-1]
    order = np.stack([lo, hi[: lo.size]], axis=1).reshape(-1)  # the shortest beside the longest
    order = np.append(order, hi[lo.size:])
    return data[order], lengths[order]


@functools.lru_cache(maxsize=None)
def _cycle_tables() -> spl.NfaTables:
    """A hand-built tile of 384 states whose unseeded scan lives on state 0:
    the seed row {1, 150}, runs 1 -> 2 -> ... -> 300 and 150 -> ... (d =
    +1, kept), 10 -> 0 (a residual edge into state 0), the accept state
    160 reached only through the seed row's residual edge 0 -> 150; every
    byte below 0x80, BOS and EOS allow every state, the dead step none.
    Without the seed row applied for a live state 0, the flags after the
    first cycle differ."""
    S, W = 384, spl._words(384)
    F = np.zeros((S, S), bool)
    F[np.arange(1, 300), np.arange(2, 301)] = True
    F[0, [1, 150]] = True
    F[10, 0] = True
    mbits = np.zeros((spl.N_SYMS, S), bool)
    mbits[:0x80] = mbits[spl.sb.SYM_BOS] = mbits[spl.sb.SYM_EOS] = True
    acc = np.zeros((1, S), bool)
    acc[0, 160] = True
    tab = np.concatenate([spl._pack_rows(F, W), spl._pack_rows(F.T, W),
                          spl._pack_rows(mbits, W), spl._pack_rows(acc, W)])
    t = spl.NfaTables(torch.from_numpy(tab.reshape(-1).view(np.int32).copy()), S)
    return spl.with_band(t, rows=tab)


def _flag_tables(name, S: int, residual: bool) -> spl.NfaTables:
    if name == "cycle":
        return _cycle_tables()
    return _prog_tables(name)[1] if name else _random_tables(S, S, residual, dead=False)


# (program, planted tile of S states with residual edges or the seed row
# alone, or the cycle through state 0)
FLAG_TILES = [(n, S, True) for n, S in RECORD_TILES] + [(None, 512, False), ("cycle", 384, True)]
FLAG_CASES = [(name, S, res, G) for name, S, res in FLAG_TILES for G in (32, 16)
              if G == 32 or name != "chain+" and S != 1024]


@pytest.mark.parametrize("keep", [True, False], ids=["diagonals", "walk-all"])
@pytest.mark.parametrize("name,S,residual,G", FLAG_CASES,
                         ids=[f"{n or f'planted{S}' + ('' if r else '-seed-row')}-G{G}"
                              for n, S, r, G in FLAG_CASES])
def test_record_flags_model_matches_plain(name, S, residual, G, keep):
    """The record flags on the band step, seeded and unseeded, equal
    ``flags_plain`` on x(ab|c){300,}y (four diagonals: many skipped steps),
    K60+ (one), planted tiles with a residual or with the seed row alone,
    and a tile whose unseeded scan cycles through state 0 (the seed row
    applied for a live state 0, ``Band::has0``), with the diagonals kept
    and every edge walked (K60+'s and the chain's defaults), at 32 lanes a
    record and, where W <= 16, two records a warp; an odd count of records
    of length 0, at the chunk edges and full, shuffled into unequal pairs."""
    tables = spl.with_band(_flag_tables(name, S, residual), spl.BANDED_MAX_DIAGS if keep else 0)
    data, lengths = _pair_batch(name, tables.s_tile)
    assert len(lengths) % 2 == 1 and {0, 30, 62} <= set(lengths.tolist())
    assert lengths.max() == data.shape[1]
    lt, dt = torch.from_numpy(lengths), torch.from_numpy(data)
    for seeded in (True, False):
        got, skipped, taken = _flags_records(tables, data, lengths, G, seeded)
        want = spl.flags_plain(dt, lt, tables, seeded=seeded)
        assert torch.equal(got, want), f"seeded={seeded}"
        assert taken > 0 and (skipped > 0 or seeded)
        assert want.any() or not seeded, "no flag bit: the batch shows nothing"


def test_walk_chunks_pair_order():
    """The pair walker: t = 0 .. n_max + 1 for every half, byte t - 1 at
    step t <= n, EOS at n + 1 and the dead step past it, for n = 0..50 of a
    64-byte row against a partner of 0..50 bytes."""
    row = np.arange(64, dtype=np.uint8) + 100
    for n in range(51):
        for n_max in range(n, 51, 7):
            steps = list(_walk_chunks_pair(row, n, n_max))
            want = [(0, spl.sb.SYM_BOS)] + [(t, int(row[t - 1])) for t in range(1, n + 1)] + [
                (n + 1, spl.sb.SYM_EOS)] + [(t, spl.sb.SYM_DEAD) for t in range(n + 2, n_max + 2)]
            assert steps == want, (n, n_max)


@functools.lru_cache(maxsize=None)
def _channel_tables(which: str):
    """(tables, span rows [P, 2, W] int32) of a wide multi-channel tile: the
    P = 3 union of K40+, cat|dog and [0-9]{3} (``MultiPattern``), its `$`
    form (K40+, cat$, [0-9]?$), or 40 channels on K40+'s tile (each state
    owned by a random channel, the seed row's states split among them)."""
    from roaringregex_tpu_torch.api import MultiPattern

    k40 = _kw(40, "+")
    if which != "40":
        pats = [k40, "cat|dog", "[0-9]{3}"] if which == "P3" else [k40, "cat$", "[0-9]?$"]
        sc = MultiPattern(pats, "cpu").engine.device_scanner
        return sc.nfa, sc.span
    prog = compile_program(k40)
    S = prog.s_tile
    rng = np.random.default_rng(40)
    owner = rng.integers(0, 40, size=S)
    acc = np.zeros((S, 40), np.uint8)
    acc[np.arange(S), owner] = np.asarray(prog.accept)[:S] != 0
    f0 = np.flatnonzero(np.asarray(prog.F[0, :S]))
    sgm = np.zeros((40, S), np.uint8)
    sgm[owner[f0], f0] = 1
    posm = np.zeros((S, 40), np.uint8)
    posm[np.arange(S), owner] = 1
    posm[0] = 0
    span = spl.span_channels(sgm, posm, 40, S).view(np.int32).copy()
    return spl.device_nfa_tables(prog, "cpu", acc, 40), torch.from_numpy(span)


def _reverse_mb_records(tables: spl.NfaTables, span: torch.Tensor, data: np.ndarray,
                        lengths: np.ndarray):
    """``wide_reverse_mb_kernel`` on the model: one record a warp, the
    bytes by ``walk_chunks_rev``, R = the band step on x = (R | acc) &
    mask[sym] (acc the union of the P accept rows); where x meets follow[0]
    (s0) each channel c tests x against its sg row: lane c < 32 keeps its
    open hit word and stores it when bit 0 closes it, channels past 32 OR
    their bits into the words, each zeroed when it opens; the words past
    the EOS word zeroed. The hit words start as garbage."""
    model = _Model(tables._replace(band=tables.rec_band, diags=tables.rec_diags), 32)
    P = tables.P
    sg = span.numpy().view(np.uint32).astype(np.uint64)[:, 0]  # [P, W]
    R, L = data.shape
    Wt = spl.sb.hit_words(L)
    hits = np.random.default_rng(3).integers(0, 1 << 32, size=(P, Wt, R), dtype=np.uint64)
    row = np.zeros(((L + 15) // 16) * 16, np.uint8)
    fired = 0
    for r in range(R):
        n = int(min(max(lengths[r], 0), L))
        hits[:, ((n + 1) >> 5) + 1:, r] = 0
        row[:L] = data[r]
        rs = np.zeros((1, model.W), np.uint64)
        hw = [0] * min(P, 32)
        for t, sym in _walk_chunks_rev(row, n):
            if t == n + 1 or t & 31 == 31:  # walking down, word t / 32 opens
                hw = [0] * min(P, 32)
                hits[32:, t >> 5, r] = 0
            x = (rs[0] | model.acc) & model.mask[sym]
            rs = model.rev(rs, [sym])
            if (x & model.seed).any():
                fired += 1
                for c in range(P):
                    if (x & sg[c]).any():
                        if c < 32:
                            hw[c] |= 1 << (t & 31)
                        else:
                            hits[c, t >> 5, r] |= np.uint64(1 << (t & 31))
            if t & 31 == 0:
                hits[:32, t >> 5, r] = hw
    assert fired > 0
    return spl.sb._as_i32(torch.from_numpy(hits.astype(np.int64)))


def _channel_batch(L: int = 80):
    """Records of length 0, at the chunk edges and full over K40+'s words,
    cat, dog, digits and spaces, a word, a number or cat at some records'
    ends (the `$` channels)."""
    rng = np.random.default_rng(7)
    words = [w.encode() for w in _keywords(40)] + [b"cat", b"dog", b"123", b"45"]
    R = 15
    data = rng.choice(np.frombuffer(b"abcdefgilmnorstu 0123456789", np.uint8), size=(R, L))
    for r in range(R):
        w = b" ".join(words[int(i)] for i in rng.integers(0, len(words), size=4))[:L]
        at = int(rng.integers(0, L - len(w) + 1))
        data[r, at:at + len(w)] = np.frombuffer(w, np.uint8)
    lengths = np.array(EDGE_LENGTHS + (L, L - 1, 64, 70, L), np.int32)
    for r in range(2, R, 3):
        e = int(lengths[r])
        if e >= 3:
            data[r, e - 3:e] = np.frombuffer(b"cat" if r % 2 else b" 45", np.uint8)
    return data.astype(np.uint8), lengths


@pytest.mark.parametrize("keep", [True, False], ids=["diagonals", "walk-all"])
@pytest.mark.parametrize("which", ["P3", "P3$", "40"])
def test_record_reverse_mb_model_matches_plain(which, keep):
    """The multi-channel reverse on the band step equals
    ``reverse_mb_plain`` on the P = 3 union, its `$` channels and 40
    channels on K40+'s tile (8 past lane 31), with its diagonal kept (the
    default) and every edge walked."""
    tables, span = _channel_tables(which)
    assert tables.s_tile > spl.REG_S_TILE and tables.rec_diags == (1,) and not tables.dead_row
    tables = spl.with_band(tables, spl.BANDED_MAX_DIAGS if keep else 0)
    data, lengths = _channel_batch()
    got = _reverse_mb_records(tables, span, data, lengths)
    want = spl.reverse_mb_plain(torch.from_numpy(data), torch.from_numpy(lengths), tables, span)
    assert torch.equal(got, want)
    hit = [bool(want[c].any()) for c in range(tables.P)]
    assert all(hit) if tables.P == 3 else any(hit[32:]), f"channels with a hit: {hit}"


@pytest.mark.parametrize("name", ["chain+", "K60+", "narrow"])
def test_nfa_flags_passes_the_band(name, monkeypatch):
    """Past 256 states ``nfa_flags`` launches rrx_nfa_wide_flags with its
    seed flag and flag words, the record flags' band split (K60+'s one
    diagonal; every edge walked for the chain), its offset count, the
    offsets (a host int array of BANDED_MAX_DIAGS) and the lanes a record
    (16 where W <= 16), then the zeroed record counter, and counts the
    launch; it refuses tables without that split. A narrow tile launches
    rrx_nfa_flags with the seed flag and the flag words alone. The meta
    device stands in for the card."""
    calls = []
    monkeypatch.setattr(spl, "_launch", lambda entry, *a: calls.append((entry, a)))
    tables = (spl.device_nfa_tables(compile_program(_kw(20)), "cpu") if name == "narrow"
              else _prog_tables(name)[1])
    data = torch.zeros((5, 32), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(5, dtype=torch.int32, device="meta")
    wide = tables.s_tile > spl.REG_S_TILE
    counter = "wide_launches" if wide else "launches"
    before = getattr(spl.nfa_flags, counter)
    words = spl.nfa_flags(data, lengths, tables, seeded=False)
    assert getattr(spl.nfa_flags, counter) == before + 1
    assert tuple(words.shape) == (spl.sb.hit_words(32), 5) and words.dtype == torch.int32
    (entry, args), = calls
    assert args[:3] == (data, lengths, tables) and args[3] == 0 and args[4] is words
    if not wide:
        assert entry == "rrx_nfa_flags" and len(args) == 5
        return
    assert entry == "rrx_nfa_wide_flags"
    band, nd, offs, lanes, nxt = args[5:]
    assert band is tables.fwd_band and nd == len(tables.fwd_diags)
    assert tables.fwd_diags == {"chain+": (), "K60+": (1,)}[name]
    assert list(offs) == list(tables.fwd_diags) + [0] * (spl.BANDED_MAX_DIAGS - nd)
    assert lanes == {"chain+": 32, "K60+": 16}[name] == tables.band_lanes
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (1,)
    spl.nfa_flags(data, lengths, tables._replace(band_lanes=32), seeded=True)
    assert calls[-1][1][3] == 1 and calls[-1][1][8] == 32
    with pytest.raises(ValueError, match="without a band split"):
        spl.nfa_flags(data, lengths, tables._replace(fwd_band=None), seeded=True)
    assert spl.nfa_flags.wide_launches == before + 2


@pytest.mark.parametrize("which", ["P3", "40"])
def test_nfa_reverse_mb_passes_the_band(which, monkeypatch):
    """Past 256 states ``nfa_reverse_mb`` launches rrx_nfa_wide_reverse_mb
    with P, the span rows and the hit words, the record band split, its
    offset count and the offsets, then the zeroed record counter, and
    counts the launch; it refuses tables without that split and tables
    whose dead step's mask row is not zero, launching nothing."""
    calls = []
    monkeypatch.setattr(spl, "_launch", lambda entry, *a: calls.append((entry, a)))
    tables, span = _channel_tables(which)
    data = torch.zeros((3, 40), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(3, dtype=torch.int32, device="meta")
    span_m = torch.zeros(tuple(span.shape), dtype=torch.int32, device="meta")
    before = spl.nfa_reverse_mb.wide_launches
    hits = spl.nfa_reverse_mb(data, lengths, tables, span_m)
    assert spl.nfa_reverse_mb.wide_launches == before + 1
    assert tuple(hits.shape) == (tables.P, spl.sb.hit_words(40), 3)
    (entry, args), = calls
    assert entry == "rrx_nfa_wide_reverse_mb"
    assert args[:3] == (data, lengths, tables) and args[3] == tables.P and args[5] is hits
    band, nd, offs, nxt = args[6:]
    assert band is tables.rec_band and nd == len(tables.rec_diags) == 1
    assert list(offs) == [1] + [0] * (spl.BANDED_MAX_DIAGS - 1)
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (1,)
    with pytest.raises(ValueError, match="without a band split"):
        spl.nfa_reverse_mb(data, lengths, tables._replace(rec_band=None), span_m)
    with pytest.raises(ValueError, match="dead step's mask row"):
        spl.nfa_reverse_mb(data, lengths, tables._replace(dead_row=True), span_m)
    assert len(calls) == 1 and spl.nfa_reverse_mb.wide_launches == before + 1


# ---------------------------------------------------------------------------
# The record stats and the multi-channel lazy spans on the band step
# (rrx_nfa_wide_stats, rrx_nfa_wide_lazy_spans_mb)
# ---------------------------------------------------------------------------


def _acc_rows(tables: spl.NfaTables) -> np.ndarray:
    """[P, W] the tile's accept rows."""
    W = spl._words(tables.s_tile)
    tab = tables.tab.numpy().view(np.uint32).astype(np.uint64).reshape(-1, W)
    return tab[2 * tables.s_tile + spl.N_SYMS:]


def _stats_walk(tables: spl.NfaTables, data: np.ndarray, lengths: np.ndarray, G: int,
                seeded: bool):
    """The walk of ``wide_stats_kernel<G>`` on the model: 32 // G records a
    warp on the record flags' split, both walked to the longer one by
    ``walk_chunks_pair``; the step skipped to the seed row alone where no
    window holds a live state; a window's state cleared after every step
    from its EOS step on; an unseeded walk stopped after a step t >= 1
    (not the last) where no window holds a live state. Per record and
    accept channel, the (t, e = min(t, len)) of every step t <= len + 1
    whose state meets the channel's accept row, in order (P > 1: the union
    fires first, then each channel is tested); its statistics are a fold
    over them (:func:`_stats_fold`). A half past the last record steps
    record R - 1 and keeps nothing. Returns (hits [R][P] lists, steps
    skipped, steps taken, walks stopped early)."""
    model = _Model(tables._replace(band=tables.fwd_band, diags=tables.fwd_diags), G)
    accs = _acc_rows(tables)
    R, L = data.shape
    rows = np.zeros((R, ((L + 15) // 16) * 16), np.uint8)
    rows[:, :L] = data
    npair = 32 // G
    hits = [[[] for _ in range(len(accs))] for _ in range(R)]
    skipped = taken = stopped = 0
    for u in range(-(-R // npair)):
        rs = [u * npair + h for h in range(npair)]
        act = [r < R for r in rs]
        rs = [r if a else R - 1 for r, a in zip(rs, act)]
        ns = [int(min(max(lengths[r], 0), L)) for r in rs]
        n_max = max(ns)
        walks = [list(_walk_chunks_pair(rows[r], n, n_max)) for r, n in zip(rs, ns)]
        v = np.zeros((npair, model.W), np.uint64)
        for i in range(n_max + 2):
            t = walks[0][i][0]
            syms = [w[i][1] for w in walks]
            gate = seeded or t < 2
            if v.any():
                seed = [gate or (model.enter0 and bool(wd[0] & np.uint64(1))) for wd in v]
                v = model.fwd_seeded(v, seed, syms)
                taken += 1
            else:
                v = np.stack([(model.seed if gate else np.zeros(model.W, np.uint64))
                              & model.mask[sym] for sym in syms])
                skipped += 1
            for h, r in enumerate(rs):
                if t <= ns[h] + 1 and (v[h] & model.acc).any() and act[h]:
                    for c, a in enumerate(accs):
                        if (v[h] & a).any():
                            hits[r][c].append((t, min(t, ns[h])))
                if t >= ns[h] + 1:
                    v[h] = 0
            if i < n_max + 1 and not seeded and t >= 1 and not v.any():
                stopped += 1
                break
    return hits, skipped, taken, stopped


def _stats_fold(hits, lengths, L: int, *, seeded: bool, lead: int, nullable: bool, channels):
    """The kernel's statistics from ``_stats_walk``'s hits: an accept counts
    at t > lead; cnt counts ends that differ from the last one (none for a
    nullable seeded scan, whose cnt is len + 1 from the start), first keeps
    the first end, last the latest, full an accept at t >= len; the
    nullable starts as ``stats_plain`` states them."""
    lead = lead if lead > 0 else -1
    R, P = len(hits), len(hits[0])
    out = np.zeros((4, R, P), np.int64)
    for r in range(R):
        n = int(min(max(lengths[r], 0), L))
        for c in range(P):
            cnt = (n + 1 if seeded else 1) if nullable else 0
            first = 0 if nullable else -1
            last = (n if seeded else 0) if nullable else -1
            full = nullable and n == 0
            for t, e in hits[r][c]:
                if t <= lead:
                    continue
                cnt += int(not (nullable and seeded) and e != last)
                first = e if first < 0 else first
                last = e
                full = full or t >= n
            out[:, r, c] = (cnt, first, last, full)
    got = [torch.from_numpy(x).to(torch.int32) for x in out[:3]] + [torch.from_numpy(out[3] != 0)]
    return tuple(got) if channels else tuple(x[:, 0].contiguous() for x in got)


# (seeded, lead, nullable): lead 0 and 3, nullable and not, the `$` dedup
# off only in a nullable seeded scan
STATS_FORMS = [(True, 0, False), (True, 3, True), (False, 3, False), (False, 0, True)]


@pytest.mark.parametrize("keep", [True, False], ids=["diagonals", "walk-all"])
@pytest.mark.parametrize("name,S,residual,G", FLAG_CASES,
                         ids=[f"{n or f'planted{S}' + ('' if r else '-seed-row')}-G{G}"
                              for n, S, r, G in FLAG_CASES])
def test_record_stats_model_matches_plain(name, S, residual, G, keep):
    """The record stats on the band step (the flags' walker, step and skip;
    the statistics of each half in registers; an accept counted only up to
    the half's own EOS step, its state cleared from there; the unseeded
    stop once the warp holds no live state) equal ``stats_plain``, seeded
    and unseeded, with lead 0 and 3, nullable and not, on x(ab|c){300,}y,
    K60+, planted tiles with a residual or the seed row alone and the tile
    that cycles through state 0, in both splits, at 32 lanes a record and,
    where W <= 16, two records a warp; an odd count of records of length
    0, at the chunk edges and full, in unequal pairs."""
    tables = spl.with_band(_flag_tables(name, S, residual), spl.BANDED_MAX_DIAGS if keep else 0)
    data, lengths = _pair_batch(name, tables.s_tile)
    lt, dt = torch.from_numpy(lengths), torch.from_numpy(data)
    for seeded in (True, False):
        hits, skipped, taken, stopped = _stats_walk(tables, data, lengths, G, seeded)
        assert taken > 0 and (skipped > 0 or seeded)
        # a planted tile's random masks keep an unseeded set alive
        assert seeded or stopped > 0 or name not in ("K60+", "chain+"), "no early stop"
        for sd, lead, nullable in STATS_FORMS:
            if sd != seeded:
                continue
            kw = dict(seeded=seeded, lead=lead, nullable=nullable)
            got = _stats_fold(hits, lengths, data.shape[1], channels=False, **kw)
            want = spl.stats_plain(dt, lt, tables, **kw)
            for x, y, what in zip(got, want, ("cnt", "first", "last", "full")):
                assert torch.equal(x, y), f"{kw} {what}"
        if seeded:
            assert any(h for rec in hits for h in rec), "no accept: the batch shows nothing"


@pytest.mark.parametrize("which", ["P3", "P3$", "40"])
def test_record_stats_channels_model_matches_plain(which):
    """P accept channels at 32 lanes a record: the union gates the warp's
    buffer, each channel tested on the state; equal to ``stats_plain`` on
    the P = 3 union, its `$` form and 40 channels, in both splits."""
    base, _ = _channel_tables(which)
    data, lengths = _channel_batch()
    lt, dt = torch.from_numpy(lengths), torch.from_numpy(data)
    for keep in (True, False):
        tables = spl.with_band(base, spl.BANDED_MAX_DIAGS if keep else 0)
        for seeded in (True, False):
            hits = _stats_walk(tables, data, lengths, 32, seeded)[0]
            for sd, lead, nullable in STATS_FORMS:
                if sd != seeded:
                    continue
                kw = dict(seeded=seeded, lead=lead, nullable=nullable)
                got = _stats_fold(hits, lengths, data.shape[1], channels=True, **kw)
                want = spl.stats_plain(dt, lt, tables, **kw)
                for x, y, what in zip(got, want, ("cnt", "first", "last", "full")):
                    assert torch.equal(x, y), f"keep={keep} {kw} {what}"
        assert any(h for rec in hits for h in rec)


def _lazy_mb_records(tables: spl.NfaTables, span: torch.Tensor, hits: torch.Tensor,
                     data: np.ndarray, lengths: np.ndarray):
    """``wide_lazy_spans_mb_kernel`` on the model: one record a warp on the
    record flags' split, the bytes by ``walk_chunks`` (the pair walker of
    one record); per step each idle channel claims sp = max(t - 1, 0) on
    its hit bit, the seed word is the OR of the sg rows of the channels
    that seed the step (cur == t - 1, or cur == 0 and t <= 1) and follow[0]
    where state 0 is live; where the state is empty the step is the seed
    word alone, and where no channel seeds either it is skipped; where the
    union of the accept rows fires, each claimed channel whose accept row
    meets the state emits (cur, min(t, len)) if that is >= cur and clears
    its positions (posm) from the state; after the walk an idle channel
    with pos <= len and hit bit len + 1 emits (len, len). Returns (spans
    [R][P] lists, steps skipped, steps with an empty state and a seed)."""
    model = _Model(tables._replace(band=tables.fwd_band, diags=tables.fwd_diags), 32)
    accs = _acc_rows(tables)
    sp_rows = span.numpy().view(np.uint32).astype(np.uint64)  # [P, 2, W]
    hw = hits.numpy().view(np.uint32)
    P = tables.P
    R, L = data.shape
    row = np.zeros(((L + 15) // 16) * 16, np.uint8)
    out = [[[] for _ in range(P)] for _ in range(R)]
    skipped = seeded_only = 0
    zero = np.zeros(model.W, np.uint64)
    for r in range(R):
        n = int(min(max(lengths[r], 0), L))
        row[:L] = data[r]
        cur, pos = [-1] * P, [0] * P
        v = np.zeros((1, model.W), np.uint64)
        for t, sym in _walk_chunks_pair(row, n, n):
            sp = max(t - 1, 0)
            seed = zero.copy()
            seeding = False
            for c in range(P):
                if cur[c] < 0 and (hw[c, t >> 5, r] >> (t & 31)) & 1 and pos[c] <= sp <= n:
                    cur[c] = sp
                if cur[c] >= 0 and (cur[c] == t - 1 or (cur[c] == 0 and t <= 1)):
                    seed |= sp_rows[c, 0]
                    seeding = True
            if v.any():
                if model.enter0 and v[0, 0] & np.uint64(1):
                    seed |= model.seed
                v = model.fwd_word(v, [seed], [sym])
            elif seeding:
                v = (seed & model.mask[sym])[None, :]
                seeded_only += 1
            else:
                skipped += 1
                continue
            if not (v[0] & model.acc).any():
                continue
            e = min(t, n)
            kill = zero.copy()
            for c in range(P):
                if cur[c] >= 0 and e >= cur[c] and (v[0] & accs[c]).any():
                    out[r][c].append((cur[c], e))
                    pos[c] = max(e, cur[c] + 1)
                    cur[c] = -1
                    kill |= sp_rows[c, 1]
            v = v & ~kill
        for c in range(P):
            if cur[c] < 0 and pos[c] <= n and (hw[c, (n + 1) >> 5, r] >> ((n + 1) & 31)) & 1:
                out[r][c].append((n, n))
    return out, skipped, seeded_only


def _spans_at_cap(spans, cap: int):
    """(starts [R, P, cap], ends [R, P, cap], -1 past the count; cnt [R, P])
    of per-record, per-channel span lists."""
    R, P = len(spans), len(spans[0])
    st = np.full((R, P, cap), -1, np.int32)
    en = np.full((R, P, cap), -1, np.int32)
    cnt = np.zeros((R, P), np.int32)
    for r in range(R):
        for c in range(P):
            for k, (a, b) in enumerate(spans[r][c][:cap]):
                st[r, c, k], en[r, c, k] = a, b
            cnt[r, c] = len(spans[r][c])
    return torch.from_numpy(st), torch.from_numpy(en), torch.from_numpy(cnt)


@pytest.mark.parametrize("keep", [True, False], ids=["diagonals", "walk-all"])
@pytest.mark.parametrize("which", ["P3", "P3$", "40"])
def test_record_lazy_spans_mb_model_matches_plain(which, keep):
    """The multi-channel lazy spans on the band step (the channels' seed
    words into ``Band::fwd_word``, the step skipped while the state is
    empty and no channel seeds) equal ``lazy_spans_mb_plain`` on the P = 3
    union, its `$` channels (the empty match after a span ending at the
    EOS step) and 40 channels (8 past lane 31), at caps 1, 2 and 16, in
    both splits; most steps of a record skip."""
    base, span = _channel_tables(which)
    tables = spl.with_band(base, spl.BANDED_MAX_DIAGS if keep else 0)
    assert tables.fwd_diags == ((1,) if keep else ())
    data, lengths = _channel_batch()
    lt, dt = torch.from_numpy(lengths), torch.from_numpy(data)
    hits = spl.reverse_mb_plain(dt, lt, tables, span)
    spans, skipped, seeded_only = _lazy_mb_records(tables, span, hits, data, lengths)
    steps = int((np.minimum(lengths, data.shape[1]) + 2).sum())
    assert seeded_only > 0 and 2 * skipped > steps, (skipped, steps)
    overflow = False
    for cap in (1, 2, 16):
        got = _spans_at_cap(spans, cap)
        want = spl.lazy_spans_mb_plain(dt, lt, tables, span, hits, cap)
        for x, y, what in zip(got, want, ("starts", "ends", "cnt")):
            assert torch.equal(x, y), f"cap={cap} {what}"
        overflow |= bool((want[2] > cap).any())
    assert (want[2] > 0).any() and (overflow or which == "40")


@pytest.mark.parametrize("name", ["chain+", "K60+", "P3", "narrow"])
def test_nfa_stats_passes_the_band(name, monkeypatch):
    """Past 256 states ``nfa_stats`` launches rrx_nfa_wide_stats with P,
    the seed flag, the lead (-1 for none), the nullable flag and the four
    outputs, then the record flags' band split (K60+'s one diagonal; every
    edge walked for the chain), its offset count, the offsets (a host int
    array of BANDED_MAX_DIAGS) and the lanes a record (16 where W <= 16
    and P = 1, else 32: the P = 3 union at W = 12 runs 32), then the
    zeroed record counter, and counts the launch; it refuses tables
    without that split. A narrow tile launches rrx_nfa_stats with its own
    arguments alone. The meta device stands in for the card."""
    calls = []
    monkeypatch.setattr(spl, "_launch", lambda entry, *a: calls.append((entry, a)))
    if name == "P3":
        tables = _channel_tables("P3")[0]
    elif name == "narrow":
        tables = spl.device_nfa_tables(compile_program(_kw(20)), "cpu")
    else:
        tables = _prog_tables(name)[1]
    data = torch.zeros((5, 32), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(5, dtype=torch.int32, device="meta")
    wide = tables.s_tile > spl.REG_S_TILE
    counter = "wide_launches" if wide else "launches"
    before = getattr(spl.nfa_stats, counter)
    out = spl.nfa_stats(data, lengths, tables, seeded=False, lead=3, nullable=True)
    assert getattr(spl.nfa_stats, counter) == before + 1
    assert tuple(out[0].shape) == ((5, tables.P) if tables.channels else (5,))
    (entry, args), = calls
    assert args[:3] == (data, lengths, tables) and args[3:7] == (tables.P, 0, 3, 1)
    assert all(a is b for a, b in zip(args[7:10], out[:3]))
    if not wide:
        assert entry == "rrx_nfa_stats" and len(args) == 11
        return
    assert entry == "rrx_nfa_wide_stats"
    band, nd, offs, lanes, nxt = args[11:]
    assert band is tables.fwd_band and nd == len(tables.fwd_diags)
    assert tables.fwd_diags == {"chain+": (), "K60+": (1,), "P3": (1,)}[name]
    assert list(offs) == list(tables.fwd_diags) + [0] * (spl.BANDED_MAX_DIAGS - nd)
    assert tables.band_lanes == {"chain+": 32, "K60+": 16, "P3": 16}[name]
    assert lanes == {"chain+": 32, "K60+": 16, "P3": 32}[name]
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (1,)
    spl.nfa_stats(data, lengths, tables, seeded=True)
    assert calls[-1][1][4:6] == (1, -1) and calls[-1][1][14] == lanes
    with pytest.raises(ValueError, match="without a band split"):
        spl.nfa_stats(data, lengths, tables._replace(fwd_band=None), seeded=True)
    assert spl.nfa_stats.wide_launches == before + 2


@pytest.mark.parametrize("which", ["P3", "40"])
def test_nfa_lazy_spans_mb_passes_the_band(which, monkeypatch):
    """Past 256 states ``nfa_lazy_spans_mb`` launches
    rrx_nfa_wide_lazy_spans_mb with P, the span rows, the hit words, the
    cap, the outputs and the scratch rows ([R, P, 2] past 32 channels),
    then the record flags' band split, its offset count, the offsets and
    32 lanes a record, then the zeroed record counter, and counts the
    launch; it refuses tables without that split, launching nothing."""
    calls = []
    monkeypatch.setattr(spl, "_launch", lambda entry, *a: calls.append((entry, a)))
    tables, span = _channel_tables(which)
    data = torch.zeros((3, 40), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(3, dtype=torch.int32, device="meta")
    span_m = torch.zeros(tuple(span.shape), dtype=torch.int32, device="meta")
    hits = torch.zeros((tables.P, spl.sb.hit_words(40), 3), dtype=torch.int32, device="meta")
    before = spl.nfa_lazy_spans_mb.wide_launches
    starts, ends, cnt = spl.nfa_lazy_spans_mb(data, lengths, tables, span_m, hits, 4)
    assert spl.nfa_lazy_spans_mb.wide_launches == before + 1
    assert tuple(starts.shape) == (3, tables.P, 4) and tuple(cnt.shape) == (3, tables.P)
    (entry, args), = calls
    assert entry == "rrx_nfa_wide_lazy_spans_mb"
    assert args[:3] == (data, lengths, tables) and args[3] == tables.P and args[6] == 4
    assert args[7] is starts and args[8] is ends and args[9] is cnt
    assert tuple(args[10].shape) == ((3, 40, 2) if tables.P > 32 else (1,))
    band, nd, offs, lanes, nxt = args[11:]
    assert band is tables.fwd_band and nd == len(tables.fwd_diags) == 1
    assert list(offs) == [1] + [0] * (spl.BANDED_MAX_DIAGS - 1) and lanes == 32
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (1,)
    with pytest.raises(ValueError, match="without a band split"):
        spl.nfa_lazy_spans_mb(data, lengths, tables._replace(fwd_band=None), span_m, hits, 4)
    assert len(calls) == 1 and spl.nfa_lazy_spans_mb.wide_launches == before + 1
