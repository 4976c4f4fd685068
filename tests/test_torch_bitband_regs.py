"""The register step of ``rrx_bitband_stats`` (``csrc/scan_bitband.cu``
``RegStep``), numpy and torch only, on the CPU.

A word-level model of the kernel's forward step, one warp of 32 lanes per
record with lane l holding the contiguous state words l NW .. l NW + NW - 1:
the launcher's plan (``reg_plan``: the diagonals of the classes A = -1 and
A = -2 in register slots, the families of A = 0 and A = -1, everything else
stepped apart), the neighbour lanes' words by shuffles that return the
lane's own word out of range, then zero fill, the classes' words a fixed
choice among them, funnel shifts, the masks as the lanes hold them, the
rank-1 columns' vote, the triangle's in-word prefix with its ballot carry,
then the symbol's mask. It equals the plain stepper
(``BitbandTables.plain(...).step``) exactly on random state sets at
several densities, gated and ungated, for bench config 10, a rank-1
column, negative triangle gaps, one program at each NW = 1..4 (at NW = 4
the register slots overflow), two specs with every edge on a diagonal
(offsets -2..4 and -300, -298) and three hand-built tables whose lane 31
holds state words (NW = 1, 3 and 4). The wrapper hands the kernel the spec's
offsets and gaps, which the launcher's plan is built from.
"""
import functools

import numpy as np
import pytest
import torch

from roaringregex_tpu_torch.compiler.program import compile_program
from roaringregex_tpu_torch.ops import scan_bitband as bb
from roaringregex_tpu_torch.ops import scan_bits as sb

M32 = np.uint64(0xFFFFFFFF)
MAX_DIAGS, MAX_FAM = bb.MAX_DIAGS, bb.MAX_TRI_FAMILIES  # the kernel's kMaxDiags, kMaxFam

# (pattern, every edge on a diagonal): NW = ceil(W / 32) in the comment
PROGRAMS = {
    "config10": ("x(ab|c){400,520}y", False),  # W 56, NW 2, 16 diagonals, gaps (4, 5)
    "rank1": ("(a(ab|c){100,200}b)+", False),  # W 24, NW 1, one rank-1 column
    "neg-gap": ("x(ab|c){100,200}(y|z+)", False),  # NW 1, gaps (-1, 4, 5)
    "unbounded": ("x(ab|c){400,}y", False),  # NW 2, gaps (-3, -1)
    "nw3": ("x(ab|c){700,800}y", False),  # W 80, NW 3
    "nw4": ("x(ab|c){1000,1300}y", False),  # W 128, NW 4, 16 diagonals
    "diag-back": ("x(ab|c){400,}y", True),  # diagonals -2 .. 4
    "diag-far": ("((ab|c){100}d)+", True),  # diagonals -300, -298: 9 lanes away
}


def _classes(offs, bounds):
    """(first row, count) of the sorted offsets in each [lo, hi] of bounds."""
    out = []
    for lo, hi in bounds:
        rows = [i for i, d in enumerate(offs) if lo <= d <= hi]
        out.append((rows[0] if rows else sum(d < lo for d in offs), len(rows)))
    return out


def reg_plan(nw: int, diags, gaps):
    """The launcher's ``reg_plan``: the diagonals of A = -1 (d in [1, 32])
    and A = -2 ([33, 64]) as (row, bit shift) in register slots (KD =
    kRegMaskWords / NW, A = -1 first), the families of A = 0 (g in [-31,
    0]) and A = -1 ([1, 32]), and the rows of everything else."""
    kd = 32 // nw
    (row1, n1), (row2, n2) = _classes(diags, [(1, 32), (33, 64)])
    n1r = min(n1, kd)
    n2r = min(n2, kd - n1r)
    up1 = [(row1 + j, (-diags[row1 + j]) & 31) for j in range(n1r)]
    up2 = [(row2 + j, (-diags[row2 + j]) & 31) for j in range(n2r)]
    taken = {r for r, _ in up1 + up2}
    rest = [i for i in range(len(diags)) if i not in taken]
    (f0, nf0), (f1, nf1) = _classes(gaps, [(-31, 0), (1, 32)])
    fam0 = [(f0 + f, (-gaps[f0 + f]) & 31) for f in range(nf0)]
    fam1 = [(f1 + f, (-gaps[f1 + f]) & 31) for f in range(nf1)]
    ftaken = {r for r, _ in fam0 + fam1}
    return up1, up2, rest, fam0, fam1, [f for f in range(len(gaps)) if f not in ftaken]


# hand-built tables whose top lane holds state words (W = 32 NW: the zero fill
# past lane 31 shows): diagonals of both signs, near and past 32 NW states,
# two rank-1 columns, gaps of both signs on the window [8, W)
HAND = {
    "hand-nw1": (32, (-70, -33, -1, 0, 1, 31, 32, 64, 100), (5, 1000), (-3, 5, 40)),
    "hand-nw3": (96, (-200, -97, -1, 0, 1, 5, 31, 33, 64, 95, 96, 97, 300), (6, 3000),
                 (-20, 3, 33)),
    "hand-nw4": (128, (-300, -129, -1, 1, 127, 128, 129, 500), (7, 4000), (-40, 2, 5)),
}


def _hand_tables(name: str) -> bb.BitbandTables:
    """Random mask rows (the exit and family rows zero outside the
    triangle's window, as the tier's tables are), three byte runs."""
    W, diags, cols, gaps = HAND[name]
    rng = np.random.default_rng(W)
    runs = ((48, 57), (97, 102), (120, 122))
    spec = bb.BitbandSpec(W=W, diags=diags, rank1=tuple((c // 32, c % 32) for c in cols),
                          tri_gaps=gaps, tri_win=(8, W), runs=runs, bos_nz=True, eos_nz=True)

    def rows(n, dens, window=False):
        r = _pack(rng.random((n, 32 * W)) < dens)
        if window:
            r[:, :8] = 0
        return r

    tab = np.concatenate([rows(3 + len(runs), 0.5), rows(len(diags), 0.5), rows(len(cols), 0.05),
                          rows(1 + len(gaps), 0.3, True), rows(1, 0.05), rows(1, 0.05)])
    tab_i = torch.from_numpy(tab.astype(np.uint32).reshape(-1).view(np.int32).copy())

    class _Named:
        pattern = name

    meta = torch.from_numpy(bb.bitband_meta(spec, _Named, 1))
    return bb.BitbandTables(tab_i, tab_i.clone(), meta, spec, 1, None, None)


@functools.lru_cache(maxsize=None)
def _tables(name: str):
    if name in HAND:
        return None, _hand_tables(name)
    pattern, all_diag = PROGRAMS[name]
    prog = compile_program(pattern)
    spec = bb.bitband_spec(prog)
    if all_diag:
        e = prog.nfa.get_edges()
        offs = tuple(sorted(set((e[:, 1].astype(int) - e[:, 0].astype(int)).tolist())))
        spec = spec._replace(diags=offs, rank1=(), tri_gaps=(), tri_win=(0, spec.W))
    return prog, bb.device_bitband_tables(prog, spec, "cpu")


class _Warp:
    """The register step of one warp per record, R records at once: the
    state as [R, 32, NW] uint64 words (lane, word of the lane)."""

    def __init__(self, tables: bb.BitbandTables):
        sp = tables.spec
        self.W, self.nw = sp.W, -(-sp.W // 32)
        self.Wp = 32 * self.nw
        rows = tables.tab_f.numpy().view(np.uint32).astype(np.uint64).reshape(-1, sp.W)
        self.rows = np.zeros((rows.shape[0], self.Wp), np.uint64)
        self.rows[:, : sp.W] = rows  # padded to 32 NW words, as in shared memory
        meta = tables.meta.numpy()
        self.sym_row = meta[bb.META_SYMS:]
        self.nd, self.n1, self.nf = int(meta[1]), int(meta[2]), int(meta[3])
        self.lo, self.hi = int(meta[4]), int(meta[5])
        self.cols = meta[bb.META_RANK1: bb.META_RANK1 + self.n1]
        r_diag = 3 + int(meta[0])
        self.r_diag, self.r_rank1 = r_diag, r_diag + self.nd
        self.r_tri = self.r_rank1 + self.n1
        self.diags, self.gaps = sp.diags, sp.tri_gaps
        self.plan = reg_plan(self.nw, sp.diags, sp.tri_gaps)
        w = np.arange(self.Wp).reshape(32, self.nw)
        self.win = np.where((w >= self.lo) & (w < self.hi), M32, np.uint64(0))

    def lanes(self, row):
        """A padded row as the lanes hold it: [32, NW]."""
        return row.reshape(32, self.nw)

    @staticmethod
    def shuffle(x, src):
        """[R, 32, NW]: lane l takes lane src[l]'s words; the hardware takes
        the source lane mod 32, and the kernel zeroes a source past the
        warp's ends."""
        inside = ((src >= 0) & (src < 32))[None, :, None]
        return np.where(inside, x[:, src & 31], np.uint64(0)).astype(np.uint64)

    def window(self, x, A, nx=True):
        """[R, 32, NW + 1]: the words from word A of each lane's words on,
        A in -2 .. 0, from [lane - 2, lane - 1, lane, lane + 1]'s words."""
        lane = np.arange(32)
        cat = np.concatenate([self.shuffle(x, lane - 2), self.shuffle(x, lane - 1), x,
                              self.shuffle(x, lane + 1)], axis=2)
        m = 2 * self.nw + A
        return cat[:, :, m: m + self.nw + 1]

    def window_any(self, x, A):
        """The same for any A: the 2 NW words of lanes l + a and l + a + 1
        (a = floor(A / NW)) by shuffles, from word o = A - a NW on."""
        a = A // self.nw
        o = A - a * self.nw
        lane = np.arange(32)
        c = np.concatenate([self.shuffle(x, lane + a), self.shuffle(x, lane + a + 1)], axis=2)
        return c[:, :, o: o + self.nw + 1]

    @staticmethod
    def funnel(p, s, mask):
        lo, hi = p[:, :, :-1], p[:, :, 1:]
        return (((hi << np.uint64(32)) | lo) >> np.uint64(s)) & M32 & mask

    def step(self, v, gate, sym):
        """v [R, 32, NW], gate [R] bool, sym [R] -> the next state."""
        mr = self.sym_row[sym]
        m = np.where((mr >= 0)[:, None, None],
                     self.rows[np.maximum(mr, 0)].reshape(-1, 32, self.nw), np.uint64(0))
        u = v | np.where(gate[:, None, None], self.lanes(self.rows[2]), np.uint64(0))
        y = np.zeros_like(u)
        up1, up2, rest, fam0, fam1, frest = self.plan
        dmask = lambda i: self.lanes(self.rows[self.r_diag + i])  # noqa: E731
        for A, slots in ((-1, up1), (-2, up2)):
            p = self.window(u, A)
            for row, s in slots:
                y |= self.funnel(p, s, dmask(row))
        for row in rest:
            d = self.diags[row]
            y |= self.funnel(self.window_any(u, (-d) // 32), (-d) & 31, dmask(row))
        for i, col in enumerate(self.cols):
            hit = (u & self.lanes(self.rows[self.r_rank1 + i])).any(axis=(1, 2))  # __any_sync
            y[:, (col >> 5) // self.nw, (col >> 5) % self.nw] |= np.where(
                hit, np.uint64(1) << np.uint64(col & 31), np.uint64(0))
        if self.nf:
            x = u & self.lanes(self.rows[self.r_tri])
            bal = (x != 0).any(axis=2)  # [R, 32]: the ballot of the lanes' any-bits
            below = (np.cumsum(bal, axis=1) - bal) > 0  # a lower lane's word is nonzero
            pre = np.zeros_like(x)
            for k in range(self.nw):
                smear = ((x[:, :, k] | ((np.uint64(0) - x[:, :, k]) & M32)) << np.uint64(1)) & M32
                pre[:, :, k] = (smear | np.where(below, M32, np.uint64(0))) & self.win[:, k]
                below = below | (x[:, :, k] != 0)
            tmask = lambda f: self.lanes(self.rows[self.r_tri + 1 + f])  # noqa: E731
            for A, fams in ((0, fam0), (-1, fam1)):
                p = self.window(pre, A)
                for f, s in fams:
                    y |= self.funnel(p, s, tmask(f))
            for f in frest:
                g = self.gaps[f]
                y |= self.funnel(self.window_any(pre, (-g) // 32), (-g) & 31, tmask(f))
        return y & m


@pytest.mark.parametrize("name", list(PROGRAMS) + list(HAND))
def test_reg_step_model_matches_plain(name):
    """Random state sets at densities 0.01 .. 0.9 (and the empty set), the
    seed gated on every second record, symbols over every row (BOS, EOS, the
    runs' bytes, bytes in no run)."""
    prog, tables = _tables(name)
    sp = tables.spec
    warp, pt = _Warp(tables), tables.plain("cpu")
    nw = warp.nw
    assert nw == {"rank1": 1, "neg-gap": 1, "diag-far": 1, "config10": 2, "unbounded": 2,
                  "diag-back": 2, "nw3": 3, "nw4": 4, "hand-nw1": 1, "hand-nw3": 3,
                  "hand-nw4": 4}[name]
    rng = np.random.default_rng(len(name))
    R = 24
    live_bits = np.zeros(warp.Wp * 32, bool)
    live_bits[: 32 * sp.W if prog is None else prog.n_states] = True
    for dens in (0.0, 0.01, 0.05, 0.3, 0.9):
        bits = (rng.random((R, warp.Wp * 32)) < dens) & live_bits
        words = _pack(bits)
        v = words.reshape(R, 32, nw)
        gate = np.arange(R) % 2 == 0
        sym = rng.choice([sb.SYM_BOS, sb.SYM_EOS, 0x80, 0x41, *b"xabcyzd"], size=R)
        got = warp.step(v, gate, sym).reshape(R, -1)[:, : sp.W]
        want = pt.step(torch.from_numpy(words[:, : sp.W].astype(np.int64)),
                       torch.from_numpy(gate), torch.from_numpy(sym.astype(np.int64)))
        np.testing.assert_array_equal(got.astype(np.int64), want.numpy(),
                                      err_msg=f"{name} density {dens}")


def _pack(bits: np.ndarray) -> np.ndarray:
    """[R, 32 n] bool -> [R, n] uint64 words (bit s % 32 of word s // 32)."""
    b = bits.reshape(bits.shape[0], -1, 32).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(axis=2, dtype=np.uint64)


def test_reg_plan_of_config10():
    """Config 10 at NW = 2: its 13 offsets in [1, 32] and 3 in [33, 64]
    fill the 16 register slots (32 mask words), nothing is stepped apart;
    the gaps 4 and 5 are families of A = -1. At NW = 4 (8 slots) the same
    offsets overflow: 8 in registers, 8 apart."""
    _, tables = _tables("config10")
    sp = tables.spec
    up1, up2, rest, fam0, fam1, frest = reg_plan(2, sp.diags, sp.tri_gaps)
    assert [sp.diags[r] for r, _ in up1] == [1, 2, 3, 4, 7, 10, 13, 16, 19, 22, 25, 28, 31]
    assert [sp.diags[r] for r, _ in up2] == [34, 37, 40]
    assert [s for _, s in up1 + up2] == [(-d) & 31 for d in sp.diags]
    assert rest == [] and fam0 == [] and frest == [] and fam1 == [(0, 28), (1, 27)]
    up1, up2, rest, *_ = reg_plan(4, sp.diags, sp.tri_gaps)
    assert len(up1) == 8 and up2 == [] and rest == list(range(8, 16))


def test_stats_wrapper_passes_the_shifts(monkeypatch):
    """``bitband_stats`` on a non-CPU tensor launches rrx_bitband_stats
    with the spec's diagonal offsets and triangle gaps (counts and host int
    arrays of MAX_DIAGS and MAX_TRI_FAMILIES) after the outputs, and counts
    the launch; the meta device stands in for the card."""
    calls = []
    monkeypatch.setattr(sb, "launch", lambda entry, *a: calls.append((entry, a)))
    _, tables = _tables("neg-gap")
    data = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(4, dtype=torch.int32, device="meta")
    before = bb.bitband_stats.launches
    out = bb.bitband_stats(data, lengths, tables, seeded=True, nullable=False)
    assert bb.bitband_stats.launches == before + 1 and len(out) == 4
    (entry, args), = calls
    assert entry == "rrx_bitband_stats"
    nd, diags, nf, gaps = args[-4:]
    sp = tables.spec
    assert nd == len(sp.diags) == 16 and list(diags)[:nd] == list(sp.diags)
    assert len(diags) == MAX_DIAGS and not any(list(diags)[nd:])
    assert nf == 3 and list(gaps) == [-1, 4, 5, 0, 0, 0] and len(gaps) == MAX_FAM
