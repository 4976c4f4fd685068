"""The register steps of ``rrx_bitband_stats``, ``rrx_bitband_flags`` and
``rrx_bitband_reverse`` (``csrc/scan_bitband.cu`` ``RegStep`` and
``RevStep``), numpy and torch only, on the CPU.

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

The reverse step's model mirrors it over the reverse tables: the plan
with the shifts negated (the diagonals of A = 0 and A = 1, the families of
A = 0 and A = -1), u = R & mask, the skip to the symbol's E row when u is
empty, the band step on u, rank-1 columns by their bit, each family's
suffix-OR with its ballot carry, then the E row ORed in. It equals the plain
reverse step on random state sets and, over whole records walked from
step len + 1 down to 0, ``scan_bits.reverse_plain``'s hit words, on the
same specs, with the band step both run and skipped; the E rows equal the
plain reverse step of the empty state.

The flags kernel runs the forward model over whole records: each
channel's vote a step, its open word stored when bit 31 closes it, the
open word and zero words after the EOS step. It equals ``flags_plain`` on
config 10 with one and with three accept channels, seeded and unseeded;
the wrapper hands the kernel the spec's offsets and gaps as stats's does.
"""
import functools
import re

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


def reg_plan(nw: int, diags, gaps, rev: bool = False):
    """The launcher's ``reg_plan``: forward, the diagonals of A = -1 (d in
    [1, 32]) and A = -2 ([33, 64]) as (row, bit shift) in register slots
    (KD = kRegMaskWords / NW, the first class first), the families of A = 0
    (g in [-31, 0]) and A = -1 ([1, 32]), and the rows of everything else;
    ``rev`` (the shift by -d): the diagonals of A = 0 (d in [0, 31]) and A
    = 1 ([32, 63]), the families of A = 0 (g in [0, 31]) and A = -1 ([-32,
    -1])."""
    kd = 32 // nw
    sg = -1 if rev else 1
    (row1, n1), (row2, n2) = _classes(diags, [(0, 31), (32, 63)] if rev else [(1, 32), (33, 64)])
    n1r = min(n1, kd)
    n2r = min(n2, kd - n1r)
    up1 = [(row1 + j, (-sg * diags[row1 + j]) & 31) for j in range(n1r)]
    up2 = [(row2 + j, (-sg * diags[row2 + j]) & 31) for j in range(n2r)]
    taken = {r for r, _ in up1 + up2}
    rest = [i for i in range(len(diags)) if i not in taken]
    (f0, nf0), (f1, nf1) = _classes(gaps, [(0, 31), (-32, -1)] if rev else [(-31, 0), (1, 32)])
    fam0 = [(f0 + f, (-sg * gaps[f0 + f]) & 31) for f in range(nf0)]
    fam1 = [(f1 + f, (-sg * gaps[f1 + f]) & 31) for f in range(nf1)]
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
    return bb.with_e_rows(bb.BitbandTables(tab_i, tab_i.clone(), meta, spec, 1, None, None))


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

        def padded(tab):  # to 32 NW words a row, as in shared memory
            rows = tab.numpy().view(np.uint32).astype(np.uint64).reshape(-1, sp.W)
            out = np.zeros((rows.shape[0], self.Wp), np.uint64)
            out[:, : sp.W] = rows
            return out

        self.rows, self.rrows = padded(tables.tab_f), padded(tables.tab_r)
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
        self.rplan = reg_plan(self.nw, sp.diags, sp.tri_gaps, rev=True)
        self.r_acc = self.r_tri + (1 + self.nf if self.nf else 0)  # the reverse accept seed row
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

    def window(self, x, A):
        """[R, 32, NW + 1]: the words from word A of each lane's words on,
        A in -2 .. 1, from [lane - 2, lane - 1, lane, lane + 1, lane + 2]'s
        words."""
        lane = np.arange(32)
        cat = np.concatenate([self.shuffle(x, lane - 2), self.shuffle(x, lane - 1), x,
                              self.shuffle(x, lane + 1), self.shuffle(x, lane + 2)], axis=2)
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

    def suffix(self, x):
        """The exclusive suffix-OR of x [R, 32, NW] inside the triangle's
        window: each word's bits below its highest one, and all ones below
        a nonzero word of the lane's higher words or of a higher lane (the
        ballot of the lanes' any-bits)."""
        bal = (x != 0).any(axis=2)  # [R, 32]
        above = (np.cumsum(bal[:, ::-1], axis=1)[:, ::-1] - bal) > 0  # a higher lane's
        s = np.zeros_like(x)
        for k in range(self.nw - 1, -1, -1):
            a = x[:, :, k].copy()
            for sh in (1, 2, 4, 8, 16):
                a |= a >> np.uint64(sh)
            s[:, :, k] = ((a >> np.uint64(1)) | np.where(above, M32, np.uint64(0))) & self.win[:, k]
            above = above | (x[:, :, k] != 0)
        return s

    def rev_step(self, R, sym):
        """R [R, 32, NW], sym [R] -> the next reverse state and whether the
        step ran the band step (u nonzero on some lane) per record."""
        mr = self.sym_row[sym]
        row = np.maximum(mr, 0)
        live = (mr >= 0)[:, None, None]
        lanes = lambda x: x.reshape(-1, 32, self.nw)  # noqa: E731
        u = np.where(live, R & lanes(self.rrows[row]), np.uint64(0))
        e = np.where(live, lanes(self.rrows[self.r_acc + 2 + row]), np.uint64(0))
        busy = (u != 0).any(axis=(1, 2))  # the __any_sync of the skip
        if not busy.any():
            return e, busy
        y = np.zeros_like(u)
        up1, up2, rest, fam0, fam1, frest = self.rplan
        dmask = lambda i: self.lanes(self.rrows[self.r_diag + i])  # noqa: E731
        for A, slots in ((0, up1), (1, up2)):
            p = self.window(u, A)
            for r, s in slots:
                y |= self.funnel(p, s, dmask(r))
        for r in rest:
            d = self.diags[r]
            y |= self.funnel(self.window_any(u, d // 32), d & 31, dmask(r))
        for i, col in enumerate(self.cols):
            bit = ((u[:, (col >> 5) // self.nw, (col >> 5) % self.nw] >> np.uint64(col & 31)) & 1) != 0
            y |= np.where(bit[:, None, None], self.lanes(self.rrows[self.r_rank1 + i]), np.uint64(0))
        if self.nf:
            exits = self.lanes(self.rrows[self.r_tri])
            tmask = lambda f: self.lanes(self.rrows[self.r_tri + 1 + f])  # noqa: E731
            for A, fams in ((0, fam0), (-1, fam1)):
                for f, s in fams:
                    y |= self.funnel(self.window(self.suffix(u & tmask(f)), A), s, exits)
            for f in frest:
                g = self.gaps[f]
                y |= self.funnel(self.window_any(self.suffix(u & tmask(f)), g // 32), g & 31, exits)
        return e | np.where(busy[:, None, None], y, np.uint64(0)), busy

    def starts(self, R):
        """[R] bool: the vote of R & the initial-state row."""
        return (R & self.lanes(self.rrows[self.r_acc + 1])).any(axis=(1, 2))


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


def _rev_batch(name: str, prog):
    """[4, L] records over the program's bytes, a chain of its body planted
    in three: a whole match where one takes at most 530 bytes (the NW = 3
    and 4 programs get 300 copies, a partial match), for the hand-built
    tables the runs' bytes."""
    rng = np.random.default_rng(len(name) + 5)
    if prog is None:
        data = rng.choice(np.frombuffer(b"059abfxyz", np.uint8), size=(4, 64)).astype(np.uint8)
        return data, np.array([64, 0, 40, 63], np.int32)
    pattern = PROGRAMS[name][0]
    lo = int(re.search(r"\{(\d+)", pattern).group(1))
    lo = lo if lo <= 520 else 300
    chain = b"x" + b"c" * lo + b"y" if pattern.startswith("x") else (
        b"a" + b"ab" * lo + b"b" if pattern.startswith("(a(") else (b"c" * 100 + b"d") * 2)
    L = len(chain) + 24
    data = rng.choice(np.frombuffer(b"abcxyzd", np.uint8), size=(4, L)).astype(np.uint8)
    for r in range(1, 4):
        at = (0, 5, 24)[r - 1]
        data[r, at : at + len(chain)] = np.frombuffer(chain, np.uint8)
    return data, np.array([L, len(chain), L, L - 3], np.int32)


@pytest.mark.parametrize("name", list(PROGRAMS) + list(HAND))
def test_rev_step_model_matches_plain(name):
    """The reverse register step: on random state sets at densities 0 ..
    0.9 (the empty set skips to the E row) and symbols over every row, the
    plain reverse step; over whole records from step len + 1 down to 0,
    ``scan_bits.reverse_plain``'s hit words, with the band step both run
    and skipped."""
    prog, tables = _tables(name)
    sp = tables.spec
    warp, pt = _Warp(tables), tables.plain("cpu")
    nw = warp.nw
    rng = np.random.default_rng(len(name) + 1)
    R = 24
    live_bits = np.zeros(warp.Wp * 32, bool)
    live_bits[: 32 * sp.W if prog is None else prog.n_states] = True
    for dens in (0.0, 0.01, 0.05, 0.3, 0.9):
        words = _pack((rng.random((R, warp.Wp * 32)) < dens) & live_bits)
        sym = rng.choice([sb.SYM_BOS, sb.SYM_EOS, sb.SYM_DEAD, 0x80, 0x41, *b"xabcyzd"], size=R)
        got, _ = warp.rev_step(words.reshape(R, 32, nw), sym)
        want = pt.rev(torch.from_numpy(words[:, : sp.W].astype(np.int64)),
                      torch.from_numpy(sym.astype(np.int64)))
        np.testing.assert_array_equal(got.reshape(R, -1)[:, : sp.W].astype(np.int64),
                                      want.numpy(), err_msg=f"{name} density {dens}")
    data, lengths = _rev_batch(name, prog)
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
    Rr, L = data.shape
    state = np.zeros((Rr, 32, nw), np.uint64)
    hits = np.zeros((sb.hit_words(L), Rr), np.int64)
    n_busy = n_steps = 0
    for t in range(L + 1, -1, -1):
        state, busy = warp.rev_step(state, sb._sym(d, ln.to(torch.int64), t).numpy())
        hits[t >> 5] |= warp.starts(state).astype(np.int64) << (t & 31)
        n_busy += int(busy.sum())
        n_steps += Rr
    want = sb.reverse_plain(d, ln, tables).numpy()
    np.testing.assert_array_equal(sb._as_i32(torch.from_numpy(hits)).numpy(), want,
                                  err_msg=f"{name} hit words")
    assert 0 < n_busy < n_steps
    if name not in ("nw3", "nw4"):
        assert np.count_nonzero(want) > 0


@pytest.mark.parametrize("name", ["config10", "rank1", "neg-gap", "hand-nw3"])
def test_e_rows_are_the_accept_sets_expansion(name):
    """The E rows after the reverse table, one per header row, are the
    plain reverse step of the empty state under each symbol's mask row
    (zero for a symbol with none), and the wrapper checks they are
    there."""
    _, tables = _tables(name)
    sp, pt = tables.spec, tables.plain("cpu")
    n_hdr = 3 + len(sp.runs)
    r_e = bb._rev_rows(sp)
    assert pt.tr.shape[0] == r_e + n_hdr and not pt.tr[r_e + 2].any()
    syms = torch.arange(sb.N_SYMS)
    rows = pt.sym_row[syms]
    got = torch.where((rows >= 0)[:, None], pt.tr[r_e + rows.clamp(min=0)], 0)
    np.testing.assert_array_equal(got.numpy(), pt.rev(pt.empty(sb.N_SYMS, "cpu"), syms).numpy())
    data = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="E rows"):
        bb.bitband_reverse(data, torch.zeros(4, dtype=torch.int32, device="meta"),
                           tables._replace(tab_r=tables.tab_r[: r_e * sp.W]))


def test_rev_plan_of_config10():
    """Config 10's reverse plan at NW = 2: the shifts by -d put its offsets
    in [1, 31] in class A = 0 (13 slots) and 34, 37 and 40 in A = 1, with
    bit shifts d mod 32; its gaps 4 and 5 are families of A = 0 (shift g).
    At NW = 4 the 8 slots hold the first 8 offsets, the rest apart. The
    negative gap of x(ab|c){100,200}(y|z+) (-1) falls in A = -1, bit shift
    31."""
    _, tables = _tables("config10")
    sp = tables.spec
    up1, up2, rest, fam0, fam1, frest = reg_plan(2, sp.diags, sp.tri_gaps, rev=True)
    assert [sp.diags[r] for r, _ in up1] == [1, 2, 3, 4, 7, 10, 13, 16, 19, 22, 25, 28, 31]
    assert [sp.diags[r] for r, _ in up2] == [34, 37, 40]
    assert [s for _, s in up1 + up2] == [d & 31 for d in sp.diags]
    assert rest == [] and fam1 == [] and frest == [] and fam0 == [(0, 4), (1, 5)]
    up1, up2, rest, *_ = reg_plan(4, sp.diags, sp.tri_gaps, rev=True)
    assert len(up1) == 8 and up2 == [] and rest == list(range(8, 16))
    _, neg = _tables("neg-gap")
    *_, fam0, fam1, frest = reg_plan(1, neg.spec.diags, neg.spec.tri_gaps, rev=True)
    assert neg.spec.tri_gaps == (-1, 4, 5)
    assert fam1 == [(0, 31)] and fam0 == [(1, 4), (2, 5)] and frest == []


def test_reverse_wrapper_passes_the_shifts(monkeypatch):
    """``bitband_reverse`` on a non-CPU tensor launches rrx_bitband_reverse
    with the reverse table and its E rows, then the hit words, a zeroed
    record counter and the spec's offsets and gaps (as stats takes them),
    and counts the launch."""
    calls = []
    monkeypatch.setattr(sb, "launch", lambda entry, *a: calls.append((entry, a)))
    _, tables = _tables("neg-gap")
    data = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(4, dtype=torch.int32, device="meta")
    before = bb.bitband_reverse.launches
    hits = bb.bitband_reverse(data, lengths, tables)
    assert bb.bitband_reverse.launches == before + 1 and tuple(hits.shape) == (2, 4)
    (entry, args), = calls
    assert entry == "rrx_bitband_reverse"
    tab, meta, W, n_rows, live, out, next_rec, nd, diags, nf, gaps = args[2:]
    sp = tables.spec
    assert tab is tables.tab_r and meta is tables.meta and W == sp.W and live is None
    assert next_rec.dtype == torch.int32 and next_rec.shape == (1,)
    assert n_rows == bb._rev_rows(sp) + 3 + len(sp.runs) and out is hits
    assert nd == len(sp.diags) and list(diags)[:nd] == list(sp.diags) and len(diags) == MAX_DIAGS
    assert nf == 3 and list(gaps) == [-1, 4, 5, 0, 0, 0] and len(gaps) == MAX_FAM


def test_flags_wrapper_passes_the_shifts(monkeypatch):
    """``bitband_flags`` on a non-CPU tensor launches rrx_bitband_flags
    (the stats kernel's register step) with the channel count, the seed
    gate and the flag words, then the spec's diagonal offsets and triangle
    gaps as stats takes them, and counts the launch."""
    calls = []
    monkeypatch.setattr(sb, "launch", lambda entry, *a: calls.append((entry, a)))
    _, tables = _tables("neg-gap")
    data = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(4, dtype=torch.int32, device="meta")
    live = torch.zeros(1, dtype=torch.int32, device="meta")
    before = bb.bitband_flags.launches
    words = bb.bitband_flags(data, lengths, tables, seeded=False, live=live)
    assert bb.bitband_flags.launches == before + 1
    assert tuple(words.shape) == (sb.hit_words(32), 4 * tables.C) and words.dtype == torch.int32
    (entry, args), = calls
    assert entry == "rrx_bitband_flags"
    tab, meta, W, n_rows, lv, C, seeded, out, nd, diags, nf, gaps = args[2:]
    sp = tables.spec
    assert tab is tables.tab_f and meta is tables.meta and W == sp.W and lv is live
    assert n_rows == tables.tab_f.numel() // sp.W and C == tables.C and seeded == 0
    assert out is words
    assert nd == len(sp.diags) == 16 and list(diags)[:nd] == list(sp.diags)
    assert len(diags) == MAX_DIAGS and not any(list(diags)[nd:])
    assert nf == 3 and list(gaps) == [-1, 4, 5, 0, 0, 0] and len(gaps) == MAX_FAM


def _flag_records(warp: _Warp, C: int, data: np.ndarray, lengths: np.ndarray, seeded: bool):
    """``bb_flags_kernel`` on the register step's model: every record walked
    from the BOS step to its EOS step, the seed gated at every step
    (seeded) or at steps < 2, channel c's flag the vote of the state on
    accept row c; lane c keeps channel c's open word and stores it when bit
    31 closes it, then after the EOS step the open word and zero words to
    the end. The flag words start as garbage (``torch.empty``)."""
    R, L = data.shape
    Wt = sb.hit_words(L)
    words = np.random.default_rng(2).integers(0, 1 << 32, size=(Wt, R * C), dtype=np.uint64)
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths).to(torch.int64)
    lnc = np.clip(lengths, 0, L)
    v = np.zeros((R, 32, warp.nw), np.uint64)
    open_w = np.zeros((R, C), np.uint64)
    accs = [warp.lanes(warp.rows[warp.r_acc + c]) for c in range(C)]
    for t in range(L + 2):
        on = t <= lnc + 1  # the records whose walk has step t
        v = warp.step(v, np.full(R, seeded or t < 2), sb._sym(d, ln, t).numpy())
        for c in range(C):
            fl = (v & accs[c]).any(axis=(1, 2))
            open_w[:, c] |= np.where(on & fl, np.uint64(1) << np.uint64(t & 31), np.uint64(0))
        if t & 31 == 31:
            for r in np.flatnonzero(on):
                words[t >> 5, r * C:(r + 1) * C] = open_w[r]
            open_w[on] = 0
    for r in range(R):
        w_eos = (int(lnc[r]) + 1) >> 5
        if (int(lnc[r]) + 1) & 31 != 31:
            words[w_eos, r * C:(r + 1) * C] = open_w[r]
        words[w_eos + 1:, r * C:(r + 1) * C] = 0
    return sb._as_i32(torch.from_numpy(words.astype(np.int64)))


@pytest.mark.parametrize("channels", [1, 3], ids=["config10", "config10-3-channels"])
def test_flags_model_matches_plain(channels):
    """The flag words of the register step (``bb_flags_kernel``) equal
    ``flags_plain`` on config 10 with its accept set and with three
    accept channels (its accept set, every fifth state and a random tenth),
    seeded and unseeded, on records of length 0, at the word edges (30-33,
    63-65) and full, chains of its body planted (a match, one copy too few
    and one too many)."""
    prog, tables = _tables("config10")
    if channels > 1:
        acc = np.zeros((prog.s_pad, 3), np.uint8)
        n = prog.n_states
        acc[:n, 0] = np.asarray(prog.accept)[:n]
        acc[:n, 1] = np.arange(n) % 5 == 2
        acc[:n, 2] = np.random.default_rng(3).random(n) < 0.1
        tables = bb.device_bitband_tables(prog, tables.spec, "cpu", acc)
    assert tables.C == channels
    rng = np.random.default_rng(channels)
    L = 560
    data = rng.choice(np.frombuffer(b"xabcyz", np.uint8), size=(12, L)).astype(np.uint8)
    for r, k in ((8, 400), (9, 399), (10, 521), (11, 460)):
        body = b"".join(rng.choice([b"ab", b"c"], size=k, p=[0.1, 0.9]))
        w = (b"x" + body + b"y")[:L]
        data[r, :len(w)] = np.frombuffer(w, np.uint8)
    lengths = np.array([0, 30, 31, 32, 33, 63, 64, 65, L, L, L, L - 7], np.int32)
    warp = _Warp(tables)
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
    for seeded in (True, False):
        got = _flag_records(warp, channels, data, lengths, seeded)
        want = bb.flags_plain(d, ln, tables, seeded=seeded)
        assert torch.equal(got, want), f"seeded={seeded}"
        assert want.any()
