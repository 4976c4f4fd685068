"""The container tier: the port's ``SparseScanner`` (plain PyTorch versions,
CPU) against the JAX package's ``SparseScanner`` (Pallas interpret mode),
and the programs that route to it through ``Pattern`` and ``MultiPattern``
against the oracle (``roaringregex_tpu/oracle/engine.py``), Python's
``re`` and the JAX ``MultiPattern``.

Interpret mode compiles each JAX scanner method for 2-10 s at its first
shape, so the JAX scanner side runs on one small program, (ab|c){2,120}d
(362 states, 6 partial blocks), and one batch: match statistics seeded and
unseeded, forward flags, reverse hits, and the same program with two
accept channels (``functools.lru_cache`` keeps one scanner and one batch);
the stream-fed methods (``match_stats``, ``forward_flags``,
``reverse_hits`` over a mask stream, rows 11-13) on that program and on a
nullable one, (ab|c){0,120}, against the JAX scanner's on the JAX stream
(which the port's equals word for word) and the port's own byte path.
Everything else is held to the oracle and ``re``, which cost no compile:
config 13 (with ``RRX_ALIAS`` on and off), ``x(abc|de){1,300}y`` (also
behind its prefilter), ``a*b{1,300}``, ``(ab|c){2,120}d``, a 40-word keyword
alternation, and, with ``RRX_BITBAND=0``, ``x[ab]{0,400}c`` (a full U
block) and config 10, each on every ``Pattern`` entry point. Every output
is an integer, a bool or a span: every comparison is exact. The CUDA
kernels (``rrx_sparse_*``) are held to the same plain versions on the card
by ``chip_smoke.py``."""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_packed as jax_packed
from roaringregex_tpu.ops import scan_pallas as jax_pallas
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu_torch.api import _pack_texts
from roaringregex_tpu_torch.compiler.program import compile_program, from_reference
from roaringregex_tpu_torch.engine import ScanEngine
from roaringregex_tpu_torch.ops import scan_bits as sb
from roaringregex_tpu_torch.ops import scan_packed as sp
from roaringregex_tpu_torch.ops import scan_sparse as ss
from roaringregex_tpu_torch.utils import config as cfg
from test_torch_pallas import K30

torch.set_num_threads(1)

SMALL = "(ab|c){2,120}d"  # multiblock, 362 states, 6 partial blocks
CONFIG13 = "(abc|de){1,300}"  # sparse, 1501 states, 78 partial blocks
CONFIG10 = "x(ab|c){400,520}y"
K30_WORDS = K30[1:-1].split("|")


def _k40_words():
    """K30's words and 10 more (lowercase, 5-9 letters, none a prefix of
    another, so every span policy parses a match one way)."""
    rng = np.random.default_rng(40)
    words = list(K30_WORDS)
    while len(words) < 40:
        w = bytes(rng.integers(97, 123, size=int(rng.integers(5, 10))).astype(np.uint8)).decode()
        if not any(a.startswith(w) or w.startswith(a) for a in words):
            words.append(w)
    return words


K40_WORDS = _k40_words()
K40 = "(" + "|".join(K40_WORDS) + ")"  # multiblock, 286 states


@pytest.fixture
def knobs():
    """Set config knobs (``RRX_ALIAS``, ``RRX_BITBAND``) for one test and
    restore them after it."""
    base = cfg.get_config()
    yield lambda **kw: cfg.set_config(base.with_(**kw))
    cfg.set_config(base)


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


# -- the scanner against the JAX SparseScanner ----------------------------------


def _batch():
    """[16, 64] records over a..e and x: chains of (ab|c) planted (at byte
    0 in every fourth record, one of them a whole record), the empty
    record, a full-width one and bytes 0x00, 0x80, 0xff."""
    rng = np.random.default_rng(5)
    data = rng.choice(np.frombuffer(b"abcdex", np.uint8), size=(16, 64)).astype(np.uint8)
    lengths = rng.integers(0, 65, size=16).astype(np.int32)
    for i in range(0, 16, 2):
        body = b"".join(rng.choice([b"ab", b"c"], size=int(rng.integers(1, 20)))) + b"d"
        at = 0 if i % 4 == 0 else int(rng.integers(0, 64 - len(body) + 1))
        data[i, at : at + len(body)] = np.frombuffer(body, np.uint8)
        if i == 4:
            lengths[i] = len(body)
    data[3, :6] = np.frombuffer(b"\x00c\x80cd\xff", np.uint8)
    lengths[:3] = (64, 0, 64)
    return data, lengths.reshape(-1, 1)


@functools.lru_cache(maxsize=None)
def _case(channels: int):
    """(JAX SparseScanner, the port's SparseScanner, data, len_g) of SMALL
    with one accept channel, or two: its accept state and the states that
    read a 'c'."""
    ref = jax_compile(SMALL)
    amap = None
    if channels == 2:
        amap = np.zeros((ref.s_pad, 2), np.uint8)
        amap[:, 0] = ref.accept
        amap[: ref.n_states, 1] = ref.nfa.symtab[ord("c")]
    jsc = jax_pallas.SparseScanner(ref, jax_packed.stream_tables(ref), accept_map=amap)
    psc = ScanEngine(from_reference(ref), "cpu", accept_map=amap,
                     channels_per_record=channels).device_scanner
    assert type(psc) is ss.SparseScanner and psc.n_partial == 6
    return jsc, psc, *_batch()


@pytest.mark.parametrize("channels,seeded", [(1, True), (1, False), (2, True)])
def test_match_stats_match_jax(channels, seeded):
    jsc, psc, data, len_g = _case(channels)
    want = jsc.match_stats_b(jnp.asarray(data), jnp.asarray(len_g), seeded=seeded)
    got = psc.match_stats_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=seeded)
    for name, x, y in zip(("cnt", "first", "last", "full", "any"), got, want, strict=True):
        _eq(x.reshape(16, channels), np.asarray(y).reshape(16, channels), name)
    assert int(got[0].sum()) > 0


def test_forward_flags_match_jax():
    jsc, psc, data, len_g = _case(1)
    want = jsc.forward_flags_b(jnp.asarray(data), jnp.asarray(len_g), seeded=True)
    got = psc.forward_flags_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=True)
    _eq(got, want, "flags")
    assert int(got[:, 1:].sum()) > 0


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
def test_channel_flags_equal_one_channel_scans(seeded):
    """Two accept channels' flags, record-major and channel-minor, equal the
    flags of two one-channel scans with each channel as the accept set."""
    _, psc, data, len_g = _case(2)
    got = psc.forward_flags_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=seeded)
    prog, amap = psc.prog, psc.tables.accs.T.astype(np.uint8)
    for c in range(2):
        one = ScanEngine(prog, "cpu", accept_map=amap[:, c : c + 1]).device_scanner
        want = one.forward_flags_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=seeded)
        _eq(got[c::2], want, f"channel {c}")
        assert int(want[:, 1:].sum()) > 0


def test_reverse_hits_match_jax():
    jsc, psc, data, len_g = _case(1)
    want = jsc.reverse_hits_b(jnp.asarray(data), jnp.asarray(len_g))
    got = psc.reverse_hits_b(torch.from_numpy(data), torch.from_numpy(len_g))
    _eq(got, want, "reverse hits")
    assert int(got.sum()) > 0


def test_channels_refuse_one_accept_set_primitives():
    _, psc, data, len_g = _case(2)
    with pytest.raises(ValueError, match="2 accept channels"):
        psc.hits_words_b(torch.from_numpy(data), torch.from_numpy(len_g))


def test_full_block_and_hand_built_partition():
    """The full U block of x[ab]{0,400}c (RRX_BITBAND=0's only route to
    one), and a hand-built partition with a U block that the forward and
    the reverse step cross both ways, against the same program stepped
    through its dense follow matrix."""
    prog = compile_program("x[ab]{0,400}c")
    pb, prow, pcol, U = prog.sparse_partition
    assert int(U.sum()) == 1 and len(pb) == 9
    # a 256-state program: block (0, 1) full, block (1, 0) partial
    S = 256
    F = np.zeros((S, S), np.uint8)
    F[0:128, 128:256] = 1
    F[130, 5] = F[200, 7] = 1
    amap = np.zeros((S, 1), np.uint8)
    amap[7, 0] = 1
    tables = ss.device_sparse_tables(prog, "cpu")  # a template for the layout
    pt = tables.plain("cpu")
    part = (np.stack([F[128:, :128]]) != 0, np.array([1]), np.array([0]),
            np.array([[0, 1], [0, 0]], bool))
    hand = tables._replace(part=part, masks=np.ones((tables.masks.shape[0], S), bool),
                           accs=amap.T != 0, acc=amap[:, 0] != 0)
    hp = hand.plain("cpu")
    assert hp.pb.shape == (1, 128, 128) and pt.U.sum() == 1
    v = torch.zeros((3, S), dtype=torch.bool)
    v[0, 0] = v[1, 130] = v[2, 200] = True
    dense = torch.from_numpy(F).to(torch.float32)
    _eq(hp._expand(v, False), (v.to(torch.float32) @ dense) > 0, "forward")
    _eq(hp._expand(v, True), (v.to(torch.float32) @ dense.T) > 0, "reverse")


# -- the forward walk tables of rrx_sparse_stats and _flags ---------------------------


def _hand_built_program():
    """x[ab]{0,400}c's 4 x 4 blocks with a hand-built partition: random
    partial blocks, full U blocks on and off the diagonal, source block 0
    feeding a full block (so the seed row holds one), and a source block
    that feeds both a partial and a full block."""
    prog = compile_program("x[ab]{0,400}c")
    rh = np.random.default_rng(21)
    pb = (rh.random((5, 128, 128)) < 0.02).astype(np.uint8)
    prow, pcol = np.array([0, 0, 1, 2, 3], np.int32), np.array([0, 1, 1, 3, 2], np.int32)
    U = np.zeros((4, 4), np.uint8)
    U[0, 2] = U[1, 1] = U[3, 0] = 1
    prog._spart = (pb, prow, pcol, U)
    return prog


def _walk_offsets(nb: int, W: int, n_part: int, n_mask: int, n_head: int = 1) -> dict:
    """Where each part of the walk tables starts (``scan_sparse._walk``):
    the head rows (the forward seed row; the reverse E rows, one per mask
    row), the full masks, the block masks, the source-block offsets and
    entries, the state offsets and entries."""
    out, at = {}, 0
    for name, n in (("seed", n_head * W), ("full", nb), ("mblk", n_mask), ("sptr", nb + 1),
                    ("sent", n_part), ("ptr", 32 * W + 1), ("rent", 0)):
        out[name] = at
        at += n
    return out


@functools.lru_cache(maxsize=None)
def _walk_case(name: str) -> ss.SparseTables:
    if name == "hand-built":
        return ss.device_sparse_tables(_hand_built_program(), "cpu")
    if name == "3 channels":
        prog = compile_program(K40)
        amap = np.zeros((prog.s_pad, 3), np.uint8)
        amap[:, 0] = prog.accept[: prog.s_pad]
        amap[: prog.n_states : 7, 1] = 1
        amap[: prog.n_states, 2] = np.asarray(prog.nfa.symtab[ord("e")])[: prog.n_states]
        return ss.device_sparse_tables(prog, "cpu", accept_map=amap)
    return ss.device_sparse_tables(compile_program({"K40": K40, "CONFIG13": CONFIG13}[name]), "cpu")


def _walk_step(tables: ss.SparseTables, v: np.ndarray, gate: bool, sym: int, walk_max: int):
    """One forward step as csrc/scan_sparse.cu's step_regs takes it, in
    numpy, from the walk tables and the forward table's words: the seed row
    when gated; per source block with live states, its partial blocks'
    rows under the live bits (more than ``walk_max`` live) or each live
    state's own nonzero rows (the rest), rows of output blocks that the
    mask zeroes skipped; U's full output blocks; the mask. Returns the new
    [lanes] bool state and the union accept test."""
    W = tables.W
    nb, n_part, n_mask = W // 4, len(tables.part[1]), len(tables.masks)
    off = _walk_offsets(nb, W, n_part, n_mask)
    wk = tables.walk_f.numpy().view(np.uint32)
    tab = tables.tab_f.numpy().view(np.uint32)
    words = ss._pack_rows(v)
    mr = int(tables.sym_row[sym])
    mb = int(wk[off["mblk"] + mr]) if mr >= 0 else 0
    if mb == 0:
        return np.zeros_like(v), False
    y = wk[off["seed"] : off["seed"] + W].copy() if gate else np.zeros(W, np.uint32)
    _walk_live(wk, tab, off, nb, v, y, mb, walk_max)
    at = 512 * n_part + mr * W
    y &= tab[at : at + W]
    acc = tab[512 * n_part + n_mask * W :][:W]  # the channels' union row
    return np.unpackbits(y.view(np.uint8), bitorder="little").astype(bool), bool((y & acc).any())


def _walk_live(wk, tab, off: dict, nb: int, x: np.ndarray, y: np.ndarray, ob: int,
               walk_max: int) -> None:
    """The kernel's ``walk_live`` in numpy, shared by both directions' steps:
    ORs into the words ``y`` the expansion of the [lanes] bool state ``x``
    from the walk tables ``wk`` and the table words ``tab``: per source
    block with live states, its partial blocks' rows under the live bits
    (more than ``walk_max`` live) or each live state's own nonzero rows (the
    rest), rows of output blocks outside the bit mask ``ob`` skipped; then
    U's full output blocks."""
    full = 0
    for s in range(nb):
        live = np.nonzero(x[128 * s : 128 * (s + 1)])[0]
        if live.size == 0:
            continue
        full |= int(wk[off["full"] + s])
        if live.size > walk_max:
            for e in range(wk[off["sptr"] + s], wk[off["sptr"] + s + 1]):
                k, o = int(wk[off["sent"] + e]) >> 5, int(wk[off["sent"] + e]) & 31
                if (ob >> o) & 1:
                    rows = tab[512 * k : 512 * (k + 1)].reshape(128, 4)
                    y[4 * o : 4 * o + 4] |= np.bitwise_or.reduce(rows[live], axis=0)
        else:
            for i in live:
                st = 128 * s + i
                for e in range(wk[off["ptr"] + st], wk[off["ptr"] + st + 1]):
                    row, o = int(wk[off["rent"] + e]) >> 5, int(wk[off["rent"] + e]) & 31
                    if (ob >> o) & 1:
                        y[4 * o : 4 * o + 4] |= tab[4 * row : 4 * row + 4]
    for o in range(nb):
        if (full >> o) & 1:
            y[4 * o : 4 * o + 4] = 0xFFFFFFFF


@pytest.mark.parametrize("walk_max", [-1, 4, 128], ids=["blocks", "mixed", "walk"])
@pytest.mark.parametrize("name", ["K40", "CONFIG13", "hand-built", "3 channels"])
def test_walk_tables_step_like_plain(name, walk_max):
    """The new forward step's tables, walked in numpy as the kernel walks
    them (every source block in the block-parallel form, each in the form
    its live count picks, or every live state walked), give ``_Plain.step``
    on random state sets (sparse, dense, whole blocks, the empty set) and
    symbols (bytes in no run among them), gated and not, and the union
    accept test gives its flags."""
    tables = _walk_case(name)
    pt = tables.plain("cpu")
    lanes = 32 * tables.W
    n_real = int(np.asarray(tables.masks).any(axis=0).nonzero()[0].max()) + 1
    rng = np.random.default_rng(13)
    R = 24
    v = np.zeros((R, lanes), bool)
    for r in range(1, R):
        dens = [0.003, 0.03, 0.3, 0.8][r % 4]
        v[r, :n_real] = rng.random(n_real) < dens
        if r % 3 == 0:  # whole blocks dead
            for blk in rng.choice(lanes // 128, size=lanes // 256, replace=False):
                v[r, 128 * blk : 128 * (blk + 1)] = False
    v[1, :] = False
    v[1, 0] = True  # state 0 live by itself, and with the seed
    gate = rng.random(R) < 0.5
    gate[:2] = True
    # mostly symbols with a mask row, some without
    syms = np.where(rng.random(R) < 0.8, rng.choice(np.nonzero(tables.sym_row >= 0)[0], size=R),
                    rng.integers(0, sb.N_SYMS, size=R))
    syms[:4] = (sb.SYM_BOS, sb.SYM_EOS, ord("e"), 0x80)
    want = pt.step(torch.from_numpy(v), torch.from_numpy(gate), torch.from_numpy(syms)).numpy()
    flags = pt.flags(torch.from_numpy(want)).numpy()
    n_live = 0
    for r in range(R):
        got, hit = _walk_step(tables, v[r], bool(gate[r]), int(syms[r]), walk_max)
        _eq(got, want[r], f"record {r}")
        assert hit == bool(flags[r].any()), f"record {r}: the union accept test"
        n_live += int(got.any())
    assert n_live >= R // 4


# -- the reverse walk tables of rrx_sparse_reverse ---------------------------------


def _walk_rev_step(tables: ss.SparseTables, v: np.ndarray, sym: int, walk_max: int) -> np.ndarray:
    """One reverse step as csrc/scan_sparse.cu's step_rev_regs takes it, in
    numpy, from the reverse walk tables and the reverse table's words: u =
    v & mask[sym] expanded through F transposed (``_walk_live``, no output
    block skipped) onto the symbol's E row; a symbol with a zero mask clears
    the state. Returns the new [lanes] bool state."""
    W = tables.W
    nb, n_part, n_mask = W // 4, len(tables.part[1]), len(tables.masks)
    off = _walk_offsets(nb, W, n_part, n_mask, n_head=n_mask)
    wk = tables.walk_r.numpy().view(np.uint32)
    tab = tables.tab_r.numpy().view(np.uint32)
    mr = int(tables.sym_row[sym])
    if mr < 0 or wk[off["mblk"] + mr] == 0:
        return np.zeros_like(v)
    at = 512 * n_part + mr * W
    u = ss._pack_rows(v) & tab[at : at + W]
    y = wk[off["seed"] + mr * W : off["seed"] + (mr + 1) * W].copy()
    _walk_live(wk, tab, off, nb, np.unpackbits(u.view(np.uint8), bitorder="little").astype(bool),
               y, (1 << nb) - 1, walk_max)
    return np.unpackbits(y.view(np.uint8), bitorder="little").astype(bool)


def _reverse_batch(name: str):
    """[6, 40] records with matches of the program planted (keywords of
    K40, chains of the others, random bytes of the hand-built program's
    alphabet), byte 0x80 and the empty record among them."""
    rng = np.random.default_rng(17)
    alphabet = b"abcdex" if name != "K40" else b"abcdeilnorstw"
    data = rng.choice(np.frombuffer(alphabet, np.uint8), size=(6, 40)).astype(np.uint8)
    lengths = np.array([40, 0, 33, 40, 21, 40], np.int32)
    plants = {"K40": [w.encode() for w in K40_WORDS[:4]],
              "CONFIG13": [b"abcdeabc", b"deabcde", b"abcabcdede", b"de"],
              "full block": [b"xababbac", b"xc", b"xbbbbbbbbbbbbc", b"xaaac"],
              "hand-built": [b"xabc", b"cxc", b"ab", b"xxxx"]}[name]
    for i, w in enumerate(plants):
        at = int(rng.integers(0, 40 - len(w) + 1))
        data[2 + i, at : at + len(w)] = np.frombuffer(w, np.uint8)
    data[5, 3] = 0x80
    return data, lengths


REVERSE_CASES = {"K40": K40, "CONFIG13": CONFIG13, "full block": "x[ab]{0,400}c"}


@functools.lru_cache(maxsize=None)
def _reverse_tables(name: str) -> ss.SparseTables:
    if name == "hand-built":
        return _walk_case("hand-built")
    return ss.device_sparse_tables(compile_program(REVERSE_CASES[name]), "cpu")


@pytest.mark.parametrize("walk_max", [-1, 4, 128], ids=["blocks", "mixed", "walk"])
@pytest.mark.parametrize("name", ["K40", "CONFIG13", "full block", "hand-built"])
def test_reverse_walk_tables_scan_like_plain(name, walk_max):
    """The reverse step walked in numpy over ``walk_r`` as the kernel walks
    it (every source block in the block-parallel form, each in the form its
    live count picks, or every live state walked), from step len + 1 down
    to 0 of each record with the E rows in place of the accept set, gives
    ``sparse_reverse_plain``'s hit words exactly."""
    tables = _reverse_tables(name)
    if name == "full block":
        assert int(tables.part[3].sum()) == 1
    data, lengths = _reverse_batch(name)
    R, L = data.shape
    got = np.zeros((sb.hit_words(L), R), np.uint32)
    for r in range(R):
        n = int(lengths[r])
        v = np.zeros(32 * tables.W, bool)
        for t in range(n + 1, -1, -1):
            sym = sb.SYM_BOS if t == 0 else sb.SYM_EOS if t == n + 1 else int(data[r, t - 1])
            v = _walk_rev_step(tables, v, sym, walk_max)
            got[t >> 5, r] |= np.uint32(int(v[0]) << (t & 31))
    want = ss.sparse_reverse_plain(torch.from_numpy(data), torch.from_numpy(lengths), tables)
    _eq(got.view(np.int32), want, f"{name} walk_max={walk_max}")
    assert int(np.count_nonzero(got)) > 0


@pytest.mark.parametrize("name", ["K40", "CONFIG13", "full block", "hand-built"])
def test_reverse_e_rows_are_the_accept_sets_expansion(name):
    """Each E row of the reverse walk tables (one per mask row) equals the
    plain stepper's reverse step of the empty state under that row's mask:
    F·(acc & mask[row])."""
    tables = _reverse_tables(name)
    W, n_mask = tables.W, len(tables.masks)
    E = tables.walk_r.numpy().view(np.uint32)[: n_mask * W].reshape(n_mask, W)
    pt = tables.plain("cpu")
    want = pt.rev_mask(pt.empty(n_mask, "cpu"), torch.from_numpy(tables.masks))
    _eq(np.unpackbits(E.view(np.uint8), axis=1, bitorder="little").astype(bool), want, name)
    assert int(np.count_nonzero(E)) > 0


def test_reverse_wrapper_passes_the_walk_tables(monkeypatch):
    """``sparse_reverse`` on a non-CPU tensor launches rrx_sparse_reverse
    with the reverse table and meta, the reverse walk tables, their length
    and walk_max, sized its shared memory as a walk kernel without channel
    buffers, and counts the launch; the meta device stands in for the
    card."""
    calls = []
    monkeypatch.setattr(sb, "launch", lambda entry, *a: calls.append((entry, a)))
    tables = _reverse_tables("K40")
    data = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(4, dtype=torch.int32, device="meta")
    before = ss.sparse_reverse.launches
    hits = ss.sparse_reverse(data, lengths, tables, walk_max=7)
    assert ss.sparse_reverse.launches == before + 1 and tuple(hits.shape) == (2, 4)
    (entry, args), = calls
    assert entry == "rrx_sparse_reverse"
    tab, n_tab, meta, n_meta, W, glob, live, _next, walk, n_walk, walk_max, out = args[2:]
    assert tab is tables.tab_r and meta is tables.meta_r and walk is tables.walk_r
    assert (n_tab, n_meta, n_walk, W) == (tab.numel(), meta.numel(), walk.numel(), tables.W)
    assert glob == 0 and live is None and walk_max == 7 and out is hits
    assert ss.smem_bytes(tables, "walk_r", False) == 4 * (
        meta.numel() + walk.numel() + tab.numel())
    assert ss.table_form(tables, "walk_r") == "shared"


# -- the stream-fed methods (rows 11-13) against the JAX SparseScanner's ------------

NULLABLE = "(ab|c){0,120}"  # multiblock, 361 states, 6 partial blocks, nullable


def _streams(jref, prog, data, len_g):
    """(the JAX mask stream, the port's) of one batch."""
    jw = jax_packed.mask_stream_from_bytes(
        jax_packed.stream_tables(jref), jnp.asarray(data), jnp.asarray(len_g),
        s_tile=jref.s_tile, G=jref.G, n_runs=len(jref.byte_runs[0]))
    pw = sp.mask_stream_from_bytes(sp.stream_tables(prog, "cpu"), torch.from_numpy(data),
                                   torch.from_numpy(len_g).reshape(-1))
    return jw, pw


@functools.lru_cache(maxsize=None)
def _stream_case(pattern: str):
    """(JAX SparseScanner, the port's, data, len_g, the JAX stream, the
    port's stream) of SMALL or the nullable program on ``_batch``."""
    if pattern == SMALL:
        jsc, psc, data, len_g = _case(1)
        ref = jsc.prog
    else:
        ref = jax_compile(pattern)
        jsc = jax_pallas.SparseScanner(ref, jax_packed.stream_tables(ref))
        psc = ss.SparseScanner(from_reference(ref), "cpu")
        data, len_g = _batch()
    return (jsc, psc, data, len_g, *_streams(ref, psc.prog, data, len_g))


@functools.lru_cache(maxsize=None)
def _jax_stream(pattern: str, what: str, seeded: bool = True):
    jsc, _, _, len_g, jw, _ = _stream_case(pattern)
    if what == "stats":
        return tuple(np.asarray(x) for x in jsc.match_stats(jw, jnp.asarray(len_g), seeded=seeded))
    if what == "flags":
        return np.asarray(jsc.forward_flags(jw, seeded=seeded))
    return np.asarray(jsc.reverse_hits(jw))


@pytest.mark.parametrize("pattern", [SMALL, CONFIG13])
def test_mask_stream_matches_jax(pattern):
    """The port's mask stream of a container program ([L + 2, B, W], W =
    s_pad / 32) equals the JAX one word for word."""
    ref = jax_compile(pattern)
    data, len_g = _batch()
    jw, pw = _streams(ref, from_reference(ref), data, len_g)
    assert tuple(pw.shape) == (66, 16, ref.s_pad // 32)
    _eq(pw, np.asarray(jw).view(np.int32), "mask stream")


@pytest.mark.parametrize("pattern,seeded", [(SMALL, True), (SMALL, False), (NULLABLE, True),
                                            (NULLABLE, False)])
def test_stream_match_stats_match_jax(pattern, seeded):
    """match_stats over the stream equals the JAX scanner's over its own,
    and the byte path's (cnt, first, any) on the same records."""
    _, psc, data, len_g, _, pw = _stream_case(pattern)
    assert psc.nullable == (pattern == NULLABLE)
    got = psc.match_stats(pw, torch.from_numpy(len_g), seeded=seeded)
    for name, x, y in zip(("cnt", "first", "any"), got, _jax_stream(pattern, "stats", seeded),
                          strict=True):
        assert tuple(x.shape) == (16, 1)
        _eq(x, y, name)
    byte = psc.match_stats_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=seeded)
    for name, x, y in zip(("cnt", "first", "any"), got, (byte[0], byte[1], byte[4]), strict=True):
        _eq(x, y, f"{name} against the byte path")
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("pattern,seeded", [(SMALL, True), (SMALL, False), (NULLABLE, True)])
def test_stream_forward_flags_match_jax(pattern, seeded):
    _, psc, data, len_g, _, pw = _stream_case(pattern)
    got = psc.forward_flags(pw, seeded=seeded)
    assert tuple(got.shape) == (16, 67)
    _eq(got, _jax_stream(pattern, "flags", seeded), "flags")
    _eq(got, psc.forward_flags_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=seeded),
        "flags against the byte path")
    assert int(got[:, 1:].sum()) > 0


@pytest.mark.parametrize("pattern", [SMALL, NULLABLE])
def test_stream_reverse_hits_match_jax(pattern):
    _, psc, data, len_g, _, pw = _stream_case(pattern)
    got = psc.reverse_hits(pw)
    assert tuple(got.shape) == (16, 66)
    _eq(got, _jax_stream(pattern, "reverse"), "hits")
    _eq(got, psc.reverse_hits_b(torch.from_numpy(data), torch.from_numpy(len_g)),
        "hits against the byte path")
    assert int(got.sum()) > 0


def test_stream_methods_refuse_channels():
    """A channel scanner raises in all three stream-fed methods: the JAX
    kernels read one accept row (channel 0's), the port refuses."""
    _, psc, data, len_g = _case(2)
    pw = sp.mask_stream_from_bytes(sp.stream_tables(psc.prog, "cpu"), torch.from_numpy(data),
                                   torch.from_numpy(len_g).reshape(-1))
    for call in (lambda: psc.match_stats(pw, torch.from_numpy(len_g), seeded=True),
                 lambda: psc.forward_flags(pw, seeded=True), lambda: psc.reverse_hits(pw)):
        with pytest.raises(ValueError, match="2 accept channels"):
            call()
    with pytest.raises(ValueError, match="one accept set"):
        ss.sparse_stream_stats_plain(psc.tables, pw, torch.from_numpy(len_g), seeded=True,
                                     nullable=False)


# -- Pattern against the oracle and re ---------------------------------------------


def _chain(rng, pattern: str, k: int) -> bytes:
    """A chain of k copies of the program's repeated body, with its head and
    tail bytes where it has them."""
    if pattern.startswith("a*b"):
        return b"a" * int(rng.integers(0, 4)) + b"b" * k
    if pattern.startswith("x[ab]"):
        return b"x" + bytes(rng.choice(np.frombuffer(b"ab", np.uint8), size=k)) + b"c"
    if "ab|c" in pattern:
        # mostly c in long chains, so config 10's fit 512-byte records
        body = b"".join(rng.choice([b"ab", b"c"], size=k, p=[0.1, 0.9] if k > 100 else None))
        return (b"x" + body + b"y") if pattern.startswith("x") else body + b"d"
    body = b"".join(rng.choice([b"abc", b"de"], size=k))
    return b"x" + body + b"y" if pattern.startswith("x") else body


def _texts(pattern: str, lo: int, hi: int, n: int = 10, width: int = 120):
    """Records for ``pattern``: the empty one, a chain of lo copies, one of
    lo - 1, random text over the pattern's bytes with chains of lo..hi
    copies planted in every second record, and bytes 0x00, 0x80 and 0xff."""
    rng = np.random.default_rng(len(pattern))
    if pattern == K40:
        out = [b"", b"error", b"xoomleakx", b"warnwarn", "".join(K40_WORDS[30:]).encode()[:width],
               b"dead\x80lock deadlock\x00", b"unauthorizedfailed"]
        while len(out) < n:
            t = bytearray(rng.choice(np.frombuffer(b"abcdeiklmnorstu ", np.uint8),
                                     size=int(rng.integers(0, 60))).tobytes())
            for _ in range(int(rng.integers(0, 4))):
                w = K40_WORDS[int(rng.integers(len(K40_WORDS)))].encode()
                at = int(rng.integers(0, len(t) + 1))
                t[at:at] = w
            out.append(bytes(t))
        return out
    alpha = np.frombuffer(b"abcdexy", np.uint8)
    out = [b"", _chain(rng, pattern, lo), _chain(rng, pattern, max(lo - 1, 0)),
           b"\x00ab\x80c\xff" + _chain(rng, pattern, lo)]
    while len(out) < n:
        t = bytearray(rng.choice(alpha, size=int(rng.integers(0, width // 3))).tobytes())
        if len(out) % 2:
            at = int(rng.integers(0, len(t) + 1))
            t[at:at] = _chain(rng, pattern, int(rng.integers(lo, hi + 1)))
        out.append(bytes(t[:width]))
    return out


def _re_spans(pattern: str, texts, longest: bool):
    """Python re's spans: every program here parses a match one way, so
    re's greedy match from the leftmost start is the longest and its lazy
    form's the shortest."""
    lazy = pattern.replace("}", "}?")
    rx = re.compile((pattern if longest else lazy).encode())
    return [[m.span() for m in rx.finditer(t)] for t in texts]


# (pattern, knobs, lo, hi, width): the chains planted, the longest record
PROGRAMS = {
    "config13": (CONFIG13, {}, 1, 12, 120),
    "config13-noalias": (CONFIG13, {"seeded_alias": False}, 1, 12, 120),
    "x(abc|de){1,300}y": ("x(abc|de){1,300}y", {}, 1, 12, 120),
    "a*b{1,300}": ("a*b{1,300}", {}, 1, 40, 120),
    "(ab|c){2,120}d": (SMALL, {}, 2, 30, 120),
    "K40": (K40, {}, 0, 0, 120),
    "x[ab]{0,400}c-nobitband": ("x[ab]{0,400}c", {"bitband": False}, 0, 60, 120),
    "config10-nobitband": (CONFIG10, {"bitband": False}, 400, 420, 500),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_pattern_matches_oracle_and_re(name, knobs):
    """Counts, search, fullmatch, both bitmaps and lazy and greedy spans
    against the oracle (spans against re too); the seeded calls of config
    13 run on its alias unless ``RRX_ALIAS=0``, everything else on the
    container tier."""
    pattern, kw, lo, hi, width = PROGRAMS[name]
    knobs(**kw)
    pat = rrx.compile(pattern, "cpu")
    eng = pat.engine
    assert type(eng.device_scanner) is ss.SparseScanner, type(eng.device_scanner)
    assert (eng._seeded_alias() is not None) == (name == "config13")
    texts = _texts(pattern, lo, hi, n=8 if width > 200 else 10, width=width)
    assert max(map(len, texts)) <= 512
    orc = OracleEngine(jax_compile(pattern).nfa)
    ends = [sorted(orc.ends(t)) for t in texts]
    assert sum(map(len, ends)) > 0
    _eq(pat.count_batch(texts), [len(e) for e in ends], "count_batch")
    _eq(pat.search_batch(texts), [bool(e) for e in ends], "search_batch")
    full = [orc.fullmatch(t) for t in texts]
    _eq(pat.fullmatch_batch(texts), full, "fullmatch_batch")
    assert pat.ends_batch(texts) == ends
    assert pat.starts_batch(texts) == [sorted(orc.starts(t)) for t in texts]
    for longest in (False, True):
        spans = pat.finditer_batch(texts, longest=longest)
        assert spans == [list(orc.finditer(t, longest=longest)) for t in texts], longest
        assert spans == _re_spans(pattern, texts, longest), longest
    t = texts[1]
    m, f = pat.match(t), pat.fullmatch(t)
    assert (m is None) == (orc.match(t) is None) and (m is None or m.end == orc.match(t))
    assert (f is not None) == full[1]


def test_prefilter_takes_the_container_kernels():
    """x(abc|de){1,300}y has a prefilter: past 128 records its seeded scans
    and bitmaps run the container kernels on the candidates only, and
    equal the unfiltered scan."""
    pattern = "x(abc|de){1,300}y"
    eng = ScanEngine(compile_program(pattern), "cpu")
    assert type(eng.device_scanner) is ss.SparseScanner and eng._prefilter() is not None
    data, lengths, _, _ = _pack_texts(_texts(pattern, 1, 8, n=144, width=30), 1)
    data, lengths = data[:144], lengths[:144]  # past 128 records: the prefilter's route
    _, _, pre = eng._prefilter_eng.match_stats(data, lengths, seeded=True)
    assert 0 < int(pre.sum()) < 128
    raw = eng._match_stats_raw(data, lengths, seeded=True)
    for x, y in zip(eng.match_stats(data, lengths, seeded=True), raw, strict=True):
        _eq(x, y, "match_stats")
    assert int(raw[0].sum()) > 0
    sc = eng.device_scanner
    words, _ = sc.hits_words_b(torch.from_numpy(data), torch.from_numpy(lengths).reshape(-1, 1))
    want = sb.hit_bits(words.T, data.shape[1] + 2)
    got = eng.reverse_hits(data, lengths)
    _eq(got, want, "reverse_hits")


# -- MultiPattern against the JAX MultiPattern --------------------------------------

# (patterns, texts) of each set
MP_SETS = {
    "K40": (K40_WORDS, [b"", b"error", b"xoomleakx deadlock", b"unauthorized failed timeout",
                        b"dead\x80lock retry",
                        b"warnwarn " + b" ".join(w.encode() for w in K40_WORDS[30:34]),
                        b" ".join(w.encode() for w in K40_WORDS[34:])]),
    "config10+cat|dog": ([CONFIG10, "cat|dog"], [b"", b"x" + b"ab" * 50 + b"c" * 355 + b"y",
                                                b"catdog x" + b"c" * 401 + b"y", b"dogs and cats",
                                                b"x" + b"ab" * 10 + b"y", b"a\x80b cat"]),
}


@functools.lru_cache(maxsize=None)
def _mp(name):
    pats = MP_SETS[name][0]
    return rrx.MultiPattern(pats, "cpu"), jax_rrx.MultiPattern(pats, backend="pallas")


@pytest.mark.parametrize("name", list(MP_SETS))
def test_multipattern_matches_jax(name):
    """count, search and grep equal the JAX MultiPattern's (one channel
    scan each on the container tier); lazy and greedy finditer, per
    pattern, equal re's spans (each pattern parses a match one way; the JAX
    MultiPattern takes the same per-pattern route, api.py:700)."""
    port, ref = _mp(name)
    pats, texts = MP_SETS[name]
    assert type(port.engine.device_scanner).__name__ == "SparseScanner"
    assert type(ref.engine.device_scanner).__name__ == "SparseScanner"
    assert port.P == len(pats) and port.engine.device_scanner.P == port.P
    cnt = port.count_batch(texts)
    _eq(cnt, ref.count_batch(texts), "count_batch")
    assert int(cnt.sum()) > 0
    found = ref.search_batch(texts)  # the JAX MultiPattern's grep is its search_batch
    _eq(port.search_batch(texts), found, "search_batch")
    _eq(port.grep(texts), found, "grep")
    for longest in (False, True):
        got = port.finditer_batch(texts, longest=longest)
        assert got == [_re_spans(p, texts, longest) for p in pats], longest
