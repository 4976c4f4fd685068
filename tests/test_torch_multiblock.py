"""The port's dense multiblock tier: multiblock programs (257..1024 states)
that the engine keeps on the matmul tier's ``PallasScanner``, at record
tiles of 384..1024 states (W = 12..32 state words; on the card the warp-
per-record kernels of ``csrc/scan_nfa_wide.cu``, here their plain PyTorch
versions on the CPU).

- Against the JAX package's ``PallasScanner`` (Pallas interpret mode, one
  cached batch per program, exact): ``x(ab|c){300,}y`` (W = 32, banded in
  JAX) for seeded and unseeded stats, reverse hits and lazy spans on 16
  records of 320 B with planted ``x(ab|c){k}y`` chains, k = 290..316, and
  K60+ (W = 16) for seeded stats. Interpret mode traces the JAX kernels'
  slab unroll at each compile, so the file runs them at a slab of 2 steps
  (``slab_r``, a layout knob: the outputs are the same), and the records
  are as short as the chains allow.
- ``Pattern`` against the oracle (and ``re`` where its spans are the
  policy's) on one program at each tile and the nullable K40*.
- ``MultiPattern`` of a dense multiblock union (P = 3) against each
  pattern's oracle, its lazy spans also against the JAX ``MultiPattern``
  (8 records, one interpret-mode call) and with a ``$`` channel.
- The long route: K60 (no ``+``) takes ``FastLongScanner`` (the wide
  window kernels); its unseeded scans keep the torch-op ``LongScanner``.
"""
import functools
import re

import numpy as np
import pytest
import torch

import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.nfa import build_nfa
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.engine import ScanEngine as JaxEngine
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu.utils.config import get_config, set_config
from roaringregex_tpu_torch.api import MultiPattern
from roaringregex_tpu_torch.compiler.program import compile_program, from_reference
from roaringregex_tpu_torch.ops import scan_pallas
from roaringregex_tpu_torch.ops.longstring import (FastLongScanner, LongScanner,
                                                      make_long_scanner)
from test_torch_api_pallas import _keywords
from test_torch_pallas import _args, _eq

torch.set_num_threads(1)


def _kw(n: int, op: str = "+") -> str:
    return "(" + "|".join(_keywords(n)) + ")" + op


CHAIN300 = "x(ab|c){300,}y"
K60P = _kw(60)
# (pattern, s_tile): one program at each record tile past 256 states
TILES = [(_kw(40), 384), (K60P, 512), (_kw(80), 640), ("x(ab|c){250,}y", 768),
         (_kw(110), 896), (_kw(130), 1024)]
NULLABLE = _kw(40, "*")
NAMES = {p: f"K{p.count('|') + 1}{p[-1]}" for p, _ in TILES if p.startswith("(")}
NAMES[NULLABLE] = "K40*"
PROGRAMS = [p for p, _ in TILES] + [NULLABLE]
IDS = [NAMES.get(p, p) for p in PROGRAMS]
WORDS = [w.encode() for w in _keywords(130)]


def _chain(rng, k: int, room: int) -> bytes:
    """x(ab|c){k}y with at most ``room`` bytes: k tokens, some of them ab."""
    n_ab = int(rng.integers(0, max(room - 2 - k, 0) + 1))
    toks = [b"ab"] * n_ab + [b"c"] * (k - n_ab)
    rng.shuffle(toks)
    return b"x" + b"".join(toks) + b"y"


def _chain_batch(L: int = 320):
    """16 records of L bytes over "abcxy ", a chain of k = 290..316 tokens
    planted in every record but the first two (the empty record and a
    random one), so that k < 300 misses and k >= 300 matches."""
    rng = np.random.default_rng(9)
    data = rng.choice(np.frombuffer(b"abcxy ", np.uint8), size=(16, L)).astype(np.uint8)
    lengths = np.full(16, L, np.int32)
    lengths[0] = 0
    for i, k in enumerate([290, 298, 299, 300, 300, 301, 305, 310, 312, 314, 316, 300, 302, 308],
                          start=2):
        ch = _chain(rng, k, L)
        at = int(rng.integers(0, L - len(ch) + 1))
        data[i, at : at + len(ch)] = np.frombuffer(ch, np.uint8)
    lengths[14] = 310  # the chain cut by the record's end or not
    return data, lengths.reshape(-1, 1)


def _keyword_batch(n: int = 16, L: int = 64):
    """n records of L bytes of lowercase text with keyword runs planted."""
    rng = np.random.default_rng(10)
    data = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz  ", np.uint8),
                      size=(n, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    lengths[1:4] = L
    for i in range(1, n):
        run = b"".join(WORDS[j] for j in rng.integers(0, 60, size=int(rng.integers(1, 4))))[:L]
        at = int(rng.integers(0, L - len(run) + 1))
        data[i, at : at + len(run)] = np.frombuffer(run, np.uint8)
    return data, lengths.reshape(-1, 1)


@pytest.fixture(scope="module", autouse=True)
def _short_slab():
    """The JAX kernels at a slab unroll of 2 steps (8 by default): the same
    outputs, a quarter of the unrolled body for interpret mode to trace."""
    base = get_config()
    set_config(base.with_(slab_r=2))
    yield
    set_config(base)


@functools.lru_cache(maxsize=None)
def _jax_case(pattern):
    """The JAX engine's scanner of the pattern (built once per process: its
    interpret-mode calls are cached on it), the port's scanner and the
    pattern's batch."""
    jax_sc = JaxEngine(jax_compile(pattern), backend="pallas").device_scanner
    port_sc = scan_pallas.PallasScanner(from_reference(jax_compile(pattern)), "cpu")
    data, len_g = _chain_batch() if pattern == CHAIN300 else _keyword_batch()
    return jax_sc, port_sc, data, len_g


@pytest.mark.parametrize("pattern,s_tile", TILES + [(NULLABLE, 384)], ids=IDS)
def test_tiles_route_to_pallas_scanner(pattern, s_tile):
    """Each program is multiblock at its tile, decomposes into no bitband
    form and takes the dense multiblock matmul: the port's ``PallasScanner``,
    whose tables hold W = s_tile / 32 words a row."""
    pat = rrx.compile(pattern, "cpu")
    sc = pat.engine.device_scanner
    assert (pat.tier, pat.program.s_tile, type(sc).__name__) == ("multiblock", s_tile,
                                                               "PallasScanner")
    assert sc.nfa.tab.numel() == (2 * s_tile + scan_pallas.N_SYMS + 1) * (s_tile // 32)
    assert pat.program.nullable == (pattern == NULLABLE)


@pytest.mark.parametrize("mode", ["seeded", "unseeded"])
def test_chain300_stats_match_jax(mode):
    jax_sc, port_sc, data, len_g = _jax_case(CHAIN300)
    assert port_sc.nfa.s_tile == 1024
    ja, pa = _args(data, len_g)
    seeded = mode == "seeded"
    got = port_sc.match_stats_b(*pa, seeded=seeded)
    _eq(jax_sc.match_stats_b(*ja, seeded=seeded), got, mode)
    if seeded:  # the whole chains of 300 tokens or more, and only those, match
        rx = re.compile(CHAIN300.encode())
        want = [len(rx.findall(data[i, : len_g[i, 0]].tobytes())) for i in range(16)]
        assert got[0].reshape(-1).tolist() == want and want[2:5] == [0, 0, 0] and sum(want) >= 10


def test_chain300_reverse_hits_match_jax():
    jax_sc, port_sc, data, len_g = _jax_case(CHAIN300)
    ja, pa = _args(data, len_g)
    got = port_sc.reverse_hits_b(*pa)
    _eq([jax_sc.reverse_hits_b(*ja)], [got], "reverse")
    assert int(got.sum()) >= 10


def test_chain300_lazy_spans_match_jax():
    jax_sc, port_sc, data, len_g = _jax_case(CHAIN300)
    ja, pa = _args(data, len_g)
    got = port_sc.lazy_spans_b(*pa, cap=4)
    _eq(jax_sc.lazy_spans_b(*ja, cap=4), got, "lazy spans")
    rx = re.compile(CHAIN300.encode())
    for i in range(data.shape[0]):
        n = int(got[2][i])
        want = [m.span() for m in rx.finditer(data[i, : len_g[i, 0]].tobytes())]
        assert list(zip(got[0][i, :n].tolist(), got[1][i, :n].tolist())) == want


def test_k60_plus_stats_match_jax():
    jax_sc, port_sc, data, len_g = _jax_case(K60P)
    assert port_sc.nfa.s_tile == 512
    ja, pa = _args(data, len_g)
    _eq(jax_sc.match_stats_b(*ja, seeded=True), port_sc.match_stats_b(*pa, seeded=True), "K60+")


def _texts(pattern: str):
    """Short texts with keyword runs, and chains across the program's bound
    (x(ab|c){250,}y: k = 249, 250, 260), plus the edge texts."""
    rng = np.random.default_rng(len(pattern))
    out = [b"", b"x", b"xy", WORDS[0], WORDS[1] + WORDS[2], b"z" + WORDS[3] * 3 + b" ",
           WORDS[4] + b"\x80" + WORDS[5], WORDS[6][:-1]]
    alphabet = np.frombuffer(b"abcdefgilnorstuwxy ", np.uint8)
    while len(out) < 24:
        t = bytearray(rng.choice(alphabet, size=int(rng.integers(0, 40))).tobytes())
        run = b"".join(WORDS[j] for j in rng.integers(0, 130, size=int(rng.integers(1, 4))))
        at = int(rng.integers(0, len(t) + 1))
        t[at:at] = run
        out.append(bytes(t))
    if "{250,}" in pattern:
        out += [_chain(rng, k, 2 + k + 6) + b" " + WORDS[0] for k in (249, 250, 260)]
    return out


@functools.lru_cache(maxsize=None)
def _api_case(pattern):
    texts = _texts(pattern)
    return rrx.compile(pattern, "cpu"), OracleEngine(build_nfa(pattern)), texts


@pytest.mark.parametrize("pattern", PROGRAMS, ids=IDS)
def test_pattern_counts_match_oracle(pattern):
    pat, orc, texts = _api_case(pattern)
    ends = [orc.ends(t) for t in texts]
    assert pat.count_batch(texts).tolist() == [len(e) for e in ends]
    assert pat.search_batch(texts).tolist() == [bool(e) for e in ends]
    assert pat.fullmatch_batch(texts).tolist() == [orc.fullmatch(t) for t in texts]
    if not pattern.endswith("*"):
        assert any(ends)


@pytest.mark.parametrize("pattern", PROGRAMS, ids=IDS)
def test_pattern_bitmaps_match_oracle(pattern):
    pat, orc, texts = _api_case(pattern)
    assert pat.ends_batch(texts) == [sorted(orc.ends(t)) for t in texts]
    assert pat.starts_batch(texts) == [sorted(orc.starts(t)) for t in texts]


@pytest.mark.parametrize("longest", [False, True], ids=["lazy", "greedy"])
@pytest.mark.parametrize("pattern", PROGRAMS, ids=IDS)
def test_pattern_spans_match_oracle(pattern, longest):
    pat, orc, texts = _api_case(pattern)
    got = pat.finditer_batch(texts, longest=longest)
    assert got == [list(orc.finditer(t, longest=longest)) for t in texts]
    if pattern != NULLABLE:
        # no keyword is a prefix of another and a chain ends at one y: re's
        # matches of the alternation (lazy) and of the pattern (greedy) are
        # the policy's spans
        lazy_re = pattern[:-1] if pattern.endswith(")+") else pattern
        rx = re.compile((pattern if longest else lazy_re).encode())
        assert got == [[m.span() for m in rx.finditer(t)] for t in texts]


def test_pattern_search_and_match():
    """The first lazy span and the lazy anchored match: one keyword."""
    pat, orc, texts = _api_case(K60P)
    rx = re.compile(K60P[:-1].encode())
    for t in texts[:12]:
        for fn, ref in ((pat.search, rx.search), (pat.match, rx.match)):
            a, b = fn(t), ref(t)
            assert (a is None) == (b is None) and (a is None or a.span() == b.span()), (fn, t)


MP = [_kw(40), "cat|dog", "[0-9]{3}"]


@functools.lru_cache(maxsize=None)
def _mp_case():
    texts = _texts(MP[0])
    texts = [t + (b" cat 1234" if i % 3 == 0 else b"") for i, t in enumerate(texts)]
    return MultiPattern(MP, "cpu"), texts


def test_multipattern_union_counts_match_oracles():
    """A combined automaton of 288 states on the dense multiblock tier
    (P = 3 accept channels): counts, search and grep per pattern."""
    mp, texts = _mp_case()
    sc = mp.engine.device_scanner
    assert (type(sc).__name__, sc.nfa.s_tile, sc.nfa.P) == ("PallasScanner", 384, 3)
    cnt = mp.count_batch(texts)
    for p, pattern in enumerate(MP):
        orc = OracleEngine(build_nfa(pattern))
        assert cnt[:, p].tolist() == [len(orc.ends(t)) for t in texts], pattern
    assert np.array_equal(mp.search_batch(texts), cnt > 0)
    assert np.array_equal(mp.grep(texts), cnt > 0)
    assert (cnt > 0).any(axis=0).all()


MP_C1 = [_kw(40), "cat|dog", "[0-9]?$"]  # a `$` channel: a span at EOS, then (len, len)


@functools.lru_cache(maxsize=None)
def _jax_mp_spans():
    """The JAX MultiPattern's lazy spans of the union on the first 8 texts
    (one interpret-mode combined scan under the module's slab_r=2)."""
    from roaringregex_tpu.api import MultiPattern as JaxMultiPattern

    _, texts = _mp_case()
    return JaxMultiPattern(MP).finditer_batch(texts[:8])


def test_multipattern_union_lazy_spans_raise():
    """Lazy spans of a dense multiblock union (288 states, s_tile 384, P = 3)
    from one combined scan (``lazy_spans_mb``: the wide multi-channel
    kernels' plain versions here): the JAX MultiPattern's on 8 records, each
    pattern's oracle on every record, and with a `$` channel the empty match
    at len after a span that ends at EOS (C1), against the oracle."""
    mp, texts = _mp_case()
    assert mp._combined_spans and mp.engine.device_scanner.nfa.s_tile > scan_pallas.REG_S_TILE
    got = mp.finditer_batch(texts)
    assert [g[:8] for g in got] == _jax_mp_spans()
    for p, pattern in enumerate(MP):
        orc = OracleEngine(build_nfa(pattern))
        assert got[p] == [list(orc.finditer(t)) for t in texts], pattern
    assert all(any(g) for g in got)
    mp1 = MultiPattern(MP_C1, "cpu")
    assert (mp1._combined_spans, mp1.engine.device_scanner.nfa.s_tile) == (True, 384)
    texts1 = [t + b" 12" for t in texts[:12]] + [b"7", b"", b"cat 9"]
    got1 = mp1.finditer_batch(texts1)
    for p, pattern in enumerate(MP_C1):
        orc = OracleEngine(build_nfa(pattern))
        assert got1[p] == [list(orc.finditer(t)) for t in texts1], pattern
    assert (len(texts1[0]) - 1, len(texts1[0])) in got1[2][0]
    assert (len(texts1[0]), len(texts1[0])) in got1[2][0]


def test_long_route_keeps_torch_op_scanner():
    """K60 (412 states, s_tile 512, horizon 12) takes the window kernels
    (FastLongScanner) for its seeded scans and answers as the oracle does;
    its unseeded scans (fullmatch) still take the torch-op LongScanner, as
    in the JAX package."""
    pattern = _kw(60, "")
    prog = compile_program(pattern)
    assert (prog.s_tile, prog.horizon) == (512, 12)
    sc = make_long_scanner(prog, "cpu", block=256)
    assert type(sc) is FastLongScanner
    rng = np.random.default_rng(11)
    parts = [bytes(rng.choice(np.frombuffer(b"abcdefgilnorstu ", np.uint8), size=40))
             + WORDS[int(j)] for j in rng.integers(0, 60, size=4)]
    text = b"".join(parts)
    orc = OracleEngine(build_nfa(pattern))
    want = orc.ends(text)
    assert sc.count_ends(text) == len(want) and sc.search(text)
    assert np.nonzero(sc.ends_bitmap(text))[0].tolist() == sorted(want)
    # the route's LongScanner takes 4,096-step blocks (as JAX's does): ~12 s
    # a call here, so this one, set in its place, takes 256
    assert sc._portable is None
    portable = LongScanner(prog, "cpu", block=256)
    calls = []
    flags = portable._flags
    portable._flags = lambda *a: calls.append(a[2]) or flags(*a)
    sc._portable = portable
    assert sc.fullmatch(WORDS[5]) and not sc.fullmatch(text)
    assert calls == [False, False]  # unseeded, both through the torch-op scanner
