"""The port's engine and ``Pattern`` on the matmul tier (CPU, plain PyTorch
versions) against the JAX package (Pallas interpret mode): the scanner the
engine picks for each pattern (the counting, bitband and container tiers'
too, and the dense multiblock matmul's), the ``Pattern`` entry points on
33..256-state programs, and the engine-level window plan."""
import functools
import re

import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.engine import ScanEngine as JaxEngine
from roaringregex_tpu.utils import config as jax_config
from roaringregex_tpu_torch.utils import config as port_config
from roaringregex_tpu.oracle.engine import OracleEngine
from test_torch_pallas import HTTP, K7, K16, K30, NAMES, PATTERNS

torch.set_num_threads(1)


def _keywords(n: int):
    """K30's words and n - 30 more (lowercase, 5-9 letters, none a prefix of
    another)."""
    rng = np.random.default_rng(40)
    words = K30[1:-1].split("|")
    while len(words) < n:
        w = bytes(rng.integers(97, 123, size=int(rng.integers(5, 10))).astype(np.uint8)).decode()
        if not any(a.startswith(w) or w.startswith(a) for a in words):
            words.append(w)
    return words


K40 = "(" + "|".join(_keywords(40)) + ")"  # multiblock, 286 states: containers
K60_PLUS = "(" + "|".join(_keywords(60)) + ")+"  # multiblock, 427 states: dense multiblock matmul
# the scanner each package's engine picks: the SWAR and u32-word tiers, the
# matmul tier, (then three) the counting tier, (then three) the bitband
# tier: config 10 and two banded multiblock programs, and (the last five)
# the container tier: two multiblock programs, a 40-word alternation, and
# config 13 and x(abc|de){1,300}y (sparse)
ROUTED = [p for p, _ in PATTERNS] + [
    "cat|dog", "(ab)*c+d?", "^[a-z]{3,8}[.]log$", "(cat|dog|bird)+",
    "a{1,120}", "(ab){2,60}", "a{1,300}",
    "x(ab|c){400,520}y", "(ab|c){100,130}", "x{2,300}y",
    "a*b{1,300}", "(ab|c){2,120}d", K40, "(abc|de){1,300}", "x(abc|de){1,300}y",
]
NAMES = {**NAMES, K40: "K40", K60_PLUS: "K60+"}
# programs with neither a counting plan nor a seeded alias, which both
# engines run on the dense multiblock matmul (tests/test_torch_multiblock.py
# holds that tier to the JAX package)
DENSE_MB = [
    ("x(ab|c){300,}y", "multiblock, 903 states"),
    (K60_PLUS, "multiblock, 427 states"),
]
WORDS = [b"error", b"warning", b"critical", b"fatal", b"exception", b"timeout", b"refused",
         b"oom", b"leak", b"deadlock", b"unauthorized"]


def _texts(seed: int, n: int = 40, maxlen: int = 40):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdeiklmnorstuwx ", np.uint8)
    out = [b"", b"error", b"timeout", b"GET /a HTTP/1.0", b"PUT /x.y HTTP/1.1", b"oomleak",
           b"errorerror", b"warning: disk timeout", b"HEAD / HTTP/2.0"]
    while len(out) < n:
        t = bytearray(rng.choice(alphabet, size=int(rng.integers(0, maxlen))).tobytes())
        for _ in range(int(rng.integers(0, 3))):
            w = WORDS[int(rng.integers(len(WORDS)))]
            at = int(rng.integers(0, len(t) + 1))
            t[at:at] = w
        out.append(bytes(t))
    return out


@functools.lru_cache(maxsize=None)
def _both(pattern):
    return rrx.compile(pattern, "cpu"), jax_rrx.compile(pattern, backend="pallas")


@pytest.mark.parametrize("pattern", ROUTED, ids=lambda p: NAMES.get(p, p))
def test_routing_identity(pattern):
    port = rrx.compile(pattern, "cpu").engine.device_scanner
    ref = JaxEngine(jax_compile(pattern), backend="pallas").device_scanner
    assert type(port).__name__ == type(ref).__name__


@pytest.mark.parametrize("pattern", ["x[ab]{0,400}c", "x(ab|c){400,520}y"])
def test_routing_identity_without_bitband(pattern):
    """RRX_BITBAND=0 sends bitband programs to the container tier in both
    packages."""
    old_j, old_p = jax_config.get_config(), port_config.get_config()
    jax_config.set_config(old_j.with_(bitband=False))
    port_config.set_config(old_p.with_(bitband=False))
    try:
        port = rrx.compile(pattern, "cpu").engine.device_scanner
        ref = JaxEngine(jax_compile(pattern), backend="pallas").device_scanner
    finally:
        jax_config.set_config(old_j)
        port_config.set_config(old_p)
    assert type(port).__name__ == type(ref).__name__ == "SparseScanner"


@pytest.mark.parametrize("pattern,why", DENSE_MB, ids=lambda p: NAMES.get(p, p))
def test_refused_tiers_raise(pattern, why):
    """The two programs the port refused before it had the dense multiblock
    matmul (the test keeps its name): both engines take that tier
    (``PallasScanner`` at the same record tile), and the port's counts,
    search and fullmatch equal the oracle's."""
    ref = JaxEngine(jax_compile(pattern), backend="pallas")
    assert type(ref.device_scanner).__name__ == "PallasScanner" and ref.prog.tier == "multiblock"
    assert ref._seeded_alias() is None
    pat = rrx.compile(pattern, "cpu")
    assert type(pat.engine.device_scanner).__name__ == "PallasScanner"
    assert f"{pat.tier}, {pat.n_states} states" == why
    assert pat.program.s_tile == ref.prog.s_tile > 256
    orc = OracleEngine(jax_compile(pattern).nfa)
    texts = [b"", b"x" + b"c" * 300 + b"y", b"xab" + b"c" * 298 + b"y", b"timeout", b"errorwarning",
             _keywords(60)[59].encode() * 2 + b" x"]
    ends = [sorted(orc.ends(t)) for t in texts]
    assert sum(map(len, ends)) > 0
    np.testing.assert_array_equal(pat.count_batch(texts), [len(e) for e in ends])
    np.testing.assert_array_equal(pat.search_batch(texts), [bool(e) for e in ends])
    np.testing.assert_array_equal(pat.fullmatch_batch(texts), [orc.fullmatch(t) for t in texts])


@pytest.mark.parametrize("pattern", ["a*b{1,300}", "(ab|c){2,120}d"])
def test_container_programs_answer(pattern):
    """Two multiblock programs with neither a counting plan nor a seeded
    alias run on the container tier: counts, search and fullmatch against
    the oracle."""
    pat = rrx.compile(pattern, "cpu")
    assert type(pat.engine.device_scanner).__name__ == "SparseScanner"
    orc = OracleEngine(jax_compile(pattern).nfa)
    texts = [b"", b"b", b"cabd", b"xaabbd", b"ab" * 20 + b"d", b"c" * 3 + b"d" + b"b" * 4, b"abcd"]
    ends = [sorted(orc.ends(t)) for t in texts]
    assert sum(map(len, ends)) > 0
    np.testing.assert_array_equal(pat.count_batch(texts), [len(e) for e in ends])
    np.testing.assert_array_equal(pat.search_batch(texts), [bool(e) for e in ends])
    np.testing.assert_array_equal(pat.fullmatch_batch(texts), [orc.fullmatch(t) for t in texts])


def test_alias_program_unseeded_call_raises():
    """Config 13's seeded scans run on its 6-state alias and a scan that
    needs the original program on its container tier: fullmatch equals
    the oracle's."""
    pat = rrx.compile("(abc|de){1,300}", "cpu")
    assert type(pat.engine.device_scanner).__name__ == "SparseScanner"
    assert pat.search_batch([b"xabcx", b"dd"]).tolist() == [True, False]
    orc = OracleEngine(jax_compile("(abc|de){1,300}").nfa)
    texts = [b"abc", b"abcde", b"abcd", b"", b"de" * 300, b"de" * 301, b"xabc"]
    assert pat.fullmatch_batch(texts).tolist() == [orc.fullmatch(t) for t in texts]


@pytest.mark.parametrize("pattern", [K7, K30], ids=["K7", "K30"])
def test_pattern_entry_points_match_jax(pattern):
    port, ref = _both(pattern)
    assert type(port.engine.device_scanner).__name__ == "PallasScanner"
    texts = _texts(len(pattern))
    for name in ("count_batch", "search_batch", "fullmatch_batch"):
        np.testing.assert_array_equal(getattr(port, name)(texts),
                                      np.asarray(getattr(ref, name)(texts)), err_msg=name)
    assert port.grep(texts) == ref.grep(texts)
    rx = re.compile(pattern.encode())
    for longest in (False, True):
        got = port.finditer_batch(texts, longest=longest)
        assert got == ref.finditer_batch(texts, longest=longest)
        # no keyword is a prefix of another: re's spans are both policies'
        assert got == [[m.span() for m in rx.finditer(t)] for t in texts]
    singles = (b"xxerror", b"timeout", b"no match") if pattern == K7 else ()
    if singles:
        # the JAX Pattern's search (its first lazy span), match (the
        # anchored end from 0) and fullmatch of each single text, run in one
        # batch with ``texts`` so that they reuse the batch's interpret-mode
        # compiles (records are independent)
        batch = list(singles) + texts
        spans = ref.finditer_batch(batch)
        full = np.asarray(ref.fullmatch_batch(batch))
        data, lengths, _, _ = ref._pack(batch)
        starts = np.full(data.shape[0], -1, np.int32)
        starts[: len(singles)] = 0
        ends = np.asarray(ref.engine.first_end_from(data, lengths, starts))
    for i, t in enumerate(singles):
        want = {"search": spans[i][0] if spans[i] else None,
                "match": (0, int(ends[i])) if ends[i] >= 0 else None,
                "fullmatch": (0, len(t)) if full[i] else None}
        for fn, w in want.items():
            a = getattr(port, fn)(t)
            assert (a is None) == (w is None), (fn, t)
            assert a is None or (a.span(), a.group()) == (w, t[w[0] : w[1]]), (fn, t)


def test_anchored_pattern_matches_jax():
    port, ref = _both(HTTP)
    texts = _texts(3)
    for name in ("count_batch", "search_batch", "fullmatch_batch"):
        np.testing.assert_array_equal(getattr(port, name)(texts),
                                      np.asarray(getattr(ref, name)(texts)), err_msg=name)
    rx = re.compile(HTTP.encode())
    assert port.search_batch(texts).tolist() == [rx.search(t) is not None for t in texts]
    for t in (b"GET /a HTTP/1.0", b"GET /a HTTP/1.0x", b"GET /A HTTP/1.0"):
        a, b = port.match(t), ref.match(t)
        assert (a is None) == (b is None) and (a is None or a.span() == b.span()), t


def test_nullable_greedy_spans_match_jax():
    port, ref = _both(K7 + "*")
    texts = _texts(4, n=16)
    assert port.finditer_batch(texts, longest=True) == ref.finditer_batch(texts, longest=True)
    assert port.finditer_batch(texts) == ref.finditer_batch(texts)


@pytest.fixture()
def window_cfg():
    """Engine-level windows on (window_cols=2048) and the SWAR tiers off,
    in both packages, as tests/test_windowed.py sets the JAX package."""
    old_j, old_p = jax_config.get_config(), port_config.get_config()
    jax_config.set_config(old_j.with_(window_cols=2048, swar=False))
    port_config.set_config(old_p.with_(window_cols=2048, swar=False))
    yield
    jax_config.set_config(old_j)
    port_config.set_config(old_p)


WINDOW_CASES = [
    ("cat|dog", 300, 32), ("cat|dog", 1000, 16), ("a[bc]d", 1000, 64), ("[a-z]x{2,5}", 300, 8),
    (K7, 1000, 4), (K16, 2000, 2), ("(a|b)*c", 1000, 16), ("^ab", 1000, 16), ("a*", 1000, 16),
    ("cat|dog", 200, 16), ("cat|dog", 4000, 4096),
]


@pytest.mark.parametrize("pattern,L,B", WINDOW_CASES,
                         ids=[f"{NAMES.get(p, p)}-{L}-{B}" for p, L, B in WINDOW_CASES])
def test_window_plan_matches_jax(window_cfg, pattern, L, B):
    port = rrx.compile(pattern, "cpu").engine
    ref = JaxEngine(jax_compile(pattern), backend="pallas")
    assert type(port.device_scanner).__name__ == type(ref.device_scanner).__name__
    assert port._window_plan(L, B, True) == ref._window_plan(L, B, True)
    assert port._window_plan(L, B, False) is None


@pytest.mark.parametrize("pattern,plant", [("cat|dog", b"dog"), (K7, b"timeout")],
                         ids=["cat|dog", "K7"])
def test_windowed_stats_match_jax(window_cfg, pattern, plant):
    port = rrx.compile(pattern, "cpu").engine
    ref = JaxEngine(jax_compile(pattern), backend="pallas")
    G = port.prog.G
    rng = np.random.default_rng(5)
    B, L = 2 * G, 600
    data = rng.integers(97, 123, size=(B, L), dtype=np.uint8)
    w = np.frombuffer(plant, np.uint8)
    for b in range(B):
        for pos in (0, 127, 128, 150, 299, 300, L - len(w)):
            if rng.random() < 0.5:
                data[b, pos : pos + len(w)] = w
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[0], lengths[1] = L, 0
    plan = port._window_plan(L, B, True)
    assert plan is not None and plan[0] >= 2
    got = port.match_stats(data, lengths, seeded=True)
    want = ref.match_stats(data, lengths, seeded=True)
    for x, y, name in zip(got, want, ("cnt", "first", "any")):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    port_config.set_config(port_config.get_config().with_(window_cols=0))
    flat = port.match_stats(data, lengths, seeded=True)
    for x, y in zip(got, flat):
        assert torch.equal(x, y)
