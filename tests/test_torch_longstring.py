"""One long string: the port's long scanners (plain PyTorch versions, CPU)
against the oracle (``roaringregex_tpu/oracle/engine.py``) and Python's
``re``, and against the JAX package's long scanners (Pallas interpret mode)
on a few cached cases.

Windows of 256 bytes and a 64-step speculative warm-up make strings of up
to 3,000 bytes cross many windows. Parity is held at the scanners' public
outputs (counts, search, fullmatch, flags and the two bitmaps, spans):
the window layouts of the two packages differ. Every output is an integer
or a bool, so every comparison is exact. The CUDA kernels (``rrx_long_*``)
are held to the same plain versions on the card by ``chip_smoke.py``."""
import functools
import re

import numpy as np
import pytest
import torch

import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.nfa import build_nfa as jax_build_nfa
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops.longstring import make_long_scanner as jax_make_long_scanner
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu_torch.compiler.program import compile_program
from roaringregex_tpu_torch.ops import longstring as ls
from roaringregex_tpu_torch.ops import scan_pallas as spl
from roaringregex_tpu_torch.utils import config as cfg

torch.set_num_threads(1)

BLOCK, WARMUP = 256, 64
K7 = "(error|warning|critical|fatal|exception|timeout|refused)"
# (id, pattern, the port's long scanner): configs 8, 9, 12 and 14, anchors,
# a nullable pattern, a wide tile with a horizon (W = 2), a wide cyclic tile
# (torch-op summaries), a speculative case that fails validation, and a
# big X{m,n} through its seeded alias
CASES = [
    ("config8", "cat|dog", "FastLongScanner"),
    ("config9", "a{1,300}", "CountLongScanner"),
    ("config12", ".*(cat|dog).*", "DotStarLongScanner"),
    ("config14", "(ab)*c", "FastLongScanner"),
    ("bos", "^ab", "FastLongScanner"),
    ("eos", "ab$", "FastLongScanner"),
    ("nullable", "(ab|c)*d?", "FastLongScanner"),
    ("wide", K7, "FastLongScanner"),
    ("wide-cyclic", "(error|warning|critical|fatal|exception|timeout|refused)+x", "LongScanner"),
    ("spec-fail", "a(bb)*c", "FastLongScanner"),
    ("alias", "(abc|de){1,300}", "AliasLongScanner"),
]
IDS = [c[0] for c in CASES]
BYTES = b"abcdeogt\x00\x80\xff\n"
PLANTS = [b"cat", b"dog", b"ab", b"abab", b"aaaa", b"error", b"timeout x", b"abcde",
          b"abbbbc", b"dd", b"refusedx"]


@pytest.fixture(autouse=True)
def _long_config():
    base = cfg.get_config()
    cfg.set_config(base.with_(long_block=BLOCK, spec_warmup=WARMUP))
    yield
    cfg.set_config(base)


def _texts(seed: int, sizes=(0, 1, 2, 255, 256, 257, 700, 1500, 3000)):
    """Random strings over BYTES (bytes 0x00, 0x80, 0xff and newline among
    them) with plants, one per size."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        t = bytearray(rng.choice(np.frombuffer(BYTES, np.uint8), size=n).astype(np.uint8))
        for _ in range(n // 40):
            w = PLANTS[int(rng.integers(len(PLANTS)))]
            at = int(rng.integers(0, max(n - len(w), 0) + 1))
            t[at : at + len(w)] = w[: n - at]
        out.append(bytes(t[:n]))
    return out


@functools.lru_cache(maxsize=None)
def _oracle(pattern):
    return OracleEngine(jax_build_nfa(pattern))


@functools.lru_cache(maxsize=None)
def _pattern(pattern):
    return rrx.compile(pattern, "cpu")


def _scanner(pattern):
    p = rrx.compile(pattern, "cpu")  # fresh: its long scanner reads this test's config
    return p, p.long


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_routing(case):
    """make_long_scanner picks the JAX package's scanner class."""
    _, pattern, name = case
    _, sc = _scanner(pattern)
    assert type(sc).__name__ == name
    jsc = jax_make_long_scanner(jax_compile(pattern), block=BLOCK)
    assert type(jsc).__name__ == name


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_counts_bitmaps_vs_oracle(case):
    """count_ends, search, fullmatch, ends_bitmap and flags against the
    oracle's ends and fullmatch (the alias case's fullmatch and flags run
    its own sparse program's summary + replay in torch ops, ~2 S^2
    operations a byte at 1,503 states: test_alias_unseeded_raises checks
    them on short strings)."""
    _, pattern, _ = case
    _, sc = _scanner(pattern)
    orc = _oracle(pattern)
    for t in _texts(1):
        ends = orc.ends(t)
        assert sc.count_ends(t) == len(ends), (pattern, len(t))
        assert sc.search(t) == bool(ends), (pattern, len(t))
        if case[0] != "alias":
            assert sc.fullmatch(t) == orc.fullmatch(t), (pattern, len(t))
        assert set(np.nonzero(sc.ends_bitmap(t))[0].tolist()) == ends, (pattern, len(t))
        if hasattr(sc, "flags") and case[0] != "alias":
            fl = sc.flags(t)
            assert fl.shape == (len(t) + 2,) and fl.dtype == torch.bool
            if not _pattern(pattern).program.nullable:
                got = ls.ends_of_flags(fl, len(t))
                assert set(torch.nonzero(got)[:, 0].tolist()) == ends, (pattern, len(t))


SPAN_CASES = [c for c in CASES if c[0] != "alias"]


@pytest.mark.parametrize("case", SPAN_CASES, ids=[c[0] for c in SPAN_CASES])
def test_starts_and_spans_vs_oracle(case):
    """starts_bitmap (bounded-horizon programs; the cyclic ones raise) and
    finditer_long (lazy and greedy) against the oracle."""
    _, pattern, _ = case
    p, sc = _scanner(pattern)
    orc = _oracle(pattern)
    for t in _texts(2, sizes=(0, 1, 257, 900)):
        if p.program.horizon is not None:
            got = set(np.nonzero(sc.starts_bitmap(t))[0].tolist())
            assert got == orc.starts(t), (pattern, len(t))
        for longest in (False, True):
            assert p.finditer_long(t, longest=longest) == orc.findall(t, longest=longest), (
                pattern, len(t), longest)


@pytest.mark.parametrize("pattern", ["(ab)*c", ".*(cat|dog).*"])
def test_cyclic_starts_raise(pattern):
    _, sc = _scanner(pattern)
    with pytest.raises(ValueError, match="bounded-horizon"):
        sc.starts_bitmap(b"abc")


def _short_texts(seed: int, n: int = 4):
    """Strings of tens of bytes over the C2 programs' letters, with chains."""
    rng = np.random.default_rng(seed)
    # the last fixed one crosses a 32-step block: pass 1 summarises block 0
    out = [b"", b"abcde", b"xabcdey", b"xdey", b"abcdeabcde", b"z" * 27 + b"xabcdedeabcy" + b"x"]
    for _ in range(n):
        t = bytearray(rng.choice(np.frombuffer(b"abcdexyz", np.uint8), size=int(rng.integers(5, 24))))
        chain = b"x" + b"".join(rng.choice([b"abc", b"de"], size=int(rng.integers(1, 5)))) + b"y"
        at = int(rng.integers(0, len(t)))
        out.append(bytes(t[:at] + chain + t[at:]))
    return out


def test_alias_unseeded_raises():
    """A big X{m,n} counts and searches through its seeded alias; what needs
    the original sparse-tier program (fullmatch, the reversed program of
    finditer_long) runs LongScanner's summary + replay over the XLA
    backend's tables, as the JAX package's does, and answers as the oracle
    does. (The name is from before the sparse tier's long scans answered:
    they raised ValueError.)"""
    p, sc = _scanner("(abc|de){1,300}")
    orc = _oracle("(abc|de){1,300}")
    for t in _short_texts(11):
        assert sc.fullmatch(t) == orc.fullmatch(t), t
        for longest in (False, True):
            assert p.finditer_long(t, longest=longest) == orc.findall(t, longest=longest), (
                t, longest)


@functools.lru_cache(maxsize=None)
def _jax_sparse_long():
    """The JAX package's LongScanner of x(abc|de){1,300}y (its F from the
    follow blocks) at a block of 32: (count_ends, fullmatch) per string."""
    jsc = jax_make_long_scanner(jax_compile("x(abc|de){1,300}y"), block=32)
    assert type(jsc).__name__ == "LongScanner"
    return {t: (jsc.count_ends(t), jsc.fullmatch(t)) for t in _short_texts(12)}


def test_sparse_long_scanner_vs_jax_and_oracle():
    """Pattern.long of a sparse-tier program that no rewrite takes
    (x(abc|de){1,300}y, 1,503 states): count_ends and fullmatch on strings
    of tens of bytes against the JAX package's LongScanner and the oracle."""
    cfg.set_config(cfg.get_config().with_(long_block=32))
    p = rrx.compile("x(abc|de){1,300}y", "cpu")
    sc = p.long
    assert type(sc).__name__ == "LongScanner"
    orc = _oracle("x(abc|de){1,300}y")
    for t, (want_cnt, want_full) in _jax_sparse_long().items():
        assert sc.count_ends(t) == want_cnt == len(orc.ends(t)), t
        assert sc.fullmatch(t) == want_full == orc.fullmatch(t), t


@pytest.mark.parametrize("pattern,re_pattern", [
    ("cat|dog", "cat|dog"), ("a{1,300}", "a{1,300}"), ("ab$", r"ab\Z"), ("^ab", r"\Aab"),
    (K7, K7), (".*(cat|dog).*", "[^\x80-\xff\n]*(cat|dog)[^\x80-\xff\n]*"),
], ids=["config8", "config9", "eos", "bos", "wide", "config12"])
def test_finditer_long_vs_re(pattern, re_pattern):
    """Greedy spans against Python's re (leftmost-longest coincides with re
    for these patterns; '.' never matches bytes >= 0x80, and re's '.' never
    matches a newline, which the text keeps out)."""
    p, _ = _scanner(pattern)
    rx = re.compile(re_pattern.encode("latin-1"), re.S)
    for t in _texts(3, sizes=(300, 2000)):
        t = t.replace(b"\n", b" ")
        assert p.finditer_long(t, longest=True) == [m.span() for m in rx.finditer(t)], pattern


def test_speculative_validation():
    """(ab)*c validates on any text (its seeded state set depends on one
    byte); a(bb)*c fails on a b-run longer than the warm-up across a window
    edge and takes summary + replay, with the same counts."""
    _, sc = _scanner("(ab)*c")
    t = b"x" * 100 + b"ab" * 400 + b"c" + b"x" * 100
    data = ls.as_data(t, "cpu")
    val, ok = sc._spec_impl(data, len(t), "count", WARMUP)
    assert bool(ok) and int(val) == len(_oracle("(ab)*c").ends(t))
    _, sc = _scanner("a(bb)*c")
    t = b"xa" + b"b" * 700 + b"c" + b"abbc" * 20
    data = ls.as_data(t, "cpu")
    val, ok = sc._spec_impl(data, len(t), "count", WARMUP)
    assert not bool(ok)
    assert sc.count_ends(t) == len(_oracle("a(bb)*c").ends(t))
    assert int(sc._sum_impl(data, len(t), True, "count")) == sc.count_ends(t)


@pytest.mark.parametrize("n", [0, 1, 4096, 4097, 3 * 4096 + 5])
def test_running_max_in_two_levels(n):
    """The running max of the `.*X.*` epilogue (rows of 4096, then the rows'
    maxima) equals one torch.cummax."""
    x = torch.from_numpy(np.random.default_rng(n).integers(-1, 1 << 30, size=n).astype(np.int32))
    want = torch.cummax(x, dim=0).values if n else x
    assert torch.equal(ls._cummax(x), want)


def test_too_long_raises():
    big = torch.zeros(1, dtype=torch.uint8).expand((1 << 31))
    _, sc = _scanner("cat|dog")
    with pytest.raises(ValueError, match="int32"):
        sc.count_ends(big)


def test_tensor_input():
    """A uint8 tensor is scanned in place, as bytes are."""
    _, sc = _scanner("cat|dog")
    t = _texts(4, sizes=(1500,))[0]
    assert sc.count_ends(torch.frombuffer(bytearray(t), dtype=torch.uint8)) == sc.count_ends(t)


@pytest.mark.parametrize("pattern", ["cat|dog", "(ab)*c", "^ab", K7])
def test_window_plain_versions_compose(pattern):
    """The windowed plain versions agree with one window over the whole
    string: the flags and counts of 64-step windows replayed from entry
    states (each the carry of every step before the window) equal the
    single window's."""
    prog = compile_program(pattern)
    t = spl.device_nfa_tables(prog, "cpu")
    data = ls.as_data(_texts(5, sizes=(700,))[0], "cpu")
    n = data.numel()
    one = spl.LongGeom(n, 1, 736, 0, 736)
    blk = 64
    nb = -(-(n + 2) // blk)
    entries = torch.zeros((nb, spl._words(t.s_tile)), dtype=torch.int32)
    for w in range(1, nb):  # one window over the global steps [0, 64 w)
        entries[w] = spl.long_carry_plain(data, spl.LongGeom(n, 1, 32, 0, blk * w), t,
                                          seeded=True)[0]
    geom = spl.LongGeom(n, nb, blk, 0, blk)
    got = spl.long_flags_plain(data, geom, t, entries, seeded=True)
    want = spl.long_flags_plain(data, one, t, seeded=True)
    assert torch.equal(ls.bits_of_words(got, n + 2), ls.bits_of_words(want, n + 2))
    cnt, tail, _ = spl.long_count_plain(data, geom, t, entries, seeded=True)
    c1, t1, _ = spl.long_count_plain(data, one, t, seeded=True)
    assert int(cnt.sum()) == int(c1.sum()) and bool(tail.any()) == bool(t1.any())


# -- parity with the JAX package's long scanners (interpret mode) -------------


@functools.lru_cache(maxsize=None)
def _jax_case(pattern):
    from roaringregex_tpu.utils.config import get_config, set_config

    base = get_config()
    set_config(base.with_(spec_warmup=WARMUP))
    try:
        jsc = jax_make_long_scanner(jax_compile(pattern), block=BLOCK)
        t = _texts(6, sizes=(1100,))[0]
        return t, jsc.count_ends(t), np.asarray(jsc.ends_bitmap(t))
    finally:
        set_config(base)


@pytest.mark.parametrize("pattern", ["cat|dog", "(ab)*c", "a{1,300}", K7],
                         ids=["config8-swar", "config14-spec", "config9-counting", "wide"])
def test_parity_with_jax_long_scanners(pattern):
    """count_ends and ends_bitmap of the port's scanner equal the JAX
    package's (SWAR windows, speculative and summary windows, run-length
    windows, a W = 2 wide tile)."""
    t, want_cnt, want_ends = _jax_case(pattern)
    _, sc = _scanner(pattern)
    assert sc.count_ends(t) == want_cnt
    np.testing.assert_array_equal(sc.ends_bitmap(t), want_ends)


# -- the API ----------------------------------------------------------------


def test_pattern_n_states_and_tier():
    for pattern in ("cat|dog", K7, "(abc|de){1,300}", "a{1,300}"):
        p = rrx.compile(pattern, "cpu")
        ref = jax_compile(pattern)
        assert (p.n_states, p.tier) == (ref.n_states, ref.tier)


def test_rev_long_is_the_reversed_program():
    p, _ = _scanner("ab+c")
    t = _texts(7, sizes=(600,))[0] + b"abbbc"
    rev = p.rev_long
    starts = set(np.nonzero(rev.ends_bitmap(t[::-1])[::-1])[0].tolist())
    assert starts == _oracle("ab+c").starts(t)
