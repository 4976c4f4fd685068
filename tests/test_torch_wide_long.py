"""One long string of a dense program of 257..1024 states (record tiles of
384..1024 states, W = 12..32 state words): the port's ``FastLongScanner`` on
the wide window kernels (``csrc/scan_long_wide.cu`` on the card, their plain
PyTorch versions here on the CPU).

- Routing: ``make_long_scanner`` picks the JAX package's class
  (``FastLongScanner``) for keyword alternations of 60 and 120 words,
  ``[a-z]{300}x`` and ``x(ab|c){300,340}y``.
- Against the JAX package's ``FastLongScanner`` (Pallas interpret mode, one
  cached scanner at a long block of 128 and one ~1.5 KB string): K60's
  ``count_ends``, ``search``, ``ends_bitmap`` and ``starts_bitmap``. Each
  JAX method costs a ~10-13 s interpret-mode compile, so ``search`` is held
  to JAX's count (its "any" mode is the same kernel with another reduction).
- The four window plain versions at tiles of 384, 512, 896 and 1024 states
  against the oracle (``roaringregex_tpu/oracle/engine.py``).
- ``x(ab|c){300,340}y`` and ``[a-z]{300}x`` on one string of 6,000 bytes
  with a chain across a window edge, against ``re`` and the oracle,
  ``finditer_long`` included. The plain step at 1024 states costs ~0.4 ms
  on the CPU (a [2, 1024] x [1024, 1024] product), ~3 s a pass here.

Every output is an integer or a bool: every comparison is exact.
"""
import functools
import re

import numpy as np
import pytest
import torch

import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.nfa import build_nfa
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops.longstring import make_long_scanner as jax_make_long_scanner
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu.utils.config import get_config, set_config
from roaringregex_tpu_torch.compiler.program import compile_program
from roaringregex_tpu_torch.ops import longstring as ls
from roaringregex_tpu_torch.ops import scan_pallas as spl
from test_torch_api_pallas import _keywords

torch.set_num_threads(1)


def _kw(n: int) -> str:
    return "(" + "|".join(_keywords(n)) + ")"


K60, K120 = _kw(60), _kw(120)
CHAIN = "x(ab|c){300,340}y"
RUN = "[a-z]{300}x"
WORDS = [w.encode() for w in _keywords(120)]
# (id, pattern, s_tile): one bounded-horizon program at each of four tiles
TILES = [("K40", _kw(40), 384), ("K60", K60, 512), ("K120", K120, 896), ("chain", CHAIN, 1024)]


@functools.lru_cache(maxsize=None)
def _oracle(pattern):
    return OracleEngine(build_nfa(pattern))


@pytest.mark.parametrize("pattern", [K60, K120, RUN, CHAIN], ids=["K60", "K120", "run", "chain"])
def test_routing_matches_jax(pattern):
    """The window kernels hold the tile: both packages take FastLongScanner,
    the block grown to eight overlaps where the horizon needs it."""
    prog = compile_program(pattern)
    assert prog.s_tile > spl.REG_S_TILE and prog.horizon is not None
    sc = ls.make_long_scanner(prog, "cpu")
    jsc = jax_make_long_scanner(jax_compile(pattern))
    assert type(sc).__name__ == type(jsc).__name__ == "FastLongScanner"
    assert sc.overlap == prog.horizon + 2 and sc.block >= 8 * sc.overlap
    assert ls.fast_long_takes(prog, sc.block)


def _keyword_text(seed: int, n: int, words) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        parts.append(bytes(rng.choice(np.frombuffer(b"abcdefgilnorstu ", np.uint8),
                                      size=int(rng.integers(5, 40)))))
        parts.append(words[int(rng.integers(len(words)))])
    return b"".join(parts)[:n]


@functools.lru_cache(maxsize=None)
def _jax_k60():
    """(text, count, ends bitmap, starts bitmap) of the JAX package's
    FastLongScanner of K60 at a long block of 128 (s_tile 512: its window
    kernels at a slab unroll of 2 steps)."""
    base = get_config()
    set_config(base.with_(slab_r=2))
    try:
        jsc = jax_make_long_scanner(jax_compile(K60), block=128)
        assert type(jsc).__name__ == "FastLongScanner" and jsc.block == 128
        t = _keyword_text(3, 1536, WORDS[:60])
        return (t, jsc.count_ends(t), np.asarray(jsc.ends_bitmap(t)),
                np.asarray(jsc.starts_bitmap(t)))
    finally:
        set_config(base)


@pytest.mark.parametrize("method", ["count_ends", "search", "ends_bitmap", "starts_bitmap"])
def test_k60_matches_jax(method):
    t, cnt, ends, starts = _jax_k60()
    sc = ls.make_long_scanner(compile_program(K60), "cpu", block=128)
    assert type(sc).__name__ == "FastLongScanner" and sc._ov_block(len(t)) == 128
    want = {"count_ends": cnt, "search": cnt > 0, "ends_bitmap": ends,
            "starts_bitmap": starts}[method]
    got = getattr(sc, method)(t)
    np.testing.assert_array_equal(got, want)
    assert cnt >= 20


def _plant_text(seed: int, n: int) -> bytes:
    """n bytes with bytes 0x00 and 0x80, keywords planted, and last two
    chains: a miss of x(ab|c){300,340}y (210 tokens) and a match (320)."""
    rng = np.random.default_rng(seed)
    t = bytearray(rng.choice(np.frombuffer(b"abcdefgilnorstuxy \x00\x80", np.uint8), size=n))
    for k in range(n // 60):
        w = WORDS[k % 8]
        at = int(rng.integers(0, n - len(w) + 1))
        t[at : at + len(w)] = w
    t[40:360] = b"x" + b"abc" * 106 + b"y"
    t[500:822] = b"x" + b"c" * 320 + b"y"
    return bytes(t)


@pytest.mark.parametrize("name,pattern,s_tile", TILES, ids=[t[0] for t in TILES])
def test_window_plain_versions_vs_oracle(name, pattern, s_tile):
    """long_count_plain, long_flags_plain and long_reverse_plain over
    overlapped windows of 256 owned steps, and long_carry_plain chained
    into long_count_plain from its final state, give the oracle's count,
    ends and starts."""
    prog = compile_program(pattern)
    assert prog.s_tile == s_tile
    tb = spl.device_nfa_tables(prog, "cpu")
    t = _plant_text(len(name), 900)
    data = ls.as_data(t, "cpu")
    n, o, blk = len(t), prog.horizon + 2, 256
    orc = _oracle(pattern)
    ends, starts = orc.ends(t), orc.starts(t)
    assert ends
    nw = -(-(n + 2) // blk)
    geom = spl.LongGeom(n, nw, blk, o, blk + o)
    cnt, tail, _ = spl.long_count_plain(data, geom, tb, seeded=True)
    assert int(ls._merge_counts(cnt, tail, "count")) == len(ends)
    fl = ls.bits_of_words(spl.long_flags_plain(data, geom, tb, seeded=True), n + 2)
    assert set(torch.nonzero(ls.ends_of_flags(fl, n))[:, 0].tolist()) == ends
    rgeom = spl.LongGeom(n, nw, blk, 0, blk + o)
    hits = ls.bits_of_words(spl.long_reverse_plain(data, rgeom, tb), n + 2)
    assert set(torch.nonzero(ls.starts_of_hits(hits, n))[:, 0].tolist()) == starts
    # two windows of m steps: the second from the carry of the first
    m = ls._round_up(-(-(n + 2) // 2), 32)
    v1 = spl.long_carry_plain(data, spl.LongGeom(n, 1, m, 0, m), tb, seeded=True)
    v0 = torch.cat([torch.zeros_like(v1), v1])
    c2, t2, _ = spl.long_count_plain(data, spl.LongGeom(n, 2, m, 0, m), tb, v0, seeded=True)
    assert int(ls._merge_counts(c2, t2, "count")) == len(ends)


def _chain_string(pattern: str) -> bytes:
    """A string of 6,000 bytes (two windows of the overlapped path) with
    matches and near misses, one of them across the first window's edge."""
    rng = np.random.default_rng(7)
    t = bytearray(rng.choice(np.frombuffer(b"abcxy -", np.uint8), size=6000))
    sc = ls.make_long_scanner(compile_program(pattern), "cpu")
    edge = sc._ov_block(len(t))
    if pattern == CHAIN:
        def chain(k):
            toks = [b"ab" if rng.random() < 0.4 else b"c" for _ in range(k)]
            return b"x" + b"".join(toks) + b"y"
        plants = [(100, chain(299)), (700, chain(300)), (1400, chain(340)), (2200, chain(341)),
                  (3000, chain(305)), (edge - 200, chain(310))]
    else:
        letters = bytes(rng.integers(97, 123, size=420).astype(np.uint8))
        plants = [(edge - 150, letters[:300] + b"x"), (400, letters[:299] + b"x"),
                  (1500, letters[:330] + b"x"), (3000, b"q" + letters[:300] + b"xx")]
    for at, w in plants:
        t[at : at + len(w)] = w
    return bytes(t)


@pytest.mark.parametrize("pattern", [CHAIN, RUN], ids=["chain", "run"])
def test_chain_programs_vs_re_and_oracle(pattern):
    """count_ends, ends_bitmap and finditer_long of the pattern's long
    scanner (block 5,472 and 4,096: overlaps of 684 and 303 steps) against
    the oracle and re."""
    p = rrx.compile(pattern, "cpu")
    sc = p.long
    assert type(sc).__name__ == "FastLongScanner" and p.program.s_tile > spl.REG_S_TILE
    t = _chain_string(pattern)
    orc = _oracle(pattern)
    ends = orc.ends(t)
    spans = [m.span() for m in re.finditer(pattern.encode(), t)]
    assert len(spans) >= 3 and any(s < sc._ov_block(len(t)) < e for s, e in spans)
    assert sc.count_ends(t) == len(ends)
    assert set(np.nonzero(sc.ends_bitmap(t))[0].tolist()) == ends
    # finditer_long reads its candidate starts from starts_bitmap (the
    # reverse windows); a second reverse pass here would cost ~3 s
    assert p.finditer_long(t) == orc.findall(t, longest=False) == spans
