"""The port's span entry points (CPU, plain PyTorch versions) against the
JAX package's Pattern (Pallas interpret mode): finditer_batch lazy and
greedy, finditer, findall, search and match, on the SWAR-tier patterns and
texts of tests/test_device_spans.py."""
import functools

import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu_torch.ops.scan_swar import SwarScanner
from test_device_spans import PATTERNS, _texts

torch.set_num_threads(1)

WORD_TIER = "(ab|cd)+e{2,3}f"
SWAR_PATTERNS = [p for p in PATTERNS if p != WORD_TIER]
SINGLE_TEXTS = [b"", b"xxcatdog", b"aab"]


@functools.lru_cache(maxsize=None)
def _both(pattern):
    port = rrx.compile(pattern, "cpu")
    assert isinstance(port.engine.device_scanner, SwarScanner), pattern
    return port, jax_rrx.compile(pattern, backend="pallas")


@pytest.mark.parametrize("longest", [False, True])
@pytest.mark.parametrize("pattern", SWAR_PATTERNS)
def test_finditer_batch_matches_jax(pattern, longest):
    port, ref = _both(pattern)
    texts = _texts()
    if longest and port.program.nullable:
        # the JAX package runs these on the matmul tier's span kernels
        with pytest.raises(NotImplementedError, match="matmul tier.*ROADMAP"):
            port.finditer_batch(texts, longest=True)
        return
    assert port.finditer_batch(texts, longest=longest) == ref.finditer_batch(texts, longest=longest)


@pytest.mark.parametrize("pattern", ["cat|dog", "^a+", "a|ab", "a*"])
def test_single_string_entry_points_match_jax(pattern):
    port, ref = _both(pattern)
    for t in SINGLE_TEXTS:
        for name in ("search", "match"):
            a, b = getattr(port, name)(t), getattr(ref, name)(t)
            assert (a is None) == (b is None), (pattern, name, t)
            if a is not None:
                assert (a.span(), a.group()) == (b.span(), b.group()), (pattern, name, t)
        want = list(ref.finditer(t))
        assert [m.span() for m in port.finditer(t)] == [m.span() for m in want], (pattern, t)
        assert port.findall(t) == [m.group() for m in want], (pattern, t)


@pytest.mark.parametrize(
    "pattern,text,want",
    [
        ("a|ab", b"ab", [(0, 2)]),
        ("a|ab", b"aab", [(0, 1), (1, 3)]),
        ("x|xy|xyz", b"xyzxy", [(0, 3), (3, 5)]),
    ],
)
def test_posix_longest_alternation(pattern, text, want):
    port, ref = _both(pattern)
    got = port.finditer_batch([text], longest=True)[0]
    assert got == want == ref.finditer_batch([text], longest=True)[0]
    assert [m.span() for m in port.finditer(text, longest=True)] == want
    assert port.findall(text, longest=True) == [text[s:e] for s, e in want]


@pytest.mark.parametrize("longest", [False, True])
def test_cap_presized_no_retry(longest, monkeypatch):
    """1,000 matches in one record take one span call: the cap comes from
    the counts pass, bucketed to a power of two."""
    port = rrx.compile("a", "cpu")
    sc = port.engine.device_scanner
    name = "greedy_spans_b" if longest else "lazy_spans_b"
    orig = getattr(sc, name)
    caps = []
    monkeypatch.setattr(sc, name, lambda *a, **k: caps.append(k["cap"]) or orig(*a, **k))
    got = port.finditer_batch([b"a" * 1000], longest=longest)[0]
    assert got == [(i, i + 1) for i in range(1000)]
    assert caps == [1024]


def test_word_tier_spans_raise():
    port = rrx.compile(WORD_TIER, "cpu")
    assert type(port.engine.device_scanner).__name__ == "WordScanner"
    for longest in (False, True):
        with pytest.raises(NotImplementedError, match="u32-word tier.*matmul.*ROADMAP"):
            port.finditer_batch([b"abee f", b"cdeef"], longest=longest)
    with pytest.raises(NotImplementedError, match="u32-word tier.*ROADMAP"):
        port.match(b"abeef")


def test_spans_on_cpu_leave_launch_counts():
    """The CPU path takes the plain versions: no kernel launch is counted."""
    from roaringregex_tpu_torch.ops import scan_swar

    names = ("swar_reverse", "swar_lazy_spans", "swar_anchor_end", "swar_greedy_spans")
    before = [getattr(scan_swar, n).launches for n in names]
    port, _ = _both("cat|dog")
    port.finditer_batch([b"catdog"], longest=False)
    port.finditer_batch([b"catdog"], longest=True)
    port.match(b"cat")
    assert [getattr(scan_swar, n).launches for n in names] == before
    assert np.array_equal(port.search_batch([b"catdog", b"x"]), [True, False])
