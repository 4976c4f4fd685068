"""The port's span entry points (CPU, plain PyTorch versions) against the
JAX package's Pattern (Pallas interpret mode): finditer_batch lazy and
greedy, finditer, findall, search and match, on the patterns and texts of
tests/test_device_spans.py (SWAR tier, and the u32-word tier, whose spans
run on the matmul tier in both packages)."""
import functools

import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from test_device_spans import PATTERNS, _texts

torch.set_num_threads(1)

WORD_TIER = "(ab|cd)+e{2,3}f"
SINGLE_TEXTS = [b"", b"xxcatdog", b"aab"]


@functools.lru_cache(maxsize=None)
def _both(pattern):
    port = rrx.compile(pattern, "cpu")
    ref = jax_rrx.compile(pattern, backend="pallas")
    name = type(ref.engine.device_scanner).__name__
    assert type(port.engine.device_scanner).__name__ == name, pattern
    return port, ref


@pytest.mark.parametrize("longest", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_finditer_batch_matches_jax(pattern, longest):
    """Nullable greedy spans and every span of the u32-word-tier pattern
    run on the matmul tier's span path in both packages."""
    port, ref = _both(pattern)
    texts = _texts()
    assert port.finditer_batch(texts, longest=longest) == ref.finditer_batch(texts, longest=longest)


def _jax_spans(ref, texts, *, longest: bool = False):
    """The JAX Pattern's spans of ``texts``, run in one batch with
    ``_texts()`` so that it packs to the shape of
    test_finditer_batch_matches_jax's batch and reuses its interpret-mode
    compiles (records are independent: each one's spans do not depend on
    the rest of the batch)."""
    return ref.finditer_batch(list(texts) + _texts(), longest=longest)[: len(texts)]


def _jax_match_ends(ref, texts):
    """The JAX Pattern's ``match`` end of each text (-1 = none; a nullable
    program matches the empty prefix without a scan, as ``match`` does),
    from one ``first_end_from`` over the batch of :func:`_jax_spans`."""
    if ref.program.nullable:
        return [0] * len(texts)
    data, lengths, _, _ = ref._pack(list(texts) + _texts())
    starts = np.full(data.shape[0], -1, np.int32)
    starts[: len(texts)] = 0
    return np.asarray(ref.engine.first_end_from(data, lengths, starts))[: len(texts)].tolist()


@pytest.mark.parametrize("pattern", ["cat|dog", "^a+", "a|ab", "a*"])
def test_single_string_entry_points_match_jax(pattern):
    """search, match, finditer and findall of single strings against the
    JAX Pattern's answers for the same strings (``search`` is the first
    lazy span, ``finditer`` the spans, ``match`` the anchored end from 0)."""
    port, ref = _both(pattern)
    spans = _jax_spans(ref, SINGLE_TEXTS)
    ends = _jax_match_ends(ref, SINGLE_TEXTS)
    for t, want, e in zip(SINGLE_TEXTS, spans, ends):
        a = port.search(t)
        assert (a is None) == (not want), (pattern, "search", t)
        assert a is None or (a.span(), a.group()) == (want[0], t[want[0][0] : want[0][1]])
        a = port.match(t)
        assert (a is None) == (e < 0), (pattern, "match", t)
        assert a is None or (a.span(), a.group()) == ((0, e), t[:e]), (pattern, "match", t)
        assert [m.span() for m in port.finditer(t)] == want, (pattern, t)
        assert port.findall(t) == [t[s:e_] for s, e_ in want], (pattern, t)


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
    assert got == want == _jax_spans(ref, [text], longest=True)[0]
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
    """A u32-word-tier program's spans and anchored match run on the matmul
    tier's span path and equal the JAX package's."""
    port, ref = _both(WORD_TIER)
    assert type(port.engine.device_scanner).__name__ == "WordScanner"
    texts = [b"abee f", b"cdeef", b"ababeefcdeeef", b""]
    for longest in (False, True):
        got = port.finditer_batch(texts, longest=longest)
        assert got == _jax_spans(ref, texts, longest=longest), longest
    assert got[2] == [(0, 7), (7, 13)]
    singles = (b"abeef", b"abeefx", b"xabeef")
    for t, e in zip(singles, _jax_match_ends(ref, singles)):
        a = port.match(t)
        assert (a is None) == (e < 0) and (a is None or a.span() == (0, e)), t


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
