"""The port's ``MultiPattern`` (CPU, plain PyTorch versions) against the JAX
package's ``MultiPattern(patterns, backend="pallas")`` (Pallas interpret
mode): the scanner each engine picks for the combined automaton (the
bitband and container tiers' too), the per-channel scanner methods
(``match_stats_b`` [B_rows, G * P], ``lazy_spans_mb``), and the entry
points (``count_batch``, ``search_batch``, ``grep``, lazy and greedy
``finditer_batch``) with nullable, ``^``- and ``$``-anchored patterns and
empty texts. Every output is an integer, a bool or a span, so every
comparison is exact. The CUDA kernels are held to the same plain versions
on the card (chip_smoke.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.nfa import build_nfa as jax_build_nfa
from roaringregex_tpu.compiler.nfa import combine_nfas as jax_combine
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.engine import ScanEngine as JaxEngine
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu_torch.ops import scan_pallas, scan_word
from test_torch_pallas import K7

torch.set_num_threads(1)

K7_WORDS = K7[1:-1].split("|")
CONFIG6 = ["cat|dog", "[0-9]{3}", "err(or)?", "ab(cd)*e"]
# tests/test_multipattern.py's sets, bench config 6 and K7 as seven patterns
SETS = {
    "words": ["cat", "dog", "bird"],
    "alt-plus-star": ["cat|dog", "[0-9]+", "(ab)*c"],
    "nullable-bos": ["a*", "err(or)?", "^x"],
    "class-eos": ["[a-f]{3}", "z", "foo$"],
    "config6": CONFIG6,
    "K7x7": K7_WORDS,
}
# greedy spans run per pattern through Pattern (the JAX route): checked on
# the sets with a nullable, a ^- and a $-anchored pattern
GREEDY = ["nullable-bos", "class-eos"]
TEXTS = [
    "catdog9", "", "bird", "abc", "ababc x", "zzz", "error!", "xfoo", "deadbeef", "a" * 30,
    "the cat had 4215 errors, abcdcde and abe", "xerror 123 warning: timeout refused",
    "fatal exception critical", "foo", "abefoo dog", "err0r erorr errorerror 99",
]


@functools.lru_cache(maxsize=None)
def _both(name):
    """One port MultiPattern (CPU) and one JAX MultiPattern per set, reused
    across the tests (the JAX scanner's jitted calls are cached on it)."""
    pats = SETS[name]
    return rrx.MultiPattern(pats, "cpu"), jax_rrx.MultiPattern(pats, backend="pallas")


@functools.lru_cache(maxsize=None)
def _packed(name):
    port, _ = _both(name)
    data, lengths, B = port._pack(TEXTS)
    return data, lengths.reshape(-1, max(port.program.G, 1))


@pytest.mark.parametrize("name", list(SETS))
def test_routing_identity(name):
    port, ref = _both(name)
    assert type(port.engine.device_scanner).__name__ == type(ref.engine.device_scanner).__name__
    assert port.P == ref.P and port.program.n_states == ref.program.n_states
    np.testing.assert_array_equal(port.accept_map, ref.accept_map)
    assert port.nullables.tolist() == ref.nullables.tolist()
    assert port._ranges == ref._ranges
    assert (port.subprograms is None) == (ref.subprograms is None)


def test_route_of_the_bench_sets():
    """Config 6 runs on the u32-word tier with 4 channels, K7 as seven
    patterns on the matmul tier with 7: the P-channel kernels' two homes."""
    c6, k7 = _both("config6")[0], _both("K7x7")[0]
    assert isinstance(c6.engine.device_scanner, scan_word.WordScanner)
    assert (c6.program.n_states, c6.program.s_tile, c6.P) == (20, 32, 4)
    assert type(k7.engine.device_scanner) is scan_pallas.PallasScanner
    assert (k7.program.n_states, k7.P) == (49, 7)


def _oracle_counts(pats, texts):
    """[B, P] distinct match-end counts per pattern, from the oracle."""
    orcs = [OracleEngine(jax_build_nfa(p)) for p in pats]
    return np.array([[len(o.ends(t)) for o in orcs] for t in texts])


@pytest.mark.parametrize("pats,tier", [(["a{2,900}", "b{2,300}"], "sparse"),
                                       (["a{3,1200}", "b{2,4}"], "sparse")])
def test_refused_tiers_raise(pats, tier):
    """The JAX engine runs these combined programs on its bitband or
    container tier, and so does the port: per-pattern counts, search and
    grep equal the oracle's, and spans run per pattern."""
    ref = jax_rrx.MultiPattern(pats, backend="pallas")
    port = rrx.MultiPattern(pats, "cpu")
    assert ref.program.tier == port.program.tier == tier
    name = type(ref.engine.device_scanner).__name__
    assert name in ("BitbandScanner", "SparseScanner")
    assert type(port.engine.device_scanner).__name__ == name
    texts = [b"", b"aa", b"abbb", b"a" * 70 + b"b" * 3, b"xbbaaa", b"b" * 90]
    want = _oracle_counts(pats, texts)
    np.testing.assert_array_equal(port.count_batch(texts), want)
    np.testing.assert_array_equal(port.grep(texts), want > 0)
    assert port.finditer_batch(texts[:3]) == [rrx.compile(p, "cpu").finditer_batch(texts[:3])
                                              for p in pats]


def test_accept_map_has_no_counting_plan():
    """A counting-plan pattern given with an accept map gets no counting
    plan in either engine (the plan has one accept channel)."""
    nfa, accepts = jax_combine([jax_build_nfa("a{1,300}")])
    prog = jax_compile(nfa)
    A = np.zeros((prog.lanes, prog.G), np.uint8)
    A[sorted(s for s in accepts[0] if s > 0), 0] = 1
    ref = JaxEngine(prog, backend="pallas", accept_map=A)
    assert ref._counting is None and JaxEngine(prog, backend="pallas")._counting is not None
    assert rrx.compile("a{1,300}", "cpu").engine.device_scanner is not None
    mp = rrx.MultiPattern(["a{1,300}"], "cpu")
    assert mp.engine._counting is None and mp.program.tier == "multiblock"
    ref_mp = JaxEngine(prog, backend="pallas", accept_map=A, channels_per_record=1)
    assert type(mp.engine.device_scanner).__name__ == type(ref_mp.device_scanner).__name__
    texts = [b"", b"a", b"ba" * 3, b"a" * 305]
    np.testing.assert_array_equal(mp.count_batch(texts), _oracle_counts(["a{1,300}"], texts))


@pytest.mark.parametrize("name", ["config6", "K7x7"])
@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
def test_match_stats_b_matches_jax(name, seeded):
    port, ref = _both(name)
    data, len_g = _packed(name)
    a = ref.engine.device_scanner.match_stats_b(jnp.asarray(data), jnp.asarray(len_g), seeded=seeded)
    b = port.engine.device_scanner.match_stats_b(torch.from_numpy(data), torch.from_numpy(len_g),
                                                 seeded=seeded)
    shape = (len_g.shape[0], len_g.shape[1] * port.P)
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        assert tuple(y.shape) == shape
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=f"{name} output {i}")


@pytest.mark.parametrize("name", ["config6", "K7x7", "nullable-bos"])
def test_lazy_spans_mb_matches_jax(name):
    """Both scanners' per-channel lazy spans, on the non-nullable channels
    (a nullable channel's rows are meaningless in both)."""
    port, ref = _both(name)
    data, len_g = _packed(name)
    a = ref.engine.device_scanner.lazy_spans_mb(jnp.asarray(data), jnp.asarray(len_g), cap=4)
    b = port.engine.device_scanner.lazy_spans_mb(torch.from_numpy(data), torch.from_numpy(len_g),
                                                 cap=4)
    R, live = data.shape[0], ~port.nullables
    assert [tuple(x.shape) for x in b] == [(R, port.P, 4)] * 2 + [(R, port.P)]
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        np.testing.assert_array_equal(np.asarray(x)[:, live], y.numpy()[:, live],
                                      err_msg=f"{name} output {i}")


@pytest.mark.parametrize("name", list(SETS))
def test_entry_points_match_jax(name):
    port, ref = _both(name)
    for fn in ("count_batch", "search_batch", "grep"):
        got = getattr(port, fn)(TEXTS)
        assert got.shape == (len(TEXTS), port.P), fn
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, fn)(TEXTS)), err_msg=fn)
    assert port.finditer_batch(TEXTS) == ref.finditer_batch(TEXTS)
    if name in GREEDY:
        assert port.finditer_batch(TEXTS, longest=True) == ref.finditer_batch(TEXTS, longest=True)


def test_empty_batch_and_texts():
    port, ref = _both("nullable-bos")
    for texts in ([], [""], ["", "x", ""]):
        np.testing.assert_array_equal(port.count_batch(texts), np.asarray(ref.count_batch(texts)))
        assert port.finditer_batch(texts) == ref.finditer_batch(texts)


def test_errors():
    with pytest.raises(ValueError, match="no patterns"):
        rrx.MultiPattern([], "cpu")
    with pytest.raises(rrx.RegexSyntaxError):
        rrx.MultiPattern(["a", "b{3,1}"], "cpu")


def test_single_channel_primitives_raise():
    """A multi-channel engine and its scanner refuse every primitive that
    reads one accept set, rather than answering from the channels' union."""
    port, _ = _both("config6")
    eng, sc = port.engine, port.engine.device_scanner
    data, len_g = _packed("config6")
    d, lengths = torch.from_numpy(data), torch.from_numpy(len_g.reshape(-1))
    calls = [
        lambda: eng.forward_flags(d, lengths, seeded=True),
        lambda: eng.reverse_hits(d, lengths),
        lambda: eng.first_end_from(d, lengths, torch.zeros_like(lengths)),
        lambda: eng.lazy_spans(d, lengths, cap=4),
        lambda: eng.greedy_spans(d, lengths, cap=4),
        lambda: eng.ends_bitmap(d, lengths, 8),
        lambda: eng.starts_bitmap(d, lengths, 8),
        lambda: eng.fullmatch_flags(d, lengths),
        lambda: sc.lazy_spans_b(d, torch.from_numpy(len_g), cap=4),
        lambda: sc.hits_words_b(d, torch.from_numpy(len_g)),
        lambda: sc.flags_words_b(d, torch.from_numpy(len_g), seeded=True),
        lambda: sc.anchor_end_b(d, torch.from_numpy(len_g), torch.from_numpy(len_g), longest=True),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="accept channels"):
            call()
    assert eng._seeded_alias() is None and eng._window_plan(4096, 64, True) is None
