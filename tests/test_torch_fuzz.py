"""Differential fuzz of the port: random patterns (the generators of
``tests/test_fuzz_differential.py``) through every batch entry point of
``Pattern`` and ``MultiPattern`` (plain PyTorch versions, CPU) against the
oracle (``roaringregex_tpu/oracle/engine.py``).

The oracle is the spec here, not the JAX package's Pallas kernels: lazy
spans that end at the EOS step and are followed by the empty match at the
end of the record (``a?$`` on ``a``: (0, 1), (1, 1)) are emitted by the
port and by ``re``, and dropped by the JAX package's Pallas span kernels
(its host-round route keeps them). The C1 cases below pin that."""
import numpy as np
import pytest
import torch

import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.nfa import build_nfa as jax_build_nfa
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu_torch.api import MultiPattern
from test_fuzz_differential import _gen_blowup_pattern, _gen_pattern, _gen_texts

torch.set_num_threads(1)

# lazy spans that end at EOS, then the empty match at len (C1)
C1_PATTERNS = ["a?$", "b*$", "(ab)?$", "[a-c]{0,40}$", "(a|bc)*$"]
C1_TEXTS = [b"a", b"ab", b"abc", b"xa", b"bcbc", b"", b"cab"]


def _check_pattern(pattern: str, texts) -> bool:
    """Every Pattern entry point against the oracle; False when the port
    refuses the program's tier (it raises naming it)."""
    try:
        pat = rrx.compile(pattern, "cpu")
    except NotImplementedError:
        return False
    orc = OracleEngine(jax_build_nfa(pattern))
    fm = pat.fullmatch_batch(texts)
    sr = pat.search_batch(texts)
    cnt = pat.count_batch(texts)
    ends = pat.ends_batch(texts)
    starts = pat.starts_batch(texts)
    lazy = pat.finditer_batch(texts)
    greedy = pat.finditer_batch(texts, longest=True)
    for i, t in enumerate(texts):
        want_ends = orc.ends(t)
        assert bool(fm[i]) == orc.fullmatch(t), (pattern, t, "fullmatch")
        assert bool(sr[i]) == orc.search(t), (pattern, t, "search")
        assert int(cnt[i]) == len(want_ends), (pattern, t, "count")
        assert set(ends[i]) == want_ends, (pattern, t, "ends")
        assert set(starts[i]) == orc.starts(t), (pattern, t, "starts")
        assert lazy[i] == orc.findall(t), (pattern, t, "lazy")
        assert greedy[i] == orc.findall(t, longest=True), (pattern, t, "greedy")
    t = texts[-1]
    m = pat.match(t)
    assert (m.end if m else None) == orc.match(t), (pattern, t, "match")
    s = pat.search(t)
    assert (s.span() if s else None) == next(iter(orc.finditer(t)), None), (pattern, t)
    f = pat.fullmatch(t)
    assert (f is not None) == orc.fullmatch(t), (pattern, t)
    return True


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_pattern_vs_oracle(seed):
    rng = np.random.default_rng(7000 + seed)
    tested = 0
    while tested < 8:
        pattern = _gen_pattern(rng)
        tested += _check_pattern(pattern, _gen_texts(rng, n=6))


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_blowups_vs_oracle(seed):
    rng = np.random.default_rng(8000 + seed)
    tested = 0
    while tested < 4:
        pattern = _gen_blowup_pattern(rng)
        texts = [b"", b"ab", b"abcd" * 6, b"x" + b"ab" * 10]
        texts += [bytes(rng.choice(list(b"abcdex"), size=int(rng.integers(0, 60)))
                        .astype(np.uint8)) for _ in range(3)]
        tested += _check_pattern(pattern, texts)


@pytest.mark.parametrize("pattern", C1_PATTERNS)
def test_c1_trailing_empty_lazy_span(pattern):
    """The empty match at len after a lazy span that ends at EOS."""
    assert _check_pattern(pattern, C1_TEXTS)


def test_c1_repro():
    assert rrx.compile("a?$", "cpu").finditer_batch([b"a"]) == [[(0, 1), (1, 1)]]


MP_SETS = [
    ["a?$", "b*$", "cat"],  # $ channels: C1 per channel
    ["(ab)?$", "x", "[a-c]{0,40}$"],
    ["cat|dog", "[0-9]{3}", "err(or)?", "ab(cd)*e"],  # config 6
]


@pytest.mark.parametrize("patterns", MP_SETS, ids=["eos-channels", "eos-wide", "config6"])
def test_fuzz_multipattern_vs_oracle(patterns):
    """MultiPattern count_batch, search_batch, grep and lazy and greedy
    finditer_batch per pattern against the oracle."""
    rng = np.random.default_rng(9000)
    texts = C1_TEXTS + _gen_texts(rng, n=6) + [b"cat123 error abcde", b"xab"]
    mp = MultiPattern(patterns, "cpu")
    cnt = mp.count_batch(texts)
    sr = mp.search_batch(texts)
    gr = mp.grep(texts)
    lazy = mp.finditer_batch(texts)
    greedy = mp.finditer_batch(texts, longest=True)
    for p, pattern in enumerate(patterns):
        orc = OracleEngine(jax_build_nfa(pattern))
        for i, t in enumerate(texts):
            ends = orc.ends(t)
            assert int(cnt[i, p]) == len(ends), (pattern, t)
            assert bool(sr[i, p]) == bool(ends) == bool(gr[i, p]), (pattern, t)
            assert lazy[p][i] == orc.findall(t), (pattern, t, "lazy")
            assert greedy[p][i] == orc.findall(t, longest=True), (pattern, t, "greedy")
