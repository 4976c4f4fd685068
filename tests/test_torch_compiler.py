"""The port's carried-over compiler against the JAX package's.

``roaringregex_tpu_torch`` cannot import the JAX package's host compiler
(importing any of ``roaringregex_tpu`` loads jax), so it carries its own
copy; these tests hold every field the scan tiers read, and both specs,
to the original.
"""
import numpy as np
import pytest
import torch

from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_swar as jax_swar
from roaringregex_tpu.ops import scan_word as jax_word
from roaringregex_tpu_torch.compiler.program import compile_program, from_reference
from roaringregex_tpu_torch.ops import scan_swar, scan_word
from test_swar import PATTERNS as SWAR_PATTERNS
from test_word import PATTERNS as WORD_PATTERNS

torch.set_num_threads(1)

BENCH_PATTERNS = ["cat|dog", "[a-z]+\\.log$", "(ab)*c+d?"]
PATTERNS = list(dict.fromkeys(SWAR_PATTERNS + WORD_PATTERNS + BENCH_PATTERNS))
# wider programs: the port compiles them and routes them nowhere yet
WIDE = ["a{1,300}", "a" * 200, "a{1,1100}"]

ARRAYS = ["F", "Bc_words", "accept"]
SCALARS = [
    "bos_class", "eos_class", "tier", "s_tile", "G", "n_states",
    "nullable", "horizon", "uses_anchor",
]


def _same_program(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    for x, y, name in zip(a.byte_runs, b.byte_runs, ("lo", "hi", "cls")):
        np.testing.assert_array_equal(x, y, err_msg=f"byte_runs {name}")
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("pattern", PATTERNS + WIDE)
def test_program_fields_match_jax(pattern):
    _same_program(compile_program(pattern), jax_compile(pattern))


@pytest.mark.parametrize("pattern", PATTERNS + WIDE[:1])
def test_specs_match_jax(pattern):
    port, ref = compile_program(pattern), jax_compile(pattern)
    assert scan_swar.swar_spec(port) == jax_swar.swar_spec(ref)
    assert scan_word.word_spec(port) == jax_word.word_spec(ref)


@pytest.mark.parametrize("pattern", ["cat|dog", "^[a-z]{3,8}[.]log$", "(a|$)*", "a{1,1100}"])
def test_from_reference_round_trip(pattern):
    ref = jax_compile(pattern)
    port = from_reference(ref)
    _same_program(port, ref)
    assert port.pattern == ref.pattern
    # a copy, not a view: the port never writes into the reference's tables
    if ref.F is not None:
        assert not np.shares_memory(port.F, ref.F)
    # and the port's own object round-trips through itself
    _same_program(from_reference(port), port)
