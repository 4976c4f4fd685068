"""The port's SWAR span path (plain PyTorch versions, CPU) against the JAX
SwarScanner (Pallas interpret mode) at the scanner boundary: reverse hits,
anchored-rescan ends (lazy and longest), lazy and greedy spans. Every
output is an integer or a bool, so every comparison is exact. The CUDA
kernels themselves are held to the same plain versions on the card
(chip_smoke.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_packed as sp
from roaringregex_tpu.ops import scan_swar as jax_swar
from roaringregex_tpu_torch.compiler.program import from_reference
from roaringregex_tpu_torch.ops import scan_bits, scan_swar
from test_swar import PATTERNS, _batch

torch.set_num_threads(1)

NON_NULLABLE = [p for p in PATTERNS if not jax_compile(p).nullable]
NULLABLE = [p for p in PATTERNS if jax_compile(p).nullable]
# nullable, '^' and '$' patterns among them
ANCHOR_PATTERNS = [
    "cat|dog", "(ab)*c+d?", "(cat|dog)*", "^ab?c$", "[a-c]x{0,2}$", "a*",
    "(a|$)*", "(^|a)b*",
]


@functools.lru_cache(maxsize=None)
def _case(pattern):
    """One JAX scanner per pattern, reused across its methods (its jitted
    calls are cached on the scanner), the port's plain-path scanner, and
    the shared test batch."""
    ref = jax_compile(pattern)
    jax_sc = jax_swar.SwarScanner(ref, sp.packed_tables(ref))
    port_sc = scan_swar.SwarScanner(from_reference(ref), "cpu")
    data, lengths = _batch(seed=3, G=ref.G)
    return jax_sc, port_sc, data, lengths.reshape(-1, ref.G)


def _eq(a, b, tag):
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=f"{tag} output {i}")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_reverse_hits_parity(pattern):
    jax_sc, port_sc, data, len_g = _case(pattern)
    a = np.asarray(jax_sc.reverse_hits_b(jnp.asarray(data), jnp.asarray(len_g)))
    b = port_sc.reverse_hits_b(torch.from_numpy(data), torch.from_numpy(len_g))
    assert b.shape == (data.shape[0], data.shape[1] + 2) and b.dtype == torch.bool
    np.testing.assert_array_equal(a, b.numpy(), err_msg=pattern)


@pytest.mark.parametrize("pattern", ["cat|dog", "^ab?c$", "(a|$)*", "[^a-c]"])
def test_hit_words_unpack(pattern):
    """The hit words [W, R] the span kernels read unpack to the bits of
    reverse_hits_b, and every bit past a record's EOS step is 0."""
    _, port_sc, data, len_g = _case(pattern)
    d, lengths = torch.from_numpy(data), torch.from_numpy(len_g.reshape(-1))
    words = scan_swar.swar_reverse(d, lengths, port_sc.tables)
    R, L = data.shape
    assert words.shape == (scan_bits.hit_words(L), R) and words.dtype == torch.int32
    bits = scan_bits.hit_bits(words, L + 2)
    assert torch.equal(bits, port_sc.reverse_hits_b(d, torch.from_numpy(len_g)))
    full = scan_bits.hit_bits(words, 32 * words.shape[0])
    past = torch.arange(full.shape[1])[None, :] > lengths[:, None] + 1
    assert not full[past].any()


@pytest.mark.parametrize("longest", [False, True])
@pytest.mark.parametrize("pattern", ANCHOR_PATTERNS)
def test_anchor_end_parity(pattern, longest):
    jax_sc, port_sc, data, len_g = _case(pattern)
    rng = np.random.default_rng(1)
    starts = rng.integers(-1, data.shape[1] + 3, size=len_g.size).astype(np.int32)
    starts[:8] = 0
    starts[8:12] = -1
    starts[12:16] = len_g.reshape(-1)[12:16]  # the EOS step is the seed step
    st_g = starts.reshape(len_g.shape)
    a = jax_sc.anchor_end_b(
        jnp.asarray(data), jnp.asarray(len_g), jnp.asarray(st_g), longest=longest
    )
    b = port_sc.anchor_end_b(
        torch.from_numpy(data), torch.from_numpy(len_g), torch.from_numpy(st_g), longest=longest
    )
    assert b.shape == len_g.shape
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{pattern} {longest}")


@pytest.mark.parametrize("pattern", NON_NULLABLE)
def test_lazy_spans_parity(pattern):
    jax_sc, port_sc, data, len_g = _case(pattern)
    a = jax_sc.lazy_spans_b(jnp.asarray(data), jnp.asarray(len_g), cap=16)
    b = port_sc.lazy_spans_b(torch.from_numpy(data), torch.from_numpy(len_g), cap=16)
    assert [tuple(x.shape) for x in b] == [(data.shape[0], 16)] * 2 + [(data.shape[0],)]
    _eq(a, b, pattern)


@pytest.mark.parametrize("pattern", NON_NULLABLE)
def test_greedy_spans_parity(pattern):
    jax_sc, port_sc, data, len_g = _case(pattern)
    a = jax_sc.greedy_spans_b(jnp.asarray(data), jnp.asarray(len_g), cap=16)
    b = port_sc.greedy_spans_b(torch.from_numpy(data), torch.from_numpy(len_g), cap=16)
    assert b[3].dtype == torch.bool
    _eq(a, b, pattern)


@pytest.mark.parametrize("policy", ["lazy", "greedy"])
def test_spans_overflow_parity(policy):
    """cap = 2 on a pattern with more spans than that per record: lazy
    counts past cap, greedy raises ``over``."""
    jax_sc, port_sc, data, len_g = _case("(ab)*c+d?")
    args = (torch.from_numpy(data), torch.from_numpy(len_g))
    if policy == "lazy":
        a = jax_sc.lazy_spans_b(jnp.asarray(data), jnp.asarray(len_g), cap=2)
        b = port_sc.lazy_spans_b(*args, cap=2)
        assert (b[2] > 2).any()
    else:
        a = jax_sc.greedy_spans_b(jnp.asarray(data), jnp.asarray(len_g), cap=2)
        b = port_sc.greedy_spans_b(*args, cap=2)
        assert b[3].any() and (b[2] <= 2).all()
    _eq(a, b, policy)


@pytest.mark.parametrize("pattern", NULLABLE)
def test_nullable_spans_raise(pattern):
    """A nullable program's spans run on the matmul tier in both packages:
    greedy spans (with the empty-match fallback, over cap on long records)
    equal the JAX scanner's; lazy spans, the empty match at every
    position, are refused by both scanners (the API answers them without
    a scan)."""
    jax_sc, port_sc, data, len_g = _case(pattern)
    args = (torch.from_numpy(data), torch.from_numpy(len_g))
    a = jax_sc.greedy_spans_b(jnp.asarray(data), jnp.asarray(len_g), cap=16)
    b = port_sc.greedy_spans_b(*args, cap=16)
    assert b[3].any()
    _eq(a, b, pattern)
    with pytest.raises(AssertionError):
        jax_sc.lazy_spans_b(jnp.asarray(data), jnp.asarray(len_g), cap=16)
    with pytest.raises(ValueError, match="empty match at every position"):
        port_sc.lazy_spans_b(*args, cap=16)


def test_span_wrappers_check_shapes():
    _, port_sc, data, len_g = _case("cat|dog")
    d, lengths = torch.from_numpy(data), torch.from_numpy(len_g.reshape(-1))
    words = scan_swar.swar_reverse(d, lengths, port_sc.tables)
    with pytest.raises(ValueError, match="hits must be"):
        scan_swar.swar_lazy_spans(d, lengths, port_sc.tables, words[:-1], 4)
    with pytest.raises(ValueError, match="cap must be"):
        scan_swar.swar_greedy_spans(d, lengths, port_sc.tables, words, 0)
    with pytest.raises(ValueError, match="starts must be"):
        scan_swar.swar_anchor_end(d, lengths, port_sc.tables, lengths[:-1], longest=False)
