"""The port's matmul tier (``PallasScanner``, plain PyTorch versions, CPU)
against the JAX package's ``PallasScanner`` (Pallas interpret mode) at the
scanner boundary: anchored-rescan ends (lazy and longest), lazy and greedy
spans, for record tiles of 8 to 256 states, on the patterns and batches of
tests/test_torch_pallas.py. Exact comparisons."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pallas import IDS, NON_NULLABLE, NON_NULLABLE_IDS, PATTERNS, _args, _case, _eq

torch.set_num_threads(1)

# both policies on the wide tiles, the longest end (the greedy rounds'
# rescan) on the SWAR- and word-size ones
ANCHOR_CASES = [
    (p, s, longest) for (p, s) in PATTERNS for longest in (False, True) if s >= 64 or longest
]
ANCHOR_IDS = [f"{i}-{'longest' if lg else 'lazy'}" for i, (p, s) in zip(IDS, PATTERNS)
              for lg in (False, True) if s >= 64 or lg]


@pytest.mark.parametrize("pattern,s_tile,longest", ANCHOR_CASES, ids=ANCHOR_IDS)
def test_anchor_end_parity(pattern, s_tile, longest):
    jax_sc, port_sc, data, len_g = _case(pattern)
    rng = np.random.default_rng(s_tile)
    starts = rng.integers(-1, data.shape[1] + 3, size=len_g.size).astype(np.int32)
    starts[:8] = 0
    starts[8:10] = -1
    starts[10:14] = len_g.reshape(-1)[10:14]  # the EOS step is the seed step
    st_g = starts.reshape(len_g.shape)
    ja, pa = _args(data, len_g)
    a = jax_sc.anchor_end_b(*ja, jnp.asarray(st_g), longest=longest)
    b = port_sc.anchor_end_b(*pa, torch.from_numpy(st_g), longest=longest)
    assert b.shape == len_g.shape
    _eq([a], [b], f"{pattern} longest={longest}")


@pytest.mark.parametrize("pattern,s_tile", NON_NULLABLE, ids=NON_NULLABLE_IDS)
def test_lazy_spans_parity(pattern, s_tile):
    jax_sc, port_sc, data, len_g = _case(pattern)
    ja, pa = _args(data, len_g)
    b = port_sc.lazy_spans_b(*pa, cap=4)
    assert [tuple(x.shape) for x in b] == [(data.shape[0], 4)] * 2 + [(data.shape[0],)]
    _eq(jax_sc.lazy_spans_b(*ja, cap=4), b, pattern)


@pytest.mark.parametrize("pattern,s_tile", PATTERNS, ids=IDS)
def test_greedy_spans_parity(pattern, s_tile):
    jax_sc, port_sc, data, len_g = _case(pattern)
    ja, pa = _args(data, len_g)
    b = port_sc.greedy_spans_b(*pa, cap=4)
    assert b[3].dtype == torch.bool
    _eq(jax_sc.greedy_spans_b(*ja, cap=4), b, pattern)


def test_nullable_lazy_spans_refused():
    """Both scanners refuse a nullable program's lazy spans: they are the
    empty match at every position."""
    jax_sc, port_sc, data, len_g = _case("(cat|dog)*")
    ja, pa = _args(data, len_g)
    with pytest.raises(AssertionError):
        jax_sc.lazy_spans_b(*ja, cap=4)
    with pytest.raises(ValueError, match="empty match at every position"):
        port_sc.lazy_spans_b(*pa, cap=4)
