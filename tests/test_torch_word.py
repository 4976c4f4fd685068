"""The port's u32-word tier (plain PyTorch version, CPU) against the JAX
WordScanner (Pallas interpret mode) at the scanner boundary, seeded and
unseeded, plus the zero-byte phantom-BOS case."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_packed as sp
from roaringregex_tpu.ops import scan_word as jax_word
from roaringregex_tpu_torch.compiler.program import from_reference
from roaringregex_tpu_torch.ops import scan_bits, scan_word
from test_word import PATTERNS, _batch

torch.set_num_threads(1)

NAMES = ["cnt", "first", "last", "full", "any"]


def _both(pattern):
    ref = jax_compile(pattern)
    jax_sc = jax_word.WordScanner(ref, sp.packed_tables(ref))
    port_sc = scan_word.WordScanner(from_reference(ref), "cpu")
    return ref, jax_sc, port_sc


def _assert_equal(jax_sc, port_sc, data, lengths, G, seeded, tag=""):
    len_g = lengths.reshape(-1, G)
    a = jax_sc.match_stats_b(jnp.asarray(data), jnp.asarray(len_g), seeded=seeded)
    b = port_sc.match_stats_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=seeded)
    for name, x, y in zip(NAMES, a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=f"{tag} {name}")
    return b


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seeded", [True, False])
def test_match_stats_parity(pattern, seeded):
    ref, jax_sc, port_sc = _both(pattern)
    data, lengths = _batch(G=ref.G)
    _assert_equal(jax_sc, port_sc, data, lengths, ref.G, seeded, pattern)


@pytest.mark.parametrize("pattern", [
    "[^a]{1,3}|[ab]a{2}a?(a|bc)|0{2}(a|b)",
    ".[ab]x|q{2}[cd]y{2}z",
])
def test_zero_byte_class_no_bos_phantom(pattern):
    """Classes holding byte 0 ([^a], .) must not match the BOS step: the
    kernel's BOS step reads the BOS table row, never a byte."""
    ref, jax_sc, port_sc = _both(pattern)
    G = ref.G
    texts = [b"", b"a", b"ab", b".abx", b"qqcyyz", b"\x00ab", b"\x00\x00", b"b"]
    data = np.zeros((G, 8), np.uint8)
    lengths = np.zeros(G, np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    for seeded in (True, False):
        _assert_equal(jax_sc, port_sc, data, lengths, G, seeded, pattern)


def test_word_lead_not_ported():
    """Windowed (lead > 0) scans of a u32-word-tier program run on the
    matmul tier in both packages and agree."""
    ref, jax_sc, port_sc = _both("abcdefghij")
    data, lengths = _batch(G=ref.G)
    len_g = lengths.reshape(-1, ref.G)
    a = jax_sc.match_stats_b(jnp.asarray(data), jnp.asarray(len_g), seeded=True, lead=3)
    b = port_sc.match_stats_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=True, lead=3)
    for name, x, y in zip(NAMES, a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=name)
    assert int(b[0].sum()) > 0


@pytest.mark.parametrize("pattern", ["(cat|dog|bird)+", "a{10,20}", "x(yz|zy)*x$"])
def test_spec_to_table(pattern):
    """One step of the (delta, table) form equals one step of the spec's
    (delta, gate, mask) decomposition (scan_word._word_kernel's inner
    loop), for random 32-bit state sets and every symbol."""
    spec = scan_word.word_spec(from_reference(jax_compile(pattern)))
    deltas, tab, acc = scan_word.word_tables(spec)
    assert acc == spec.acc_masks[0]
    rng = np.random.default_rng(0)
    states = [0, 1, 0xFFFFFFFF, 1 << 31] + [int(x) for x in rng.integers(0, 1 << 32, 60)]
    for sym in range(scan_bits.N_SYMS):
        hit = []
        for runs, bos, eos in spec.gates:
            if sym < 256:
                hit.append(any(lo <= sym <= hi for lo, hi in runs))
            else:
                hit.append((bos and sym == scan_bits.SYM_BOS) or (eos and sym == scan_bits.SYM_EOS))
        for v in states:
            want = 0
            for d, ps in spec.dg:
                sh = (v << d if d >= 0 else v >> -d) & 0xFFFFFFFF
                for gid, mask in ps:
                    if hit[gid]:
                        want |= sh & mask
            got = 0
            for i, d in enumerate(deltas.tolist()):
                sh = (v << d if d >= 0 else v >> -d) & 0xFFFFFFFF
                got |= sh & int(tab[sym, i])
            assert got == want, (pattern, sym, v)
