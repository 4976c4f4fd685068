"""The port's SWAR tier (plain PyTorch version, CPU) against the JAX
SwarScanner (Pallas interpret mode) at the scanner boundary: every
match_stats_b output must be equal, seeded and unseeded. The CUDA kernel
itself is held to the same plain version on the card (chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_packed as sp
from roaringregex_tpu.ops import scan_swar as jax_swar
from roaringregex_tpu_torch.compiler.program import from_reference
from roaringregex_tpu_torch.ops import scan_bits, scan_swar
from roaringregex_tpu_torch.utils.config import get_config, set_config
from test_swar import PATTERNS, _batch

torch.set_num_threads(1)

NAMES = ["cnt", "first", "last", "full", "any"]


def _both(pattern):
    ref = jax_compile(pattern)
    jax_sc = jax_swar.SwarScanner(ref, sp.packed_tables(ref))
    port_sc = scan_swar.SwarScanner(from_reference(ref), "cpu")
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
    data, lengths = _batch(seed=3, G=ref.G)
    _assert_equal(jax_sc, port_sc, data, lengths, ref.G, seeded, pattern)


def test_windowed_parity():
    """The tall-narrow batch of tests/test_swar.py: the port takes the
    same window route and gives the JAX scanner's results."""
    ref, jax_sc, port_sc = _both("cat|dog")
    G = ref.G
    rng = np.random.default_rng(7)
    B, L = 2 * G, 1024
    data = rng.choice(np.frombuffer(b"abcdogt.ca", np.uint8), size=(B, L)).astype(np.uint8)
    data[0, 100:103] = np.frombuffer(b"cat", np.uint8)
    data[1, 510:513] = np.frombuffer(b"dog", np.uint8)
    data[2, 253:256] = np.frombuffer(b"cat", np.uint8)  # window boundary
    lengths = np.full(B, L, np.int32)
    lengths[3] = 0
    lengths[4] = 257
    win = port_sc._swar_window(L, B, True)
    assert win is not None and win == jax_sc._swar_window(L, B, True)
    b = _assert_equal(jax_sc, port_sc, data, lengths, G, True, "windowed")
    # window knob off -> the unwindowed scan, same results
    old = get_config()
    try:
        set_config(old.with_(swar_window_cols=0))
        assert port_sc._swar_window(L, B, True) is None
        c = port_sc.match_stats_b(
            torch.from_numpy(data), torch.from_numpy(lengths.reshape(-1, G)), seeded=True
        )
        for name, x, y in zip(NAMES, b, c):
            assert torch.equal(x, y), name
    finally:
        set_config(old)


def test_config1_window_route():
    """Bench config 1 (10 MB of 1024-byte records) takes the (4, 256, 3)
    window split on both packages."""
    _, jax_sc, port_sc = _both("cat|dog")
    B = 10_000_000 // 1024
    assert port_sc._swar_window(1024, B, True) == (4, 256, 3)
    assert jax_sc._swar_window(1024, B, True) == (4, 256, 3)


def test_full_length_records_keep_eos():
    # len == L: the EOS step is the final stream step
    ref, jax_sc, port_sc = _both("ab$")
    G = ref.G
    data = np.tile(np.frombuffer(b"zzzzzzab", np.uint8), (2 * G, 1))
    lengths = np.full(2 * G, 8, np.int32)
    b = _assert_equal(jax_sc, port_sc, data, lengths, G, True, "ab$")
    assert b[4].all()


def test_high_bytes_are_dead():
    ref, jax_sc, port_sc = _both("a.b")  # '.' covers 0..0x7F only
    G = ref.G
    data = np.zeros((G, 8), np.uint8)
    lengths = np.zeros(G, np.int32)
    for i, t in enumerate([b"a\xfeb", b"a\xffb", b"a\x80b", b"axb", b"a\x00b"]):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    b = _assert_equal(jax_sc, port_sc, data, lengths, G, True, "a.b")
    assert b[4].reshape(-1)[:5].tolist() == [False, False, False, True, True]


@pytest.mark.parametrize("pattern", ["cat|dog", "^ab?c$", "(a|$)*", "[^a-c]"])
def test_spec_to_table(pattern):
    """The host-side conversion of a SwarSpec into the kernel's (delta,
    table) form: one step of the table equals one step of the spec's
    diagonal decomposition (scan_swar._swar_kernel's inner loop) for every
    state set and symbol."""
    spec = scan_swar.swar_spec(from_reference(jax_compile(pattern)))
    deltas, tab, acc = scan_swar.swar_tables(spec)
    assert acc == sum(1 << s for s in spec.accept_bits)
    assert not tab[0x80:256].any()
    for sym in range(scan_bits.N_SYMS):
        runs_hit = []
        for runs, bos, eos in spec.gates:
            if sym < 256:
                runs_hit.append(any(lo <= sym <= hi for lo, hi in runs) and sym < 0x80)
            else:
                runs_hit.append((bos and sym == scan_bits.SYM_BOS) or (eos and sym == scan_bits.SYM_EOS))
        for v in range(256):
            want = 0
            for d, pis in spec.diags:
                gm = 0
                for pi in pis:
                    gid, u = spec.gpos[pi]
                    if runs_hit[gid]:
                        gm |= 1 << u
                sh = v << d if d >= 0 else v >> -d
                want |= sh & gm
            got = 0
            for i, d in enumerate(deltas.tolist()):
                sh = v << d if d >= 0 else v >> -d
                got |= sh & int(tab[sym, i])
            assert got == want, (pattern, sym, v)
