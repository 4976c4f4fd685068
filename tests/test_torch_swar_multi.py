"""The slotted multi-pattern SWAR scan (``RRX_SWAR_MULTI=1``): the port's
``SwarMultiScanner`` (plain PyTorch versions, CPU) against the JAX
package's (Pallas interpret mode), the oracle
(``roaringregex_tpu/oracle/engine.py``) and single-pattern scans.

Routing of ``MultiPattern`` with the knob on and off, the slotted spec
against the JAX one, the slot tables against one SWAR scan per pattern
(no state crosses a byte lane), ``match_stats_b`` against the JAX scanner
seeded and unseeded, ``count_batch`` against the oracle with nullable and
`$` channels, and the windowed (``lead``) route to the matmul tier's
P-channel kernel. The JAX side keeps one scanner per set
(``functools.lru_cache``) with its config at a slab unroll of 2 steps
(``slab_r``, a layout knob: the outputs are the same). Every output is an
integer or a bool: every comparison is exact. The CUDA kernel
(``rrx_swar_multi_stats``) is held to the same plain version on the card
by ``chip_smoke.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.nfa import build_nfa as jax_build_nfa
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_swar as jax_swar
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu.utils import config as jax_config
from roaringregex_tpu_torch.compiler.program import from_reference
from roaringregex_tpu_torch.ops import scan_bits as sb
from roaringregex_tpu_torch.ops import scan_pallas
from roaringregex_tpu_torch.ops import scan_swar as ss
from roaringregex_tpu_torch.utils import config as cfg

torch.set_num_threads(1)

CONFIG6 = ["cat|dog", "[0-9]{3}", "err(or)?", "ab(cd)*e"]
# tests/test_multipattern.py's slotted sets (:110 is config 6, :131 a
# nullable and a `$` channel, :144 two of config 6's patterns), and four
# patterns of up to 8 states that share gates (a, b, c and [a-c]) at
# deltas -3..+3, for the slot-leak check
SETS = {
    "config6": CONFIG6,
    "nullable-eos": ["a*", "x$"],
    "catdog-abcde": ["cat|dog", "ab(cd)*e"],
    "shared-gates": ["abcabca", "(ab|c)+a", "a[a-c]{1,3}c", "^(ca)*b$"],
}
ALPHABET = b"catdoger0123 abcdex"


@pytest.fixture
def swar_multi():
    """Both packages' configs with the slotted scan on (and the JAX one at
    slab_r = 2), restored after the test."""
    base, jbase = cfg.get_config(), jax_config.get_config()
    cfg.set_config(base.with_(swar_multi=True))
    jax_config.set_config(jbase.with_(swar_multi=True, slab_r=2))
    yield
    cfg.set_config(base)
    jax_config.set_config(jbase)


def _batch(G: int, B: int = 32, L: int = 64):
    """[B, L] records over config 6's bytes (numpy seed 6) with plants of
    every set's matches (at byte 0 in every fourth record, where unseeded
    scans match), plus the edge records: empty, len == L, bytes >= 0x80 and
    byte 0; len_g [B / G, G]."""
    rng = np.random.default_rng(6)
    data = rng.choice(np.frombuffer(ALPHABET, np.uint8), size=(B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    plants = [b"cat", b"dog", b"4215", b"error", b"abcdcde", b"abe", b"aaax", b"abcabca",
              b"ababca", b"aabcc", b"cacab", b"x"]
    for i in range(8, B):
        w = plants[int(rng.integers(len(plants)))]
        at = 0 if i % 4 == 0 else int(rng.integers(0, L - len(w) + 1))  # byte 0: unseeded
        data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
    lengths[0], lengths[1:3] = 0, L
    data[3, :5] = np.frombuffer(b"c\x80at\xff", np.uint8)
    data[4, :4] = np.frombuffer(b"do\x00g", np.uint8)
    lengths[5], data[5, :4] = 4, np.frombuffer(b"cabx", np.uint8)
    lengths[6], data[6, :1] = 1, np.frombuffer(b"x", np.uint8)
    return data, lengths.reshape(-1, G)


@functools.lru_cache(maxsize=None)
def _jax_case(name: str):
    """The JAX MultiPattern's SwarMultiScanner of a set with its
    match_stats_b on the set's batch, seeded and unseeded (as numpy)."""
    jbase = jax_config.get_config()
    jax_config.set_config(jbase.with_(swar_multi=True, slab_r=2))
    try:
        ref = jax_rrx.MultiPattern(SETS[name], backend="pallas")
        sc = ref.engine.device_scanner
        data, len_g = _batch(max(ref.program.G, 1))
        stats = {seeded: tuple(np.asarray(x) for x in sc.match_stats_b(
            jnp.asarray(data), jnp.asarray(len_g), seeded=seeded)) for seeded in (True, False)}
        return ref, stats
    finally:
        jax_config.set_config(jbase)


@pytest.mark.parametrize("name", ["config6", "nullable-eos"])
def test_routing_identity_knob_on(name, swar_multi):
    ref = jax_rrx.MultiPattern(SETS[name], backend="pallas")
    port = rrx.MultiPattern(SETS[name], "cpu")
    assert type(ref.engine.device_scanner).__name__ == "SwarMultiScanner"
    assert type(port.engine.device_scanner) is ss.SwarMultiScanner
    assert port.engine.device_scanner.P == ref.P == len(SETS[name])


@pytest.mark.parametrize("name", ["config6", "nullable-eos"])
def test_routing_identity_knob_off(name):
    """The default (RRX_SWAR_MULTI unset): both engines take the u32-word
    tier."""
    assert not cfg.get_config().swar_multi and not jax_config.get_config().swar_multi
    ref = jax_rrx.MultiPattern(SETS[name], backend="pallas")
    port = rrx.MultiPattern(SETS[name], "cpu")
    assert type(ref.engine.device_scanner).__name__ == "WordScanner"
    assert type(port.engine.device_scanner).__name__ == "WordScanner"


@pytest.mark.parametrize("name", list(SETS))
def test_spec_matches_jax(name):
    subs = [jax_compile(jax_build_nfa(p)) for p in SETS[name]]
    want = jax_swar.swar_multi_spec(subs)
    got = ss.swar_multi_spec([from_reference(p) for p in subs])
    assert want is not None
    assert tuple(got) == tuple(want)


def test_spec_refuses_what_jax_refuses():
    for pats in (CONFIG6 + ["z"], ["abcdefghi", "a"], ["a", "x{2,9}"]):
        subs = [jax_compile(jax_build_nfa(p)) for p in pats]
        assert jax_swar.swar_multi_spec(subs) is None
        assert ss.swar_multi_spec([from_reference(p) for p in subs]) is None


@pytest.mark.parametrize("name", list(SETS))
@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
def test_slots_equal_single_pattern_scans(name, seeded):
    """The slotted tables leak nothing across byte lanes: each slot's
    statistics equal one SWAR scan of its own pattern (same seed rule, not
    nullable), and every slot's target bits lie in its own lane."""
    port = rrx.MultiPattern(SETS[name], "cpu")
    mspec = ss.swar_multi_spec(port.subprograms)
    P = len(SETS[name])
    deltas, tab, acc, accs = ss.swar_multi_tables(mspec, P)
    for i, d in enumerate(deltas.tolist()):
        for k in range(4):
            lane = (tab[:, i] >> np.uint32(8 * k)) & np.uint32(0xFF)
            # a delta-d target bit u of a lane has its source u - d in the lane
            bad = [u for u in range(8) if (lane >> np.uint32(u) & 1).any() and not 0 <= u - d < 8]
            assert not bad, (name, d, k, bad)
    tables = sb.device_tables(deltas, tab, acc, "cpu", accs=accs)
    data, len_g = _batch(1)
    d, ln = torch.from_numpy(data), torch.from_numpy(len_g.reshape(-1))
    got = ss.swar_multi_stats(d, ln, tables, seeded=seeded)
    assert all(tuple(x.shape) == (d.shape[0], P) for x in got)
    for p, sub in enumerate(port.subprograms):
        one = sb.device_tables(*ss.swar_tables(ss.swar_spec(sub)), "cpu")
        want = sb.stats_plain(d, ln, one, seeded=seeded, lead=0, nullable=False)
        for label, x, y in zip(("cnt", "first", "last", "full"), got, want, strict=True):
            np.testing.assert_array_equal(x[:, p].numpy(), y.numpy(),
                                          err_msg=f"{name} {SETS[name][p]!r} {label}")
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("name", ["config6", "nullable-eos"])
@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
def test_match_stats_b_matches_jax(name, seeded, swar_multi):
    ref, stats = _jax_case(name)
    port = rrx.MultiPattern(SETS[name], "cpu")
    sc = port.engine.device_scanner
    data, len_g = _batch(max(port.program.G, 1))
    got = sc.match_stats_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=seeded)
    shape = (len_g.shape[0], len_g.shape[1] * port.P)
    for label, x, y in zip(("cnt", "first", "last", "full", "any"), got, stats[seeded],
                           strict=True):
        assert tuple(x.shape) == shape == y.shape, label
        np.testing.assert_array_equal(x.numpy(), y, err_msg=f"{name} {label}")
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("name", list(SETS))
def test_count_batch_matches_oracle(name, swar_multi):
    """Per-pattern distinct match-end counts, nullable and `$` channels
    included (the nullable ones corrected on the host)."""
    pats = SETS[name]
    port = rrx.MultiPattern(pats, "cpu")
    assert type(port.engine.device_scanner) is ss.SwarMultiScanner
    data, len_g = _batch(1)
    texts = [bytes(row[:n]) for row, n in zip(data, len_g.reshape(-1))]
    texts += [b"", b"x", b"aaax", b"bxb", b"the cat had 4215 errors", b"abcdcde or err"]
    orcs = [OracleEngine(jax_build_nfa(p)) for p in pats]
    want = np.array([[len(o.ends(t)) for o in orcs] for t in texts])
    np.testing.assert_array_equal(port.count_batch(texts), want)
    np.testing.assert_array_equal(port.search_batch(texts), want > 0)


def test_lead_takes_the_matmul_channel_route(swar_multi, monkeypatch):
    """A windowed (lead > 0) scan goes to the matmul tier's P-channel
    statistics, as in the JAX scanner; lead 0 runs the slotted scan."""
    port = rrx.MultiPattern(CONFIG6, "cpu")
    sc = port.engine.device_scanner
    calls = []
    nfa_stats, slotted = scan_pallas.nfa_stats, ss.swar_multi_stats

    def spy(name, fn):
        def call(*a, **kw):
            calls.append((name, kw.get("lead", 0)))
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(scan_pallas, "nfa_stats", spy("nfa", nfa_stats))
    monkeypatch.setattr(ss, "swar_multi_stats", spy("slotted", slotted))
    data, len_g = _batch(max(port.program.G, 1))
    d, lg = torch.from_numpy(data), torch.from_numpy(len_g)
    windowed = sc.match_stats_b(d, lg, seeded=True, lead=3)
    assert calls == [("nfa", 3)]
    plain = sc.match_stats_b(d, lg, seeded=True)
    assert calls[1:] == [("slotted", 0)]
    assert tuple(windowed[0].shape) == tuple(plain[0].shape)
    # the lead only drops flags at steps <= 3: no count grows
    assert bool((windowed[0] <= plain[0]).all())


def test_single_channel_primitives_raise(swar_multi):
    port = rrx.MultiPattern(CONFIG6, "cpu")
    sc = port.engine.device_scanner
    data, len_g = _batch(max(port.program.G, 1))
    with pytest.raises(ValueError, match="accept"):
        sc.forward_flags_b(torch.from_numpy(data), torch.from_numpy(len_g), seeded=True)
    with pytest.raises(ValueError, match="accept"):
        sc.reverse_hits_b(torch.from_numpy(data), torch.from_numpy(len_g))
