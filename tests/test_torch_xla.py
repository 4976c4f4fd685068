"""The XLA backend: the port's ``ops/scan_xla.py`` and ``ScanEngine(...,
backend="xla")`` against the JAX package's (XLA on the CPU), and the
container programs past the container kernels' caps (fault C3 of
ROADMAP.md), which both engines send to this backend with a warning.

The JAX side compiles each primitive once per shape, so one batch per
program is cached (``functools.lru_cache``): ``cat|dog``, ``a{2,40}``,
``(ab){1,100}`` and the two C3 programs, ``(abc|de){1,420}`` and
``x(abc|de){1,420}y`` (153 partial blocks, 2,176 lanes, over the
container kernels' 120). The C3 programs' API answers are held to the
oracle. Every output is an integer, a bool or a span: every comparison is
exact. The backend runs torch ops only, on the card as here, so
``chip_smoke.py`` times it and holds it to ``re``."""
import functools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.engine import ScanEngine as JaxEngine
from roaringregex_tpu.ops import scan_xla as jax_sx
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu_torch.compiler.program import compile_program
from roaringregex_tpu_torch.engine import ScanEngine
from roaringregex_tpu_torch.ops import scan_xla as sx

torch.set_num_threads(1)

C3 = ["(abc|de){1,420}", "x(abc|de){1,420}y"]
PATTERNS = ["cat|dog", "a{2,40}", "(ab){1,100}"] + C3
ALPHABET = b"abcdegotxy"
PLANTS = [b"cat", b"dog", b"aaaaa", b"ababab", b"abcdeabc", b"xabcdedey", b"xdey"]


def _batch(seed: int, B: int = 8, L: int = 32):
    """[B, L] uint8 records over ALPHABET with plants, lengths 0..L."""
    rng = np.random.default_rng(seed)
    data = rng.choice(np.frombuffer(ALPHABET, np.uint8), size=(B, L)).astype(np.uint8)
    for i in range(B):
        w = PLANTS[i % len(PLANTS)]
        at = int(rng.integers(0, L - len(w)))
        data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:2] = L
    starts = rng.integers(-1, L, size=B).astype(np.int32)
    return data, lengths, starts


def _texts(seed: int, n: int = 10):
    data, lengths, _ = _batch(seed, B=n)
    return [bytes(data[i, : lengths[i]]) for i in range(n)] + [b"", b"abcde", b"xabcdey"]


@functools.lru_cache(maxsize=None)
def _jax_case(pattern: str):
    """The JAX package's XLA functions and XLA-backend engine primitives on
    one batch, as numpy."""
    prog = jax_compile(pattern)
    data, lengths, starts = _batch(len(pattern))
    tab = jax_sx.device_tables(prog)
    cls = jax_sx.encode_stream(tab, jnp.asarray(data), jnp.asarray(lengths), prog.bos_class,
                               prog.eos_class, prog.dead_class)
    out = {"reverse_hits": jax_sx.reverse_hits(tab, cls)}
    for seeded in (True, False):
        out[f"flags{seeded}"] = jax_sx.forward_flags(tab, cls, seeded=seeded)
        out[f"stats{seeded}"] = jax_sx.match_stats(tab, cls, jnp.asarray(lengths), seeded=seeded,
                                                   nullable=prog.nullable)
    eng = JaxEngine(prog, backend="xla")
    for seeded in (True, False):
        out[f"eng_stats{seeded}"] = eng.match_stats(data, lengths, seeded=seeded)
    for longest in (False, True):
        out[f"eng_first{longest}"] = eng.first_end_from(data, lengths, starts, longest=longest)
    out["eng_flags"] = eng.forward_flags(data, lengths, seeded=True)
    out["eng_hits"] = eng.reverse_hits(data, lengths)
    out["eng_ends"] = eng.ends_bitmap(data, lengths, data.shape[1])
    out["eng_starts"] = eng.starts_bitmap(data, lengths, data.shape[1])
    out["eng_full"] = eng.fullmatch_flags(data, lengths)
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in out.items()}


def _eq(got, want, what):
    if isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            _eq(g, w, what)
        return
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(g.astype(np.int64), want.astype(np.int64), err_msg=what)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_scan_xla_functions_vs_jax(pattern):
    """scan_xla.match_stats, forward_flags and reverse_hits (seeded and
    unseeded) equal the JAX functions on one batch."""
    want = _jax_case(pattern)
    prog = compile_program(pattern)
    data, lengths, _ = _batch(len(pattern))
    tab = sx.device_tables(prog, "cpu")
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
    cls = sx.encode_stream(tab, d, ln, prog.bos_class, prog.eos_class)
    _eq(sx.reverse_hits(tab, cls), want["reverse_hits"], "reverse_hits")
    for seeded in (True, False):
        _eq(sx.forward_flags(tab, cls, seeded=seeded), want[f"flags{seeded}"], "flags")
        _eq(sx.match_stats(tab, cls, ln, seeded=seeded, nullable=prog.nullable),
            want[f"stats{seeded}"], f"match_stats seeded={seeded}")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_engine_xla_primitives_vs_jax(pattern):
    """ScanEngine(..., backend="xla"): match stats, anchored rescans (lazy
    and longest), flags, hits, both bitmaps and fullmatch equal the JAX
    engine's on its XLA backend."""
    want = _jax_case(pattern)
    eng = ScanEngine(compile_program(pattern), "cpu", backend="xla")
    assert eng.backend == "xla" and eng.device_scanner is None and not eng.packed
    data, lengths, starts = _batch(len(pattern))
    for seeded in (True, False):
        _eq(eng.match_stats(data, lengths, seeded=seeded), want[f"eng_stats{seeded}"],
            f"match_stats seeded={seeded}")
    for longest in (False, True):
        _eq(eng.first_end_from(data, lengths, starts, longest=longest),
            want[f"eng_first{longest}"], f"first_end_from longest={longest}")
    _eq(eng.forward_flags(data, lengths, seeded=True), want["eng_flags"], "forward_flags")
    _eq(eng.reverse_hits(data, lengths), want["eng_hits"], "reverse_hits")
    _eq(eng.ends_bitmap(data, lengths, data.shape[1]), want["eng_ends"], "ends_bitmap")
    _eq(eng.starts_bitmap(data, lengths, data.shape[1]), want["eng_starts"], "starts_bitmap")
    _eq(eng.fullmatch_flags(data, lengths), want["eng_full"], "fullmatch_flags")


@pytest.mark.parametrize("pattern", C3)
def test_c3_routes_to_xla_with_the_warning(pattern, caplog):
    """A container program past the caps compiles in both packages, with the
    JAX engine's warning, onto the XLA backend with no device scanner."""
    with caplog.at_level(logging.WARNING):
        p = rrx.compile(pattern, "cpu")
        jeng = JaxEngine(jax_compile(pattern), backend="pallas")
    msgs = [r.getMessage() for r in caplog.records if "falling back to the XLA backend" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1], msgs
    assert "153 partial blocks, 2176 lanes" in msgs[0]
    for eng in (p.engine, jeng):
        assert eng.backend == "xla" and eng.device_scanner is None


@pytest.mark.parametrize("pattern", C3)
def test_c3_api_vs_oracle(pattern):
    """count_batch, fullmatch_batch and finditer_batch (lazy and greedy) of
    the C3 programs against the oracle."""
    p = rrx.compile(pattern, "cpu")
    orc = OracleEngine.compile(pattern)
    texts = _texts(7)
    assert p.count_batch(texts).tolist() == [len(orc.ends(t)) for t in texts]
    assert p.fullmatch_batch(texts).tolist() == [orc.fullmatch(t) for t in texts]
    for longest in (False, True):
        assert p.finditer_batch(texts, longest=longest) == [
            orc.findall(t, longest=longest) for t in texts], longest


@pytest.mark.parametrize("backend", ["xla", "packed"])
def test_c3_backend_requests_stay_xla(backend):
    """A sparse program asked for the packed backend runs on XLA, as in the
    JAX engine; an explicit "xla" request stays there without a warning."""
    for pattern in C3:
        eng = ScanEngine(compile_program(pattern), "cpu", backend=backend)
        jeng = JaxEngine(jax_compile(pattern), backend=backend)
        assert eng.backend == jeng.backend == "xla"


def test_rrx_backend_env(monkeypatch):
    """RRX_BACKEND picks the backend when the caller names none; an unknown
    name raises."""
    from roaringregex_tpu_torch.utils import config as cfg

    base = cfg.get_config()
    try:
        monkeypatch.setenv("RRX_BACKEND", "xla")
        cfg.set_config(cfg.RrxConfig())
        assert rrx.compile("cat|dog", "cpu").engine.backend == "xla"
        assert rrx.compile("cat|dog", "cpu", backend="packed").engine.backend == "packed"
        monkeypatch.delenv("RRX_BACKEND")
        cfg.set_config(cfg.RrxConfig())
        assert rrx.compile("cat|dog", "cpu").engine.backend == "pallas"
        with pytest.raises(ValueError, match="backend"):
            rrx.compile("cat|dog", "cpu", backend="tpu")
    finally:
        cfg.set_config(base)


def test_multipattern_xla_falls_back_to_singles():
    """MultiPattern on the XLA backend scans its patterns one by one, as the
    JAX one does; counts and spans equal the oracle's."""
    pats = ["cat", "dog", "a{2,5}", "x*"]
    mp = rrx.MultiPattern(pats, "cpu", backend="xla")
    jmp = jax_rrx.MultiPattern(pats, backend="xla")
    assert (mp._singles is not None) and (jmp._singles is not None)
    assert all(s.engine.backend == "xla" for s in mp._singles)
    texts = _texts(3)
    orcs = [OracleEngine.compile(q) for q in pats]
    want = np.array([[len(o.ends(t)) for o in orcs] for t in texts])
    np.testing.assert_array_equal(mp.count_batch(texts), want)
    np.testing.assert_array_equal(mp.search_batch(texts), want > 0)
    assert mp.finditer_batch(texts) == [[o.findall(t) for t in texts] for o in orcs]
