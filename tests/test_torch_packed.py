"""The packed backend: the port's mask stream and its four primitives
(``ops/scan_packed.py``, plain PyTorch versions on the CPU) against the
JAX package's ``scan_packed`` (XLA on the CPU), the stream-fed methods of
``PallasScanner`` against the JAX ``PallasScanner``'s (Pallas interpret
mode), and the counting tier's anchored rescans, which take
``scan_packed.first_end_from`` in both packages.

The JAX packs G records of ``s_tile`` lanes into one row; the port keeps
one record a row, so the outputs are compared per record (and per accept
channel), and the streams themselves wherever G = 1 (one record a row in
both). Programs: ``cat|dog`` (dense128, s_tile 8, G = 16), the nullable
``a?(cat|dog)*`` (G = 16), ``a{1,200}`` (dense256, G = 1) and config 4's
``a{1,300}`` (multiblock, s_tile 384, W = 12), seeded and unseeded, lazy
and ``longest``, and a ``MultiPattern`` of three patterns on the packed
backend (P = 3 accept channels). Interpret mode compiles each JAX kernel
for seconds, so its case is one program and one batch, cached. Every
output is an integer or a bool: every comparison is exact. The CUDA
kernels (``rrx_stream_*``) are held to the same plain versions on the card
by ``chip_smoke.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_packed as jax_sp
from roaringregex_tpu.ops import scan_pallas as jax_spl
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu.utils.config import get_config as jax_get_config
from roaringregex_tpu.utils.config import set_config as jax_set_config
from roaringregex_tpu_torch.compiler.program import compile_program
from roaringregex_tpu_torch.ops import scan_packed as sp
from roaringregex_tpu_torch.ops import scan_pallas as spl

torch.set_num_threads(1)

PATTERNS = ["cat|dog", "a?(cat|dog)*", "a{1,200}", "a{1,300}"]
ALPHABET = b"acdgotx"
PLANTS = [b"cat", b"dog", b"aaaaa", b"catdog", b"a" * 20]


def _batch(seed: int, B: int = 32, L: int = 40):
    """[B, L] uint8 records with plants, lengths 0..L, and rescan starts."""
    rng = np.random.default_rng(seed)
    data = rng.choice(np.frombuffer(ALPHABET, np.uint8), size=(B, L)).astype(np.uint8)
    for i in range(0, B, 2):
        w = PLANTS[i % len(PLANTS)]
        at = int(rng.integers(0, L - len(w)))
        data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:2] = L
    starts = rng.integers(-1, L, size=B).astype(np.int32)
    return data, lengths, starts


@functools.lru_cache(maxsize=None)
def _jax_case(pattern: str):
    """The JAX package's mask stream and scan_packed primitives on one batch
    (per record: [B_rows, G] outputs flattened), as numpy."""
    prog = jax_compile(pattern)
    data, lengths, starts = _batch(len(pattern))
    tab = jax_sp.packed_tables(prog)
    len_g = jnp.asarray(lengths).reshape(-1, prog.G)
    words = jax_sp.mask_stream_from_bytes(tab, jnp.asarray(data), len_g, s_tile=prog.s_tile,
                                          G=prog.G, n_runs=len(prog.byte_runs[0]))
    out = {"words": words, "hits": jax_sp.reverse_hits(tab, words, lanes=prog.lanes)}
    for seeded in (True, False):
        out[f"stats{seeded}"] = jax_sp.match_stats(tab, words, len_g, seeded=seeded,
                                                   nullable=prog.nullable, lanes=prog.lanes)
        out[f"flags{seeded}"] = jax_sp.forward_flags(tab, words, seeded=seeded, lanes=prog.lanes)
    for longest in (False, True):
        out[f"first{longest}"] = jax_sp.first_end_from(
            tab, words, len_g, jnp.asarray(starts).reshape(-1, prog.G), lanes=prog.lanes,
            s_tile=prog.s_tile, longest=longest)
    res = {}
    for k, v in out.items():
        if k.startswith("stats"):
            res[k] = tuple(np.asarray(x).reshape(-1) for x in v)
        elif k.startswith("first"):
            res[k] = np.asarray(v).reshape(-1)
        else:
            res[k] = np.asarray(v)
    return res


def _port(pattern: str):
    prog = compile_program(pattern)
    data, lengths, starts = _batch(len(pattern))
    tabs = sp.packed_tables(prog, "cpu")
    ln = torch.from_numpy(lengths)
    words = sp.mask_stream_from_bytes(tabs, torch.from_numpy(data), ln)
    return prog, tabs, words, ln, torch.from_numpy(starts)


def _eq(got, want, what):
    if isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            _eq(g, w, what)
        return
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(g.astype(np.int64), np.asarray(want).astype(np.int64),
                                  err_msg=what)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_mask_stream(pattern):
    """The stream equals its plain helpers' (range-compare classes, then
    their mask words) and, for a program of one record a row (G = 1), the
    JAX package's stream word for word."""
    prog, tabs, words, ln, _ = _port(pattern)
    data, lengths, _ = _batch(len(pattern))
    cls = sp.encode_classes_fast(tabs, torch.from_numpy(data), ln, bos_class=prog.bos_class,
                                 eos_class=prog.eos_class)
    assert torch.equal(words, sp.pack_mask_stream(tabs, cls))
    assert words.shape == (data.shape[1] + 2, data.shape[0], max(1, prog.s_tile // 32))
    if prog.G == 1:
        want = _jax_case(pattern)["words"]
        np.testing.assert_array_equal(words.numpy().view(np.uint32), want.astype(np.uint32))
    bits = sp.unpack_bits(words, prog.s_tile)
    assert bits.shape == (*words.shape[:2], prog.s_tile)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seeded", [True, False])
def test_match_stats_and_flags_vs_jax(pattern, seeded):
    want = _jax_case(pattern)
    prog, tabs, words, ln, _ = _port(pattern)
    nfa = tabs["nfa"]
    _eq(sp.match_stats(nfa, words, ln, seeded=seeded, nullable=prog.nullable),
        want[f"stats{seeded}"], f"match_stats seeded={seeded}")
    _eq(sp.forward_flags(nfa, words, seeded=seeded), want[f"flags{seeded}"],
        f"forward_flags seeded={seeded}")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_reverse_and_first_end_vs_jax(pattern):
    want = _jax_case(pattern)
    prog, tabs, words, ln, starts = _port(pattern)
    nfa = tabs["nfa"]
    _eq(sp.reverse_hits(nfa, words), want["hits"], "reverse_hits")
    for longest in (False, True):
        _eq(sp.first_end_from(nfa, words, ln, starts, longest=longest), want[f"first{longest}"],
            f"first_end_from longest={longest}")


MULTI = ["cat", "dog", "a{2,5}"]


@functools.lru_cache(maxsize=None)
def _jax_multi():
    data, lengths, _ = _batch(3)
    jmp = jax_rrx.MultiPattern(MULTI, backend="packed")
    assert jmp.engine.packed and jmp.engine.device_scanner is None
    return {seeded: tuple(np.asarray(x) for x in jmp.engine.match_stats(data, lengths,
                                                                         seeded=seeded))
            for seeded in (True, False)}


def test_multipattern_packed_channels_vs_jax():
    """MultiPattern on the packed backend: one pass over the mask stream
    gives per-channel statistics (P = 3) equal to the JAX engine's; counts
    and spans through the API equal the oracle's."""
    mp = rrx.MultiPattern(MULTI, "cpu", backend="packed")
    assert mp.engine.backend == "packed" and mp.engine.device_scanner is None
    assert mp._singles is None
    data, lengths, _ = _batch(3)
    for seeded, want in _jax_multi().items():
        _eq(mp.engine.match_stats(data, lengths, seeded=seeded), want, f"seeded={seeded}")
    texts = [bytes(data[i, : lengths[i]]) for i in range(8)]
    orcs = [OracleEngine.compile(q) for q in MULTI]
    np.testing.assert_array_equal(mp.count_batch(texts),
                                  [[len(o.ends(t)) for o in orcs] for t in texts])
    assert mp.finditer_batch(texts) == [[o.findall(t) for t in texts] for o in orcs]


@functools.lru_cache(maxsize=None)
def _jax_scanner_case():
    """The JAX PallasScanner's stream-fed methods (Pallas interpret mode) on
    cat|dog (G = 16), one batch."""
    prog = jax_compile("cat|dog")
    data, lengths, starts = _batch(1)
    tab = jax_sp.packed_tables(prog)
    len_g = jnp.asarray(lengths).reshape(-1, prog.G)
    words = jax_sp.mask_stream_from_bytes(tab, jnp.asarray(data), len_g, s_tile=prog.s_tile,
                                          G=prog.G, n_runs=len(prog.byte_runs[0]))
    sc = jax_spl.PallasScanner(prog, tab)
    cnt, first, anym = sc.match_stats(words, len_g, seeded=True)
    return {
        "stats": tuple(np.asarray(x).reshape(-1) for x in (cnt, first, anym)),
        "flags": np.asarray(sc.forward_flags(words, seeded=False)),
        "hits": np.asarray(sc.reverse_hits(words)),
        "first": np.asarray(sc.first_end_from(words, len_g, jnp.asarray(starts).reshape(-1, prog.G),
                                              layout="packed")).reshape(-1),
    }


def test_stream_fed_scanner_methods_vs_jax():
    """PallasScanner.match_stats, forward_flags, reverse_hits and
    first_end_from over the port's mask stream equal the JAX scanner's over
    its own (rows 7-10)."""
    want = _jax_scanner_case()
    prog, _, words, ln, starts = _port("cat|dog")
    data, lengths, _ = _batch(1)
    ln = torch.from_numpy(lengths)
    words = sp.mask_stream_from_bytes(sp.stream_tables(prog, "cpu"), torch.from_numpy(data), ln)
    sc = spl.PallasScanner(prog, "cpu")
    len_g = ln.reshape(-1, prog.G)
    stats = sc.match_stats(words, len_g, seeded=True)
    assert all(x.shape == len_g.shape for x in stats)
    _eq(tuple(x.reshape(-1) for x in stats), want["stats"], "match_stats")
    _eq(sc.forward_flags(words, seeded=False), want["flags"], "forward_flags")
    _eq(sc.reverse_hits(words), want["hits"], "reverse_hits")
    st = torch.from_numpy(_batch(1)[2]).reshape(-1, prog.G)
    _eq(sc.first_end_from(words, len_g, st).reshape(-1), want["first"], "first_end_from")


def _config4_texts():
    rng = np.random.default_rng(4)
    out = [b"", b"a", b"aaaa", b"xaaay", b"a" * 33 + b"b" + b"a" * 5]
    for _ in range(5):
        t = bytearray(rng.choice(np.frombuffer(b"abx", np.uint8), size=int(rng.integers(0, 40))))
        out.append(bytes(t))
    return out


@functools.lru_cache(maxsize=None)
def _jax_config4_spans():
    base = jax_get_config()
    jax_set_config(base.with_(slab_r=2))
    try:
        p = jax_rrx.Pattern("a{1,300}", backend="pallas")
        assert type(p.engine.device_scanner).__name__ == "CountScanner"
        return {lg: p.finditer_batch(_config4_texts(), longest=lg) for lg in (False, True)}
    finally:
        jax_set_config(base)


def test_config4_spans_take_the_packed_rescan(monkeypatch):
    """Config 4 (a{1,300}, the counting tier: no anchored kernels) takes its
    spans in host rounds whose anchored rescans run scan_packed's
    first_end_from, as in the JAX engine; the spans equal the JAX
    package's (lazy and greedy) and the oracle's."""
    calls = []
    orig = sp.first_end_from

    def spy(*a, **kw):
        calls.append(kw.get("longest"))
        return orig(*a, **kw)

    monkeypatch.setattr(sp, "first_end_from", spy)
    p = rrx.compile("a{1,300}", "cpu")
    assert type(p.engine.device_scanner).__name__ == "CountScanner" and p.engine.packed
    texts = _config4_texts()
    orc = OracleEngine.compile("a{1,300}")
    for longest, want in _jax_config4_spans().items():
        got = p.finditer_batch(texts, longest=longest)
        assert got == want == [orc.findall(t, longest=longest) for t in texts], longest
    assert set(calls) == {False, True}
