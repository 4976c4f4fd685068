"""Forward flags, bit-packed flag and hit words, and position bitmaps on the
dense tiers, and the seeded-alias route: the port (plain PyTorch versions,
CPU) against the JAX package (Pallas interpret mode). The SWAR and
u32-word scanners inherit these methods from the matmul tier's
``PallasScanner`` in both packages. Every output is an integer or a bool,
so every comparison is exact. The CUDA kernel ``rrx_nfa_flags`` is held
to the same plain version on the card (chip_smoke.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.engine import ScanEngine as JaxEngine
from roaringregex_tpu.engine import seeded_alias_program as jax_alias_program
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu_torch.compiler.program import compile_program, from_reference
from roaringregex_tpu_torch.engine import ScanEngine, seeded_alias_program
from roaringregex_tpu_torch.ops import scan_bits, scan_xla
from test_torch_pallas import HTTP, K7, NAMES, _batch

torch.set_num_threads(1)

# (pattern, scanner): SWAR, u32-word, and matmul-tier programs of 64 and
# 256 states, one of them nullable
PATTERNS = [
    ("cat|dog", "SwarScanner"), ("(cat|dog|bird)+", "WordScanner"), (K7, "PallasScanner"),
    (HTTP, "PallasScanner"), (K7 + "*", "PallasScanner"), ("(a|bc){1,60}", "PallasScanner"),
]
IDS = [NAMES.get(p, p) for p, _ in PATTERNS]
L = 72  # 74 steps: three flag words, the last one partial
CONFIG13 = "(abc|de){1,300}"


@functools.lru_cache(maxsize=None)
def _case(pattern):
    """The JAX engine (its scanner's jitted calls cached on it) and the
    port's engine over the same program, and one shared batch."""
    ref = jax_compile(pattern)
    data, len_g = _batch(ref.G, seed=11, n=40, L=L)
    return JaxEngine(ref, backend="pallas"), ScanEngine(from_reference(ref), "cpu"), data, len_g


def _word_bits(words, T: int) -> np.ndarray:
    """[B, Wt] uint32 words (either package) -> [B, T] bool, bit t of word t // 32."""
    w = np.ascontiguousarray(np.asarray(words).astype(np.int64).astype(np.uint32))
    bits = np.unpackbits(w.view(np.uint8).reshape(w.shape[0], -1), axis=1, bitorder="little")
    return bits[:, :T].astype(bool)


@pytest.mark.parametrize("pattern,scanner", PATTERNS, ids=IDS)
def test_routing_and_flag_words_ok(pattern, scanner):
    jeng, peng, _, _ = _case(pattern)
    assert type(jeng.device_scanner).__name__ == type(peng.device_scanner).__name__ == scanner
    sc = peng.device_scanner
    assert sc.has_anchor and callable(sc.flags_words_b) and callable(sc.hits_words_b)


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
@pytest.mark.parametrize("pattern,scanner", PATTERNS, ids=IDS)
def test_forward_flags_parity(pattern, scanner, seeded):
    jeng, peng, data, len_g = _case(pattern)
    a = jeng.device_scanner.forward_flags_b(jnp.asarray(data), jnp.asarray(len_g), seeded=seeded)
    b = peng.device_scanner.forward_flags_b(torch.from_numpy(data), torch.from_numpy(len_g),
                                            seeded=seeded)
    assert b.shape == (data.shape[0], L + 3) and b.dtype == torch.bool
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("pattern,scanner", PATTERNS, ids=IDS)
def test_flags_words_parity(pattern, scanner):
    """The first T bits of the words equal the JAX words' (seeded, as
    ``ends_bitmap`` asks for them) and the unpacked forward flags; bits past
    T are 0."""
    jeng, peng, data, len_g = _case(pattern)
    got, T = peng.device_scanner.flags_words_b(torch.from_numpy(data), torch.from_numpy(len_g),
                                               seeded=True)
    assert T == L + 2 and got.shape == (data.shape[0], scan_bits.hit_words(L))
    want, T_ref = jeng.device_scanner.flags_words_b(jnp.asarray(data), jnp.asarray(len_g),
                                                    seeded=True)
    assert T_ref == T
    np.testing.assert_array_equal(_word_bits(got, T), _word_bits(want, T))
    flags = peng.device_scanner.forward_flags_b(torch.from_numpy(data), torch.from_numpy(len_g),
                                                seeded=True)
    np.testing.assert_array_equal(_word_bits(got, T), flags[:, 1:].numpy())
    assert not _word_bits(got, 32 * got.shape[1])[:, T:].any()


@pytest.mark.parametrize("pattern,scanner", PATTERNS, ids=IDS)
def test_hits_words_parity(pattern, scanner):
    jeng, peng, data, len_g = _case(pattern)
    got, T = peng.device_scanner.hits_words_b(torch.from_numpy(data), torch.from_numpy(len_g))
    want, T_ref = jeng.device_scanner.hits_words_b(jnp.asarray(data), jnp.asarray(len_g))
    assert T == T_ref == L + 2
    np.testing.assert_array_equal(_word_bits(got, T), _word_bits(want, T))
    hits = peng.device_scanner.reverse_hits_b(torch.from_numpy(data), torch.from_numpy(len_g))
    np.testing.assert_array_equal(_word_bits(got, T), hits.numpy())


@pytest.mark.parametrize("pattern,scanner", PATTERNS, ids=IDS)
def test_engine_bitmaps_parity(pattern, scanner):
    """Both bitmaps through the words path equal the JAX engine's and the
    port's ``scan_xla`` bitmaps over the unpacked flags and hits."""
    jeng, peng, data, len_g = _case(pattern)
    lengths = len_g.reshape(-1)
    nullable = peng.prog.nullable
    ln = torch.from_numpy(lengths)
    generic = {
        "ends_bitmap": scan_xla.ends_bitmap(peng.forward_flags(data, lengths, seeded=True), ln, L,
                                            nullable, seeded=True),
        "starts_bitmap": scan_xla.starts_bitmap(peng.reverse_hits(data, lengths), ln, L, nullable),
    }
    for name, gen in generic.items():
        got = getattr(peng, name)(data, lengths, L)
        np.testing.assert_array_equal(got, np.asarray(getattr(jeng, name)(data, lengths, L)),
                                      err_msg=name)
        np.testing.assert_array_equal(got, gen.numpy(), err_msg=f"{name} generic")


@pytest.mark.parametrize("pattern,scanner", PATTERNS, ids=IDS)
def test_pattern_ends_starts_match_jax(pattern, scanner):
    """ends_batch and starts_batch against the JAX Pattern's: its engine's
    bitmaps, read as ``Pattern.ends_batch`` reads them, of the same texts
    laid out in ``_case``'s batch shape, so that the interpret-mode words
    calls compile once per pattern (records are independent)."""
    jeng, _, data0, _ = _case(pattern)
    port = rrx.compile(pattern, "cpu")
    texts = [b"", b"cat", b"dogcatxbird", b"GET / HTTP/1.0", b"errorerror timeout",
             b"bcbcabc", b"xx" * 20 + b"cat", b"a" * 40]
    data = np.zeros_like(data0)
    lengths = np.zeros(data0.shape[0], np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    maxlen = max(map(len, texts))
    for name in ("ends_batch", "starts_batch"):
        bm = np.asarray(getattr(jeng, name.replace("_batch", "_bitmap"))(data, lengths, maxlen))
        want = [[int(p) for p in np.nonzero(bm[i])[0] if p <= lengths[i]]
                for i in range(len(texts))]
        assert getattr(port, name)(texts) == want, name


# -- the seeded alias (config 13's route) -----------------------------------


def test_alias_routing_gates():
    """tests/test_seeded_alias.py::test_alias_routing_gates on the port."""
    eng = rrx.compile(CONFIG13, "cpu").engine
    al = eng._seeded_alias()
    assert al is not None and al.prog.n_states == 6
    assert type(eng.device_scanner).__name__ == "SparseScanner"
    assert type(al.device_scanner).__name__ == "SwarScanner"
    ref = jax_alias_program(jax_compile(CONFIG13))
    assert (al.prog.n_states, al.prog.tier, al.prog.s_tile) == (ref.n_states, ref.tier, ref.s_tile)
    assert type(JaxEngine(jax_compile(CONFIG13), backend="pallas")._seeded_alias()
                .device_scanner).__name__ == "SwarScanner"
    for pattern in ("x(ab|c){400,520}y", "a{3,1200}", "(abc|de){2,}"):
        assert seeded_alias_program(compile_program(pattern)) is None, pattern
        assert jax_alias_program(jax_compile(pattern)) is None, pattern


@functools.lru_cache(maxsize=None)
def _alias_case():
    rng = np.random.default_rng(13)
    texts = [rng.choice(np.frombuffer(b"abcde", np.uint8), size=int(rng.integers(0, 120))).tobytes()
             for _ in range(9)] + [b"abcde" * 24, b"", b"abc", b"de" * 60]  # 13 records: B % G != 0
    port, ref = rrx.compile(CONFIG13, "cpu"), jax_rrx.compile(CONFIG13, backend="pallas")
    data, lengths, _, _ = port._pack(texts)
    data, lengths = data[:13], lengths[:13]
    starts = np.random.default_rng(2).integers(-1, 60, size=13).astype(np.int32)
    return port, ref, texts, data, lengths, starts


def test_alias_seeded_primitives_match_jax():
    port, ref, _, data, lengths, starts = _alias_case()
    pe, je = port.engine, ref.engine
    for x, y in zip(pe.match_stats(data, lengths, seeded=True),
                    je.match_stats(data, lengths, seeded=True)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    checks = {
        "forward_flags": (pe.forward_flags(data, lengths, seeded=True),
                          je.forward_flags(data, lengths, seeded=True)),
        "reverse_hits": (pe.reverse_hits(data, lengths), je.reverse_hits(data, lengths)),
        "first_end_from": (pe.first_end_from(data, lengths, starts),
                           je.first_end_from(data, lengths, starts)),
        "ends_bitmap": (pe.ends_bitmap(data, lengths, data.shape[1]),
                        je.ends_bitmap(data, lengths, data.shape[1])),
        "starts_bitmap": (pe.starts_bitmap(data, lengths, data.shape[1]),
                          je.starts_bitmap(data, lengths, data.shape[1])),
    }
    for name, (x, y) in checks.items():
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        assert x.shape[0] == 13, name
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)


def test_alias_pattern_entry_points_match_jax():
    port, ref, texts, _, _, _ = _alias_case()
    for name in ("search_batch", "count_batch"):
        np.testing.assert_array_equal(getattr(port, name)(texts), np.asarray(getattr(ref, name)(texts)))
    for name in ("ends_batch", "starts_batch"):
        assert getattr(port, name)(texts) == getattr(ref, name)(texts), name
    spans = ref.finditer_batch(texts)
    assert port.finditer_batch(texts) == spans
    # the JAX Pattern's match (the lazy anchored end from 0) and search (the
    # first lazy span) of the last four texts, from calls on the whole
    # batch (records are independent)
    data, lengths, _, _ = ref._pack(texts)
    ends = np.asarray(ref.engine.first_end_from(data, lengths, np.zeros(data.shape[0], np.int32)))
    for i in range(len(texts) - 4, len(texts)):
        t, e = texts[i], int(ends[i])
        a = port.match(t)
        assert (a is None) == (e < 0) and (a is None or a.span() == (0, e)), t
        a = port.search(t)
        assert (a is None) == (not spans[i]) and (a is None or a.span() == spans[i][0]), t


@functools.lru_cache(maxsize=None)
def _alias_oracle():
    """The oracle of config 13, the records of ``_alias_case`` and, per
    record, the ends of the matches that start at 0: the match ends of
    ``^`` + config 13 (one oracle pass a record; the pattern has no anchors
    of its own, so these are the prefixes that match whole)."""
    _, _, _, data, lengths, _ = _alias_case()
    orc = OracleEngine(jax_compile(CONFIG13).nfa)
    at0 = OracleEngine(jax_compile("^" + CONFIG13).nfa)
    recs = [bytes(data[i, : lengths[i]]) for i in range(len(lengths))]
    return orc, recs, [sorted(at0.ends(t)) for t in recs]


@pytest.mark.parametrize("call", [
    "match_stats", "forward_flags", "fullmatch_flags", "first_end_longest", "lazy_spans",
    "greedy_spans", "fullmatch_batch", "finditer_longest",
])
def test_alias_unseeded_calls_raise(call):
    """Every primitive that needs the original program runs on config 13's
    own container tier and answers as the oracle does; the engine-level
    span primitives raise as the JAX container scanner has no span kernels
    (``Pattern`` takes host rounds over the starts bitmap for it)."""
    port, _, texts, data, lengths, starts = _alias_case()
    eng = port.engine
    orc, recs, prefix = _alias_oracle()
    if call == "match_stats":
        cnt, first, anym = eng.match_stats(data, lengths, seeded=False)
        assert cnt.tolist() == [len(p) for p in prefix]
        assert first.tolist() == [p[0] if p else -1 for p in prefix]
        assert anym.tolist() == [bool(p) for p in prefix] and any(prefix)
    elif call == "forward_flags":
        fl = eng.forward_flags(data, lengths, seeded=False).numpy()
        want = np.zeros_like(fl)
        for i, p in enumerate(prefix):
            want[i, [e + 1 for e in p]] = True  # column t + 1 = step t ends at t
        np.testing.assert_array_equal(fl, want)
    elif call == "fullmatch_flags":
        assert eng.fullmatch_flags(data, lengths).tolist() == [orc.fullmatch(t) for t in recs]
    elif call == "first_end_longest":
        got = eng.first_end_from(data, lengths, starts, longest=True).tolist()
        ends = [None if s < 0 or s > len(t) else orc.last_end_from(t, s)
                for t, s in zip(recs, starts.tolist())]
        assert got == [-1 if e is None else e for e in ends] and max(got) > 0
    elif call in ("lazy_spans", "greedy_spans"):
        fn = eng.lazy_spans if call == "lazy_spans" else eng.greedy_spans
        with pytest.raises(NotImplementedError, match="SparseScanner has no span kernels"):
            fn(data, lengths, cap=4)
    elif call == "fullmatch_batch":
        full = port.fullmatch_batch(texts).tolist()
        assert full == [orc.fullmatch(t) for t in texts] and any(full)
    else:
        got = port.finditer_batch(texts, longest=True)
        assert got == [list(orc.finditer(t, longest=True)) for t in texts]
