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
    port, ref = rrx.compile(pattern, "cpu"), jax_rrx.compile(pattern, backend="pallas")
    texts = [b"", b"cat", b"dogcatxbird", b"GET / HTTP/1.0", b"errorerror timeout",
             b"bcbcabc", b"xx" * 20 + b"cat", b"a" * 40]
    for name in ("ends_batch", "starts_batch"):
        assert getattr(port, name)(texts) == getattr(ref, name)(texts), name


# -- the seeded alias (config 13's route) -----------------------------------


def test_alias_routing_gates():
    """tests/test_seeded_alias.py::test_alias_routing_gates on the port."""
    eng = rrx.compile(CONFIG13, "cpu").engine
    al = eng._seeded_alias()
    assert al is not None and al.prog.n_states == 6 and eng.device_scanner is None
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
    assert port.finditer_batch(texts) == ref.finditer_batch(texts)
    for t in texts[-4:]:
        a, b = port.match(t), ref.match(t)
        assert (a is None) == (b is None) and (a is None or a.span() == b.span()), t
        a, b = port.search(t), ref.search(t)
        assert (a is None) == (b is None) and (a is None or a.span() == b.span()), t


@pytest.mark.parametrize("call", [
    "match_stats", "forward_flags", "fullmatch_flags", "first_end_longest", "lazy_spans",
    "greedy_spans", "fullmatch_batch", "finditer_longest",
])
def test_alias_unseeded_calls_raise(call):
    """Every primitive that needs the original program (its bitband or
    container tier is not ported) raises, naming the tier."""
    port, _, texts, data, lengths, starts = _alias_case()
    eng = port.engine
    calls = {
        "match_stats": lambda: eng.match_stats(data, lengths, seeded=False),
        "forward_flags": lambda: eng.forward_flags(data, lengths, seeded=False),
        "fullmatch_flags": lambda: eng.fullmatch_flags(data, lengths),
        "first_end_longest": lambda: eng.first_end_from(data, lengths, starts, longest=True),
        "lazy_spans": lambda: eng.lazy_spans(data, lengths, cap=4),
        "greedy_spans": lambda: eng.greedy_spans(data, lengths, cap=4),
        "fullmatch_batch": lambda: port.fullmatch_batch(texts),
        "finditer_longest": lambda: port.finditer_batch(texts, longest=True),
    }
    with pytest.raises(NotImplementedError, match="sparse, 1501 states.*ROADMAP"):
        calls[call]()
