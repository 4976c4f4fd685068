"""The port's counting tier (``CountScanner``, plain PyTorch versions, CPU)
against the JAX package's (Pallas interpret mode): routing, match
statistics (seeded, unseeded, ``lead``), forward flags and reverse hits at
the scanner boundary; the engine's bitmaps and anchored rescans
(``scan_xla.first_end_from``, held to both JAX routes); and the
``Pattern`` entry points, spans in host rounds included. Every output is
an integer or a bool, so every comparison is exact. The CUDA kernels are
held to the same plain versions on the card (chip_smoke.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.engine import ScanEngine as JaxEngine
from roaringregex_tpu.ops import scan_xla as jax_xla
from roaringregex_tpu_torch.compiler.program import from_reference
from roaringregex_tpu_torch.engine import ScanEngine
from roaringregex_tpu_torch.ops import scan_bits, scan_pallas, scan_xla
from test_counting import COUNTING, STRIDE_K

torch.set_num_threads(1)

PATTERNS = COUNTING + STRIDE_K
L_MAX = 320
# Pattern-level cases: programs of at most ~300 states, so that the host
# rounds' anchored rescans (a dense 0/1 product per step) stay cheap here
API_PATTERNS = ["a{1,300}", "x{0,300}", "a{300}", "(ab){2,80}", "(ab){0,40}", "(abc){1,50}"]


def _texts(seed: int, n: int, maxlen: int, alphabet: bytes):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return [rng.choice(a, size=int(rng.integers(0, maxlen + 1))).tobytes() for _ in range(n)]


SCAN_TEXTS = _texts(5, 18, 300, b"abcd0123x") + [
    b"a" * 310, b"a" * 300, b"a" * 299, b"", b"a", b"a" * 270, b"ab" * 130, b"ab" * 120,
    b"abc" * 100, b"abcd" * 60, b"a1b2" * 40, b"abab" + b"x" + b"ab" * 45, b"ba" * 50,
    b"xbc" * 90, b"cdab" * 70,
]
API_TEXTS = _texts(9, 14, 90, b"abcx") + [b"a" * 310, b"ab" * 130, b"a" * 40, b"ab" * 40,
                                           b"abc" * 30, b"", b"x"]


def _pack(texts, L: int = L_MAX):
    data = np.zeros((len(texts), L), np.uint8)
    lengths = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        t = t[:L]
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    return data, lengths


DATA, LENGTHS = _pack(SCAN_TEXTS)
STARTS = np.random.default_rng(3).integers(-1, L_MAX + 2, size=len(SCAN_TEXTS)).astype(np.int32)
STARTS[:4] = 0


@functools.lru_cache(maxsize=None)
def _case(pattern):
    """One JAX engine per pattern (its jitted calls are cached on its
    scanner) and the port's engine on the CPU, over the same program."""
    ref = jax_compile(pattern)
    return JaxEngine(ref, backend="pallas"), ScanEngine(from_reference(ref), "cpu")


@functools.lru_cache(maxsize=None)
def _api(pattern):
    return rrx.compile(pattern, "cpu"), jax_rrx.compile(pattern, backend="pallas")


def _eq(a, b, tag):
    assert len(a) == len(b), tag
    for i, (x, y) in enumerate(zip(a, b)):
        x = np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape, f"{tag} output {i}: {x.shape} != {y.shape}"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} output {i}")


def _lg():
    return jnp.asarray(LENGTHS.reshape(-1, 1)), torch.from_numpy(LENGTHS.reshape(-1, 1))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_routing_identity(pattern):
    jeng, peng = _case(pattern)
    assert type(jeng.device_scanner).__name__ == "CountScanner"
    assert isinstance(peng.device_scanner, scan_pallas.CountScanner)
    sc = peng.device_scanner
    assert (sc.m, sc.n, sc.body) == (jeng.device_scanner.m, jeng.device_scanner.n,
                                      jeng.device_scanner.body)
    assert peng._window_plan(4096, 8, True) is None


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_match_stats_parity(pattern, seeded):
    jeng, peng = _case(pattern)
    jl, pl = _lg()
    a = jeng.device_scanner.match_stats_b(jnp.asarray(DATA), jl, seeded=seeded)
    b = peng.device_scanner.match_stats_b(torch.from_numpy(DATA), pl, seeded=seeded)
    _eq(a, b, f"{pattern} seeded={seeded}")


@pytest.mark.parametrize("pattern", ["a{3,280}", "(ab){2,120}", "(abc|xbc|bca){1,200}"])
def test_match_stats_lead_parity(pattern):
    """``lead`` = m * k, the one-long-string windows' horizon."""
    jeng, peng = _case(pattern)
    sc = peng.device_scanner
    lead = sc.m * sc.k
    jl, pl = _lg()
    a = jeng.device_scanner.match_stats_b(jnp.asarray(DATA), jl, seeded=True, lead=lead)
    b = sc.match_stats_b(torch.from_numpy(DATA), pl, seeded=True, lead=lead)
    _eq(a, b, f"{pattern} lead={lead}")


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_forward_flags_parity(pattern, seeded):
    jeng, peng = _case(pattern)
    jl, pl = _lg()
    a = jeng.device_scanner.forward_flags_b(jnp.asarray(DATA), jl, seeded=seeded)
    b = peng.device_scanner.forward_flags_b(torch.from_numpy(DATA), pl, seeded=seeded)
    assert b.shape == (DATA.shape[0], DATA.shape[1] + 3) and b.dtype == torch.bool
    _eq([a], [b], f"{pattern} seeded={seeded}")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_reverse_hits_parity(pattern):
    jeng, peng = _case(pattern)
    jl, pl = _lg()
    a = jeng.device_scanner.reverse_hits_b(jnp.asarray(DATA), jl)
    b = peng.device_scanner.reverse_hits_b(torch.from_numpy(DATA), pl)
    _eq([a], [b], pattern)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_engine_bitmaps_parity(pattern):
    """Both bitmaps (the engine's word-domain path over the counting
    kernels' flag and hit words) equal the JAX engine's, which builds them
    with ``scan_xla`` from unpacked flags, and the port's ``scan_xla`` on
    the same flags."""
    jeng, peng = _case(pattern)
    ln, nullable = torch.from_numpy(LENGTHS), peng.prog.nullable
    generic = {
        "ends_bitmap": scan_xla.ends_bitmap(peng.forward_flags(DATA, LENGTHS, seeded=True), ln,
                                            L_MAX, nullable, seeded=True),
        "starts_bitmap": scan_xla.starts_bitmap(peng.reverse_hits(DATA, LENGTHS), ln, L_MAX,
                                                nullable),
    }
    for name, gen in generic.items():
        a = getattr(jeng, name)(DATA, LENGTHS, L_MAX)
        b = getattr(peng, name)(DATA, LENGTHS, L_MAX)
        _eq([a, gen], [b, b], f"{pattern} {name}")


@pytest.mark.parametrize("longest", [False, True], ids=["lazy", "longest"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_engine_first_end_parity(pattern, longest):
    jeng, peng = _case(pattern)
    a = jeng.first_end_from(DATA, LENGTHS, STARTS, longest=longest)
    b = peng.first_end_from(DATA, LENGTHS, STARTS, longest=longest)
    _eq([a], [b], f"{pattern} longest={longest}")


@pytest.mark.parametrize("pattern", ["a{1,300}", "a{3,1200}"], ids=["multiblock", "sparse"])
def test_scan_xla_first_end_matches_both_jax_routes(pattern):
    """The port's ``scan_xla.first_end_from`` against the JAX package's
    ``scan_xla.first_end_from`` and its engine's route (``scan_packed`` on
    the multiblock tier, ``scan_xla`` on the sparse one)."""
    jeng, peng = _case(pattern)
    ref = jeng.prog
    assert ref.tier == ("multiblock" if pattern == "a{1,300}" else "sparse")
    data, lengths = DATA[:, :160], np.minimum(LENGTHS, 160)
    starts = np.minimum(STARTS, 161)
    jt = jax_xla.device_tables(ref)
    jcls = jax_xla.encode_stream(jt, jnp.asarray(data), jnp.asarray(lengths), ref.bos_class,
                                 ref.eos_class, ref.dead_class)
    prog = peng.prog
    pt = scan_xla.device_tables(prog, "cpu")
    pcls = scan_xla.encode_stream(pt, torch.from_numpy(data), torch.from_numpy(lengths),
                                  prog.bos_class, prog.eos_class)
    np.testing.assert_array_equal(pcls.numpy(), np.asarray(jcls))
    for longest in (False, True):
        got = scan_xla.first_end_from(pt, pcls, torch.from_numpy(lengths),
                                      torch.from_numpy(starts), longest=longest)
        want = jax_xla.first_end_from(jt, jcls, jnp.asarray(lengths), jnp.asarray(starts),
                                      longest=longest)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"xla {longest}")
        want_eng = jeng.first_end_from(data, lengths, starts, longest=longest)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_eng), err_msg=f"engine {longest}")


def test_wrappers_check_shapes():
    _, peng = _case("(ab){2,120}")
    ct = peng.device_scanner.tables
    d, lengths = torch.from_numpy(DATA), torch.from_numpy(LENGTHS)
    with pytest.raises(ValueError, match="lengths must be"):
        scan_pallas.count_stats(d, lengths[:-1], ct, seeded=True)
    words = scan_pallas.count_flags(d, lengths, ct, seeded=True)
    assert words.shape == (scan_bits.hit_words(L_MAX), d.shape[0]) and words.dtype == torch.int32
    full = scan_bits.hit_bits(words, 32 * words.shape[0])
    assert not full[torch.arange(full.shape[1])[None, :] > lengths[:, None] + 1].any()


def test_cpu_path_leaves_launch_counts():
    """A CPU tensor takes the plain versions: no kernel launch is counted."""
    wrappers = (scan_pallas.count_stats, scan_pallas.count_flags, scan_pallas.count_reverse)
    before = [w.launches for w in wrappers]
    _, peng = _case("a{1,300}")
    peng.match_stats(DATA, LENGTHS, seeded=True)
    peng.ends_bitmap(DATA, LENGTHS, L_MAX)
    peng.starts_bitmap(DATA, LENGTHS, L_MAX)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("pattern", API_PATTERNS)
def test_pattern_entry_points_match_jax(pattern):
    port, ref = _api(pattern)
    assert isinstance(port.engine.device_scanner, scan_pallas.CountScanner)
    texts = API_TEXTS
    # the JAX Pattern's batch entry points, read from the JAX engine of the
    # scanner tests on the texts laid out in their [33, 320] batch shape,
    # so that the interpret-mode calls compile once per pattern (a Pattern
    # reads the same engine calls; records are independent)
    jeng = _case(pattern)[0]
    data = np.zeros_like(DATA)
    lengths = np.zeros_like(LENGTHS)
    data[: len(texts)], lengths[: len(texts)] = _pack(texts)
    B, maxlen = len(texts), max(map(len, texts))
    cnt, _, anym = jeng.match_stats(data, lengths, seeded=True)
    want = {"search_batch": np.asarray(anym)[:B], "count_batch": np.asarray(cnt)[:B],
            "fullmatch_batch": np.asarray(jeng.fullmatch_flags(data, lengths))[:B]}
    for name in ("ends_batch", "starts_batch"):
        bm = np.asarray(getattr(jeng, name.replace("_batch", "_bitmap"))(data, lengths, maxlen))
        want[name] = [[int(p) for p in np.nonzero(bm[i])[0] if p <= lengths[i]] for i in range(B)]
    for name, w in want.items():
        got = getattr(port, name)(texts)
        if isinstance(w, list):
            assert got == w, name
        else:
            np.testing.assert_array_equal(got, w, err_msg=name)
    for longest in (False, True):
        assert port.finditer_batch(texts, longest=longest) == ref.finditer_batch(
            texts, longest=longest), longest
    # the JAX Pattern's match (the anchored lazy end from 0) of each of the
    # last seven texts, in one batch of the texts' packed shape, so that it
    # reuses the rounds' first_end_from compile (records are independent)
    singles = texts[-7:]
    data, lengths, _, _ = ref._pack(singles + texts)
    starts = np.full(data.shape[0], -1, np.int32)
    starts[: len(singles)] = 0
    ends = np.asarray(ref.engine.first_end_from(data, lengths, starts))
    for t, e in zip(singles, ends.tolist()):
        a = port.match(t)
        # a nullable program's match is the empty prefix, without a scan
        want = (0, 0) if ref.program.nullable else ((0, e) if e >= 0 else None)
        assert (a is None) == (want is None) and (a is None or a.span() == want), t


def test_dump_matches_jax():
    for pattern in ("a{2,5}", "(ab|c)*d$", "^x[0-9]{1,3}"):
        port, ref = rrx.compile(pattern, "cpu"), jax_rrx.compile(pattern, backend="pallas")
        for full in (False, True):
            assert port.dump(full=full) == ref.dump(full=full), (pattern, full)
