"""The port's matmul tier (``PallasScanner``, plain PyTorch versions, CPU)
against the JAX package's ``PallasScanner`` (Pallas interpret mode) at the
scanner boundary: match statistics (seeded, unseeded, ``lead``) and
reverse hits, for record tiles of 8 to 256 states (anchored rescans and
spans: tests/test_torch_pallas_spans.py). Every output is an integer or a
bool, so every comparison is exact. The CUDA kernels are held to the same
plain versions on the card (chip_smoke.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_packed as sp
from roaringregex_tpu.ops import scan_pallas as jax_pallas
from roaringregex_tpu_torch.compiler.program import from_reference
from roaringregex_tpu_torch.ops import scan_bits, scan_pallas

torch.set_num_threads(1)

K7 = "(error|warning|critical|fatal|exception|timeout|refused)"
K16 = (
    "(error|warn|fail|denied|refused|timeout|exception|fatal|panic|critical|abort|killed"
    "|segfault|overflow|corrupt|unreachable)"
)
K30 = K16[:-1] + (
    "|invalid|missing|expired|forbidden|unauthorized|unavailable|conflict|deadlock|retry"
    "|dropped|rejected|throttled|oom|leak)"
)
HTTP = "^(GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH) /[a-z0-9/._-]* HTTP/1\\.[01]$"
# (pattern, s_tile): nullable SWAR-size programs, u32-word-size programs, and
# the dense128 / dense256 programs the SWAR and word specs reject
PATTERNS = [
    ("a*", 8), ("(cat|dog)*", 8), ("(a|$)*", 8),
    ("(ab|cd)+e{2,3}fgh", 16), ("a{10,20}", 32),
    (K7, 64), (K7 + "*", 64), (HTTP, 64),
    (K16, 128), ("x(ab|c){20,40}y", 128),
    (K30, 256), ("(a|bc){1,60}", 256),
]
NAMES = {K7: "K7", K7 + "*": "K7*", HTTP: "HTTP", K16: "K16", K30: "K30"}
IDS = [NAMES.get(p, p) for p, _ in PATTERNS]
NON_NULLABLE = [(p, s) for p, s in PATTERNS if not jax_compile(p).nullable]
NON_NULLABLE_IDS = [i for i, (p, _) in zip(IDS, PATTERNS) if not jax_compile(p).nullable]
PLANTS = [
    b"error", b"warning timeout", b"x critical", b"GET /a/b.c HTTP/1.1", b"POST / HTTP/1.0",
    b"xababccababcy", b"xabababababcccccccccababababcccy", b"abcbcbca", b"cat", b"dogcat",
    b"aaaaaaaaaaaa", b"abcdcdeeefgh", b"oomleakretry", b"segfaulterror",
]


def _batch(G: int, seed: int = 7, n: int = 48, L: int = 48):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdeflmnorstwxy /.$", np.uint8)
    texts = [b"", b"error", b"GET / HTTP/1.0", b"a" * L, b"\x00ab", b"a\xfeb"]
    while len(texts) < n:
        t = bytearray(rng.choice(alphabet, size=int(rng.integers(0, L + 1))).tobytes())
        w = PLANTS[int(rng.integers(len(PLANTS)))]
        at = int(rng.integers(0, len(t) + 1))
        t[at:at] = w
        texts.append(bytes(t[:L]))
    Bp = -(-len(texts) // G) * G
    data = np.zeros((Bp, L), np.uint8)
    lengths = np.zeros(Bp, np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    return data, lengths.reshape(-1, G)


@functools.lru_cache(maxsize=None)
def _case(pattern):
    """One JAX scanner per pattern, reused across its methods (its jitted
    calls are cached on the scanner), the port's scanner on the CPU, and
    the shared test batch."""
    ref = jax_compile(pattern)
    jax_sc = jax_pallas.PallasScanner(ref, sp.packed_tables(ref))
    port_sc = scan_pallas.PallasScanner(from_reference(ref), "cpu")
    data, len_g = _batch(ref.G)
    return jax_sc, port_sc, data, len_g


def _eq(a, b, tag):
    assert len(a) == len(b), tag
    for i, (x, y) in enumerate(zip(a, b)):
        x = np.asarray(x)
        assert x.shape == tuple(y.shape), f"{tag} output {i}"
        np.testing.assert_array_equal(x, y.numpy(), err_msg=f"{tag} output {i}")


def _args(data, len_g):
    return (jnp.asarray(data), jnp.asarray(len_g)), (torch.from_numpy(data), torch.from_numpy(len_g))


@pytest.mark.parametrize("pattern,s_tile", PATTERNS, ids=IDS)
def test_program_tiles(pattern, s_tile):
    prog = jax_compile(pattern)
    assert prog.s_tile == s_tile and prog.tier in ("dense128", "dense256")


@pytest.mark.parametrize("mode", ["seeded", "unseeded", "lead"])
@pytest.mark.parametrize("pattern,s_tile", PATTERNS, ids=IDS)
def test_match_stats_parity(pattern, s_tile, mode):
    jax_sc, port_sc, data, len_g = _case(pattern)
    ja, pa = _args(data, len_g)
    kw = dict(seeded=mode != "unseeded", lead=3 if mode == "lead" else 0)
    a = jax_sc.match_stats_b(*ja, **kw)
    b = port_sc.match_stats_b(*pa, **kw)
    assert all(tuple(x.shape) == len_g.shape for x in b)
    _eq(a, b, f"{pattern} {mode}")


@pytest.mark.parametrize("pattern,s_tile", PATTERNS, ids=IDS)
def test_reverse_hits_parity(pattern, s_tile):
    jax_sc, port_sc, data, len_g = _case(pattern)
    ja, pa = _args(data, len_g)
    b = port_sc.reverse_hits_b(*pa)
    assert b.shape == (data.shape[0], data.shape[1] + 2) and b.dtype == torch.bool
    _eq([jax_sc.reverse_hits_b(*ja)], [b], pattern)


@pytest.mark.parametrize("pattern", [K7, "(a|bc){1,60}"])
def test_hit_words_unpack(pattern):
    """The hit words [W, R] the span kernels read unpack to the bits of
    reverse_hits_b, and every bit past a record's EOS step is 0."""
    _, port_sc, data, len_g = _case(pattern)
    d, lengths = torch.from_numpy(data), torch.from_numpy(len_g.reshape(-1))
    words = scan_pallas.nfa_reverse(d, lengths, port_sc.nfa)
    R, L = data.shape
    assert words.shape == (scan_bits.hit_words(L), R) and words.dtype == torch.int32
    assert torch.equal(scan_bits.hit_bits(words, L + 2),
                       port_sc.reverse_hits_b(d, torch.from_numpy(len_g)))
    full = scan_bits.hit_bits(words, 32 * words.shape[0])
    assert not full[torch.arange(full.shape[1])[None, :] > lengths[:, None] + 1].any()


def test_wrappers_check_shapes():
    _, port_sc, data, len_g = _case(K7)
    d, lengths = torch.from_numpy(data), torch.from_numpy(len_g.reshape(-1))
    words = scan_pallas.nfa_reverse(d, lengths, port_sc.nfa)
    with pytest.raises(ValueError, match="hits must be"):
        scan_pallas.nfa_lazy_spans(d, lengths, port_sc.nfa, words[:-1], 4)
    with pytest.raises(ValueError, match="cap must be"):
        scan_pallas.nfa_greedy_spans(d, lengths, port_sc.nfa, words, 0, nullable=False)
    with pytest.raises(ValueError, match="starts must be"):
        scan_pallas.nfa_anchor_end(d, lengths, port_sc.nfa, lengths[:-1], longest=False)


def test_cpu_path_leaves_launch_counts():
    """A CPU tensor takes the plain versions: no kernel launch is counted."""
    wrappers = (scan_pallas.nfa_stats, scan_pallas.nfa_reverse, scan_pallas.nfa_anchor_end,
                scan_pallas.nfa_lazy_spans, scan_pallas.nfa_greedy_spans)
    before = [w.launches for w in wrappers]
    _, port_sc, data, len_g = _case(K7)
    pa = _args(data, len_g)[1]
    port_sc.match_stats_b(*pa, seeded=True)
    port_sc.lazy_spans_b(*pa, cap=4)
    port_sc.greedy_spans_b(*pa, cap=4)
    port_sc.anchor_end_b(*pa, torch.zeros(len_g.shape, dtype=torch.int32), longest=False)
    assert [w.launches for w in wrappers] == before
