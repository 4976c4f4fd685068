"""The port's carried-over compiler against the JAX package's.

``roaringregex_tpu_torch`` cannot import the JAX package's host compiler
(importing any of ``roaringregex_tpu`` loads jax), so it carries its own
copy; these tests hold every field the scan tiers read, and both specs,
to the original.
"""
import numpy as np
import pytest
import torch

from roaringregex_tpu.compiler.nfa import build_nfa as jax_build_nfa
from roaringregex_tpu.compiler.nfa import combine_nfas as jax_combine_nfas
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_pallas as jax_pallas
from roaringregex_tpu.ops import scan_swar as jax_swar
from roaringregex_tpu.ops import scan_word as jax_word
from roaringregex_tpu_torch.compiler.nfa import build_nfa, combine_nfas
from roaringregex_tpu_torch.compiler.program import compile_program, from_reference
from roaringregex_tpu import engine as jax_engine
from roaringregex_tpu.ops import scan_bitband as jax_bitband
from roaringregex_tpu.utils.config import get_config as jax_get_config
from roaringregex_tpu_torch import engine
from roaringregex_tpu_torch.ops import scan_bitband, scan_bits, scan_pallas, scan_swar, scan_word
from test_swar import PATTERNS as SWAR_PATTERNS
from test_torch_pallas import HTTP, K7, K16, K30
from test_word import PATTERNS as WORD_PATTERNS

torch.set_num_threads(1)

BENCH_PATTERNS = ["cat|dog", "[a-z]+\\.log$", "(ab)*c+d?"]
PATTERNS = list(dict.fromkeys(SWAR_PATTERNS + WORD_PATTERNS + BENCH_PATTERNS))
# the matmul tier's record tiles of 64, 128 and 256 states
MATMUL = [K7, HTTP, K16, "x(ab|c){20,40}y", K30, "(a|bc){1,60}"]
# wider programs: the port compiles them and routes them nowhere yet
WIDE = ["a{1,300}", "a" * 200, "a{1,1100}"]
# (pattern, has a counting plan)
COUNTING = [
    ("a{1,120}", True), ("(ab){2,60}", True), ("([a-c][0-9]){4,}", True),
    ("(ab|cd){1,400}", True), ("(a|b|[x-z]){3,9}", True), ("a{2,500}", True), ("x{5}", True),
    ("cat|dog", False), ("a{1,120}b", False), ("(a|bc){1,60}", False), ("(ab|c){2,5}", False),
    ("(^a){2,3}", False), ("a*", True), (K7, False), ("(a|b|c|d|ef){2,4}", False),
]

ARRAYS = ["F", "Bc_words", "accept"]
SCALARS = [
    "bos_class", "eos_class", "tier", "s_tile", "G", "n_states",
    "nullable", "horizon", "uses_anchor",
]


def _same_program(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    for x, y, name in zip(a.byte_runs, b.byte_runs, ("lo", "hi", "cls")):
        np.testing.assert_array_equal(x, y, err_msg=f"byte_runs {name}")
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("pattern", PATTERNS + MATMUL + WIDE)
def test_program_fields_match_jax(pattern):
    _same_program(compile_program(pattern), jax_compile(pattern))


@pytest.mark.parametrize("pattern", PATTERNS + WIDE[:1])
def test_specs_match_jax(pattern):
    port, ref = compile_program(pattern), jax_compile(pattern)
    assert scan_swar.swar_spec(port) == jax_swar.swar_spec(ref)
    assert scan_word.word_spec(port) == jax_word.word_spec(ref)


@pytest.mark.parametrize(
    "pattern", ["cat|dog", "^[a-z]{3,8}[.]log$", "(a|$)*", "a{1,1100}"] + MATMUL
)
def test_from_reference_round_trip(pattern):
    ref = jax_compile(pattern)
    port = from_reference(ref)
    _same_program(port, ref)
    assert port.pattern == ref.pattern
    # a copy, not a view: the port never writes into the reference's tables
    if ref.F is not None:
        assert not np.shares_memory(port.F, ref.F)
    # and the port's own object round-trips through itself
    _same_program(from_reference(port), port)


@pytest.mark.parametrize("pattern,planned", COUNTING)
def test_counting_plan_matches_jax(pattern, planned):
    """The port's copy of counting_plan (which only routes) gives the JAX
    package's plan, or None, on the port's own parser."""
    plan = scan_pallas.counting_plan(compile_program(pattern))
    assert plan == jax_pallas.counting_plan(jax_compile(pattern))
    assert (plan is not None) == planned


@pytest.mark.parametrize("pattern", ["a*", "(ab|cd)+e{2,3}fgh", "a{10,20}"] + MATMUL)
def test_nfa_tables_hold_program(pattern):
    """nfa_tables' rows unpack to the program's follow matrix, its
    transpose, the per-symbol class masks and the accept set."""
    prog = from_reference(jax_compile(pattern))
    S = prog.s_tile
    tab = scan_pallas.nfa_tables(prog)
    W = tab.shape[1]
    assert W == -(-S // 32) and tab.shape[0] == 2 * S + scan_bits.N_SYMS + 1
    bits = np.unpackbits(tab.view(np.uint8), axis=1, bitorder="little")[:, :S].astype(bool)
    F = np.asarray(prog.F)[:S, :S] != 0
    np.testing.assert_array_equal(bits[:S], F)
    np.testing.assert_array_equal(bits[S : 2 * S], F.T)
    mask = bits[2 * S : 2 * S + scan_bits.N_SYMS]
    Bc = np.asarray(prog.Bc)[:, :S] != 0
    for b in range(256):
        want = Bc[prog.byte_class[b]] if b < 0x80 else np.zeros(S, bool)
        np.testing.assert_array_equal(mask[b], want, err_msg=f"byte {b}")
    np.testing.assert_array_equal(mask[scan_bits.SYM_BOS], Bc[prog.bos_class])
    np.testing.assert_array_equal(mask[scan_bits.SYM_EOS], Bc[prog.eos_class])
    assert not mask[scan_bits.SYM_DEAD].any()
    np.testing.assert_array_equal(bits[-1], np.asarray(prog.accept)[:S] != 0)


@pytest.mark.parametrize("patterns", [
    ["cat", "dog", "bird"], ["a*", "err(or)?", "^x"], ["[a-f]{3}", "z", "foo$"],
    ["cat|dog", "[0-9]{3}", "err(or)?", "ab(cd)*e"], K7[1:-1].split("|"), ["", "a", "a*"],
])
def test_combine_nfas_matches_jax(patterns):
    """The Glushkov union of MultiPattern: state count, follow sets, labels,
    nullability and the per-pattern accept sets (state 0 in pattern p's
    iff p is nullable), and the combined program the tiers read."""
    port, port_acc = combine_nfas([build_nfa(p) for p in patterns])
    ref, ref_acc = jax_combine_nfas([jax_build_nfa(p) for p in patterns])
    assert port.n_states == ref.n_states and port.nullable == ref.nullable
    assert port.get_follow_sets() == ref.get_follow_sets()
    assert port.labels == ref.labels and port.accept_set == ref.accept_set
    assert port_acc == ref_acc
    assert [0 in a for a in port_acc] == [build_nfa(p).nullable for p in patterns]
    _same_program(compile_program(port), jax_compile(ref))


# `.*X.*` shapes of tests/test_longstring.py, and shapes the rewrite refuses
DOTSTAR = [".*error.*", ".*(cat|dog).*", "abc.*", ".*abc", ".*a{2,40}.*", ".*(er|ro)r.*",
           "x.*y", "cat|dog", ".*a*", "(ab)*c", ".*^a", ".*(a|$).*"]


@pytest.mark.parametrize("pattern", DOTSTAR)
def test_dotstar_core_matches_jax(pattern):
    """The carried `.*X.*` rewrite builds the JAX package's core program
    (or refuses the same shapes) and reports the same trailing `.*`."""
    from roaringregex_tpu.ops.longstring import dotstar_core as jax_dotstar_core
    from roaringregex_tpu_torch.ops.longstring import dotstar_core

    port, ref = dotstar_core(compile_program(pattern)), jax_dotstar_core(jax_compile(pattern))
    assert (port is None) == (ref is None), pattern
    if port is not None:
        assert port[1] == ref[1]
        assert port[0].pattern == ref[0].pattern
        _same_program(port[0], ref[0])


@pytest.mark.parametrize("pattern", PATTERNS[:6] + MATMUL[:2] + WIDE + ["(abc|de){1,300}"])
def test_pattern_n_states_and_tier_match_jax(pattern):
    import roaringregex_tpu_torch as rrx

    p, ref = rrx.compile(pattern, "cpu"), jax_compile(pattern)
    assert (p.n_states, p.tier) == (ref.n_states, ref.tier)


# the multiblock and sparse programs of the bitband slice's probe table: the
# bitband programs (config 10 first), then config 13 and three programs the
# JAX engine runs on the container tier or the dense multiblock matmul
BIG = ["x(ab|c){400,520}y", "x{2,300}y", "(ab|c){100,130}", "x(ab|c){100,200}(y|z+)",
       "(a(ab|c){100,200}b)+", "^x(ab|c){100,200}y$", "x(ab|c){100,200}", "x(ab|c){400,}y",
       "(abc|de){1,300}", "a*b{1,300}", "(ab|c){2,120}d", "x(ab|c){300,}y"]


@pytest.mark.parametrize("pattern", BIG)
def test_block_layout_matches_jax(pattern):
    """The block-sparse follow layout, its container split and seed_row."""
    port, ref = compile_program(pattern), jax_compile(pattern)
    for name in ("fblocks", "fblock_rows", "fblock_cols", "seed_row"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    for x, y in zip(port.sparse_partition, ref.sparse_partition, strict=True):
        np.testing.assert_array_equal(x, y)
    carried = from_reference(ref)
    for name in ("fblocks", "fblock_rows", "fblock_cols"):
        np.testing.assert_array_equal(getattr(carried, name), getattr(ref, name), err_msg=name)
        assert not np.shares_memory(getattr(carried, name), getattr(ref, name))


@pytest.mark.parametrize("pattern", BIG)
def test_bitband_builders_match_jax(pattern):
    """bitband_spec, _tri_structure and build_bitband_tables (one accept
    channel and two) give the JAX package's output exactly."""
    port, ref = compile_program(pattern), jax_compile(pattern)
    spec = scan_bitband.bitband_spec(port)
    assert spec == jax_bitband.bitband_spec(ref)
    if spec is None:
        return
    if spec.tri_gaps:
        E, fams = scan_bitband._tri_structure(port, spec)
        rE, rfams = jax_bitband._tri_structure(ref, spec)
        np.testing.assert_array_equal(E, rE)
        assert fams == rfams
    acc = np.zeros((port.s_pad, 2), np.uint8)
    acc[: port.n_states, 0] = np.asarray(port.accept)[: port.n_states]
    acc[: port.n_states, 1] = np.arange(port.n_states) % 3 == 1
    for am in (acc[:, :1], acc):
        for x, y in zip(scan_bitband.build_bitband_tables(port, spec, am),
                        jax_bitband.build_bitband_tables(ref, spec, am), strict=True):
            np.testing.assert_array_equal(x, y)


def test_routing_constants_match_jax_defaults():
    """The port's fixed routing limits are the JAX package's knob defaults."""
    jc = jax_get_config()
    assert (scan_bitband.BITBAND_MAX_DIAGS, scan_bitband.BITBAND_MAX_RANK1,
            scan_bitband.SPARSE_LANES_MAX) == (jc.bitband_max_diags, jc.bitband_max_rank1,
                                               jc.sparse_lanes_max)
    assert (engine.BANDED_MAX_DIAGS, engine.SPARSE_PARTIAL_MAX) == (jc.banded_max_diags,
                                                                    jc.sparse_partial_max)
    assert jc.bitband


@pytest.mark.parametrize("pattern", BIG)
def test_routing_rules_match_jax(pattern):
    """The multiblock routing rule (with banded_offsets) and the relaxed
    prefilter program."""
    port, ref = compile_program(pattern), jax_compile(pattern)
    assert engine.ScanEngine._multiblock_container_wins(port) == \
        jax_engine.ScanEngine._multiblock_container_wins(ref, jax_get_config())
    if port.F is not None:
        assert scan_pallas.banded_offsets(port.F.T, 8) == jax_pallas.banded_offsets(ref.F.T, 8)
    rp, rr = engine.relaxed_prefilter_program(port), jax_engine.relaxed_prefilter_program(ref)
    assert (rp is None) == (rr is None)
    if rp is not None:
        _same_program(rp, rr)
        assert rp.pattern == rr.pattern
        np.testing.assert_array_equal(rp.nfa.get_edges(), rr.nfa.get_edges())
    if pattern == "x(ab|c){400,520}y":
        assert rp.pattern == "<prefilter:x(ab|c){400,520}y>" and rp.n_states == 15
