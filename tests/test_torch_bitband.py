"""The bitband tier: the port's ``BitbandScanner`` (plain PyTorch versions,
CPU) and its route through the engine and ``Pattern`` against the JAX
package's ``BitbandScanner`` (Pallas interpret mode), the oracle
(``roaringregex_tpu/oracle/engine.py``) and Python's ``re``; and the sparse
tier's prefilter (``ScanEngine._prefilter_apply``) against the unfiltered
scan.

Interpret mode compiles each JAX method for 5-13 s at its first shape, so
each pattern keeps one JAX scanner and one batch (``functools.lru_cache``)
and the JAX side runs on three patterns: bench config 10 (all five entry
points, lazy and greedy spans), a rank-1 column and a negative triangle
gap (match statistics; their reverse passes are held to Python re, and
their ``Pattern`` entry points to the oracle and re); the stream-fed
methods (the container kernels' plain versions over a mask stream, rows
11-13) run on x{2,300}y and the nullable x{0,300}y? against the JAX
scanner's and the byte path, on records of at most 40 bytes. Config 10's batch has ``Pattern``'s packed
shape, so the JAX ``Pattern`` calls reuse the scanner's compiles. Every
output is an integer or a bool: every comparison is exact. The CUDA
kernels (``rrx_bitband_*``) are held to the same plain versions on the
card by ``chip_smoke.py``."""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.program import compile_program as jax_compile
from roaringregex_tpu.ops import scan_packed as jax_packed
from roaringregex_tpu.oracle.engine import OracleEngine
from roaringregex_tpu_torch.api import _pack_texts
from roaringregex_tpu_torch.compiler.program import compile_program, from_reference
from roaringregex_tpu_torch.engine import ScanEngine
from roaringregex_tpu_torch.ops import scan_bitband as bb
from roaringregex_tpu_torch.ops import scan_packed as sp
from roaringregex_tpu_torch.utils import config as cfg

torch.set_num_threads(1)

CONFIG10 = "x(ab|c){400,520}y"  # sparse, 1563 states, W = 56, 16 diagonals
RANK1 = "(a(ab|c){100,200}b)+"  # multiblock, one rank-1 column
NEG_GAP = "x(ab|c){100,200}(y|z+)"  # multiblock, triangle gaps (-1, 4, 5)
# the rest of the bitband programs of the probe table: BOS and EOS rows, no
# static accept words (the accept OR-fold), gaps (-3, -1), a 16-diagonal
# band of one byte, 9 diagonals
ORACLE = ["^x(ab|c){100,200}y$", "x(ab|c){100,200}", "x(ab|c){400,}y", "x{2,300}y",
          "(ab|c){100,130}"]


def _chain(rng, pattern: str, lo: int, hi: int, maxlen: int, y: bytes = b"y") -> bytes:
    """A chain of lo..hi copies of the pattern's repeated body (at most
    ``maxlen`` bytes): x(ab|c){k}y, x{k}y or a(ab|c){k}b."""
    k = int(rng.integers(lo, hi + 1))
    if pattern.startswith("x{"):
        return b"x" * min(k, maxlen - 1) + y
    nab = int(rng.integers(0, max(0, min(k, maxlen - k - 2)) + 1))
    body = [b"ab"] * nab + [b"c"] * (k - nab)
    rng.shuffle(body)
    if pattern.startswith("(a("):
        return b"a" + b"".join(body) + b"b"
    return b"x" + b"".join(body) + y


def _texts(pattern: str, n: int, maxlen: int, seed: int):
    """Records for ``pattern`` of at most ``maxlen`` bytes: the empty one,
    matches, near misses (one repetition too few or too many), random text
    over the pattern's bytes with chains planted in every second record,
    and bytes 0x00, 0x80 and 0xff."""
    rng = np.random.default_rng(seed)
    m = re.search(r"\{(\d+),(\d*)\}", pattern)
    lo, hi = int(m.group(1)), int(m.group(2) or int(m.group(1)) + 40)
    alpha = np.frombuffer(b"xabcyz", np.uint8)
    ch = functools.partial(_chain, rng, pattern)
    out = [b"", ch(hi - 30, hi - 30, maxlen - 20), ch(lo - 1, lo - 1, maxlen),
           ch(hi + 1, hi + 1, maxlen), b"xab\x80c\xffy\x00" + ch(lo, lo, maxlen - 8)]
    while len(out) < n:
        t = bytearray(rng.choice(alpha, size=int(rng.integers(0, maxlen // 3))).tobytes())
        if len(out) % 2:
            at = int(rng.integers(0, len(t) + 1))
            t[at:at] = ch(lo, hi, maxlen - len(t), bytes([int(rng.choice(alpha))]))
        out.append(bytes(t))
    return [t[:maxlen] for t in out]


def _pack(texts):
    """Texts -> (data [16, Lp] uint8, lengths [16] int32) in ``Pattern``'s
    packed shape."""
    return _pack_texts(texts, 1)[:2]


@functools.lru_cache(maxsize=None)
def _case(pattern: str):
    """(JAX scanner, the port's scanner, texts, data, lengths) of a pattern
    whose program the port builds from the JAX one. The JAX scanner is the
    JAX ``Pattern``'s own (``compile`` caches it), so that its calls and the
    ``Pattern``'s share their compiles."""
    ref = jax_rrx.compile(pattern, backend="pallas")
    jsc = ref.engine.device_scanner
    psc = ScanEngine(from_reference(ref.program), "cpu").device_scanner
    assert type(jsc).__name__ == type(psc).__name__ == "BitbandScanner"
    texts = _texts(pattern, 16, 650 if pattern == CONFIG10 else 500, 7)
    data, lengths = _pack(texts)
    return jsc, psc, texts, data, lengths


@functools.lru_cache(maxsize=None)
def _jax(pattern: str, what: str, *args):
    jsc, _, _, data, lengths = _case(pattern)
    lg = lengths.reshape(-1, 1)
    if what == "stats":
        return tuple(np.asarray(x) for x in jsc.match_stats_b(data, lg, seeded=args[0]))
    if what == "flags":
        return np.asarray(jsc.forward_flags_b(data, lg, seeded=args[0]))
    if what == "reverse":
        return np.asarray(jsc.reverse_hits_b(data, lg))
    if what == "anchor":
        return np.asarray(jsc.anchor_end_b(data, lg, _starts(len(lengths))[:, None],
                                           longest=args[0]))
    spans = jsc.greedy_spans_b if args[0] else jsc.lazy_spans_b
    return tuple(np.asarray(x) for x in spans(data, lg, cap=8))


def _starts(R: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    st = rng.integers(-1, 40, size=R).astype(np.int32)
    st[:6] = [0, 0, 0, 1, 8, -1]  # record 4's chain starts at byte 8
    return st


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("pattern,seeded", [(CONFIG10, True), (CONFIG10, False), (RANK1, True),
                                            (NEG_GAP, True)])
def test_match_stats_match_jax(pattern, seeded):
    _, psc, _, data, lengths = _case(pattern)
    got = psc.match_stats_b(data, lengths.reshape(-1, 1), seeded=seeded)
    for name, x, y in zip(("cnt", "first", "last", "full", "any"), got,
                          _jax(pattern, "stats", seeded), strict=True):
        _eq(x, y, f"{pattern} {name}")
    assert int(np.asarray(got[0]).sum()) > 0


def test_forward_flags_match_jax():
    _, psc, _, data, lengths = _case(CONFIG10)
    got = psc.forward_flags_b(data, lengths.reshape(-1, 1), seeded=True)
    _eq(got, _jax(CONFIG10, "flags", True), "forward flags")


def test_reverse_hits_match_jax():
    _, psc, _, data, lengths = _case(CONFIG10)
    got = psc.reverse_hits_b(data, lengths.reshape(-1, 1))
    _eq(got, _jax(CONFIG10, "reverse"), "reverse hits")
    assert np.asarray(got).any()


@pytest.mark.parametrize("pattern", [RANK1, NEG_GAP])
def test_reverse_hits_match_re(pattern):
    """The reverse pass of a rank-1 column and of a negative triangle gap
    (their reverse terms differ most from the forward ones): the starts
    bitmap it gives equals the positions where Python re finds a match."""
    _, psc, texts, data, lengths = _case(pattern)
    hits = np.asarray(psc.reverse_hits_b(data, lengths.reshape(-1, 1)))
    rx = re.compile(pattern.encode())
    for i, t in enumerate(texts):
        starts = [s for s in range(len(t) + 1) if hits[i, s + 1] or (s == 0 and hits[i, 0])]
        assert starts == [s for s in range(len(t) + 1) if rx.match(t, s)], i
    assert hits.any()


def test_anchor_end_matches_jax():
    _, psc, _, data, lengths = _case(CONFIG10)
    st = _starts(len(lengths))
    got = psc.anchor_end_b(data, lengths.reshape(-1, 1), st[:, None], longest=True)
    _eq(got, _jax(CONFIG10, "anchor", True), "anchor longest")
    assert (np.asarray(got) >= 0).any()


def test_lazy_spans_match_jax():
    _, psc, _, data, lengths = _case(CONFIG10)
    got = psc.lazy_spans_b(data, lengths.reshape(-1, 1), cap=8)
    for name, x, y in zip(("starts", "ends", "count"), got, _jax(CONFIG10, "spans", False),
                          strict=True):
        _eq(x, y, f"lazy spans {name}")


def test_greedy_spans_match_jax():
    _, psc, _, data, lengths = _case(CONFIG10)
    got = psc.greedy_spans_b(data, lengths.reshape(-1, 1), cap=8)
    for name, x, y in zip(("starts", "ends", "count", "over"), got,
                          _jax(CONFIG10, "spans", True), strict=True):
        _eq(x, y, f"greedy spans {name}")
    assert int(np.asarray(got[2]).sum()) > 0


def _re_spans(pattern: str, texts, longest: bool):
    """Python re's spans: every program here parses a match one way (the
    alternatives (ab|c) never share a first byte, and a chain ends only at
    a byte no repetition starts with), so re's greedy match from the
    leftmost start is the longest and its lazy form's the shortest."""
    lazy = pattern.replace("}", "}?").replace("+", "+?")
    rx = re.compile((pattern if longest else lazy).encode())
    return [[m.span() for m in rx.finditer(t)] for t in texts]


def test_pattern_matches_jax_and_oracle():
    """Config 10 through ``Pattern``: count, search, fullmatch and lazy
    spans equal the JAX ``Pattern``'s (whose calls reuse the scanner's
    compiles), counts, ends and fullmatch the oracle's, spans (lazy and
    greedy: this pattern's matches are unique per start) and starts
    Python re's."""
    _, _, texts, data, _ = _case(CONFIG10)
    port, ref = rrx.compile(CONFIG10, "cpu"), jax_rrx.compile(CONFIG10, backend="pallas")
    assert port._pack(texts)[0].shape == data.shape == (16, 1024)
    orc = OracleEngine(ref.program.nfa)
    ends = [sorted(orc.ends(t)) for t in texts]
    cnt = port.count_batch(texts)
    _eq(cnt, ref.count_batch(texts), "count_batch")
    _eq(cnt, [len(e) for e in ends], "count_batch vs oracle")
    _eq(port.search_batch(texts), ref.search_batch(texts), "search_batch")
    full = port.fullmatch_batch(texts)
    _eq(full, ref.fullmatch_batch(texts), "fullmatch_batch")
    _eq(full, [orc.fullmatch(t) for t in texts], "fullmatch_batch vs oracle")
    lazy = port.finditer_batch(texts)
    assert lazy == ref.finditer_batch(texts)
    assert lazy == _re_spans(CONFIG10, texts, False) == _re_spans(CONFIG10, texts, True)
    assert port.finditer_batch(texts, longest=True) == lazy
    assert sum(map(len, lazy)) >= 4
    assert port.ends_batch(texts) == ends
    assert port.starts_batch(texts) == [[s for s, _ in sp] for sp in lazy]


@pytest.mark.parametrize("pattern", ORACLE + [RANK1, NEG_GAP])
def test_pattern_matches_oracle(pattern):
    """Counts, ends and fullmatch against the oracle, spans against re
    (the rank-1 and negative-gap programs too: their flags, rescans and
    spans, past the match statistics held to JAX above)."""
    pat = rrx.compile(pattern, "cpu")
    assert type(pat.engine.device_scanner).__name__ == "BitbandScanner"
    texts = _texts(pattern, 10, 500, 3)
    orc = OracleEngine(jax_compile(pattern).nfa)
    ends = [sorted(orc.ends(t)) for t in texts]
    assert sum(map(len, ends)) > 0
    _eq(pat.count_batch(texts), [len(e) for e in ends], "count_batch")
    _eq(pat.search_batch(texts), [bool(e) for e in ends], "search_batch")
    _eq(pat.fullmatch_batch(texts), [orc.fullmatch(t) for t in texts], "fullmatch_batch")
    for longest in (False, True):
        assert pat.finditer_batch(texts, longest=longest) == _re_spans(pattern, texts, longest)
    assert pat.ends_batch(texts) == ends


def test_acc_static_and_or_fold_agree():
    """The plain versions read the static accept words where the JAX
    scanner has them, else the accept rows' OR-fold (as the kernels always
    do): both give the same flags."""
    prog = compile_program("x(ab|c){100,200}(y|z+)")
    spec = bb.bitband_spec(prog)
    tables = bb.device_bitband_tables(prog, spec, "cpu")
    assert tables.acc_static is not None and tables.anchor_static is not None
    folded = tables._replace(acc_static=None, anchor_static=None)
    data, lengths = _pack(_texts(NEG_GAP, 16, 500, 5))
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
    for seeded in (True, False):
        for x, y in zip(bb.stats_plain(d, ln, tables, seeded=seeded, nullable=False),
                        bb.stats_plain(d, ln, folded, seeded=seeded, nullable=False)):
            _eq(x, y, f"stats seeded={seeded}")
    st = torch.from_numpy(_starts(16))
    from roaringregex_tpu_torch.ops import scan_bits as sb

    _eq(sb.anchor_plain(d, ln, tables, st, longest=True),
        sb.anchor_plain(d, ln, folded, st, longest=True), "anchor")
    assert bb.device_bitband_tables(compile_program("x(ab|c){100,200}"), bb.bitband_spec(
        compile_program("x(ab|c){100,200}")), "cpu").acc_static is None


def test_accept_channels_and_nullable_stats():
    """Two accept channels on one program (the program's accept set and a
    second row) give each channel the stats of its own one-channel scan; a
    nullable program's stats start as the JAX kernel's."""
    prog = compile_program("x(ab|c){100,120}y")
    spec = bb.bitband_spec(prog)
    acc2 = np.zeros((prog.s_pad, 1), np.uint8)
    acc2[: prog.n_states, 0] = np.arange(prog.n_states) % 5 == 2
    both = np.concatenate([np.asarray(prog.accept)[:, None], acc2], axis=1)
    data, lengths = _pack(_texts("x(ab|c){100,120}y", 16, 300, 9))
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
    two = bb.device_bitband_tables(prog, spec, "cpu", both)
    outs = bb.stats_plain(d, ln, two, seeded=True, nullable=False)
    for c, am in enumerate((None, acc2)):
        one = bb.device_bitband_tables(prog, spec, "cpu", am)
        for x, y in zip(outs, bb.stats_plain(d, ln, one, seeded=True, nullable=False)):
            _eq(x[:, c], y[:, 0], f"channel {c}")
    flags = bb.flags_plain(d, ln, two, seeded=True)
    for c, am in enumerate((None, acc2)):
        one = bb.device_bitband_tables(prog, spec, "cpu", am)
        _eq(flags[:, c::2], bb.flags_plain(d, ln, one, seeded=True), f"flags channel {c}")
    nul = compile_program("(ab|c){0,120}d?")
    assert nul.nullable and nul.tier == "multiblock"
    tn = bb.device_bitband_tables(nul, bb.bitband_spec(nul), "cpu")
    orc = OracleEngine(jax_compile("(ab|c){0,120}d?").nfa)
    texts = [b"", b"abcd", b"xx", b"ab" * 130]
    dn, lnn = (torch.from_numpy(x) for x in _pack(texts))
    cnt, first, last, full = bb.stats_plain(dn, lnn, tn, seeded=True, nullable=True)
    _eq(cnt[:4, 0], [len(orc.ends(t)) for t in texts], "nullable seeded cnt")
    _eq(first[:4, 0], [0, 0, 0, 0], "nullable first")
    _, _, _, full = bb.stats_plain(dn, lnn, tn, seeded=False, nullable=True)
    _eq(full[:4, 0], [orc.fullmatch(t) for t in texts], "nullable fullmatch")


# -- the stream-fed methods on the container kernels (rows 11-13) -------------
SHORT = "x{2,300}y"  # multiblock, 302 states: matches of a few bytes
NULL_BB = "x{0,300}y?"  # multiblock, nullable


@functools.lru_cache(maxsize=None)
def _stream_case(pattern: str):
    """(JAX BitbandScanner, the port's, data, len_g, the JAX mask stream,
    the port's) on 16 records of at most 40 bytes (the JAX container step
    costs ~13 ms a step in interpret mode). SHORT reuses ``_case``'s
    scanners."""
    if pattern == SHORT:
        jsc, psc = _case(SHORT)[:2]
    else:
        ref = jax_rrx.compile(pattern, backend="pallas")
        jsc = ref.engine.device_scanner
        psc = ScanEngine(from_reference(ref.program), "cpu").device_scanner
    assert type(jsc).__name__ == type(psc).__name__ == "BitbandScanner"
    texts = [b"", b"xxy", b"xy", b"x" * 30 + b"y", b"axxxyxxy", b"xxxx", b"x\x80xy\x00xxy"]
    texts += [t[:40] for t in _texts(SHORT, 9, 40, 12)]
    data, lengths = _pack(texts)
    len_g = lengths.reshape(-1, 1)
    jref = jsc.prog
    jw = jax_packed.mask_stream_from_bytes(
        jax_packed.stream_tables(jref), jnp.asarray(data), jnp.asarray(len_g),
        s_tile=jref.s_tile, G=jref.G, n_runs=len(jref.byte_runs[0]))
    pw = sp.mask_stream_from_bytes(sp.stream_tables(psc.prog, "cpu"), torch.from_numpy(data),
                                   torch.from_numpy(lengths))
    _eq(pw, np.asarray(jw).view(np.int32), "mask stream")
    return jsc, psc, data, len_g, jw, pw


@pytest.mark.parametrize("pattern,seeded", [(SHORT, True), (SHORT, False), (NULL_BB, True),
                                            (NULL_BB, False)])
def test_stream_methods_match_jax(pattern, seeded):
    """match_stats and forward_flags over the stream (reverse_hits once per
    program) equal the JAX BitbandScanner's (its SparseScanner's container
    kernels) and the port's own byte path on the same records; the
    container tables are built at the first stream call."""
    jsc, psc, data, len_g, jw, pw = _stream_case(pattern)
    assert psc.nullable == (pattern == NULL_BB)
    d, lg = torch.from_numpy(data), torch.from_numpy(len_g)
    stats = psc.match_stats(pw, lg, seeded=seeded)
    assert psc._sparse is not None
    byte = psc.match_stats_b(d, lg, seeded=seeded)
    want = jsc.match_stats(jw, jnp.asarray(len_g), seeded=seeded)
    for name, x, y, z in zip(("cnt", "first", "any"), stats, want, (byte[0], byte[1], byte[4]),
                             strict=True):
        _eq(x, y, name)
        _eq(x, z, f"{name} against the byte path")
    assert int(stats[0].sum()) > 0
    flags = psc.forward_flags(pw, seeded=seeded)
    _eq(flags, jsc.forward_flags(jw, seeded=seeded), "flags")
    _eq(flags, psc.forward_flags_b(d, lg, seeded=seeded), "flags against the byte path")
    if seeded:
        hits = psc.reverse_hits(pw)
        _eq(hits, jsc.reverse_hits(jw), "hits")
        _eq(hits, psc.reverse_hits_b(d, lg), "hits against the byte path")


def test_stream_methods_refuse_channels():
    prog = compile_program(SHORT)
    amap = np.stack([np.asarray(prog.accept), np.asarray(prog.accept)], axis=1)
    psc = ScanEngine(prog, "cpu", accept_map=amap, channels_per_record=2).device_scanner
    assert type(psc).__name__ == "BitbandScanner"
    _, _, data, len_g, _, pw = _stream_case(SHORT)
    for call in (lambda: psc.match_stats(pw, torch.from_numpy(len_g), seeded=True),
                 lambda: psc.forward_flags(pw, seeded=True), lambda: psc.reverse_hits(pw)):
        with pytest.raises(ValueError, match="2 accept channels"):
            call()
    assert psc._sparse is None


# -- the prefilter ------------------------------------------------------------
PREFILTERED = "x(ab|c){100,120}y"  # sparse under dense_max = 256


@pytest.fixture
def sparse_256():
    """dense_max = 256: PREFILTERED is a sparse program (the prefilter's
    tier) at W = 16, cheap for the plain versions."""
    base = cfg.get_config()
    cfg.set_config(base.with_(dense_max=256))
    yield
    cfg.set_config(base)


def _density_batch(n_plant: int, B: int = 160, L: int = 256):
    """[B, L] records over a, b, c, y, z with ``n_plant`` prefilter
    candidates: a chain of 100-120 copies (a match), or of 5-99 (a
    candidate of x(ab|c){4,}y that does not match)."""
    rng = np.random.default_rng(n_plant)
    data = rng.choice(np.frombuffer(b"abcyz", np.uint8), size=(B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    for i in rng.permutation(B)[:n_plant]:
        lo, hi = (100, 120) if rng.random() < 0.6 else (5, 99)
        w = _chain(rng, PREFILTERED, lo, hi, L)
        at = int(rng.integers(0, L - len(w) + 1))
        data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
        lengths[i] = max(lengths[i], at + len(w))
    return data, lengths


@pytest.mark.parametrize("n_plant", [6, 100, 150])
def test_prefilter_apply_equals_raw_scan(sparse_256, n_plant):
    """Candidates under B / 16, within the B / 4 bucket (128 rows for 160
    records) and past it (the full-batch pass): the prefiltered primitives
    equal the unfiltered scan (``RRX_SPARSE_PREFILTER=0``), all of them at
    the middle density."""
    eng = ScanEngine(compile_program(PREFILTERED), "cpu")
    assert eng.prog.tier == "sparse" and eng._prefilter() is not None
    base = cfg.get_config()
    cfg.set_config(base.with_(sparse_prefilter=False))
    try:
        raw = ScanEngine(compile_program(PREFILTERED), "cpu")
        assert raw._prefilter() is None
    finally:
        cfg.set_config(base)
    data, lengths = _density_batch(n_plant)
    _, _, pre = eng._prefilter_eng.match_stats(data, lengths, seeded=True)
    assert int(pre.sum()) == n_plant
    got, want = eng.match_stats(data, lengths, seeded=True), raw.match_stats(data, lengths,
                                                                              seeded=True)
    for x, y in zip(got, want, strict=True):
        _eq(x, y, "match_stats")
    assert 0 < int(want[2].sum()) < n_plant
    L = data.shape[1]
    _eq(eng.ends_bitmap(data, lengths, L), raw.ends_bitmap(data, lengths, L), "ends")
    if n_plant == 100:
        _eq(eng.fullmatch_flags(data, lengths), raw.fullmatch_flags(data, lengths), "fullmatch")
        _eq(eng.starts_bitmap(data, lengths, L), raw.starts_bitmap(data, lengths, L), "starts")
        _eq(eng.forward_flags(data, lengths, seeded=False),
            raw.forward_flags(data, lengths, seeded=False), "forward flags")
        _eq(eng.reverse_hits(data, lengths), raw.reverse_hits(data, lengths), "reverse hits")
        for x, y in zip(eng.lazy_spans(data, lengths, cap=2),
                        raw.lazy_spans(data, lengths, cap=2), strict=True):
            _eq(x, y, "lazy spans")
    st = np.random.default_rng(1).integers(-1, 60, size=len(lengths)).astype(np.int32)
    _eq(eng.first_end_from(data, lengths, st, longest=True),
        raw.first_end_from(data, lengths, st, longest=True), "first_end_from")
    for x, y in zip(eng.greedy_spans(data, lengths, cap=2), raw.greedy_spans(data, lengths, cap=2),
                    strict=True):
        _eq(x, y, "greedy spans")
