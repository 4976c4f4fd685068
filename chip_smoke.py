#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (roaringregex_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when
its check fails:

1. the card's name and power limit; build the CUDA kernels from
   roaringregex_tpu_torch/csrc with nvcc for sm_90a, with nvcc's register
   report and the build time;
2. kernel against plain PyTorch version on the card, for both entry points
   (rrx_swar_stats, rrx_word_stats): the SWAR and u32-word test patterns,
   seeded and unseeded, lead 0 and h, random batches from a numpy seed plus
   edge records (empty, len == L, bytes >= 0x80, byte 0); integer outputs,
   tolerance 0;
3. the main path, with the launch counts set to 0 first: bench config 1
   (cat|dog over 10 MB of 1024-byte records) through
   ScanEngine.match_stats, which must take the (4, 256, 3) window split,
   checked against an independent numpy count of cat/dog; then
   Pattern.search_batch and fullmatch_batch for configs 2 and 3 and a
   u32-word pattern against Python's re on 2,000 records;
4. real size: cat|dog over 1 GiB of 1024-byte records through the engine
   (the last main-path run; the counts are read after it), then kernel
   and plain version timed with CUDA events (median of 7 runs of 5-20
   back-to-back kernel calls, and of 5 plain calls, after warm-up) and
   compared.

Prints the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}. Needs torch built for CUDA, numpy and nvcc;
imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time

SWAR_PATTERNS = [
    "cat|dog", "(ab)*c+d?", "(cat|dog)*", "^ab?c$", "[a-c]x{0,2}$", "a*",
    "(a|b)(c|d)", "a\\.b", "[^a-c]", "a+b", "a.b", "...", "(a|.)c",
    "(a|$)*", "$?", "(a$)?", "(^|a)b*",
]
WORD_PATTERNS = [
    "(ab|cd)+e{2,3}fgh", "abcdefghij", "[a-f]{2,6}z", "(cat|dog|bird)+",
    "a{10,20}", "^[a-z]{3,8}[.]log$", "(ab)*c+d?", "x(yz|zy)*x$",
    "a*b*c*d*e*", "[^a]{1,3}|[ab]a{2}a?(a|bc)|0{2}(a|b)",
    ".[ab]x|q{2}[cd]y{2}z",
]
WORD_BENCH = "(cat|dog|bird)+"
SOURCE = "roaringregex_tpu_torch/csrc/scan_bits.cu"
REPLACES = {
    "rrx_swar_stats": "roaringregex_tpu/ops/scan_swar.py:526",
    "rrx_word_stats": "roaringregex_tpu/ops/scan_word.py:169",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def edge_batch(rng, np, R: int, L: int, alphabet: bytes):
    """Random records over ``alphabet`` plus the edge records."""
    a = np.frombuffer(alphabet, np.uint8)
    data = rng.choice(a, size=(R, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    lengths[0] = 0  # empty
    lengths[1:4] = L  # len == L: the EOS step is the stream's last
    data[4, :4] = [ord("a"), 0xFE, ord("b"), 0x80]  # bytes >= 0x80
    data[5, :3] = [ord("a"), 0x00, ord("b")]  # byte 0 inside the record
    data[6, :] = 0  # all zero bytes
    data[7, :] = 0xFF
    lengths[4:8] = np.array([4, 3, L, L], np.int32)
    return data, lengths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np

    from roaringregex_tpu_torch.api import compile as rrx_compile
    from roaringregex_tpu_torch.compiler.program import compile_program
    from roaringregex_tpu_torch.engine import ScanEngine
    from roaringregex_tpu_torch.ops import _build, scan_bits, scan_swar, scan_word

    dev = torch.device("cuda:0")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}, {n_sm} SMs)")

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    build_s = time.perf_counter() - t0
    print(f"build: {_build.BUILD.path} ({'nvcc ' + ' '.join(_build.ARCH_FLAGS)}; "
          f"built={_build.BUILD.built}, nvcc {_build.BUILD.seconds:.1f}s, total {build_s:.1f}s)")
    for line in _build.BUILD.ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    entries = {
        "rrx_swar_stats": (scan_swar.swar_stats, scan_swar.swar_spec, scan_swar.swar_tables, SWAR_PATTERNS),
        "rrx_word_stats": (scan_word.word_stats, scan_word.word_spec, scan_word.word_tables, WORD_PATTERNS),
    }
    max_err = {name: 0 for name in entries}

    def compare(name, got, want, tag):
        for label, x, y in zip(("cnt", "first", "last", "full"), got, want):
            x64, y64 = x.to(torch.int64), y.to(torch.int64)
            err = int((x64 - y64).abs().max().item()) if x.numel() else 0
            max_err[name] = max(max_err[name], err)
            if err != 0:
                bad = torch.nonzero(x64 != y64)[:5].flatten().tolist()
                fail(f"{name} {tag} {label}: kernel != plain at records {bad}")

    # -- phase 2: kernel against plain on the card ------------------------
    rng = np.random.default_rng(0)
    n_cmp = 0
    t0 = time.perf_counter()
    for name, (wrapper, spec_fn, tables_fn, patterns) in entries.items():
        before = wrapper.launches
        for pattern in patterns:
            prog = compile_program(pattern)
            spec = spec_fn(prog)
            if spec is None:
                fail(f"{pattern!r} does not fit {name}")
            tables = scan_bits.device_tables(*tables_fn(spec), dev)
            h = prog.horizon or 3
            for R, L in ((1000, 61), (1024, 64)):
                data, lengths = edge_batch(rng, np, R, L, b"abcdefghijlogqtxyz.\x00")
                d = torch.from_numpy(data).to(dev)
                ln = torch.from_numpy(lengths).to(dev)
                for seeded in (True, False):
                    for lead in (0, h):
                        kw = dict(seeded=seeded, lead=lead, nullable=prog.nullable)
                        got = wrapper(d, ln, tables, **kw)
                        want = scan_bits.stats_plain(d, ln, tables, **kw)
                        compare(name, got, want, f"{pattern!r} R={R} L={L} {kw}")
                        n_cmp += 1
        if wrapper.launches <= before:
            fail(f"{name}: launch count did not rise in the comparison")
    torch.cuda.synchronize()
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches, both entry points "
          f"({time.perf_counter() - t0:.1f}s)")

    # -- phase 3: the main path (counts from here to the end of phase 4's engine run)
    import bench

    scan_swar.swar_stats.launches = 0
    scan_word.word_stats.launches = 0
    data, lengths = bench.make_corpus(10_000_000, 1024, seed=0)
    B0 = data.shape[0]
    G = compile_program("cat|dog").G
    pad = -B0 % G
    data_p = np.pad(data, ((0, pad), (0, 0)))
    lengths_p = np.pad(lengths, (0, pad))
    eng = ScanEngine(compile_program("cat|dog"), device=dev)
    win = eng.device_scanner._swar_window(data_p.shape[1], data_p.shape[0], True)
    if win != (4, 256, 3):
        fail(f"config 1 window route {win}, expected (4, 256, 3)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cnt, first, anym = eng.match_stats(data_p, lengths_p, seeded=True)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    cnt, first, anym = (x.cpu().numpy()[:B0] for x in (cnt, first, anym))
    hits = np.zeros(data.shape, bool)  # hits[r, j]: a match ends after byte j
    for word in (b"cat", b"dog"):
        w = np.frombuffer(word, np.uint8)
        hits[:, 2:] |= (data[:, :-2] == w[0]) & (data[:, 1:-1] == w[1]) & (data[:, 2:] == w[2])
    want_cnt = hits.sum(axis=1)
    want_first = np.where(hits.any(axis=1), hits.argmax(axis=1) + 1, -1)
    if not (np.array_equal(cnt, want_cnt) and np.array_equal(first, want_first)
            and np.array_equal(anym, want_cnt > 0)):
        fail("config 1 (cnt, first, any) disagree with the numpy count")
    print(f"phase 3: config 1 cat|dog, {B0} records x 1024 B, window route {win}: "
          f"matches={int(cnt.sum())} records_with_match={int(anym.sum())} == numpy count "
          f"(first call {first_call_s * 1e3:.1f} ms)")

    def sample(seed, n, maxlen, alphabet, plants):
        r = np.random.default_rng(seed)
        a = np.frombuffer(alphabet, np.uint8)
        out = []
        for _ in range(n):
            t = bytearray(r.choice(a, size=int(r.integers(0, maxlen + 1))).tobytes())
            if r.random() < 0.5:
                w = plants[int(r.integers(len(plants)))]
                at = int(r.integers(0, len(t) + 1))
                t[at:at] = w
            out.append(bytes(t))
        return out

    c2, _ = bench.make_corpus(2000 * 256, 256, seed=2, plant=(b"x" * 250 + b"ab.log",))
    cuts = np.random.default_rng(3).integers(200, 257, size=c2.shape[0])
    samples = {
        "[a-z]+\\.log$": [bytes(row[:k]) for row, k in zip(c2, cuts)]
        + [bytes(row) for row in c2[:200]],
        "(ab)*c+d?": sample(4, 2000, 40, b"abcdx", [b"ababccd", b"abc", b"ccc", b"abd"]),
        "^[a-z]{3,8}[.]log$": sample(5, 2000, 10, b"abcxyz.", [b".log", b"abcd.log"]),
    }
    api_batches = []
    for pattern, texts in samples.items():
        pat = rrx_compile(pattern, dev)
        api_batches.append((pat, texts))
        rx = re.compile(pattern.encode())
        got_s = pat.search_batch(texts)
        got_f = pat.fullmatch_batch(texts)
        want_s = np.array([rx.search(t) is not None for t in texts])
        want_f = np.array([rx.fullmatch(t) is not None for t in texts])
        if not (np.array_equal(got_s, want_s) and np.array_equal(got_f, want_f)):
            fail(f"{pattern!r}: search/fullmatch disagree with re")
        print(f"phase 3: {pattern!r} ({type(pat.engine.device_scanner).__name__}) on "
              f"{len(texts)} records: search {int(got_s.sum())} / fullmatch "
              f"{int(got_f.sum())} hits == re")

    # -- phase 4: real size -----------------------------------------------
    R, L = 1 << 20, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    big = torch.randint(ord("a"), ord("z") + 1, (R, L), dtype=torch.uint8, device=dev, generator=gen)
    prng = np.random.default_rng(6)
    for word in (b"cat", b"dog"):
        rows = torch.from_numpy(prng.integers(0, R, size=R // 8)).to(dev)
        cols = torch.from_numpy(prng.integers(0, L - 3, size=R // 8)).to(dev)
        for i, ch in enumerate(word):
            big[rows, cols + i] = ch
    big_len = torch.full((R,), L, dtype=torch.int32, device=dev)
    if eng.device_scanner._swar_window(L, R, True) is not None:
        fail("1 GiB batch should not window")
    bcnt, bfirst, bany = eng.match_stats(big, big_len, seeded=True)
    torch.cuda.synchronize()
    launches = {
        "rrx_swar_stats": scan_swar.swar_stats.launches,
        "rrx_word_stats": scan_word.word_stats.launches,
    }
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
    print(f"main path launches: {launches}")
    nbytes = R * L
    print(f"phase 4: cat|dog over {R} records x {L} B ({nbytes} bytes): "
          f"matches={int(bcnt.sum().item())} records_with_match={int(bany.sum().item())}")

    def time_ms(fn, warm: int, runs: int, per_run: int = 1) -> float:
        """Median over ``runs`` of the CUDA-event time of ``per_run``
        back-to-back calls, divided by ``per_run``."""
        for _ in range(warm):
            fn()
        ts = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per_run):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / per_run)
        return float(np.median(ts))

    props = torch.cuda.get_device_properties(0)
    max_threads = props.max_threads_per_multi_processor

    def occupancy(name, tables, rows):
        bps = ctypes.c_int(0)
        word = int(name == "rrx_word_stats")
        _build.check(lib.rrx_occupancy(word, int(tables.deltas.numel()), ctypes.byref(bps)),
                     "rrx_occupancy")
        tpb = lib.rrx_threads_per_block()
        blocks = -(-rows // tpb)
        resident = min(blocks, bps.value * n_sm)
        return (f"theoretical {bps.value * tpb}/{max_threads} threads per SM "
                f"({100.0 * bps.value * tpb / max_threads:.1f}%); grid {blocks} blocks of {tpb} "
                f"-> at most {100.0 * resident * tpb / (n_sm * max_threads):.1f}% of the card's "
                f"resident-thread slots filled")

    # kernel against plain at the shapes the API batches above gave it
    for pat, texts in api_batches:
        sc = pat.engine.device_scanner
        name = "rrx_swar_stats" if isinstance(sc, scan_swar.SwarScanner) else "rrx_word_stats"
        data_a, lengths_a, _, _ = pat._pack(texts)
        d = torch.from_numpy(data_a).to(dev)
        ln = torch.from_numpy(lengths_a).to(dev)
        for seeded in (True, False):
            kw = dict(seeded=seeded, lead=0, nullable=pat.program.nullable)
            compare(name, entries[name][0](d, ln, sc.tables, **kw),
                    scan_bits.stats_plain(d, ln, sc.tables, **kw),
                    f"{pat.pattern!r} API batch {tuple(d.shape)}")
    print("phase 4: kernel == plain on the phase-3 API batches, seeded and unseeded")

    # the config-1 headline at its own shape: the windowed batch
    sc = eng.device_scanner
    d10 = torch.from_numpy(data_p).to(dev)
    l10 = torch.from_numpy(lengths_p).to(dev)
    k, w, h = win
    wind, lnw, _ = sc.windows(d10, l10, k, w, h)
    kw = dict(seeded=True, lead=h, nullable=False)
    got = scan_swar.swar_stats(wind, lnw, sc.tables, **kw)
    compare("rrx_swar_stats", got, scan_bits.stats_plain(wind, lnw, sc.tables, **kw), "10 MB windows")
    n10 = int(lengths.sum())
    ms_k = time_ms(lambda: scan_swar.swar_stats(wind, lnw, sc.tables, **kw), warm=2, runs=7, per_run=20)
    ms_p = time_ms(lambda: scan_bits.stats_plain(wind, lnw, sc.tables, **kw), warm=1, runs=5)
    ms_e = time_ms(lambda: sc.match_stats_b(d10, l10.reshape(-1, G), seeded=True), warm=2, runs=7, per_run=20)
    print(f"phase 4: rrx_swar_stats config 1 windows [{wind.shape[0]} x {wind.shape[1]}]: "
          f"kernel {ms_k:.3f} ms = {n10 / ms_k / 1e6:.1f} GB/s, plain {ms_p:.3f} ms = "
          f"{n10 / ms_p / 1e6:.2f} GB/s; match_stats_b end to end {ms_e:.3f} ms = "
          f"{n10 / ms_e / 1e6:.1f} GB/s [{card}]")
    print(f"  occupancy rrx_swar_stats (10 MB windows): "
          f"{occupancy('rrx_swar_stats', sc.tables, wind.shape[0])}")

    kernels = []
    for name, pattern in (("rrx_swar_stats", "cat|dog"), ("rrx_word_stats", WORD_BENCH)):
        wrapper, spec_fn, tables_fn, _ = entries[name]
        prog = compile_program(pattern)
        tables = scan_bits.device_tables(*tables_fn(spec_fn(prog)), dev)
        kw = dict(seeded=True, lead=0, nullable=prog.nullable)
        got = wrapper(big, big_len, tables, **kw)
        want = scan_bits.stats_plain(big, big_len, tables, **kw)
        compare(name, got, want, f"{pattern!r} 1 GiB")
        if name == "rrx_swar_stats" and not torch.equal(got[0], bcnt):
            fail("1 GiB engine count != direct kernel count")
        ms = time_ms(lambda: wrapper(big, big_len, tables, **kw), warm=2, runs=7, per_run=5)
        plain_ms = time_ms(lambda: scan_bits.stats_plain(big, big_len, tables, **kw), warm=1, runs=5)
        print(f"phase 4: {name} {pattern!r} 1 GiB: kernel {ms:.3f} ms = {nbytes / ms / 1e6:.1f} GB/s, "
              f"plain {plain_ms:.3f} ms = {nbytes / plain_ms / 1e6:.2f} GB/s, outputs equal "
              f"[{card}]")
        print(f"  occupancy {name} (1 GiB): {occupancy(name, tables, R)}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
        })

    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
