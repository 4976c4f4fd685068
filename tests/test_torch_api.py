"""The port's Pattern entry points (CPU, plain PyTorch versions) against
the JAX package's Pattern (Pallas interpret mode), on the bench configs
1-3 and one u32-word-tier pattern."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import roaringregex_tpu as jax_rrx
import roaringregex_tpu_torch as rrx
from roaringregex_tpu.compiler.nfa import build_nfa
from roaringregex_tpu.oracle.engine import OracleEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (pattern, tier, longest text): config 1's texts are long enough that
# the batch takes the SWAR window route, as the bench corpus does
CASES = [
    ("cat|dog", "SwarScanner", 300),
    ("[a-z]+\\.log$", "SwarScanner", 60),
    ("(ab)*c+d?", "SwarScanner", 60),
    ("^[a-z]{3,8}[.]log$", "WordScanner", 20),
]


def _texts(seed, n, maxlen):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdglotx.", np.uint8)
    plants = [b"cat", b"dog", b"ab.log", b"abcd", b"ccd", b".log"]
    out = [b"", b"cat", b"abc.log", b"ab", b"abcdefgh.log", b"x.log", b"abababccc"]
    while len(out) < n:
        t = bytearray(rng.choice(alphabet, size=int(rng.integers(0, maxlen))).tobytes())
        if rng.random() < 0.5:
            w = plants[int(rng.integers(len(plants)))]
            at = int(rng.integers(0, len(t) + 1))
            t[at:at] = w
        out.append(bytes(t[:maxlen]))
    return out


@pytest.mark.parametrize("pattern,scanner,maxlen", CASES)
def test_pattern_entry_points_match_jax(pattern, scanner, maxlen):
    port = rrx.compile(pattern, "cpu")
    ref = jax_rrx.compile(pattern, backend="pallas")
    assert type(port.engine.device_scanner).__name__ == scanner
    assert type(ref.engine.device_scanner).__name__ == scanner
    texts = _texts(sum(pattern.encode()), 100, maxlen)
    np.testing.assert_array_equal(port.count_batch(texts), np.asarray(ref.count_batch(texts)))
    np.testing.assert_array_equal(port.search_batch(texts), np.asarray(ref.search_batch(texts)))
    np.testing.assert_array_equal(port.fullmatch_batch(texts), np.asarray(ref.fullmatch_batch(texts)))
    assert port.grep(texts) == ref.grep(texts)
    # the JAX Pattern's fullmatch of each single text, in one batch with
    # ``texts`` (the shape its fullmatch_batch compiled; records are
    # independent)
    singles = ["cat", "abc.log", "ababcc"]
    full = np.asarray(ref.fullmatch_batch(singles + texts))
    for t, f in zip(singles, full):
        a = port.fullmatch(t)
        assert (a is None) == (not f), t
        assert a is None or (a.span(), a.group()) == ((0, len(t)), t.encode())


def test_windowed_api_route():
    """Config 1's API batch above is long enough to take the window split."""
    port = rrx.compile("cat|dog", "cpu")
    data, lengths, B, _ = port._pack(_texts(0, 100, 300))
    sc = port.engine.device_scanner
    assert sc._swar_window(data.shape[1], data.shape[0], True) is not None


def test_unported_tier_raises():
    """a*b{1,300} has neither a counting plan nor a seeded alias: it runs on
    the container tier (the JAX ``SparseScanner``), which answers every
    entry point as the oracle does."""
    pat = rrx.compile("a*b{1,300}", "cpu")
    assert type(pat.engine.device_scanner).__name__ == "SparseScanner"
    orc = OracleEngine(build_nfa("a*b{1,300}"))
    texts = [b"", b"b", b"aab", b"xaabbx", b"ab" * 20, b"a" * 30, b"c" + b"b" * 310 + b"ab"]
    ends = [sorted(orc.ends(t)) for t in texts]
    np.testing.assert_array_equal(pat.count_batch(texts), [len(e) for e in ends])
    np.testing.assert_array_equal(pat.search_batch(texts), [bool(e) for e in ends])
    np.testing.assert_array_equal(pat.fullmatch_batch(texts), [orc.fullmatch(t) for t in texts])
    assert pat.ends_batch(texts) == ends
    for longest in (False, True):
        assert pat.finditer_batch(texts, longest=longest) == [
            list(orc.finditer(t, longest=longest)) for t in texts]


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import roaringregex_tpu_torch as r\n"
        "import roaringregex_tpu_torch.ops._build, roaringregex_tpu_torch.utils\n"
        "assert r.compile('cat|dog', 'cpu').count_batch(['catdog'])[0] == 2\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'roaringregex_tpu.')) or m == 'roaringregex_tpu')\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
