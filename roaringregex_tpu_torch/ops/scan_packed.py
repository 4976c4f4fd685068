"""The mask-stream ("packed") backend: scans over a precomputed symbol-mask stream.

The port of ``roaringregex_tpu/ops/scan_packed.py``. The per-byte symbol
mask ``Bc[class(byte)]`` depends on one byte only, so it is computed for
the whole batch in one parallel pass (:func:`mask_stream_from_bytes`) and
stored bit-packed; the sequential scan then reads one mask row a step and
needs no byte -> class lookup. The four primitives over that stream,
:func:`match_stats`, :func:`forward_flags`, :func:`reverse_hits` and
:func:`first_end_from` (lazy and ``longest``), are the engine's ``packed``
backend (``ScanEngine(prog, device, backend="packed")``) and its anchored
rescans of the dense and multiblock programs whose scanner has no anchored
kernels (the counting tier's config 4, ``a{1,300}``; the container tier's
multiblock programs), as in the JAX engine (``engine.py:825-835``). The
stream-fed methods of ``scan_pallas.PallasScanner`` run on the same four;
those of ``scan_sparse.SparseScanner`` and ``scan_bitband.BitbandScanner``
take the same stream on the container kernels (``scan_sparse``).

Layout. The JAX package packs G records of ``s_tile`` lanes into one
128- or 256-lane MXU row (``words[t, row, w]``); that is a TPU layout. The
port keeps one record per row: ``words`` [T, B, Wt] int32 (uint32 bit
patterns), T = L + 2 steps (BOS | the bytes | EOS at the record's end |
dead zero rows after it), Wt = ceil(s_tile / 32) words a record-step, bit s
of word s // 32 the mask of state s: the layout of ``Bc_words`` and of the
matmul tier's mask rows (``scan_pallas.nfa_tables``). For a program of
one record per row (G = 1: dense256 and multiblock) it is the JAX stream
itself. Outputs are per record (and per accept channel), in the order of
the JAX package's [B_rows, G] outputs flattened.

Each primitive is a wrapper: on a CUDA tensor it launches its kernel of
``csrc/scan_stream.cu`` (``rrx_stream_stats``, ``rrx_stream_flags``,
``rrx_stream_reverse``, ``rrx_stream_first_end``; one thread per record at
tiles of up to 256 states, one warp per record at 257..1024, the matmul
tier's set-form step with the mask row read from the stream) and counts
it in ``<wrapper>.launches``; on a CPU tensor it runs its plain version, a
line-by-line port of the JAX function over one record per row: the state
set as a [B, S] 0/1 float32 plane, ``y = v @ F`` (exact: sums <= 1024),
``v = (y > 0) & unpack_bits(words[t])``, the accept test a product with
the accept rows. ``spans_rounds`` is not ported: only the sharded scanner
(``parallel/dist.py``) uses it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..compiler.program import DeviceProgram
from . import scan_bits as sb
from . import scan_pallas as spl

Tables = dict
MASK32 = sb.MASK32
# records of a chunk of mask_stream_from_bytes: its lookup holds ~64 MB
CHUNK_WORDS = 1 << 24


def _i32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.uint32)).view(np.int32))


def stream_tables(prog: DeviceProgram, device) -> Tables:
    """The byte -> mask translation of any program on ``device`` (dense,
    multiblock or sparse: the container and bitband scanners' stream-fed
    methods take a sparse program's stream, Wt = s_pad / 32): the byte runs
    of its class map (``run_lo``, ``run_hi``,
    ``run_cls`` [R] int64), the BOS and EOS mask words [Wt], the class
    masks ``Bc_words`` [c_pad, Wt] and ``byte_words`` [256, Wt], every
    byte's mask (zero for bytes >= 0x80, whose class is dead); mask words
    are int32 holding uint32 bit patterns; ``Wt`` is an int."""
    dev = torch.device(device)
    lo, hi, cl = prog.byte_runs
    Bw = np.asarray(prog.Bc_words, np.uint32)
    return {
        "run_lo": torch.from_numpy(np.asarray(lo, np.int64)).to(dev),
        "run_hi": torch.from_numpy(np.asarray(hi, np.int64)).to(dev),
        "run_cls": torch.from_numpy(np.asarray(cl, np.int64)).to(dev),
        "bos_words": _i32(Bw[prog.bos_class]).to(dev),
        "eos_words": _i32(Bw[prog.eos_class]).to(dev),
        "Bc_words": _i32(Bw).to(dev),
        "byte_words": _i32(Bw[np.asarray(prog.byte_class)]).to(dev),
        "Wt": int(Bw.shape[1]),
    }


def packed_tables(prog: DeviceProgram, device, accept_map=None, P: int = 1) -> Tables:
    """:func:`stream_tables` plus ``nfa``: the matmul tier's rows of one
    record tile (``scan_pallas.device_nfa_tables``: follow, pred and the
    accept rows, or with ``accept_map`` [lanes, G * P] one accept row per
    channel), which the kernels and the plain versions step. Dense and
    multiblock tiers only (a tile of at most 1024 states), as in the JAX
    package: a sparse program raises ValueError."""
    if prog.tier == "sparse":
        raise ValueError(f"{prog.pattern!r}: the packed engine covers the dense and multiblock "
                         "tiers only; a sparse program runs on the XLA backend")
    t = stream_tables(prog, device)
    t["nfa"] = spl.device_nfa_tables(prog, device, accept_map, P)
    return t


# ---------------------------------------------------------------------------
# The mask stream (torch ops on any device, outside any kernel)
# ---------------------------------------------------------------------------


def mask_stream_from_bytes(tables: Tables, data: torch.Tensor, lengths: torch.Tensor
                           ) -> torch.Tensor:
    """Bytes -> the [L + 2, B, Wt] int32 mask stream in one parallel pass:
    row 0 the BOS mask; row j + 1 the mask of byte j for j < len, the EOS
    mask at j == len, zero after it (j runs to L: the EOS of a record that
    fills its row). Each byte's mask is one lookup in ``byte_words``, in
    chunks of records that keep the lookup near 64 MB. The same stream as
    ``pack_mask_stream(encode_classes_fast(...))``."""
    B, L = data.shape
    Wt = tables["Wt"]
    dev = data.device
    out = torch.empty((L + 2, B, Wt), dtype=torch.int32, device=dev)
    out[0] = tables["bos_words"]
    if B == 0:
        return out
    bw, eos = tables["byte_words"], tables["eos_words"]
    j = torch.arange(L + 1, device=dev)[None, :, None]
    ln = lengths.to(torch.int64)
    step = max(1, CHUNK_WORDS // ((L + 1) * Wt))
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        w = torch.nn.functional.pad(bw[data[b0:b1].to(torch.int64)], (0, 0, 0, 1))
        n = ln[b0:b1, None, None]
        w = torch.where(j < n, w, torch.where(j == n, eos, torch.zeros_like(eos)))
        out[1:, b0:b1] = w.transpose(0, 1)
    return out


def encode_classes_fast(tables: Tables, data: torch.Tensor, lengths: torch.Tensor, *,
                        bos_class: int, eos_class: int) -> torch.Tensor:
    """[B, L + 2] int64 class ids by range compares against the byte runs
    (no gather; dead bytes and the steps after EOS are class 0): the JAX
    package's gather-free drop-in for ``scan_xla.encode_stream``."""
    B, L = data.shape
    dd = torch.nn.functional.pad(data, (0, 1)).to(torch.int64)
    cls = torch.zeros((B, L + 1), dtype=torch.int64, device=data.device)
    for r in range(tables["run_lo"].numel()):
        hit = (dd >= tables["run_lo"][r]) & (dd <= tables["run_hi"][r])
        cls = cls | torch.where(hit, tables["run_cls"][r], 0)
    j = torch.arange(L + 1, device=data.device)[None, :]
    n = lengths.to(torch.int64)[:, None]
    cls = torch.where(j < n, cls, torch.where(j == n, eos_class, 0))
    bos = torch.full((B, 1), bos_class, dtype=torch.int64, device=data.device)
    return torch.cat([bos, cls], dim=1)


def pack_mask_stream(tables: Tables, cls: torch.Tensor) -> torch.Tensor:
    """[B, T] class ids -> the [T, B, Wt] int32 mask stream (one record per
    row: the port's layout of the JAX package's lane-packed words)."""
    return tables["Bc_words"][cls].transpose(0, 1).contiguous()


def unpack_bits(words: torch.Tensor, S: int) -> torch.Tensor:
    """[..., Wt] int32 words -> [..., S] bool, bit s of word s // 32."""
    sh = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & MASK32)[..., None] >> sh) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :S] != 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the JAX functions, line by line, one record a row
# ---------------------------------------------------------------------------


def _planes(nfa: spl.NfaTables, dev):
    """(follow F [S, S] float32, pred-of F^T [S, S] float32, seed [S] bool
    (the initial state), accept rows A [S, P] float32, the union of the
    accept rows [S] float32)."""
    pt = nfa.plain(dev)
    S = nfa.s_tile
    seed = torch.zeros(S, dtype=torch.bool, device=dev)
    seed[0] = True
    return pt.F, pt.P, seed, pt.accs.to(torch.float32).T, pt.acc.to(torch.float32)


def match_stats_plain(nfa: spl.NfaTables, words: torch.Tensor, lengths: torch.Tensor, *,
                      seeded: bool, nullable: bool, n_seed_steps: int = 2):
    """Plain version of :func:`match_stats` (JAX ``scan_packed.match_stats``)."""
    T, B, _ = words.shape
    dev = words.device
    F, _, seed, A, _ = _planes(nfa, dev)
    S = nfa.s_tile
    len_c = lengths.to(torch.int64)[:, None].expand(B, A.shape[1])
    v = seed.expand(B, S).clone()
    if nullable:
        cnt = len_c + 1 if seeded else torch.ones_like(len_c)
        first = torch.zeros_like(len_c)
        last = len_c.clone() if seeded else torch.zeros_like(len_c)
    else:
        cnt = torch.zeros_like(len_c)
        first = torch.full_like(len_c, -1)
        last = torch.full_like(len_c, -1)
    for t in range(T):
        if seeded or t < n_seed_steps:
            v = v | seed
        y = v.to(torch.float32) @ F
        v = (y > 0) & unpack_bits(words[t], S)
        flag = (v.to(torch.float32) @ A) > 0
        e = len_c.clamp(max=t)
        if not (nullable and seeded):
            cnt = cnt + (flag & (e != last)).to(torch.int64)
        first = torch.where((first < 0) & flag, e, first)
        last = torch.where(flag, e, last)
    cnt = cnt.to(torch.int32)
    out = (cnt, first.to(torch.int32), cnt > 0)
    return out if nfa.channels else tuple(x[:, 0].contiguous() for x in out)


def forward_flags_plain(nfa: spl.NfaTables, words: torch.Tensor, *, seeded: bool,
                        n_seed_steps: int = 2) -> torch.Tensor:
    """Plain version of :func:`forward_flags` (JAX ``scan_packed.forward_flags``)."""
    T, B, _ = words.shape
    dev = words.device
    F, _, seed, _, acc = _planes(nfa, dev)
    S = nfa.s_tile
    v = seed.expand(B, S).clone()
    flags = torch.zeros((B, T + 1), dtype=torch.bool, device=dev)
    flags[:, 0] = bool(acc[0] > 0)  # the initial state accepts: the nullability
    for t in range(T):
        if seeded or t < n_seed_steps:
            v = v | seed
        y = v.to(torch.float32) @ F
        v = (y > 0) & unpack_bits(words[t], S)
        flags[:, t + 1] = (v.to(torch.float32) @ acc) > 0
    return flags


def reverse_hits_plain(nfa: spl.NfaTables, words: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`reverse_hits` (JAX ``scan_packed.reverse_hits``)."""
    T, B, _ = words.shape
    dev = words.device
    _, Pm, _, _, acc = _planes(nfa, dev)
    S = nfa.s_tile
    r = torch.zeros((B, S), dtype=torch.bool, device=dev)
    hits = torch.zeros((B, T), dtype=torch.bool, device=dev)
    for j in range(T - 1, -1, -1):
        r = r | (acc > 0)
        masked = r & unpack_bits(words[j], S)
        r = (masked.to(torch.float32) @ Pm) > 0
        hits[:, j] = r[:, 0]
    return hits


def first_end_plain(nfa: spl.NfaTables, words: torch.Tensor, lengths: torch.Tensor,
                    starts: torch.Tensor, *, longest: bool = False) -> torch.Tensor:
    """Plain version of :func:`first_end_from` (JAX
    ``scan_packed.first_end_from``). Before the earliest seed step every
    state set is empty, and after the last one an empty set stays empty (a
    lazy scan is also done once every record has its end), so the loop
    covers only the steps between (checked every 32 steps): the same
    outputs as the JAX function's loop over all T steps."""
    T, B, _ = words.shape
    dev = words.device
    F, _, seed, _, acc = _planes(nfa, dev)
    S = nfa.s_tile
    ln = lengths.to(torch.int64)
    st = starts.to(torch.int64)
    first = torch.full((B,), -1, dtype=torch.int64, device=dev)
    valid = st >= 0
    if not bool(valid.any()):
        return first.to(torch.int32)
    t0 = int(torch.where(st == 0, 0, st + 1)[valid].min())
    t_seed = int((st + 1)[valid].max())
    v = torch.zeros((B, S), dtype=torch.bool, device=dev)
    for t in range(t0, T):
        gate = ((st == t - 1) | ((st == 0) & (t <= 1))) & valid
        v = v | (gate[:, None] & seed)
        y = v.to(torch.float32) @ F
        v = (y > 0) & unpack_bits(words[t], S)
        fl = (v.to(torch.float32) @ acc) > 0
        e = ln.clamp(max=t)
        ok = fl & (e >= st)
        if not longest:
            ok = ok & (first < 0)
        first = torch.where(ok, e, first)
        if t >= t_seed and t % 32 == 31 and not bool(
            v.any() if longest else (v.any(dim=1) & (first < 0)).any()
        ):
            break
    return first.to(torch.int32)


# ---------------------------------------------------------------------------
# Counted wrappers: a CUDA tensor goes to the kernel, a CPU tensor to the
# plain version
# ---------------------------------------------------------------------------


def _check_stream(words: torch.Tensor, nfa: spl.NfaTables) -> None:
    W = spl._words(nfa.s_tile)
    if words.dim() != 3 or words.shape[2] != W or words.dtype != torch.int32:
        raise ValueError(f"a mask stream of a {nfa.s_tile}-state tile is [T, B, {W}] int32, "
                         f"got {tuple(words.shape)} {words.dtype}")


def _launch(entry: str, words: torch.Tensor, nfa: spl.NfaTables, *args) -> None:
    """Launch ``entry`` on the current stream of ``words``' card: (words, T,
    R, tab, s_tile), ``args`` (tensors by pointer, ints as they are), the
    record counter of the warp form, then the stream. A refused launch
    raises."""
    from . import _build

    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on a CUDA tensor, got {dev}")
    words = words.contiguous()
    for x in args:
        if isinstance(x, torch.Tensor) and (x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{entry}: a {tuple(x.shape)} argument on {x.device} "
                             f"(contiguous: {x.is_contiguous()}), words on {dev}")
    T, R, _ = words.shape
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(words.data_ptr(), T, R, nfa.tab.data_ptr(),
                                   int(nfa.s_tile), *ptrs, nxt.data_ptr(), stream)
    _build.check(code, entry)


def _rows(name: str, x: torch.Tensor, R: int, dev) -> torch.Tensor:
    x = torch.as_tensor(x, device=dev).reshape(-1)
    if x.numel() != R:
        raise ValueError(f"{name} must hold one value per record ({R}), got {x.numel()}")
    return x.to(torch.int32).contiguous()


def match_stats(nfa: spl.NfaTables, words: torch.Tensor, lengths, *, seeded: bool,
                nullable: bool):
    """(count, first_end, any) per record, each [B], or [B, P] for tables
    with accept channels (per channel: a ``MultiPattern``'s patterns):
    count = distinct end positions e = min(t, len) with an accept (the
    `$` step's repeat of e = len counts once); a nullable scan starts from
    the closed form (count len + 1 seeded, 1 unseeded; first 0) and a
    nullable seeded one adds no end. ``rrx_stream_stats`` on a CUDA tensor
    (counted in ``match_stats.launches``), :func:`match_stats_plain` on a
    CPU tensor."""
    _check_stream(words, nfa)
    if words.device.type == "cpu":
        return match_stats_plain(nfa, words, torch.as_tensor(lengths), seeded=seeded,
                                 nullable=nullable)
    _, R, _ = words.shape
    dev = words.device
    lengths = _rows("lengths", lengths, R, dev)
    shape = (R, nfa.P) if nfa.channels else (R,)
    cnt, first, last = (torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(3))
    _launch("rrx_stream_stats", words, nfa, lengths, int(nfa.P), int(seeded), int(nullable),
            cnt, first, last)
    match_stats.launches += 1
    return cnt, first, cnt > 0


def flag_words(nfa: spl.NfaTables, words: torch.Tensor, *, seeded: bool) -> torch.Tensor:
    """``rrx_stream_flags`` on a CUDA tensor: flag words [ceil(T / 32), B]
    int32, bit t of record b in word t // 32 the accept flag of step t
    (counted in ``forward_flags.launches``)."""
    _check_stream(words, nfa)
    T, R, _ = words.shape
    fw = torch.empty((-(-T // 32), R), dtype=torch.int32, device=words.device)
    _launch("rrx_stream_flags", words, nfa, int(seeded), fw)
    forward_flags.launches += 1
    return fw


def forward_flags(nfa: spl.NfaTables, words: torch.Tensor, *, seeded: bool) -> torch.Tensor:
    """[B, T + 1] bool accept flags: column 0 is the initial state's
    acceptance (the nullability), column t + 1 step t's flag.
    :func:`flag_words` unpacked on a CUDA tensor,
    :func:`forward_flags_plain` on a CPU tensor."""
    _check_stream(words, nfa)
    if words.device.type == "cpu":
        return forward_flags_plain(nfa, words, seeded=seeded)
    T, R, _ = words.shape
    fw = flag_words(nfa, words, seeded=seeded)
    # column 0: state 0 in an accept row (word 0 of each), read on the card
    W = spl._words(nfa.s_tile)
    acc0 = nfa.tab[(2 * nfa.s_tile + spl.N_SYMS) * W :: W][: nfa.P] & 1
    return torch.cat([(acc0 != 0).any().expand(R, 1), sb.hit_bits(fw, T)], dim=1)


def hit_words(nfa: spl.NfaTables, words: torch.Tensor) -> torch.Tensor:
    """``rrx_stream_reverse`` on a CUDA tensor: hit words [ceil(T / 32), B]
    int32, bit j set iff some match starts at max(j - 1, 0) (counted in
    ``reverse_hits.launches``)."""
    _check_stream(words, nfa)
    T, R, _ = words.shape
    hw = torch.empty((-(-T // 32), R), dtype=torch.int32, device=words.device)
    _launch("rrx_stream_reverse", words, nfa, hw)
    reverse_hits.launches += 1
    return hw


def reverse_hits(nfa: spl.NfaTables, words: torch.Tensor) -> torch.Tensor:
    """[B, T] bool: column j is set iff some match starts at max(j - 1, 0).
    :func:`hit_words` unpacked on a CUDA tensor, :func:`reverse_hits_plain`
    on a CPU tensor."""
    _check_stream(words, nfa)
    if words.device.type == "cpu":
        return reverse_hits_plain(nfa, words)
    return sb.hit_bits(hit_words(nfa, words), words.shape[0])


def first_end_from(nfa: spl.NfaTables, words: torch.Tensor, lengths, starts, *,
                   longest: bool = False) -> torch.Tensor:
    """[B] int32 anchored end per record: the smallest end e >= s such that
    text[s:e] matches (lazy), or with ``longest`` the largest; -1 if none
    or the record is inactive (start -1). Start s seeds the initial state
    into step s + 1, and s = 0 also into step 0. ``rrx_stream_first_end``
    on a CUDA tensor (counted in ``first_end_from.launches``),
    :func:`first_end_plain` on a CPU tensor."""
    _check_stream(words, nfa)
    if words.device.type == "cpu":
        return first_end_plain(nfa, words, torch.as_tensor(lengths), torch.as_tensor(starts),
                               longest=longest)
    _, R, _ = words.shape
    dev = words.device
    end = torch.empty(R, dtype=torch.int32, device=dev)
    _launch("rrx_stream_first_end", words, nfa, _rows("lengths", lengths, R, dev),
            _rows("starts", starts, R, dev), int(longest), end)
    first_end_from.launches += 1
    return end


for _w in (match_stats, forward_flags, reverse_hits, first_end_from):
    _w.launches = 0
