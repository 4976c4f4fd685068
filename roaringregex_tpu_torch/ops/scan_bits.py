"""Shared core of the SWAR and u32-word scan tiers: the (delta, table)
form of a bit-set automaton, the plain PyTorch versions of its scans, and
the launchers of the CUDA kernels in ``csrc/scan_bits.cu`` (forward match
statistics) and ``csrc/scan_spans.cu`` (reverse hits, anchored rescans,
lazy and greedy spans).

Both TPU kernels (``_swar_kernel``, ``_word_kernel``) step a record's
state set as ``v' = OR over (delta, gate, mask) of shift(v | seed, delta)
& mask, where the step's byte is in the gate``. Folding every gate into a
per-symbol table gives one form for both:

    v' = OR_i shift(v | seed, delta_i) & tab[sym][i]

with ``tab[sym][i]`` the union of the target masks of the pairs at
``delta_i`` whose gate holds ``sym`` (a byte 0..255, 256 = BOS, 257 =
EOS, 258 = a dead step past EOS). ``scan_swar.swar_tables`` and
``scan_word.word_tables`` build it from their specs; the per-tier modules
own the wrappers (and their launch counts) around the plain versions and
the launchers here.

The mirrored automaton of the span path runs the same pairs target ->
source and needs no table of its own:

    R' = OR_i unshift(R & tab[sym][i], delta_i)

(unshift is ``>> delta`` for delta > 0 and ``<< -delta`` for delta < 0).
Its candidate-start bits travel as hit words: [W, R] int32 (uint32 bit
patterns), W = ceil((L + 2) / 32), bit t of record r in word t // 32.

The plain versions of the span path (reverse hits, anchored rescans, lazy
and greedy spans) serve this form and the matmul tier's
(``scan_pallas.NfaTables``) alike: each table form gives them a stepper
(``tables.plain(device)``) with the forward step, the accept test, the
reverse step and the start bit, and the bookkeeping around the steps is
written once.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

BIG = 1 << 30
N_SYMS = 259
SYM_BOS, SYM_EOS, SYM_DEAD = 256, 257, 258
MASK32 = 0xFFFFFFFF


class ScanTables(NamedTuple):
    """Device copy of one program's (delta, table) form."""

    tab: torch.Tensor  # [N_SYMS, n_delta] int32 (uint32 bit patterns)
    deltas: torch.Tensor  # [n_delta] int32, target - source
    acc: int  # accepting-state mask (with channels: their union)
    # [P] int32 per-channel accept masks (a multi-pattern program's accept
    # channels), or None for one channel, ``acc``
    accs: Optional[torch.Tensor] = None

    @property
    def P(self) -> int:
        """Number of accept channels."""
        return 1 if self.accs is None else int(self.accs.numel())

    def plain(self, dev) -> "_Plain":
        """The stepper of the plain versions on ``dev``."""
        return _Plain.of(self, dev)


def dg_tables(
    gates: Sequence, pairs: Dict[Tuple[int, int], int], acc: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """(deltas [n] int32, tab [N_SYMS, n] uint32, acc) from deduped gates
    ``((runs, bos, eos), ...)`` and ``{(delta, gate index): target mask}``."""
    deltas = sorted({d for d, _ in pairs})
    col = {d: i for i, d in enumerate(deltas)}
    tab = np.zeros((N_SYMS, len(deltas)), np.uint32)
    for (d, gid), mask in pairs.items():
        runs, bos, eos = gates[gid]
        i = col[d]
        for lo, hi in runs:
            tab[lo : hi + 1, i] |= np.uint32(mask)
        if bos:
            tab[SYM_BOS, i] |= np.uint32(mask)
        if eos:
            tab[SYM_EOS, i] |= np.uint32(mask)
    tab[0x80:256] = 0  # bytes >= 0x80 are outside the alphabet
    return np.asarray(deltas, np.int32), tab, int(acc) & MASK32


def device_tables(deltas: np.ndarray, tab: np.ndarray, acc: int, device,
                  accs: Optional[Sequence[int]] = None) -> ScanTables:
    """``accs``: per-channel accept masks (``acc`` is then their union)."""
    if accs is not None:
        accs = torch.from_numpy(np.asarray(accs, np.uint32).view(np.int32).copy()).to(device)
    return ScanTables(
        tab=torch.from_numpy(tab.view(np.int32).copy()).to(device),
        deltas=torch.from_numpy(deltas.astype(np.int32)).to(device),
        acc=acc,
        accs=accs,
    )


def _check_inputs(data: torch.Tensor, lengths: torch.Tensor) -> None:
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"data must be [R, L] uint8, got {tuple(data.shape)} {data.dtype}")
    if lengths.dim() != 1 or lengths.numel() != data.shape[0]:
        raise ValueError(
            f"lengths must be [R] with R = {data.shape[0]}, got {tuple(lengths.shape)}"
        )
    if lengths.device != data.device:
        raise ValueError(f"lengths on {lengths.device}, data on {data.device}")


def _check_rows(name: str, x: torch.Tensor, data: torch.Tensor, dtypes) -> None:
    if x.dim() != 1 or x.numel() != data.shape[0] or x.dtype not in dtypes:
        raise ValueError(
            f"{name} must be [R] with R = {data.shape[0]} of {dtypes}, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if x.device != data.device:
        raise ValueError(f"{name} on {x.device}, data on {data.device}")


def _check_hits(hits: torch.Tensor, data: torch.Tensor) -> None:
    R, L = data.shape
    want = (hit_words(L), R)
    if tuple(hits.shape) != want or hits.dtype != torch.int32 or hits.device != data.device:
        raise ValueError(
            f"hits must be {want} int32 on {data.device}, got {tuple(hits.shape)} "
            f"{hits.dtype} on {hits.device}"
        )


def _check_cap(cap: int) -> None:
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")


def hit_words(L: int) -> int:
    """Number W of 32-step hit words per record of width L (L + 2 steps)."""
    return -(-(L + 2) // 32)


def hit_bits(hits: torch.Tensor, T: int) -> torch.Tensor:
    """Hit words [W, R] -> [R, T] bool (bit t of record r)."""
    sh = torch.arange(32, dtype=torch.int32, device=hits.device)
    bits = (hits.T[:, :, None] >> sh) & 1  # [R, W, 32]; >> sign-fills, & 1 drops it
    return bits.reshape(hits.shape[1], -1)[:, :T] != 0


def _hit(hits: torch.Tensor, t: int) -> torch.Tensor:
    """[R] bool: bit t of every record's hit words."""
    return ((hits[t >> 5] >> (t & 31)) & 1) != 0


def _hit_at(hits: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[R] bool: bit t[r] of record r's hit words [W, R] (0 past W)."""
    W, R = hits.shape
    w = t >> 5
    word = hits.to(torch.int64).gather(0, w.clamp(max=W - 1)[None, :])[0]
    return (w < W) & (((word >> (t & 31)) & 1) != 0)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


class _Plain(NamedTuple):
    """One program's tables as the plain versions use them: a record's
    state set is one int64 masked to 32 bits."""

    tab: torch.Tensor  # [N_SYMS, n] int64, masked to 32 bits
    deltas: list
    acc: int

    @classmethod
    def of(cls, tables: ScanTables, dev) -> "_Plain":
        tab = tables.tab.to(dev).to(torch.int64) & MASK32
        return cls(tab, [int(d) for d in tables.deltas.tolist()], tables.acc)

    def fwd(self, vv: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """v' = OR_i shift(vv, delta_i) & tab[sym][i]."""
        rows = self.tab[sym]
        nxt = torch.zeros_like(vv)
        for i, d in enumerate(self.deltas):
            sh = vv << d if d > 0 else (vv >> -d if d < 0 else vv)
            nxt |= sh & rows[:, i]
        return nxt

    # the stepper of the span path's plain versions
    def empty(self, R: int, dev) -> torch.Tensor:
        return torch.zeros(R, dtype=torch.int64, device=dev)

    def step(self, v: torch.Tensor, gate: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """The forward step with the initial state added where ``gate``."""
        return self.fwd(v | gate.to(torch.int64), sym)

    def accepts(self, v: torch.Tensor) -> torch.Tensor:
        return (v & self.acc) != 0

    def cleared(self, v: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
        return torch.where(done, 0, v)

    def rev(self, r: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """R' = OR_i unshift((R | acc) & tab[sym][i], delta_i)."""
        rows = self.tab[sym]
        x = r | self.acc
        nxt = torch.zeros_like(x)
        for i, d in enumerate(self.deltas):
            m = x & rows[:, i]
            nxt |= m >> d if d > 0 else (m << -d if d < 0 else m)
        return nxt & MASK32

    def start(self, r: torch.Tensor) -> torch.Tensor:
        """[R] bool: the initial state is in R."""
        return (r & 1) != 0


def _sym(data: torch.Tensor, ln: torch.Tensor, t: int) -> torch.Tensor:
    """[R] int64 symbol of stream step t: BOS at 0, byte t-1 while live,
    EOS at len + 1, dead after."""
    R, L = data.shape
    if t == 0:
        return torch.full((R,), SYM_BOS, dtype=torch.int64, device=data.device)
    j = t - 1
    byte = data[:, j].to(torch.int64) if j < L else torch.zeros_like(ln)
    return torch.where(j < ln, byte, torch.where(ln == j, SYM_EOS, SYM_DEAD))


def _lengths(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return lengths.to(torch.int64).clamp(0, data.shape[1])


def stats_plain(
    data: torch.Tensor,
    lengths: torch.Tensor,
    tables: ScanTables,
    *,
    seeded: bool,
    lead: int,
    nullable: bool,
    seed: int = 1,
):
    """Plain PyTorch version of the kernel: a loop over the L + 2 stream
    steps, vectorised over records and accept channels, in int64 masked
    to 32 bits (torch on the CPU lacks uint32 shifts). Each channel has its
    own flags, its own `$` dedup (the EOS step's flag is dropped when the
    channel flagged at step len) and its own (cnt, first, last, full).
    ``seed``: the initial states ORed in (state 0; the slotted SWAR scan's
    state 0 of every slot). Returns (cnt, first, last, full), each [R, P]
    for tables with accept channels and [R] for one channel."""
    _check_inputs(data, lengths)
    R, L = data.shape
    dev = data.device
    i64 = torch.int64
    ln = _lengths(data, lengths)[:, None]
    pt = _Plain.of(tables, dev)
    if tables.accs is None:
        accm = torch.tensor([tables.acc], dtype=i64, device=dev)
    else:
        accm = tables.accs.to(dev).to(i64) & MASK32
    P = accm.numel()
    lead = lead if lead > 0 else -1
    v = torch.zeros(R, dtype=i64, device=dev)
    prev = torch.zeros((R, P), dtype=torch.bool, device=dev)
    cnt = torch.zeros((R, P), dtype=i64, device=dev)
    first = torch.full((R, P), BIG, dtype=i64, device=dev)
    last = torch.full((R, P), -1, dtype=i64, device=dev)
    for t in range(L + 2):
        sym = _sym(data, ln[:, 0], t)
        eos = (sym == SYM_EOS)[:, None]
        v = pt.fwd(v | seed if (seeded or t < 2) else v, sym)
        fl = (v[:, None] & accm) != 0
        emit = fl & ~(eos & prev)
        prev = fl
        if t > lead:
            cnt += emit.to(i64)
            first = torch.where(emit & (first == BIG), t, first)
            last = torch.where(emit, t, last)
    full = (cnt > 0) & (last >= ln)
    if nullable:
        # closed forms of _swar_stats / _word_stats: every position ends an
        # empty match (seeded); end 0 is pre-counted (unseeded)
        full = full | (ln == 0)
        first_o = torch.zeros_like(cnt)
        if seeded:
            cnt_o = (ln + 1).expand(R, P)
            last_o = torch.where(last < 0, ln, torch.minimum(last, ln))
        else:
            step0 = (first == 0).to(i64)
            cnt_o = torch.where(ln == 0, 1, 1 + cnt - step0)
            last_o = torch.minimum(torch.where(last < 0, 0, last), ln).clamp(min=0)
    else:
        cnt_o = cnt
        first_o = torch.where(first >= BIG, -1, torch.minimum(first, ln))
        last_o = torch.where(last < 0, -1, torch.minimum(last, ln))
    i32 = torch.int32
    out = (cnt_o.to(i32), first_o.to(i32), last_o.to(i32), full)
    return out if tables.accs is not None else tuple(x[:, 0].contiguous() for x in out)


def reverse_plain(data: torch.Tensor, lengths: torch.Tensor, tables):
    """Plain version of ``rrx_swar_reverse`` and ``rrx_nfa_reverse``
    (``tables``: a ``ScanTables`` or an ``NfaTables``): the reverse step
    walked from step L + 1 down to step 0, accept states joining at every
    step (dead steps past EOS leave the set empty). Hit bit t = the initial
    state is in the set after step t, i.e. a match can start at max(t - 1,
    0). Returns hit words [W, R] int32."""
    _check_inputs(data, lengths)
    R, L = data.shape
    ln = _lengths(data, lengths)
    pt = tables.plain(data.device)
    rs = pt.empty(R, data.device)
    words = torch.zeros((hit_words(L), R), dtype=torch.int64, device=data.device)
    for t in range(L + 1, -1, -1):
        rs = pt.rev(rs, _sym(data, ln, t))
        words[t >> 5] |= pt.start(rs).to(torch.int64) << (t & 31)
    return _as_i32(words)


def anchor_plain(
    data: torch.Tensor,
    lengths: torch.Tensor,
    tables,
    starts: torch.Tensor,
    *,
    longest: bool,
):
    """Plain version of ``rrx_swar_anchor_end`` and ``rrx_nfa_anchor_end``
    (the TPU's ``_anchor_end_kernel_b``): per record, the automaton seeded
    only at ``starts`` (step start + 1, or steps <= 1 when start == 0; -1 =
    inactive), reduced to the first (lazy) or last (``longest``) accept
    step as an end min(step, len); -1 when none. No `$` dedup. Returns end
    [R] int32.

    Before the earliest seed step every state set is empty, and once all
    are empty after the last seed step they stay so: the loop covers only
    the steps in between."""
    _check_inputs(data, lengths)
    _check_rows("starts", starts, data, (torch.int32, torch.int64))
    R, L = data.shape
    dev = data.device
    ln = _lengths(data, lengths)
    pt = tables.plain(dev)
    st = starts.to(torch.int64)
    valid = st >= 0
    first = torch.full((R,), BIG, dtype=torch.int64, device=dev)
    last = torch.full((R,), -1, dtype=torch.int64, device=dev)
    if bool(valid.any()):
        t0 = int(torch.where(st == 0, 0, st + 1)[valid].min())
        t_seed = int((st + 1)[valid].max())
        v = pt.empty(R, dev)
        for t in range(t0, L + 2):
            gate = valid & ((st == t - 1) | ((st == 0) & (t <= 1)))
            v = pt.step(v, gate, _sym(data, ln, t))
            fl = pt.accepts(v)
            first = torch.where(fl & (first == BIG), t, first)
            last = torch.where(fl, t, last)
            if t >= t_seed and not bool(v.any()):
                break
    if longest:
        end = torch.where(last < 0, -1, torch.minimum(last, ln))
    else:
        end = torch.where(first >= BIG, -1, torch.minimum(first, ln))
    return end.to(torch.int32)


def lazy_spans_plain(
    data: torch.Tensor,
    lengths: torch.Tensor,
    tables,
    hits: torch.Tensor,
    cap: int,
):
    """Plain version of ``rrx_swar_lazy_spans`` and ``rrx_nfa_lazy_spans``:
    one forward pass with the claim/anchor/emit bookkeeping of the TPU's
    ``_swar_span_kernel`` / ``_span_kernel_b`` over the hit words of
    :func:`reverse_plain`, written straight into the span buffers (the
    TPU's compaction). After the EOS step an idle record with pos <= len
    and hit bit len + 1 emits the empty match (len, len), which the TPU
    kernels drop (the EOS step reads that hit while a span ending there
    still holds cur). Returns (starts [R, cap], ends [R, cap], -1 past the
    count; cnt [R], which counts past cap)."""
    _check_inputs(data, lengths)
    _check_hits(hits, data)
    _check_cap(cap)
    R, L = data.shape
    dev = data.device
    i64 = torch.int64
    ln = _lengths(data, lengths)
    pt = tables.plain(dev)
    v = pt.empty(R, dev)
    pos = torch.zeros(R, dtype=i64, device=dev)
    cur = torch.full((R,), -1, dtype=i64, device=dev)
    cnt = torch.zeros(R, dtype=i64, device=dev)
    sbuf = torch.full((R, cap + 1), -1, dtype=i64, device=dev)  # column cap: overflow
    ebuf = torch.full((R, cap + 1), -1, dtype=i64, device=dev)
    for t in range(L + 2):
        sp = max(t - 1, 0)
        claim = (cur < 0) & _hit(hits, t) & (pos <= sp) & (sp <= ln)
        cur = torch.where(claim, sp, cur)
        gate = (cur >= 0) & ((cur == t - 1) | ((cur == 0) & (t <= 1)))
        v = pt.step(v, gate, _sym(data, ln, t))
        e = ln.clamp(max=t)
        done = pt.accepts(v) & (cur >= 0) & (e >= cur)
        slot = torch.where(done, cnt.clamp(max=cap), cap)[:, None]
        sbuf.scatter_(1, slot, torch.where(done, cur, -1)[:, None])
        ebuf.scatter_(1, slot, torch.where(done, e, -1)[:, None])
        cnt += done.to(i64)
        pos = torch.where(done, torch.maximum(e, cur + 1), pos)
        cur = torch.where(done, -1, cur)
        v = pt.cleared(v, done)
    # the empty match at len: the EOS step reads its start hit (bit len + 1)
    # while a span ending at that step still holds cur
    done = (cur < 0) & (pos <= ln) & _hit_at(hits, ln + 1)
    slot = torch.where(done, cnt.clamp(max=cap), cap)[:, None]
    sbuf.scatter_(1, slot, torch.where(done, ln, -1)[:, None])
    ebuf.scatter_(1, slot, torch.where(done, ln, -1)[:, None])
    cnt += done.to(i64)
    i32 = torch.int32
    return sbuf[:, :cap].to(i32), ebuf[:, :cap].to(i32), cnt.to(i32)


def greedy_spans_plain(
    data: torch.Tensor,
    lengths: torch.Tensor,
    tables,
    hits: torch.Tensor,
    cap: int,
    *,
    nullable: bool = False,
    longest: bool = True,
):
    """Plain version of ``rrx_swar_greedy_spans``,
    ``rrx_nfa_greedy_spans`` and ``rrx_bitband_spans``, in the round
    structure of the TPU's ``_greedy_call_b`` (and ``_bb_spans_call``): a
    starts bitmap [R, L + 1] from the hit words (hit step j = start max(j -
    1, 0); with ``nullable`` every position <= len as well), then while
    some record is active and fewer than ``cap`` rounds ran, each active
    record takes its first start s >= pos, rescans from s for the longest
    end e (the first one with ``longest=False``: :func:`anchor_plain`; with
    ``nullable`` e < s falls back to the empty match e = s), emits (s, e)
    if e >= s and moves pos to max(e, s + 1). Returns (starts [R, cap],
    ends [R, cap], cnt [R], over [R] bool = still active after the
    rounds)."""
    _check_inputs(data, lengths)
    _check_hits(hits, data)
    _check_cap(cap)
    R, L = data.shape
    dev = data.device
    i64 = torch.int64
    ln = _lengths(data, lengths)
    hb = hit_bits(hits, L + 2)
    sbm = torch.cat([hb[:, :1] | hb[:, 1:2], hb[:, 2:]], dim=1)  # [R, L + 1]
    cols = torch.arange(L + 1, dtype=i64, device=dev)[None, :]
    if nullable:
        sbm = sbm | (cols <= ln[:, None])
    pos = torch.zeros(R, dtype=i64, device=dev)
    n = torch.zeros(R, dtype=i64, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    sbuf = torch.full((R, cap + 1), -1, dtype=i64, device=dev)
    ebuf = torch.full((R, cap + 1), -1, dtype=i64, device=dev)
    for _ in range(cap):
        if not bool(active.any()):
            break
        m = sbm & (cols >= pos[:, None]) & (cols <= ln[:, None]) & active[:, None]
        has = m.any(dim=1)
        s = torch.where(has, m.to(torch.uint8).argmax(dim=1), -1)
        active = active & has
        e = anchor_plain(data, lengths, tables, s, longest=longest).to(i64)
        if nullable:
            e = torch.where(e < s, s, e)  # the empty match at s
        emit = active & (e >= s)
        slot = torch.where(emit, n, cap)[:, None]
        sbuf.scatter_(1, slot, torch.where(emit, s, -1)[:, None])
        ebuf.scatter_(1, slot, torch.where(emit, e, -1)[:, None])
        pos = torch.where(emit, torch.maximum(e, s + 1), pos)
        n += emit.to(i64)
        active = emit & (pos <= ln)
    i32 = torch.int32
    return sbuf[:, :cap].to(i32), ebuf[:, :cap].to(i32), n.to(i32), active


def launch(entry: str, data: torch.Tensor, lengths: torch.Tensor, *args) -> None:
    """Launch ``entry`` on the current stream of ``data``'s card. Every
    entry point takes the same row head (data, stride, L, lengths, R), then
    ``args``: ints as they are, tensors (tables, inputs and preallocated
    outputs, contiguous, on the same card) by pointer, then the stream. A
    refused launch raises (``_build.check``)."""
    from . import _build

    _check_inputs(data, lengths)
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on a CUDA tensor, got {dev}")
    for x in args:
        if isinstance(x, torch.Tensor) and (x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{entry}: a {tuple(x.shape)} argument on {x.device} "
                             f"(contiguous: {x.is_contiguous()}), data on {dev}")
    R, L = data.shape
    # the kernels read rows 16 bytes at a time: 16-byte aligned base, a row
    # width and a row stride that are multiples of 16. Rows may overlap (a
    # strided view of one buffer: the long-string windows)
    stride = data.stride(0) if R > 1 else -(-max(L, 1) // 16) * 16
    if (L % 16 or data.data_ptr() % 16 or data.stride(1) != 1 or stride % 16
            or stride <= 0):
        padded = torch.zeros((R, -(-max(L, 1) // 16) * 16), dtype=torch.uint8, device=dev)
        padded[:, :L] = data
        data = padded
        stride = data.shape[1]
    lengths = lengths.to(torch.int32).contiguous()
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(
            data.data_ptr(), stride, L, lengths.data_ptr(), R, *ptrs, stream
        )
    _build.check(code, entry)


def _launch(entry: str, data: torch.Tensor, lengths: torch.Tensor,
            tables: ScanTables, *tail) -> None:
    """:func:`launch` with the (delta, table) head: tab, deltas, n_delta,
    acc, then ``tail``."""
    launch(entry, data, lengths, tables.tab, tables.deltas,
           int(tables.deltas.numel()), tables.acc, *tail)


def launch_stats(
    entry: str,
    data: torch.Tensor,
    lengths: torch.Tensor,
    tables: ScanTables,
    *,
    seeded: bool,
    lead: int,
    nullable: bool,
):
    """Launch ``entry`` (``rrx_swar_stats`` / ``rrx_word_stats``) on the
    current stream of ``data``'s card. ``rrx_word_stats`` also takes the
    channel count and the per-channel accept masks. Returns (cnt, first,
    last, full), each [R, P] for tables with accept channels, else [R]."""
    R, dev = data.shape[0], data.device
    shape = (R,) if tables.accs is None else (R, tables.P)
    cnt = torch.empty(shape, dtype=torch.int32, device=dev)
    first = torch.empty(shape, dtype=torch.int32, device=dev)
    last = torch.empty(shape, dtype=torch.int32, device=dev)
    full = torch.empty(shape, dtype=torch.uint8, device=dev)
    if entry == "rrx_word_stats":
        chan = (tables.P, tables.accs if tables.accs is not None else 0)
    elif tables.accs is not None:
        raise ValueError(f"{entry} takes one accept channel, got {tables.P}")
    else:
        chan = ()
    _launch(
        entry, data, lengths, tables, *chan,
        int(seeded), int(lead if lead > 0 else -1), int(nullable), cnt, first, last, full,
    )
    return cnt, first, last, full.view(torch.bool)


def launch_swar_multi(data: torch.Tensor, lengths: torch.Tensor, tables: ScanTables, *,
                      seeded: bool):
    """Launch ``rrx_swar_multi_stats`` on slotted tables (one accept mask
    per slot, ``tables.accs`` [P], P <= 4). Returns (cnt, first, last,
    full), each [R, P]."""
    if tables.accs is None or not 1 <= tables.P <= 4:
        raise ValueError(f"rrx_swar_multi_stats takes 1 to 4 slot accept masks, got "
                         f"{None if tables.accs is None else tables.P}")
    R, dev = data.shape[0], data.device
    shape = (R, tables.P)
    cnt, first, last = (torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(3))
    full = torch.empty(shape, dtype=torch.uint8, device=dev)
    _launch("rrx_swar_multi_stats", data, lengths, tables, tables.P, tables.accs, int(seeded),
            cnt, first, last, full)
    return cnt, first, last, full.view(torch.bool)


def launch_reverse(data: torch.Tensor, lengths: torch.Tensor, tables: ScanTables):
    """Launch ``rrx_swar_reverse``. Returns hit words [W, R] int32."""
    R, L = data.shape
    hits = torch.empty((hit_words(L), R), dtype=torch.int32, device=data.device)
    _launch("rrx_swar_reverse", data, lengths, tables, hits)
    return hits


def _span_buffers(R: int, cap: int, dev):
    return (
        torch.empty((R, cap), dtype=torch.int32, device=dev),
        torch.empty((R, cap), dtype=torch.int32, device=dev),
        torch.empty(R, dtype=torch.int32, device=dev),
    )


def launch_lazy_spans(data: torch.Tensor, lengths: torch.Tensor, tables: ScanTables,
                      hits: torch.Tensor, cap: int):
    """Launch ``rrx_swar_lazy_spans``. Returns (starts, ends, cnt)."""
    _check_hits(hits, data)
    _check_cap(cap)
    starts, ends, cnt = _span_buffers(data.shape[0], cap, data.device)
    _launch("rrx_swar_lazy_spans", data, lengths, tables,
            hits.contiguous(), int(cap), starts, ends, cnt)
    return starts, ends, cnt


def launch_anchor_end(data: torch.Tensor, lengths: torch.Tensor, tables: ScanTables,
                      starts: torch.Tensor, *, longest: bool):
    """Launch ``rrx_swar_anchor_end``. Returns end [R] int32."""
    _check_rows("starts", starts, data, (torch.int32, torch.int64))
    end = torch.empty(data.shape[0], dtype=torch.int32, device=data.device)
    _launch("rrx_swar_anchor_end", data, lengths, tables,
            starts.to(torch.int32).contiguous(), int(longest), end)
    return end


def launch_greedy_spans(data: torch.Tensor, lengths: torch.Tensor, tables: ScanTables,
                        hits: torch.Tensor, cap: int):
    """Launch ``rrx_swar_greedy_spans``. Returns (starts, ends, cnt, over)."""
    _check_hits(hits, data)
    _check_cap(cap)
    R = data.shape[0]
    starts, ends, cnt = _span_buffers(R, cap, data.device)
    over = torch.empty(R, dtype=torch.uint8, device=data.device)
    _launch("rrx_swar_greedy_spans", data, lengths, tables,
            hits.contiguous(), int(cap), starts, ends, cnt, over)
    return starts, ends, cnt, over.view(torch.bool)
