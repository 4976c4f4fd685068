"""Shared core of the SWAR and u32-word scan tiers: the (delta, table)
form of a bit-set automaton, its plain PyTorch scan, and the launcher of
the CUDA kernel in ``csrc/scan_bits.cu``.

Both TPU kernels (``_swar_kernel``, ``_word_kernel``) step a record's
state set as ``v' = OR over (delta, gate, mask) of shift(v | seed, delta)
& mask, where the step's byte is in the gate``. Folding every gate into a
per-symbol table gives one form for both:

    v' = OR_i shift(v | seed, delta_i) & tab[sym][i]

with ``tab[sym][i]`` the union of the target masks of the pairs at
``delta_i`` whose gate holds ``sym`` (a byte 0..255, 256 = BOS, 257 =
EOS, 258 = a dead step past EOS). ``scan_swar.swar_tables`` and
``scan_word.word_tables`` build it from their specs; the per-tier modules
own the wrappers (and their launch counts) around :func:`stats_plain` and
:func:`launch_stats`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

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
    acc: int  # accepting-state mask


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


def device_tables(deltas: np.ndarray, tab: np.ndarray, acc: int, device) -> ScanTables:
    return ScanTables(
        tab=torch.from_numpy(tab.view(np.int32).copy()).to(device),
        deltas=torch.from_numpy(deltas.astype(np.int32)).to(device),
        acc=acc,
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


def stats_plain(
    data: torch.Tensor,
    lengths: torch.Tensor,
    tables: ScanTables,
    *,
    seeded: bool,
    lead: int,
    nullable: bool,
):
    """Plain PyTorch version of the kernel: a loop over the L + 2 stream
    steps, vectorised over records, in int64 masked to 32 bits (torch on
    the CPU lacks uint32 shifts). Returns (cnt, first, last, full) [R]."""
    _check_inputs(data, lengths)
    R, L = data.shape
    dev = data.device
    i64 = torch.int64
    ln = lengths.to(i64).clamp(0, L)
    tab = tables.tab.to(dev).to(i64) & MASK32  # [N_SYMS, n]
    deltas = [int(d) for d in tables.deltas.tolist()]
    acc = tables.acc
    lead = lead if lead > 0 else -1
    v = torch.zeros(R, dtype=i64, device=dev)
    prev = torch.zeros(R, dtype=torch.bool, device=dev)
    cnt = torch.zeros(R, dtype=i64, device=dev)
    first = torch.full((R,), BIG, dtype=i64, device=dev)
    last = torch.full((R,), -1, dtype=i64, device=dev)
    for t in range(L + 2):
        j = t - 1
        if t == 0:
            sym = torch.full((R,), SYM_BOS, dtype=i64, device=dev)
            eos = torch.zeros(R, dtype=torch.bool, device=dev)
        else:
            byte = data[:, j].to(i64) if j < L else torch.zeros_like(ln)
            eos = ln == j
            sym = torch.where(
                j < ln, byte,
                torch.where(eos, SYM_EOS, SYM_DEAD),
            )
        vv = v | 1 if (seeded or t < 2) else v
        rows = tab[sym]  # [R, n]
        nxt = torch.zeros_like(v)
        for i, d in enumerate(deltas):
            sh = vv << d if d > 0 else (vv >> -d if d < 0 else vv)
            nxt |= sh & rows[:, i]
        v = nxt
        fl = (v & acc) != 0
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
        first_o = torch.zeros_like(ln)
        if seeded:
            cnt_o = ln + 1
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
    return cnt_o.to(i32), first_o.to(i32), last_o.to(i32), full


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
    current stream of ``data``'s card. Returns (cnt, first, last, full)."""
    from . import _build

    _check_inputs(data, lengths)
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on a CUDA tensor, got {dev}")
    if tables.tab.device != dev or tables.deltas.device != dev:
        raise ValueError(f"{entry}: tables on {tables.tab.device}, data on {dev}")
    R, L = data.shape
    # the kernel reads rows 16 bytes at a time: 16-byte aligned base and
    # a row stride that is a multiple of 16
    if L % 16 or data.data_ptr() % 16 or not data.is_contiguous():
        padded = torch.zeros((R, -(-max(L, 1) // 16) * 16), dtype=torch.uint8, device=dev)
        padded[:, :L] = data
        data = padded
    lengths = lengths.to(torch.int32).contiguous()
    tab = tables.tab.contiguous()
    deltas = tables.deltas.contiguous()
    cnt = torch.empty(R, dtype=torch.int32, device=dev)
    first = torch.empty(R, dtype=torch.int32, device=dev)
    last = torch.empty(R, dtype=torch.int32, device=dev)
    full = torch.empty(R, dtype=torch.uint8, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(
            data.data_ptr(), data.stride(0), L, lengths.data_ptr(), R,
            tab.data_ptr(), deltas.data_ptr(), int(deltas.numel()), tables.acc,
            int(seeded), int(lead if lead > 0 else -1), int(nullable),
            cnt.data_ptr(), first.data_ptr(), last.data_ptr(), full.data_ptr(),
            stream,
        )
    _build.check(code, entry)
    return cnt, first, last, full.view(torch.bool)
