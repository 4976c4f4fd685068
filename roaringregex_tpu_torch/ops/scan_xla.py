"""The unpacked engine's pieces that the counting tier needs.

The port of the parts of ``roaringregex_tpu/ops/scan_xla.py`` that the
counting tier's primitives read: the anchored rescan ``first_end_from``
with the tables and stream it runs on (``device_tables``,
``encode_stream``), and the position bitmaps built from unpacked per-step
flags and start hits (``end_positions``, ``ends_bitmap``,
``starts_bitmap``). The engine builds its bitmaps from every scanner's
bit-packed words instead; these are the reference they are tested
against.

The JAX engine answers a counting-tier program's anchored rescans with
``scan_packed.first_end_from`` (the lane-packed engine) on the dense and
multiblock tiers and with ``scan_xla.first_end_from`` on the sparse tier
(``roaringregex_tpu/engine.py:825-842``). Both compute the same function,
so the port takes this module's for every tier; the tests hold it to both.
It runs in torch ops on the engine's device (``torch.matmul`` of 0/1
float32 planes, exact), as the JAX package computes it in XLA, outside any
Pallas kernel. Stream convention: step t consumes column t of the [B, L +
2] class stream (BOS | bytes | EOS | dead), and its end position is
``min(t, len)``; flags column t + 1 holds step t (column 0 is the
program's nullability).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..compiler.program import DeviceProgram

Tables = Dict[str, torch.Tensor]


def device_tables(prog: DeviceProgram, device) -> Tables:
    """The program's follow matrix F [S, S] float32 (F[i, j] = 1 iff j
    follows i), class masks Bc [c_pad, S] bool, accept [S] bool and
    byte -> class map [256] int64 on ``device``, S = n_states. F is built
    from the NFA's follow relation on every tier (the sparse tier's
    program holds no dense F; the JAX package builds the same matrix from
    its follow blocks)."""
    S = prog.n_states
    dev = torch.device(device)
    return {
        "F": torch.from_numpy(prog.nfa.follow_matrix).to(dev, torch.float32),
        "Bc": torch.from_numpy(prog.Bc[:, :S] != 0).to(dev),
        "accept": torch.from_numpy(prog.accept[:S] != 0).to(dev),
        "byte_class": torch.from_numpy(prog.byte_class).to(dev, torch.int64),
    }


def encode_stream(tables: Tables, data: torch.Tensor, lengths: torch.Tensor,
                  bos_class: int, eos_class: int, dead_class: int = 0) -> torch.Tensor:
    """[B, L + 2] int64 class stream: BOS | classes of the bytes | EOS |
    the dead class after it."""
    B, L = data.shape
    cls = tables["byte_class"][data.to(torch.int64)]
    j = torch.arange(L, device=data.device)[None, :]
    n = lengths.to(torch.int64)[:, None]
    body = torch.where(j < n, cls, torch.where(j == n, eos_class, dead_class))
    tail = torch.where(n == L, eos_class, dead_class)
    bos = torch.full((B, 1), bos_class, dtype=torch.int64, device=data.device)
    return torch.cat([bos, body, tail], dim=1)


def end_positions(T_plus_1: int, lengths: torch.Tensor) -> torch.Tensor:
    """e[b, t] = clamp(t - 1, 0, len_b): the end position of flags column t."""
    t = torch.arange(T_plus_1, device=lengths.device)[None, :]
    return (t - 1).clamp(min=0).minimum(lengths.to(torch.int64)[:, None])


def _scatter_positions(bits: torch.Tensor, pos: torch.Tensor, lengths: torch.Tensor,
                       max_len: int, nullable: bool) -> torch.Tensor:
    """[B, max_len + 1] bool: OR of ``bits`` [B, T] into their positions
    ``pos`` [B, T] (positions past max_len dropped), and with ``nullable``
    every position <= len."""
    B = bits.shape[0]
    width = max(max_len + 1, int(pos.max()) + 1 if pos.numel() else 1)
    out = torch.zeros((B, width), dtype=torch.int32, device=bits.device)
    out.scatter_reduce_(1, pos, bits.to(torch.int32), reduce="amax")
    out = out[:, : max_len + 1] != 0
    if nullable:
        cols = torch.arange(max_len + 1, device=bits.device)[None, :]
        out = out | (cols <= lengths.to(torch.int64)[:, None])
    return out


def ends_bitmap(flags: torch.Tensor, lengths: torch.Tensor, max_len: int, nullable: bool,
                seeded: bool) -> torch.Tensor:
    """[B, max_len + 1] bool: some match ends at position e (``flags`` [B,
    T + 1] from a forward-flags call). A nullable seeded scan has the empty
    match at every position."""
    e = end_positions(flags.shape[1], lengths)
    return _scatter_positions(flags, e, lengths, max_len, nullable and seeded)


def starts_bitmap(hits: torch.Tensor, lengths: torch.Tensor, max_len: int,
                  nullable: bool) -> torch.Tensor:
    """[B, max_len + 1] bool: some match starts at position s (``hits``
    [B, T], step t = start max(t - 1, 0))."""
    t = torch.arange(hits.shape[1], device=hits.device)[None, :]
    s = (t - 1).clamp(min=0).minimum(lengths.to(torch.int64)[:, None])
    return _scatter_positions(hits, s, lengths, max_len, nullable)


def first_end_from(tables: Tables, cls: torch.Tensor, lengths: torch.Tensor,
                   starts: torch.Tensor, *, longest: bool = False) -> torch.Tensor:
    """[B] int32 anchored-scan end per record: the smallest end e >= s such
    that text[s:e] matches (lazy), or with ``longest`` the largest; -1 if
    none or the record is inactive (start -1). Start s seeds the initial
    state into step s + 1, and for s = 0 also step 0 (position 0 lies on
    both sides of BOS). Each step is ``((v @ F) > 0) & Bc[cls]``.

    Before the earliest seed step every state set is empty, and once all
    are empty after the last seed step they stay so; a lazy scan is also
    done once every active record has its end. The loop covers only the
    steps in between (checked every 32 steps)."""
    B, T = cls.shape
    dev = cls.device
    S = tables["F"].shape[0]
    ln = lengths.to(torch.int64)
    st = starts.to(torch.int64)
    valid = st >= 0
    best = torch.full((B,), -1, dtype=torch.int64, device=dev)
    if not bool(valid.any()):
        return best.to(torch.int32)
    t0 = int(torch.where(st == 0, 0, st + 1)[valid].min())
    t_seed = int((st + 1)[valid].max())
    v = torch.zeros((B, S), dtype=torch.bool, device=dev)
    for t in range(t0, T):
        seed = valid & ((st == t - 1) | ((st == 0) & (t <= 1)))
        v[:, 0] |= seed
        v = ((v.to(torch.float32) @ tables["F"]) > 0) & tables["Bc"][cls[:, t]]
        e = ln.clamp(max=t)
        ok = (v & tables["accept"]).any(dim=1) & (e >= st)
        if not longest:
            ok = ok & (best < 0)
        best = torch.where(ok, e, best)
        if t >= t_seed and t % 32 == 31 and not bool(
            v.any() if longest else (v.any(dim=1) & (best < 0)).any()
        ):
            break
    return best.to(torch.int32)
