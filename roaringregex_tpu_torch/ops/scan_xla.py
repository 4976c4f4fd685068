"""The unpacked engine: the JAX package's portable XLA backend in torch ops.

The port of ``roaringregex_tpu/ops/scan_xla.py``: the tables and class
stream (``device_tables``, ``encode_stream``), the forward scan
(``forward_flags``, ``match_stats``), the reverse scan (``reverse_hits``),
the anchored rescan (``first_end_from``) and the position bitmaps built
from unpacked per-step flags and start hits (``end_positions``,
``ends_bitmap``, ``starts_bitmap``). It is the engine's ``xla`` backend
(``ScanEngine(prog, device, backend="xla")``, and a container program past
the container kernels' caps, which the JAX engine sends to this backend
too), and it answers the anchored rescans of the sparse-tier programs
whose scanner has no anchored kernels (the counting and container tiers;
``roaringregex_tpu/engine.py:839-842``). The kernel route builds its
bitmaps from every scanner's bit-packed words instead; these bitmaps are
also the reference they are tested against.

The JAX package computes this module in plain XLA, outside any Pallas
kernel, so its port is torch ops on the engine's device, with no kernel of
its own: one step of B records is a [B, S] x [S, S] product of 0/1 float32
planes (exact: a sum is at most S, under float32's 2^24; bf16 or fp16
inputs would round sums past 256 or 2048), thresholded and ANDed with the
class mask, over the program's S = n_states states. Stream convention:
step t consumes column t of the [B, L + 2] class stream (BOS | bytes | EOS
| dead), and its end position is ``min(t, len)``; flags column t + 1 holds
step t (column 0 is the program's nullability).
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


def _step(tables: Tables, v: torch.Tensor, cls_t: torch.Tensor) -> torch.Tensor:
    """One step of B records: v' = follow(v) & Bc[cls_t], [B, S] bool."""
    return ((v.to(torch.float32) @ tables["F"]) > 0) & tables["Bc"][cls_t]


def _dead(v: torch.Tensor, t: int, n_seed_steps: int) -> bool:
    """True when an unseeded scan may stop after step t: past its last seed
    step every state set is empty, so none of them accepts again (asked
    every 32 steps: one host read)."""
    return t >= n_seed_steps - 1 and t % 32 == 31 and not bool(v.any())


def forward_flags(tables: Tables, cls: torch.Tensor, *, seeded: bool,
                  n_seed_steps: int = 2) -> torch.Tensor:
    """[B, T + 1] bool accept flags of the [B, T] class stream: column t + 1
    is the acceptance of the state set after step t, column 0 the initial
    state's (the program's nullability). The initial state is seeded into
    every step (``seeded``) or steps t < ``n_seed_steps``. An unseeded scan
    stops once every state set is empty: the flags after it stay False."""
    B, T = cls.shape
    S = tables["F"].shape[0]
    dev = cls.device
    v = torch.zeros((B, S), dtype=torch.bool, device=dev)
    flags = torch.zeros((B, T + 1), dtype=torch.bool, device=dev)
    flags[:, 0] = tables["accept"][0]
    for t in range(T):
        if seeded or t < n_seed_steps:
            v[:, 0] = True
        v = _step(tables, v, cls[:, t])
        flags[:, t + 1] = (v & tables["accept"]).any(dim=1)
        if not seeded and _dead(v, t, n_seed_steps):
            break
    return flags


def match_stats(tables: Tables, cls: torch.Tensor, lengths: torch.Tensor, *, seeded: bool,
                nullable: bool, n_seed_steps: int = 2):
    """(count, first_end, any) per record, each [B], from one scan without
    materialising the flags: count = the number of distinct end positions
    e = min(t, len) with a match (the `$` step's repeat of e = len counts
    once). A nullable program's empty match ends at 0 (unseeded) or at
    every position (seeded: count = len + 1 from the start, and no step
    adds an end)."""
    B, T = cls.shape
    S = tables["F"].shape[0]
    dev = cls.device
    ln = lengths.to(torch.int64)
    if nullable:
        cnt = ln + 1 if seeded else torch.ones_like(ln)
        first = torch.zeros_like(ln)
        last = ln.clone() if seeded else torch.zeros_like(ln)
    else:
        cnt = torch.zeros_like(ln)
        first = torch.full_like(ln, -1)
        last = torch.full_like(ln, -1)
    v = torch.zeros((B, S), dtype=torch.bool, device=dev)
    for t in range(T):
        if seeded or t < n_seed_steps:
            v[:, 0] = True
        v = _step(tables, v, cls[:, t])
        flag = (v & tables["accept"]).any(dim=1)
        e = ln.clamp(max=t)
        if not (nullable and seeded):
            cnt = cnt + (flag & (e != last)).to(torch.int64)
        first = torch.where((first < 0) & flag, e, first)
        last = torch.where(flag, e, last)
        if not seeded and _dead(v, t, n_seed_steps):
            break
    cnt = cnt.to(torch.int32)
    return cnt, first.to(torch.int32), cnt > 0


def reverse_hits(tables: Tables, cls: torch.Tensor, *, seed_accept: bool = True) -> torch.Tensor:
    """[B, T] bool reverse-automaton hits: column j is set iff the initial
    state is live just before stream column j, i.e. some match starts at
    position max(j - 1, 0). The recurrence, from the last column down:
    R_j = pred((R_{j+1} | accept) & Bc[cls_j]), pred(x) = the states that
    some state of x follows (x @ F^T); without ``seed_accept`` the accept
    set does not join."""
    B, T = cls.shape
    S = tables["F"].shape[0]
    dev = cls.device
    Ft = tables["F"].T
    r = torch.zeros((B, S), dtype=torch.bool, device=dev)
    hits = torch.zeros((B, T), dtype=torch.bool, device=dev)
    for j in range(T - 1, -1, -1):
        if seed_accept:
            r = r | tables["accept"]
        masked = r & tables["Bc"][cls[:, j]]
        r = (masked.to(torch.float32) @ Ft) > 0
        hits[:, j] = r[:, 0]
    return hits


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
