"""SWAR tier: bit-set scan of programs with at most 8 states.

The port of ``roaringregex_tpu/ops/scan_swar.py``'s forward match-stats
path and its span path (reverse hits, anchored rescans, lazy and greedy
spans). On the TPU the tier packs 4 records into each u32 lane (an 8-bit
state set per record) and applies the 8x8 Glushkov follow matrix as a
diagonal shift/AND/OR per byte (``_swar_kernel``), then reduces an accept
bit-log in XLA (``_swar_stats``). The spec below is the JAX package's,
unchanged, so that the same programs qualify; the scan itself is the CUDA
kernel ``rrx_swar_stats`` (``csrc/scan_bits.cu``), which gives each
record its own thread and keeps the statistics in registers, so the TPU
packing (``_swar_pack``, ``_len_planes``, the k-major planes) has no
counterpart here.

Tall-narrow batches (few long records) split into overlapped windows
exactly as on the TPU (``_swar_window``), so the same batches take the
same route: every match of a bounded-horizon, anchor-free, non-nullable
pattern fits in ``h`` bytes, so a window's first ``h`` steps only warm up
and their flags belong to the previous window (``lead = h``).

With ``RRX_SWAR_MULTI=1`` a ``MultiPattern`` of up to 4 patterns of at
most 8 states runs its combined grep scan slotted (``SwarMultiScanner``):
``swar_multi_spec`` (the JAX package's, unchanged) merges the patterns'
plans, each owning one byte lane of the u32 state, and
``rrx_swar_multi_stats`` (``csrc/scan_bits.cu``) steps the four slots of a
record in one thread with per-slot statistics (the JAX
``_swar_multi_kernel`` plus ``_swar_stats`` per byte lane).

Spans run unwindowed, as on the TPU, on four CUDA kernels
(``csrc/scan_spans.cu``): ``rrx_swar_reverse`` (candidate starts as hit
words), ``rrx_swar_anchor_end`` (an anchored rescan reduced to its first
or last end), ``rrx_swar_lazy_spans`` (one pass of claim/anchor/emit that
writes the span buffers directly) and ``rrx_swar_greedy_spans`` (the
TPU's while_loop of longest-end rescan rounds, as a loop in each record's
thread). ``SwarScanner`` subclasses the matmul tier's ``PallasScanner``
as in the JAX package, and sends it what the JAX package sends it:
nullable programs' lazy and greedy spans and nullable windowed (``lead``)
scans.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler.program import DeviceProgram
from . import scan_bits as sb
from .scan_pallas import PallasScanner

RECS = 32  # records per kernel column of the TPU layout (window rule)
BIG = sb.BIG


class SwarSpec(NamedTuple):
    """Static per-program plan."""

    # deduped byte-set gates: (((lo, hi), ...) merged runs, bos, eos)
    gates: Tuple[Tuple[Tuple[Tuple[int, int], ...], bool, bool], ...]
    # per-state positioning: ((gate_index, target_state), ...)
    gpos: Tuple[Tuple[int, int], ...]
    # diagonal decomposition: ((delta, (gpos_index, ...)), ...)
    diags: Tuple[Tuple[int, Tuple[int, ...]], ...]
    accept_bits: Tuple[int, ...]
    has_eos: bool  # some gate fires on the EOS boundary ($ patterns)
    has_bos: bool  # some gate fires on the BOS step (^ patterns)


def _merge_runs(runs):
    out = []
    for lo, hi in sorted(runs):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def swar_spec(prog: DeviceProgram) -> Optional[SwarSpec]:
    """Build the SWAR plan, or None if the program doesn't qualify
    (s_tile != 8, or a byte class reaching past 0x7F).

    A position's byte set is the union of every class whose mask contains
    it; positions sharing the same merged byte-run set share one gate."""
    if prog.tier == "sparse" or prog.s_tile != 8 or prog.F is None:
        return None
    F8 = np.asarray(prog.F[:8, :8])
    B8 = [int(w[0]) & 0xFF for w in np.asarray(prog.Bc_words)]
    lo, hi, cl = prog.byte_runs
    if len(hi) and int(max(hi)) > 0x7F:
        return None
    runs_all = [(int(l), int(h), int(c)) for l, h, c in zip(lo, hi, cl)]
    bos_c = prog.bos_class if B8[prog.bos_class] else -1
    eos_c = prog.eos_class if B8[prog.eos_class] else -1
    gate_ids = {}
    gates = []
    gpos = []
    by_delta = {}
    has_eos = has_bos = False
    for u in range(8):
        preds = tuple(int(s) for s in range(8) if F8[s, u])
        if not preds:
            continue
        cs = {c for c, w in enumerate(B8) if (w >> u) & 1}
        if not cs:
            continue
        key = (
            _merge_runs([(l, h) for l, h, c in runs_all if c in cs]),
            bos_c in cs,
            eos_c in cs,
        )
        has_bos = has_bos or key[1]
        has_eos = has_eos or key[2]
        gid = gate_ids.get(key)
        if gid is None:
            gid = gate_ids[key] = len(gates)
            gates.append(key)
        pi = len(gpos)
        gpos.append((gid, u))
        for s in preds:
            by_delta.setdefault(u - s, []).append(pi)
    diags = tuple((d, tuple(pis)) for d, pis in sorted(by_delta.items()))
    accept_bits = tuple(
        int(s) for s in range(8) if np.asarray(prog.accept)[s]
    )
    return SwarSpec(
        tuple(gates), tuple(gpos), diags, accept_bits, has_eos, has_bos
    )


class SwarMultiSpec(NamedTuple):
    """Static multi-pattern plan: up to 4 patterns share one u32, one
    8-bit sub-automaton per byte lane ("slot"). Slot-restricted target
    masks keep the sub-automata independent: a diagonal-d group only
    targets bits u >= d of its slot (u <= 7 + d for d < 0), while any bit
    that a shift carries across a slot boundary lands at u < d (u > 7 + d)
    of the next slot, so no step moves a state from one slot to another."""

    gates: Tuple  # deduped across slots: ((runs, bos, eos), ...)
    gpos: Tuple[Tuple[int, int, int], ...]  # (gate_index, bit u, slot)
    diags: Tuple[Tuple[int, Tuple[int, ...]], ...]
    accepts: Tuple[Tuple[int, int], ...]  # (slot, accept bit)
    has_eos: bool
    has_bos: bool


def swar_multi_spec(subprogs) -> Optional[SwarMultiSpec]:
    """Merge per-pattern SWAR plans into one slotted plan, or None when
    any pattern disqualifies (> 8 states, non-ASCII) or P > 4 (the JAX
    package's ``swar_multi_spec``, unchanged, so that the same sets
    qualify)."""
    if not subprogs or len(subprogs) > 4:
        return None
    specs = [swar_spec(p) for p in subprogs]
    if any(s is None for s in specs):
        return None
    gate_ids: dict = {}
    gates: list = []
    gpos: list = []
    by_delta: dict = {}
    accepts: list = []
    has_eos = has_bos = False
    for k, sp in enumerate(specs):
        gid_map = {}
        for gi, key in enumerate(sp.gates):
            gid = gate_ids.get(key)
            if gid is None:
                gid = gate_ids[key] = len(gates)
                gates.append(key)
            gid_map[gi] = gid
        pi_map = {}
        for pi, (gi, u) in enumerate(sp.gpos):
            pi_map[pi] = len(gpos)
            gpos.append((gid_map[gi], u, k))
        for d, pis in sp.diags:
            by_delta.setdefault(d, []).extend(pi_map[pi] for pi in pis)
        accepts.extend((k, s) for s in sp.accept_bits)
        has_eos = has_eos or sp.has_eos
        has_bos = has_bos or sp.has_bos
    diags = tuple((d, tuple(pis)) for d, pis in sorted(by_delta.items()))
    return SwarMultiSpec(
        tuple(gates), tuple(gpos), diags, tuple(accepts), has_eos, has_bos
    )


def swar_tables(spec: SwarSpec):
    """SwarSpec -> (deltas, tab, acc), the kernel's (delta, table) form:
    diagonal ``d``'s positioned gate ``(gid, u)`` becomes the pair
    ``(d, gid)`` with target bit ``u``."""
    pairs = {}
    for d, pis in spec.diags:
        for pi in pis:
            gid, u = spec.gpos[pi]
            pairs[(d, gid)] = pairs.get((d, gid), 0) | (1 << u)
    acc = 0
    for s in spec.accept_bits:
        acc |= 1 << s
    return sb.dg_tables(spec.gates, pairs, acc)


def swar_multi_tables(spec: SwarMultiSpec, P: int):
    """SwarMultiSpec -> (deltas, tab, acc, accs): the (delta, table) form
    of the slotted automaton, slot k owning byte lane k (bits 8k .. 8k +
    7): the diagonal-``d`` positioned gate ``(gid, u, slot)`` adds target
    bit ``8 * slot + u`` to the pair ``(d, gid)``; ``accs`` [P] holds each
    slot's accept bits (``acc`` their union)."""
    pairs = {}
    for d, pis in spec.diags:
        for pi in pis:
            gid, u, slot = spec.gpos[pi]
            pairs[(d, gid)] = pairs.get((d, gid), 0) | (1 << (8 * slot + u))
    accs = [0] * P
    for slot, s in spec.accepts:
        accs[slot] |= 1 << (8 * slot + s)
    acc = 0
    for a in accs:
        acc |= a
    return (*sb.dg_tables(spec.gates, pairs, acc), accs)


SEED_SLOTS = 0x01010101  # state 0 of every slot


def swar_multi_stats_plain(data, lengths, tables: sb.ScanTables, *, seeded: bool):
    """Plain version of ``rrx_swar_multi_stats``: the slotted step of
    :func:`scan_bits.stats_plain` (int64 masked to 32 bits) seeded with
    state 0 of every slot, one accept channel per slot, non-nullable
    closed forms (the JAX package's ``_swar_stats(nullable=False)`` per byte
    lane). Returns (cnt, first, last, full), each [R, P]."""
    return sb.stats_plain(data, lengths, tables, seeded=seeded, lead=0, nullable=False,
                          seed=SEED_SLOTS)


def swar_multi_stats(data, lengths, tables: sb.ScanTables, *, seeded: bool):
    """(cnt, first, last, full), each [R, P], of the slotted scan of
    ``data`` [R, L] uint8 with ``lengths`` [R]: ``rrx_swar_multi_stats`` on
    a CUDA tensor (counted in ``swar_multi_stats.launches``),
    :func:`swar_multi_stats_plain` on a CPU tensor."""
    if data.device.type == "cpu":
        return swar_multi_stats_plain(data, lengths, tables, seeded=seeded)
    out = sb.launch_swar_multi(data, lengths, tables, seeded=seeded)
    swar_multi_stats.launches += 1
    return out


swar_multi_stats.launches = 0


def swar_stats(data, lengths, tables: sb.ScanTables, *, seeded: bool,
               lead: int = 0, nullable: bool = False):
    """(cnt, first, last, full) [R] of ``data`` [R, L] uint8 with
    ``lengths`` [R]. A CUDA tensor goes to the kernel ``rrx_swar_stats``
    (and counts one launch in ``swar_stats.launches``); a CPU tensor goes
    to the plain PyTorch version."""
    if data.device.type == "cpu":
        return sb.stats_plain(
            data, lengths, tables, seeded=seeded, lead=lead, nullable=nullable
        )
    out = sb.launch_stats(
        "rrx_swar_stats", data, lengths, tables,
        seeded=seeded, lead=lead, nullable=nullable,
    )
    swar_stats.launches += 1
    return out


swar_stats.launches = 0


def swar_reverse(data, lengths, tables: sb.ScanTables):
    """Hit words [W, R] int32 of the reverse scan (``rrx_swar_reverse``,
    counted in ``swar_reverse.launches``, on a CUDA tensor; the plain
    version on a CPU tensor)."""
    if data.device.type == "cpu":
        return sb.reverse_plain(data, lengths, tables)
    out = sb.launch_reverse(data, lengths, tables)
    swar_reverse.launches += 1
    return out


def swar_lazy_spans(data, lengths, tables: sb.ScanTables, hits, cap: int):
    """(starts [R, cap], ends [R, cap], cnt [R]) of the lazy span pass
    (``rrx_swar_lazy_spans`` on a CUDA tensor, the plain version on a CPU
    tensor)."""
    if data.device.type == "cpu":
        return sb.lazy_spans_plain(data, lengths, tables, hits, cap)
    out = sb.launch_lazy_spans(data, lengths, tables, hits, cap)
    swar_lazy_spans.launches += 1
    return out


def swar_anchor_end(data, lengths, tables: sb.ScanTables, starts, *, longest: bool):
    """End [R] int32 of the anchored rescan from ``starts`` (-1 =
    inactive): first end, or last with ``longest`` (``rrx_swar_anchor_end``
    on a CUDA tensor, the plain version on a CPU tensor)."""
    if data.device.type == "cpu":
        return sb.anchor_plain(data, lengths, tables, starts, longest=longest)
    out = sb.launch_anchor_end(data, lengths, tables, starts, longest=longest)
    swar_anchor_end.launches += 1
    return out


def swar_greedy_spans(data, lengths, tables: sb.ScanTables, hits, cap: int):
    """(starts [R, cap], ends [R, cap], cnt [R], over [R] bool) of the
    greedy rounds (``rrx_swar_greedy_spans`` on a CUDA tensor, the plain
    version on a CPU tensor)."""
    if data.device.type == "cpu":
        return sb.greedy_spans_plain(data, lengths, tables, hits, cap)
    out = sb.launch_greedy_spans(data, lengths, tables, hits, cap)
    swar_greedy_spans.launches += 1
    return out


swar_reverse.launches = 0
swar_lazy_spans.launches = 0
swar_anchor_end.launches = 0
swar_greedy_spans.launches = 0


class SwarScanner(PallasScanner):
    """Forward match statistics and spans of an 8-state program on
    ``device``, on the SWAR kernels; what they do not cover runs on the
    inherited matmul-tier methods. Constructed by the engine when
    ``swar_spec(prog)`` qualifies."""

    def __init__(self, prog: DeviceProgram, device, nullable=None):
        sspec = swar_spec(prog)
        if sspec is None:
            raise ValueError(f"{prog.pattern!r} does not fit the SWAR tier")
        super().__init__(prog, device, nullable=nullable)
        self.sspec = sspec
        self.tables = sb.device_tables(*swar_tables(sspec), self.device)

    def _swar_window(self, L: int, B: int, seeded: bool):
        """(k, w, h) split of long records into k overlapped windows, or
        None: the JAX package's rule, unchanged (exact for bounded-horizon
        anchor-free non-nullable patterns; the window target is
        ``swar_window_cols`` 32-record columns)."""
        from ..utils.config import get_config

        p = self.prog
        if not seeded or self.nullable or p.nullable or p.uses_anchor:
            return None
        h = p.horizon
        if h is None or h > 64:
            return None
        w_min = max(128, 4 * h)
        target = get_config().swar_window_cols
        if not target or L < 2 * w_min:
            return None
        cols = -(-B // RECS)
        if cols >= target:
            return None
        k = min(L // w_min, -(-target // cols))
        if k < 2:
            return None
        w = -(-L // k)
        k = -(-L // w)
        return (k, w, h) if k >= 2 else None

    def match_stats_b(self, data, len_g, *, seeded: bool, lead: int = 0):
        """(cnt, first, last, full, any), each shaped like ``len_g``."""
        if lead and self.nullable:
            # the windowed nullable count corrections live on the matmul path
            return super().match_stats_b(data, len_g, seeded=seeded, lead=lead)
        data, len_g, lengths = self._batch(data, len_g)
        B, L = lengths.numel(), data.shape[1]
        win = self._swar_window(L, B, seeded) if not lead else None
        if win is not None:
            cnt, first, last, full = self._swar_call_win(data, lengths, *win)
        else:
            cnt, first, last, full = swar_stats(
                data, lengths, self.tables,
                seeded=seeded, lead=lead, nullable=self.nullable,
            )
        sl = lambda x: x.reshape(len_g.shape)  # noqa: E731
        cnt = sl(cnt)
        return cnt, sl(first), sl(last), sl(full), cnt > 0

    def reverse_hits_b(self, data, len_g):
        """[B, L + 2] bool candidate-start hits: step t set = a match can
        start at max(t - 1, 0)."""
        data, _, lengths = self._batch(data, len_g)
        hits = swar_reverse(data, lengths, self.tables)
        return sb.hit_bits(hits, data.shape[1] + 2)

    def lazy_spans_b(self, data, len_g, *, cap: int):
        """(starts [B, cap], ends [B, cap], cnt [B]): lazy (leftmost-
        shortest) spans, -1 past the count; cnt counts past cap."""
        if self.nullable:
            return super().lazy_spans_b(data, len_g, cap=cap)
        data, _, lengths = self._batch(data, len_g)
        hits = swar_reverse(data, lengths, self.tables)
        return swar_lazy_spans(data, lengths, self.tables, hits, cap)

    def anchor_end_b(self, data, len_g, starts_g, *, longest: bool):
        """Anchored-rescan end per record, shaped like ``len_g``: the first
        end from ``starts_g`` (-1 = inactive), or the last with
        ``longest``; -1 when none."""
        data, len_g, lengths = self._batch(data, len_g)
        starts = torch.as_tensor(starts_g, device=self.device).reshape(-1).to(torch.int32)
        end = swar_anchor_end(data, lengths, self.tables, starts, longest=longest)
        return end.reshape(len_g.shape)

    def greedy_spans_b(self, data, len_g, *, cap: int):
        """(starts [B, cap], ends [B, cap], cnt [B], over [B] bool): greedy
        (leftmost-longest, POSIX) spans; ``over`` = more spans than cap."""
        if self.nullable:
            return super().greedy_spans_b(data, len_g, cap=cap)
        data, _, lengths = self._batch(data, len_g)
        hits = swar_reverse(data, lengths, self.tables)
        return swar_greedy_spans(data, lengths, self.tables, hits, cap)

    @staticmethod
    def windows(data, lengths, k: int, w: int, h: int):
        """[B, L] records -> ([B * k, width] overlapped windows, [B * k]
        window lengths, [1, k] window offsets). Window j holds bytes
        [j*w - h, j*w + w): an h-byte head (window 0's is 0xFF-filled, a
        dead byte for ASCII programs) and w owned bytes. Rows are padded
        to a multiple of 16 bytes for the kernel's loads."""
        B, L = data.shape
        dev = data.device
        width = -(-(w + h) // 16) * 16
        main = F.pad(data, (0, k * w - L)).reshape(B, k, w)
        parts = [
            torch.cat(
                [
                    torch.full((B, 1, h), 0xFF, dtype=torch.uint8, device=dev),
                    main[:, : k - 1, w - h :],
                ],
                dim=1,
            ),
            main,
        ]
        if width > w + h:
            parts.append(
                torch.zeros((B, k, width - w - h), dtype=torch.uint8, device=dev)
            )
        wind = torch.cat(parts, dim=2).reshape(B * k, width)
        off = torch.arange(k, dtype=torch.int32, device=dev)[None, :] * w
        lnw = (lengths[:, None] + h - off).clamp(0, w + h).reshape(-1)
        return wind, lnw.to(torch.int32), off

    def _swar_call_win(self, data, lengths, k: int, w: int, h: int):
        """Windowed scan: overlapped windows scanned with lead = h, then
        reduced per record (sum of counts, min of shifted first ends, max
        of shifted last ends)."""
        B = data.shape[0]
        wind, lnw, off = self.windows(data, lengths, k, w, h)
        cnt, first, last, _ = swar_stats(
            wind, lnw, self.tables, seeded=True, lead=h, nullable=False
        )
        cnt = cnt.reshape(B, k)
        first = first.reshape(B, k)
        last = last.reshape(B, k)
        cnt_rec = cnt.sum(dim=1, dtype=torch.int32)
        fg = torch.where(first >= 0, first - h + off, BIG)
        fmin = fg.min(dim=1).values
        first_rec = torch.where(fmin >= BIG, -1, fmin).to(torch.int32)
        lg = torch.where(last >= 0, last - h + off, -1)
        last_rec = lg.max(dim=1).values.to(torch.int32)
        # seeded 'full' = some match ends at len = the max end hits len
        full_rec = (cnt_rec > 0) & (last_rec >= lengths)
        return cnt_rec, first_rec, last_rec, full_rec


class SwarMultiScanner(PallasScanner):
    """Multi-pattern SWAR scanner: up to 4 patterns of at most 8 states,
    one u32 byte lane each (:class:`SwarMultiSpec`), whose combined grep
    scan (``match_stats_b``) runs on ``rrx_swar_multi_stats``. Everything
    else (windowed ``lead`` scans, flags, reverse hits, anchored rescans,
    ``lazy_spans_mb``) is the matmul tier's with the accept map, as in the
    JAX package; the primitives that read one accept set raise. The
    slotted statistics are non-nullable, as the JAX package's: the API
    corrects nullable channels on the host. Constructed by the engine
    when ``swar_multi`` is on and ``swar_multi_spec`` takes the patterns'
    subprograms."""

    def __init__(self, prog: DeviceProgram, device, mspec: SwarMultiSpec, P: int,
                 accept_map, nullable=None):
        super().__init__(prog, device, accept_map=accept_map, nullable=nullable)
        if self.P != P or P > 4:
            raise ValueError(f"an accept map of {self.P} channels per record, P = {P} (at most 4)")
        self.mspec = mspec
        deltas, tab, acc, accs = swar_multi_tables(mspec, P)
        self.tables = sb.device_tables(deltas, tab, acc, self.device, accs=accs)

    def match_stats_b(self, data, len_g, *, seeded: bool, lead: int = 0):
        """(cnt, first, last, full, any), each [B_rows, G * P]: record-major,
        channel-minor."""
        if lead:  # windowed scans run on the matmul tier's P-channel kernel
            return super().match_stats_b(data, len_g, seeded=seeded, lead=lead)
        data, len_g, lengths = self._batch(data, len_g)
        cnt, first, last, full = swar_multi_stats(data, lengths, self.tables, seeded=seeded)
        sl = lambda x: x.reshape(len_g.shape[0], len_g.shape[1] * self.P)  # noqa: E731
        cnt = sl(cnt)
        return cnt, sl(first), sl(last), sl(full), cnt > 0
