"""u32-word tier: bit-set scan of programs with at most 32 states.

The port of ``roaringregex_tpu/ops/scan_word.py``'s forward match-stats
path. On the TPU each record owns one u32 lane, the step is a (delta,
gate) decomposition of the follow matrix (``_word_kernel``) and an accept
bit-log is reduced in XLA (``_word_stats``). The spec is the JAX
package's, unchanged; the scan is the CUDA kernel ``rrx_word_stats``
(``csrc/scan_bits.cu``), the same body as the SWAR tier's on 32-bit state
sets. A multi-pattern program (``MultiPattern``'s combined automaton)
scans with P accept channels, one mask per pattern, and gets per-channel
statistics from the same pass. As in the JAX package, ``WordScanner``
subclasses the matmul tier's ``PallasScanner``: windowed (``lead``) scans,
reverse hits, anchored rescans and spans (the multi-channel lazy spans
too) run on its methods.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..compiler.program import DeviceProgram
from . import scan_bits as sb
from .scan_pallas import PallasScanner
from .scan_swar import _merge_runs

MAX_DG_OPS = 64  # (delta, gate) pairs past this: the matmul tier wins


class WordSpec(NamedTuple):
    """Static per-program plan."""

    # deduped byte-set gates: (((lo, hi), ...) merged runs, bos, eos)
    gates: Tuple[Tuple[Tuple[Tuple[int, int], ...], bool, bool], ...]
    # (delta, ((gate_index, target_bitmask), ...))
    dg: Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]
    acc_masks: Tuple[int, ...]  # per accept channel: bitmask of states
    has_eos: bool
    has_bos: bool
    S: int


def word_spec(
    prog: DeviceProgram,
    accept_map: Optional[np.ndarray] = None,
    P: int = 1,
) -> Optional[WordSpec]:
    """Build the u32-word plan, or None if the program doesn't qualify
    (s_tile > 32, a byte class past 0x7F, or more than MAX_DG_OPS pairs).

    ``accept_map`` ([lanes, G * P] 0/1) supplies per-channel accept masks
    for multi-pattern programs: channel p's states are the rows s < S of
    column p (the first record tile), as ``MultiPattern`` builds it."""
    if prog.tier == "sparse" or prog.F is None or prog.s_tile > 32:
        return None
    S = prog.s_tile
    F = np.asarray(prog.F[:S, :S])
    Bw = [int(w[0]) & 0xFFFFFFFF for w in np.asarray(prog.Bc_words)]
    lo, hi, cl = prog.byte_runs
    if len(hi) and int(max(hi)) > 0x7F:
        return None
    runs_all = [(int(l), int(h), int(c)) for l, h, c in zip(lo, hi, cl)]
    bos_c = prog.bos_class if Bw[prog.bos_class] else -1
    eos_c = prog.eos_class if Bw[prog.eos_class] else -1
    gate_ids = {}
    gates = []
    pairs = {}
    has_eos = has_bos = False
    for u in range(S):
        preds = [int(s) for s in range(S) if F[s, u]]
        if not preds:
            continue
        cs = {c for c, w in enumerate(Bw) if (w >> u) & 1}
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
        for s in preds:
            k = (u - s, gid)
            pairs[k] = pairs.get(k, 0) | (1 << u)
    if len(pairs) > MAX_DG_OPS:
        return None
    by_d = {}
    for (d, gid), mask in sorted(pairs.items()):
        by_d.setdefault(d, []).append((gid, mask))
    dg = tuple((d, tuple(ps)) for d, ps in sorted(by_d.items()))
    if accept_map is not None:
        A = np.asarray(accept_map)
        acc_masks = tuple(sum(1 << s for s in range(S) if A[s, p]) for p in range(P))
    else:
        acc = np.asarray(prog.accept)[:S]
        acc_masks = (sum(1 << s for s in range(S) if acc[s]),)
    return WordSpec(tuple(gates), dg, acc_masks, has_eos, has_bos, S)


def word_tables(spec: WordSpec):
    """WordSpec -> (deltas, tab, acc), the kernel's (delta, table) form;
    ``acc`` is the union of the channels' accept masks."""
    pairs = {}
    for d, ps in spec.dg:
        for gid, mask in ps:
            pairs[(d, gid)] = pairs.get((d, gid), 0) | mask
    acc = 0
    for m in spec.acc_masks:
        acc |= m
    return sb.dg_tables(spec.gates, pairs, acc)


def word_stats(data, lengths, tables: sb.ScanTables, *, seeded: bool,
               lead: int = 0, nullable: bool = False):
    """(cnt, first, last, full) of ``data`` [R, L] uint8 with ``lengths``
    [R], each [R, P] for tables with P accept channels, else [R]. A CUDA
    tensor goes to the kernel ``rrx_word_stats`` (one launch counted in
    ``word_stats.launches``, or in ``word_stats.channel_launches`` for its
    P-channel kernel, P > 1); a CPU tensor goes to the plain PyTorch
    version."""
    if data.device.type == "cpu":
        return sb.stats_plain(
            data, lengths, tables, seeded=seeded, lead=lead, nullable=nullable
        )
    out = sb.launch_stats(
        "rrx_word_stats", data, lengths, tables,
        seeded=seeded, lead=lead, nullable=nullable,
    )
    if tables.P > 1:
        word_stats.channel_launches += 1
    else:
        word_stats.launches += 1
    return out


word_stats.launches = 0
word_stats.channel_launches = 0


class WordScanner(PallasScanner):
    """Forward match statistics of a program of up to 32 states on
    ``device`` on the u32-word kernel; every other method is the matmul
    tier's. Constructed by the engine when ``word_spec(prog, accept_map,
    P)`` qualifies and the 8-state SWAR tier does not. With an
    ``accept_map`` ([lanes, G * P], a multi-pattern program's accept
    channels) the statistics come per channel; ``nullable`` overrides the
    program's nullability (``MultiPattern`` scans with it off and corrects
    nullable channels on the host)."""

    def __init__(self, prog: DeviceProgram, device, accept_map=None, P: int = 1,
                 nullable=None):
        wspec = word_spec(prog, accept_map=accept_map, P=P)
        if wspec is None:
            raise ValueError(f"{prog.pattern!r} does not fit the u32-word tier")
        super().__init__(prog, device, accept_map=accept_map, nullable=nullable)
        if self.P != P:
            raise ValueError(f"an accept map of {self.P} channels per record, P = {P}")
        self.wspec = wspec
        self.tables = sb.device_tables(
            *word_tables(wspec), self.device,
            accs=wspec.acc_masks if accept_map is not None else None,
        )

    def match_stats_b(self, data, len_g, *, seeded: bool, lead: int = 0):
        """(cnt, first, last, full, any), each [B_rows, G * P] (``len_g``'s
        shape for one channel): record-major, channel-minor."""
        if lead:  # windowed scans run on the matmul tier, as in the JAX package
            return super().match_stats_b(data, len_g, seeded=seeded, lead=lead)
        data, len_g, lengths = self._batch(data, len_g)
        cnt, first, last, full = word_stats(
            data, lengths, self.tables, seeded=seeded, nullable=self.nullable
        )
        sl = lambda x: x.reshape(len_g.shape[0], len_g.shape[1] * self.P)  # noqa: E731
        cnt = sl(cnt)
        return cnt, sl(first), sl(last), sl(full), cnt > 0
