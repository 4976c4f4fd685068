"""Scan engine: routes a compiled program to its scan tier on one device.

The port of ``roaringregex_tpu/engine.py``'s batched match-stats and
span primitives. A dense program of up to 256 states (the dense128 and
dense256 tiers) goes, as in the JAX engine on its pallas backend, to the
8-state SWAR tier when ``swar_spec`` accepts it, else to the u32-word tier
when ``word_spec`` does, else to the matmul tier (``PallasScanner``).
Programs that the JAX engine sends elsewhere raise ``NotImplementedError``
naming the tier: a one-record-per-row program with a counting plan (the
counting tier), and every multiblock or sparse program (the counting,
bitband, container and multiblock matmul tiers); ROADMAP.md queues them.

Engine primitives take raw byte batches: ``data`` [B, L] uint8 and
``lengths`` [B] int32 (numpy or torch), moved to the engine's device.
The device is always the caller's choice: nothing here picks one.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .compiler.program import DeviceProgram

DENSE_TIERS = ("dense128", "dense256")


class ScanEngine:
    """Per-program engine: holds the device tables and exposes the scan
    primitives."""

    def __init__(self, prog: DeviceProgram, device):
        from .ops.scan_pallas import PallasScanner, counting_plan
        from .ops.scan_swar import SwarScanner, swar_spec
        from .ops.scan_word import WordScanner, word_spec
        from .utils.config import get_config

        self.prog = prog
        self.device = torch.device(device)
        cfg = get_config()
        if prog.tier not in DENSE_TIERS:
            self._unported(
                "the JAX package runs it on the counting, bitband, container or "
                "multiblock matmul tiers"
            )
        if cfg.swar and swar_spec(prog) is not None:
            self._scanner = SwarScanner(prog, self.device)
        elif cfg.swar and word_spec(prog) is not None:
            self._scanner = WordScanner(prog, self.device)
        elif prog.G <= 1 and counting_plan(prog) is not None:
            self._unported("the JAX package runs it on the counting tier (CountScanner)")
        else:
            self._scanner = PallasScanner(prog, self.device)

    def _unported(self, why: str):
        p = self.prog
        raise NotImplementedError(
            f"{p.pattern!r}: tier {p.tier}, {p.n_states} states ({why}); the port "
            "has the SWAR, u32-word and matmul tiers for dense programs of up to "
            "256 states, the counting, bitband and container tiers are still to be "
            "ported (see ROADMAP.md)"
        )

    @property
    def device_scanner(self):
        """The selected kernel scanner (SwarScanner, WordScanner or
        PallasScanner)."""
        return self._scanner

    def _len_g(self, lengths) -> torch.Tensor:
        return torch.as_tensor(lengths, device=self.device).reshape(-1, self.prog.G)

    def _data(self, data) -> torch.Tensor:
        return torch.as_tensor(data, dtype=torch.uint8, device=self.device)

    def match_stats(self, data, lengths, *, seeded: bool):
        """(count, first_end, any) per record, each [B]. The JAX engine's
        seeded-alias and prefilter rewrites apply only to multiblock and
        sparse programs, which the port does not route yet."""
        return self._match_stats_raw(data, lengths, seeded=seeded)

    def _match_stats_raw(self, data, lengths, *, seeded: bool):
        data = self._data(data)
        plan = self._window_plan(data.shape[1], data.shape[0], seeded)
        if plan is not None:
            return self._match_stats_windowed(data, lengths, *plan)
        cnt, first, _, _, anym = self._scanner.match_stats_b(
            data, self._len_g(lengths), seeded=seeded
        )
        return cnt.reshape(-1), first.reshape(-1), anym.reshape(-1)

    def _window_plan(self, L: int, B: int, seeded: bool):
        """(k, w, h) record window split for the matmul tier's batched scan,
        or None: the JAX engine's rule, unchanged. Exact for (cnt, first,
        any) when every match fits in ``h = prog.horizon`` bytes, the
        pattern is anchor-free and non-nullable; the SWAR tier windows
        itself and the u32-word tier never does. Off unless
        ``window_cols`` (``RRX_WINDOW_COLS``) is set."""
        from .ops.scan_swar import SwarScanner
        from .ops.scan_word import WordScanner
        from .utils.config import get_config

        p = self.prog
        if (
            not seeded
            or isinstance(self._scanner, (SwarScanner, WordScanner))
            or p.nullable
            or p.uses_anchor
        ):
            return None
        h = p.horizon
        if h is None or h > 128:
            return None
        w_min = max(128, 4 * h)
        target = get_config().window_cols
        if not target or L < 2 * w_min:
            return None
        G = max(1, p.G)
        rows = max(1, B // G)
        k = min(L // w_min, -(-target // rows))
        if k < 2:
            return None
        w = -(-L // k)
        k = -(-L // w)
        return (k, w, h) if k >= 2 else None

    def _match_stats_windowed(self, data, lengths, k: int, w: int, h: int):
        """Windowed (cnt, first, any): split [B, L] records into [B * k,
        w + h] overlapped windows (front-padded with 0xFF, a dead byte for
        ASCII programs), scan with lead = h, and reduce per record."""
        data = self._data(data)
        B, L = data.shape
        dp = F.pad(data, (h, k * w - L), value=0xFF)
        win = dp.unfold(1, w + h, w).reshape(B * k, w + h)
        off = torch.arange(k, dtype=torch.int32, device=self.device)[None, :] * w
        lengths = torch.as_tensor(lengths, device=self.device).to(torch.int32)
        ln = (lengths[:, None] + h - off).clamp(0, w + h)  # window-local lengths
        cnt, first, _, _, _ = self._scanner.match_stats_b(
            win, ln.reshape(-1, self.prog.G), seeded=True, lead=h
        )
        cnt = cnt.reshape(B, k)
        first = first.reshape(B, k)
        big = 1 << 30
        fmin = torch.where(first >= 0, first - h + off, big).min(dim=1).values
        cnt_rec = cnt.sum(dim=1, dtype=torch.int32)
        first_rec = torch.where(fmin >= big, -1, fmin).to(torch.int32)
        return cnt_rec, first_rec, cnt_rec > 0

    def reverse_hits(self, data, lengths) -> torch.Tensor:
        """[B, L + 2] bool start-position hits (step t = start max(t-1, 0))."""
        return self._scanner.reverse_hits_b(self._data(data), self._len_g(lengths))

    def first_end_from(self, data, lengths, starts, *, longest: bool = False):
        """Anchored-rescan end per record [B] (-1 = none): smallest end (lazy
        policy) or, with ``longest=True``, largest end (greedy leftmost-
        longest, the POSIX policy)."""
        starts_g = torch.as_tensor(starts, device=self.device).reshape(-1, self.prog.G)
        first = self._scanner.anchor_end_b(
            self._data(data), self._len_g(lengths), starts_g, longest=longest
        )
        return first.reshape(-1)

    def lazy_spans(self, data, lengths, *, cap: int):
        """(starts [B, cap], ends [B, cap], count [B]): lazy spans."""
        return self._scanner.lazy_spans_b(self._data(data), self._len_g(lengths), cap=cap)

    def greedy_spans(self, data, lengths, *, cap: int):
        """(starts, ends, count, overflow): greedy (leftmost-longest) spans."""
        return self._scanner.greedy_spans_b(self._data(data), self._len_g(lengths), cap=cap)

    def fullmatch_flags(self, data, lengths) -> np.ndarray:
        """[B] bool whole-string acceptance: the ``full`` statistic of an
        unseeded scan."""
        _, _, _, full, _ = self._scanner.match_stats_b(
            self._data(data), self._len_g(lengths), seeded=False
        )
        return full.reshape(-1).cpu().numpy()
