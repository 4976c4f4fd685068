"""Scan engine: routes a compiled program to its scan tier on one device.

The port of ``roaringregex_tpu/engine.py``'s batched match-stats and
span primitives. The JAX engine picks, for a dense program, the 8-state
SWAR tier when ``swar_spec`` accepts it, else the u32-word tier when
``word_spec`` does, else the matmul kernels. The port has the first two; a
program that neither accepts raises ``NotImplementedError`` (the matmul,
counting, bitband and container tiers are queued in ROADMAP.md). Reverse
hits, anchored rescans and spans run on the SWAR tier only: the JAX
package runs them for word-tier programs on the matmul tier's span
kernels, which are not ported yet, so there they raise.

Engine primitives take raw byte batches: ``data`` [B, L] uint8 and
``lengths`` [B] int32 (numpy or torch), moved to the engine's device.
The device is always the caller's choice: nothing here picks one.
"""
from __future__ import annotations

import numpy as np
import torch

from .compiler.program import DeviceProgram


class ScanEngine:
    """Per-program engine: holds the device tables and exposes the scan
    primitives."""

    def __init__(self, prog: DeviceProgram, device):
        from .ops.scan_swar import SwarScanner, swar_spec
        from .ops.scan_word import WordScanner, word_spec
        from .utils.config import get_config

        self.prog = prog
        self.device = torch.device(device)
        cfg = get_config()
        if cfg.swar and swar_spec(prog) is not None:
            self._scanner = SwarScanner(prog, self.device)
        elif cfg.swar and word_spec(prog) is not None:
            self._scanner = WordScanner(prog, self.device)
        else:
            why = "RRX_SWAR=0" if not cfg.swar else "neither the SWAR nor the u32-word spec accepts it"
            raise NotImplementedError(
                f"{prog.pattern!r}: tier {prog.tier}, {prog.n_states} states "
                f"({why}); the port has the SWAR (<= 8 states) and u32-word "
                "(<= 32 states) tiers only, the matmul, counting, bitband "
                "and container tiers are still to be ported (see ROADMAP.md)"
            )

    @property
    def device_scanner(self):
        """The selected kernel scanner (SwarScanner or WordScanner)."""
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
        cnt, first, _, _, anym = self._scanner.match_stats_b(
            self._data(data), self._len_g(lengths), seeded=seeded
        )
        return cnt.reshape(-1), first.reshape(-1), anym.reshape(-1)

    def span_scanner(self, what: str):
        """The SWAR scanner, which runs ``what`` (reverse hits, anchored
        rescans, spans); a word-tier program raises."""
        from .ops.scan_swar import SwarScanner

        if not isinstance(self._scanner, SwarScanner):
            raise NotImplementedError(
                f"{what} of {self.prog.pattern!r} ({self.prog.n_states} states, "
                "u32-word tier): the JAX package runs them on the matmul tier's "
                "reverse, anchored-rescan and span kernels, which are not ported "
                "yet (see ROADMAP.md)"
            )
        return self._scanner

    def reverse_hits(self, data, lengths) -> torch.Tensor:
        """[B, L + 2] bool start-position hits (step t = start max(t-1, 0))."""
        return self.span_scanner("reverse hits").reverse_hits_b(
            self._data(data), self._len_g(lengths)
        )

    def first_end_from(self, data, lengths, starts, *, longest: bool = False):
        """Anchored-rescan end per record [B] (-1 = none): smallest end (lazy
        policy) or, with ``longest=True``, largest end (greedy leftmost-
        longest, the POSIX policy). The JAX engine's seeded-alias and
        prefilter rewrites apply only to multiblock and sparse programs,
        which the port does not route yet."""
        sc = self.span_scanner("anchored rescans")
        starts_g = torch.as_tensor(starts, device=self.device).reshape(-1, self.prog.G)
        first = sc.anchor_end_b(
            self._data(data), self._len_g(lengths), starts_g, longest=longest
        )
        return first.reshape(-1)

    def lazy_spans(self, data, lengths, *, cap: int):
        """(starts [B, cap], ends [B, cap], count [B]): lazy spans."""
        return self.span_scanner("lazy spans").lazy_spans_b(
            self._data(data), self._len_g(lengths), cap=cap
        )

    def greedy_spans(self, data, lengths, *, cap: int):
        """(starts, ends, count, overflow): greedy (leftmost-longest) spans."""
        return self.span_scanner("greedy spans").greedy_spans_b(
            self._data(data), self._len_g(lengths), cap=cap
        )

    def fullmatch_flags(self, data, lengths) -> np.ndarray:
        """[B] bool whole-string acceptance: the ``full`` statistic of an
        unseeded scan."""
        _, _, _, full, _ = self._scanner.match_stats_b(
            self._data(data), self._len_g(lengths), seeded=False
        )
        return full.reshape(-1).cpu().numpy()
