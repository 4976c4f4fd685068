"""Batched matching API: ``compile(pattern, device)`` -> :class:`Pattern`.

The port of ``roaringregex_tpu/api.py``'s batched match-stats entry
points: ``search_batch``, ``count_batch`` and ``grep`` (seeded scans),
``fullmatch_batch`` and ``fullmatch`` (unseeded). Span extraction
(``finditer*``, ``search``, ``match``), ``MultiPattern`` and long strings
are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .compiler.program import DeviceProgram, compile_program
from .engine import ScanEngine

TextLike = Union[str, bytes]


@dataclass(frozen=True)
class Match:
    """A match span [start, end)."""

    start: int
    end: int
    text: bytes

    def group(self) -> bytes:
        return self.text[self.start : self.end]

    def span(self) -> Tuple[int, int]:
        return (self.start, self.end)


def _as_bytes(t: TextLike) -> bytes:
    return t.encode("ascii") if isinstance(t, str) else bytes(t)


def _pow2(n: int, lo: int = 8) -> int:
    x = lo
    while x < n:
        x *= 2
    return x


class Pattern:
    """A compiled pattern bound to a scan engine on one device."""

    def __init__(self, pattern: str, device):
        self.program: DeviceProgram = compile_program(pattern)
        self.engine = ScanEngine(self.program, device)

    @property
    def pattern(self) -> str:
        return self.program.pattern

    def _pack(self, texts: Sequence[TextLike]):
        """Texts -> (data [Bp, Lp] uint8, lengths [Bp] int32, B, maxlen),
        with B and the width padded to powers of two as the JAX package
        pads them (so both packages scan the same shapes)."""
        bs = [_as_bytes(t) for t in texts]
        B = len(bs)
        maxlen = max((len(b) for b in bs), default=0)
        Bp = _pow2(B, lo=max(8, self.program.G))
        Lp = _pow2(max(maxlen, 1), lo=16)
        data = np.zeros((Bp, Lp), dtype=np.uint8)
        lengths = np.zeros(Bp, dtype=np.int32)
        for i, b in enumerate(bs):
            data[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lengths[i] = len(b)
        return data, lengths, B, maxlen

    def fullmatch_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        data, lengths, B, _ = self._pack(texts)
        return self.engine.fullmatch_flags(data, lengths)[:B]

    def search_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        data, lengths, B, _ = self._pack(texts)
        _, _, anym = self.engine.match_stats(data, lengths, seeded=True)
        return anym.cpu().numpy()[:B]

    def count_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        """Number of distinct match-end positions per record."""
        data, lengths, B, _ = self._pack(texts)
        cnt, _, _ = self.engine.match_stats(data, lengths, seeded=True)
        return cnt.cpu().numpy()[:B]

    def grep(self, lines: Sequence[TextLike]) -> List[int]:
        """Indices of records containing a match."""
        hits = self.search_batch(lines)
        return [i for i, h in enumerate(hits) if h]

    def fullmatch(self, text: TextLike) -> Optional[Match]:
        b = _as_bytes(text)
        if bool(self.fullmatch_batch([b])[0]):
            return Match(0, len(b), b)
        return None


def compile(pattern: str, device) -> Pattern:  # noqa: A001
    """Compile a POSIX-ERE pattern for ``device`` ("cuda", "cuda:0" or
    "cpu"; the CPU runs the kernels' plain PyTorch versions)."""
    return Pattern(pattern, device)
