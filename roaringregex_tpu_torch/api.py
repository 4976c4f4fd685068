"""Batched matching API: ``compile(pattern, device)`` -> :class:`Pattern`.

The port of ``roaringregex_tpu/api.py``'s batched entry points:
``search_batch``, ``count_batch`` and ``grep`` (seeded scans),
``fullmatch_batch`` and ``fullmatch`` (unseeded), and span extraction:
``finditer_batch`` (lazy or greedy), ``finditer``, ``findall``, ``search``
and ``match``. Spans use the normative lazy policy (leftmost start,
shortest end, non-overlapping, empty matches advance by one) or POSIX
leftmost-longest with ``longest=True``.

Spans run on the device in O(1) dispatches, as on the JAX package's
pallas backend, wherever the engine's scanner has anchored kernels: one
reverse pass, then the lazy span kernel or the greedy round kernel, on the
SWAR tier's kernels or the matmul tier's (every other dense program the
engine takes: u32-word and 33..256-state programs, and nullable greedy
spans, which fall back to the empty match where no longer one starts).
The counting tier and the programs that run through their seeded alias
take the JAX package's other route: host rounds over ``starts_bitmap``,
each round one batched anchored rescan (``ScanEngine.first_end_from``).
``ends_batch`` and ``starts_batch`` return every match end and start
position; ``dump`` returns a text dump of the automaton. ``MultiPattern``
and long strings are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

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

    def dump(self, full: bool = False) -> str:
        """NFA dump; ``full=True`` adds per-state per-symbol forward and
        backward transition rows."""
        return self.program.nfa.dump(full=full)

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

    def ends_batch(self, texts: Sequence[TextLike]) -> List[List[int]]:
        """Every position at which some match ends, per record."""
        data, lengths, B, maxlen = self._pack(texts)
        bm = self.engine.ends_bitmap(data, lengths, maxlen)
        return [[int(p) for p in np.nonzero(bm[i])[0] if p <= lengths[i]] for i in range(B)]

    def starts_batch(self, texts: Sequence[TextLike]) -> List[List[int]]:
        """Every position at which some match starts, per record."""
        data, lengths, B, maxlen = self._pack(texts)
        bm = self.engine.starts_bitmap(data, lengths, maxlen)
        return [[int(p) for p in np.nonzero(bm[i])[0] if p <= lengths[i]] for i in range(B)]

    def finditer_batch(
        self, texts: Sequence[TextLike], *, longest: bool = False
    ) -> List[List[Tuple[int, int]]]:
        """Non-overlapping spans for every record: lazy (leftmost-shortest,
        default) or greedy (``longest=True``, leftmost-longest, POSIX). On
        the device in O(1) dispatches where the scanner has anchored
        kernels, else in host rounds over ``starts_bitmap``."""
        data, lengths, B, maxlen = self._pack(texts)
        sc = self.engine.device_scanner
        if sc is None or not sc.has_anchor:
            return self._finditer_rounds(data, lengths, B, maxlen, longest)
        eng = self.engine
        if self.program.nullable and not longest:
            # lazy spans of a nullable pattern: the empty match at every
            # position (shortest end == start, advance by one)
            return [[(p, p) for p in range(int(lengths[i]) + 1)] for i in range(B)]
        # Pre-size the span buffers from one counts pass: every emitted
        # span (lazy or greedy) ends at a distinct match-end position, so
        # n_spans <= match_stats count per record, bucketed to a power of
        # two. Nullable greedy: the empty-match fallback makes every
        # position a potential span start.
        if self.program.nullable:
            mx = int(lengths[:B].max()) + 1 if B else 1
        else:
            cnt0, _, _ = eng.match_stats(data, lengths, seeded=True)
            mx = int(cnt0[:B].max()) if B else 0
        cap = _pow2(min(max(mx, 1), maxlen + 1 if maxlen else 1))
        while True:
            if longest:
                s_buf, e_buf, cnt, over = eng.greedy_spans(data, lengths, cap=cap)
                need_retry = bool(over[:B].any())
            else:
                s_buf, e_buf, cnt = eng.lazy_spans(data, lengths, cap=cap)
                need_retry = bool((cnt[:B] > cap).any())
            if not need_retry or cap > maxlen:
                break
            cap = min(_pow2(cap * 4), maxlen + 1)  # unreachable safety net
        s_np, e_np, c_np = (x.cpu().numpy() for x in (s_buf, e_buf, cnt))
        return [
            list(zip(s_np[i, : c_np[i]].tolist(), e_np[i, : c_np[i]].tolist()))
            for i in range(B)
        ]

    def _finditer_rounds(self, data, lengths, B, maxlen, longest):
        """Host rounds: each round, every active record takes its first
        start at or after ``pos`` from the starts bitmap, one batched
        anchored rescan gives its end (the lazy end of a nullable pattern
        is the start itself; a greedy nullable one falls back to it), and
        ``pos`` moves past the span."""
        bm = self.engine.starts_bitmap(data, lengths, maxlen)  # [Bp, maxlen + 1]
        nullable = self.program.nullable
        Bp = bm.shape[0]
        spans: List[List[Tuple[int, int]]] = [[] for _ in range(Bp)]
        pos = np.zeros(Bp, dtype=np.int64)
        active = np.arange(Bp) < B  # padding records inactive
        cols = np.arange(bm.shape[1])[None, :]
        while True:
            mask = bm & (cols >= pos[:, None]) & (cols <= lengths[:, None]) & active[:, None]
            has = mask.any(axis=1)
            starts = np.where(has, mask.argmax(axis=1), -1).astype(np.int32)
            active &= has
            if not active.any():
                break
            if nullable and not longest:
                ends = starts
            else:
                ends = self.engine.first_end_from(data, lengths, starts, longest=longest)
                ends = ends.cpu().numpy()
                if nullable:
                    ends = np.where(ends >= starts, ends, starts)
            for i in np.nonzero(active)[0]:
                s, e = int(starts[i]), int(ends[i])
                if e < s:
                    raise RuntimeError(f"{self.pattern!r}: record {i} has a start at {s} "
                                       f"but its anchored rescan ended at {e}")
                spans[i].append((s, e))
                pos[i] = e if e > s else s + 1
                if pos[i] > lengths[i]:
                    active[i] = False
        return spans[:B]

    def finditer(self, text: TextLike, *, longest: bool = False) -> Iterator[Match]:
        b = _as_bytes(text)
        for s, e in self.finditer_batch([b], longest=longest)[0]:
            yield Match(s, e, b)

    def findall(self, text: TextLike, *, longest: bool = False) -> List[bytes]:
        return [m.group() for m in self.finditer(text, longest=longest)]

    def search(self, text: TextLike) -> Optional[Match]:
        b = _as_bytes(text)
        spans = self.finditer_batch([b])[0]
        return Match(*spans[0], b) if spans else None

    def match(self, text: TextLike) -> Optional[Match]:
        """Anchored-at-0 lazy prefix match."""
        b = _as_bytes(text)
        if self.program.nullable:
            return Match(0, 0, b)
        data, lengths, _, _ = self._pack([b])
        starts = np.full(data.shape[0], -1, np.int32)
        starts[0] = 0
        e = int(self.engine.first_end_from(data, lengths, starts)[0])
        return Match(0, e, b) if e >= 0 else None

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
