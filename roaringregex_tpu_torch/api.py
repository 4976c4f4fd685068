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
engine takes: u32-word and 33..256-state programs, the dense multiblock
ones of 257..1024 states such as ``(keywords)+`` lists of 40+ words and
``x(ab|c){300,}y``, and nullable greedy spans, which fall back to the empty
match where no longer one starts), or
on the bitband tier's (multiblock and sparse programs whose follow matrix
decomposes, such as bench config 10, ``x(ab|c){400,520}y``: one reverse
pass, then rounds of anchored rescans in each record's own warp, lazy or
longest; a nullable bitband program takes the host rounds below).
The counting and container tiers (the JAX ``SparseScanner``: keyword
alternations past ~35 words, config 13's own tier), and the packed and XLA
backends, take the JAX package's other route: host rounds over
``starts_bitmap``, each round one batched anchored rescan
(``ScanEngine.first_end_from``: over the mask stream, on
``rrx_stream_first_end``, for a dense or multiblock program such as config
4's ``a{1,300}``).
``ends_batch`` and ``starts_batch`` return every match end and start
position; ``dump`` returns a text dump of the automaton.

``MultiPattern(patterns, device)`` scans P patterns in one pass over their
combined automaton (the Glushkov union): per-pattern counts, search hits
and grep from one per-channel match-stats scan, and, on the u32-word and
matmul tiers (dense multiblock unions of 257..1024 states included),
every pattern's lazy spans from one channel reverse pass and one channel
span pass. A combined program on the bitband or container tier (keyword
lists past ~35 words, sets past 256 states), or on the packed backend,
takes its spans per pattern, and on the XLA backend every method runs per
pattern, as in the JAX package.

``compile``, ``Pattern`` and ``MultiPattern`` take ``backend`` (None reads
``RRX_BACKEND``; unset, the kernel route on any device): "packed" or
"xla" select the JAX package's plain backends (``ScanEngine``).

One long string (``Pattern.long``, ``finditer_long``, ``rev_long``): the
string is scanned in windows on the card (``ops/longstring.py``), for
counts, search, fullmatch, the end and start bitmaps and spans.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .compiler.nfa import build_nfa, combine_nfas
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


def _grown_cap(cap: int, maxlen: int) -> int:
    """The next span cap after a batch overflowed ``cap``: unreachable in
    practice (caps are pre-sized from a counts pass), never a silent
    truncation."""
    return min(_pow2(cap * 4), maxlen + 1)


def _pack_texts(texts: Sequence[TextLike], G: int):
    """Texts -> (data [Bp, Lp] uint8, lengths [Bp] int32, B, maxlen),
    with B and the width padded to powers of two as the JAX package pads
    them (so both packages scan the same shapes)."""
    bs = [_as_bytes(t) for t in texts]
    B = len(bs)
    maxlen = max((len(b) for b in bs), default=0)
    Bp = _pow2(B, lo=max(8, G))
    Lp = _pow2(max(maxlen, 1), lo=16)
    data = np.zeros((Bp, Lp), dtype=np.uint8)
    lengths = np.zeros(Bp, dtype=np.int32)
    for i, b in enumerate(bs):
        data[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    return data, lengths, B, maxlen


class Pattern:
    """A compiled pattern bound to a scan engine on one device. ``backend``
    (None: ``RRX_BACKEND``, else the kernel route) is the engine's:
    "pallas", "packed" or "xla" (:class:`ScanEngine`)."""

    def __init__(self, pattern: str, device, backend: Optional[str] = None):
        self.program: DeviceProgram = compile_program(pattern)
        self.engine = ScanEngine(self.program, device, backend=backend)

    @property
    def pattern(self) -> str:
        return self.program.pattern

    @property
    def n_states(self) -> int:
        return self.program.n_states

    @property
    def tier(self) -> str:
        return self.program.tier

    def dump(self, full: bool = False) -> str:
        """NFA dump; ``full=True`` adds per-state per-symbol forward and
        backward transition rows."""
        return self.program.nfa.dump(full=full)

    def _pack(self, texts: Sequence[TextLike]):
        """Texts -> (data [Bp, Lp] uint8, lengths [Bp] int32, B, maxlen)."""
        return _pack_texts(texts, self.program.G)

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
        kernels, else (the counting and container tiers, the packed and XLA
        backends) in host rounds over ``starts_bitmap``."""
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
            cap = _grown_cap(cap, maxlen)
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

    # -- one long string ------------------------------------------------------
    @property
    def long(self):
        """Scanner of ONE huge string on the pattern's device
        (``ops/longstring.py``): ``pat.long.search(blob)``, ``count_ends``,
        ``fullmatch``, ``ends_bitmap``, ``starts_bitmap`` and ``flags``. The
        string is bytes or a uint8 tensor (on the device already, for
        repeated scans)."""
        if getattr(self, "_long", None) is None:
            from .ops.longstring import make_long_scanner
            from .utils.config import get_config

            self._long = make_long_scanner(self.program, self.engine.device,
                                           block=get_config().long_block)
        return self._long

    @property
    def rev_long(self):
        """Long scanner of the REVERSED program (``parser.reverse_node``):
        its ends in the reversed string are this pattern's starts, for any
        pattern, cyclic ones included."""
        if getattr(self, "_rev_long", None) is None:
            from .compiler.nfa import build_nfa_ast
            from .compiler.parser import parse, reverse_node
            from .ops.longstring import make_long_scanner
            from .utils.config import get_config

            nfa = build_nfa_ast(reverse_node(parse(self.pattern)), f"<rev:{self.pattern}>")
            self._rev_long = make_long_scanner(compile_program(nfa), self.engine.device,
                                               block=get_config().long_block)
        return self._rev_long

    def _anchored_ends(self, arr: np.ndarray, n: int, cc: np.ndarray, width: int,
                       longest: bool) -> np.ndarray:
        """Anchored ends (-1 = none) of the starts ``cc`` over per-start
        slices [start - 1, start - 1 + width) of the string (one byte of
        left context, so an interior slice never shows a BOS; clipped at
        the end), in one batched ``ScanEngine.first_end_from``."""
        G = max(self.program.G, 1)
        g0 = np.maximum(cc.astype(np.int64) - 1, 0)
        idx = g0[:, None] + np.arange(width)[None, :]
        sl = np.where(idx < n, arr[np.minimum(idx, n - 1)], 0).astype(np.uint8)
        lens = np.minimum(width, n - g0).astype(np.int32)
        starts_loc = (cc - g0).astype(np.int32)
        K = len(cc)
        pad = -K % G
        if pad:
            sl = np.pad(sl, ((0, pad), (0, 0)))
            lens = np.pad(lens, (0, pad))
            starts_loc = np.pad(starts_loc, (0, pad), constant_values=-1)
        e_loc = self.engine.first_end_from(sl, lens, starts_loc, longest=longest)
        e_loc = e_loc.cpu().numpy()[:K]
        return np.where(e_loc >= 0, g0 + e_loc, -1)

    def finditer_long(self, text: TextLike, *, longest: bool = False,
                      chunk: int = 4096) -> List[Tuple[int, int]]:
        """Non-overlapping spans over ONE long string, with the policies of
        ``finditer_batch``. Bounded-horizon patterns: candidate starts from
        one overlapped reverse pass (``long.starts_bitmap``), ends from
        batched anchored rescans of short per-candidate slices; the
        non-overlap sweep runs on the host over candidates, not bytes.
        Counting-plan patterns: closed form. Cyclic patterns:
        :meth:`_finditer_long_cyclic`."""
        data = _as_bytes(text)
        n = len(data)
        if n == 0:  # the record path answers the empty string
            return self.finditer_batch([b""], longest=longest)[0]
        lam = self.program.horizon
        sc = self.long
        if not self.program.nullable and hasattr(sc, "spans"):
            return sc.spans(data, longest=longest)
        if lam is None or getattr(sc, "overlap", None) is None:
            return self._finditer_long_cyclic(data, n, longest=longest, chunk=chunk)
        nullable = self.program.nullable
        if nullable and not longest:
            return [(p, p) for p in range(n + 1)]
        cand = np.nonzero(sc.starts_bitmap(data))[0]
        if cand.size == 0:
            return []
        arr = np.frombuffer(data, np.uint8)
        spans: List[Tuple[int, int]] = []
        cursor = 0
        for c0 in range(0, cand.size, chunk):
            cc = cand[c0 : c0 + chunk]
            if cc[-1] < cursor:
                continue  # the whole chunk is claimed by an earlier match
            ends = self._anchored_ends(arr, n, cc, lam + 2, longest)
            if nullable:  # greedy nullable: the empty match is the fallback
                ends = np.maximum(ends, cc)
            for s, e in zip(cc.tolist(), ends.tolist()):
                if s < cursor or e < 0:
                    continue
                spans.append((s, e))
                cursor = e if e > s else s + 1
                if cursor > n:
                    break
            if cursor > n:
                break
        return spans

    def _finditer_long_cyclic(self, data: bytes, n: int, *, longest: bool,
                              chunk: int) -> List[Tuple[int, int]]:
        """finditer_long for cyclic patterns: candidate starts are the
        reversed program's ends over the reversed string (a match starts at
        s iff a match of rev(P) ends at n - s there); lazy ends come from
        batched anchored rescans whose slice doubles until the first end
        lands inside; greedy ends from one full-tail rescan per claim."""
        nullable = self.program.nullable
        if nullable and not longest:
            return [(p, p) for p in range(n + 1)]
        starts_bm = np.asarray(self.rev_long.ends_bitmap(data[::-1]))[::-1]
        cand = np.nonzero(starts_bm)[0]
        if cand.size == 0:
            return []
        arr = np.frombuffer(data, np.uint8)
        spans: List[Tuple[int, int]] = []
        cursor = 0

        def width(w: int) -> int:  # slice widths bucket to powers of two
            return _pow2(min(w + 1, n + 2), lo=16)

        if longest:
            ci = 0
            while ci < cand.size and cursor <= n:
                while ci < cand.size and cand[ci] < cursor:
                    ci += 1
                if ci >= cand.size:
                    break
                s = int(cand[ci])
                e = int(self._anchored_ends(arr, n, np.asarray([s]), width(n - s + 1), True)[0])
                if nullable:
                    e = max(e, s)
                if e < s:
                    raise RuntimeError(f"{self.pattern!r}: a start at {s} with no end")
                spans.append((s, e))
                cursor = e if e > s else s + 1
                ci += 1
            return spans
        for c0 in range(0, cand.size, chunk):
            cc = cand[c0 : c0 + chunk]
            if cc[-1] < cursor:
                continue
            ends = np.full(cc.size, -1, np.int64)
            unresolved = np.arange(cc.size)
            w = 256
            while unresolved.size:
                got = self._anchored_ends(arr, n, cc[unresolved], width(min(w, n + 1)), False)
                ends[unresolved] = got
                if w > n:
                    if (got < 0).any():
                        raise RuntimeError(f"{self.pattern!r}: a start with no end")
                    break
                unresolved = unresolved[got < 0]
                w *= 2
            for s, e in zip(cc.tolist(), ends.tolist()):
                if s < cursor or e < 0:
                    continue
                spans.append((int(s), int(e)))
                cursor = e if e > s else s + 1
                if cursor > n:
                    break
            if cursor > n:
                break
        return spans


def compile(pattern: str, device, backend: Optional[str] = None) -> Pattern:  # noqa: A001
    """Compile a POSIX-ERE pattern for ``device`` ("cuda", "cuda:0" or
    "cpu"; the CPU runs the kernels' plain PyTorch versions) on
    ``backend`` (None: ``RRX_BACKEND``, else the kernel route; "packed" or
    "xla": the JAX package's plain backends)."""
    return Pattern(pattern, device, backend=backend)


class MultiPattern:
    """Several patterns compiled into ONE automaton, scanned in one pass.

    The Glushkov union (``combine_nfas``) shares the start state and keeps
    each pattern's positions disjoint, so one scan tracks per-pattern
    accept channels: the accept map widens from [lanes, G] to [lanes, G *
    P] and goes to the engine as its accept channels. The port of the JAX
    package's ``MultiPattern`` on its pallas backend: the combined program
    runs on the u32-word or matmul tier (lazy spans from one combined scan,
    dense multiblock unions of up to 1024 states included; with
    ``RRX_SWAR_MULTI=1`` up to 4 patterns of at most 8 states count on the
    slotted SWAR scan) or, multiblock or sparse, on the bitband or
    container tier (lazy and greedy spans per pattern). Nullable patterns
    are scanned with the kernels' nullability off and corrected on the
    host. On the packed
    backend one pass over the mask stream counts every channel and spans
    run per pattern; on the XLA backend (one accept channel), and for a
    sparse program with no scanner, every method runs per pattern, as in
    the JAX package (``api.py:618-623``)."""

    def __init__(self, patterns: Sequence[str], device, backend: Optional[str] = None):
        self.patterns = [str(p) for p in patterns]
        if not self.patterns:
            raise ValueError("no patterns")
        self.backend = backend
        self.P = P = len(self.patterns)
        nfas = [build_nfa(p) for p in self.patterns]
        self.nullables = np.array([n.nullable for n in nfas])
        # disjoint position ranges in the combined automaton: pattern p
        # owns states [off_p + 1, off_p + n_p) (combine_nfas layout)
        self._ranges = []
        off = 0
        for n in nfas:
            self._ranges.append((off + 1, off + n.n_states))
            off += n.n_states - 1
        combined, accepts = combine_nfas(nfas)
        self.program: DeviceProgram = compile_program(combined)
        prog = self.program
        s_tile, G, lanes = prog.s_tile, max(prog.G, 1), prog.lanes
        # channel g * P + p over the JAX package's lane packing; state 0
        # (a nullable pattern's empty match) is in no channel
        acc_tile = np.zeros((P, s_tile), np.uint8)
        for p, aset in enumerate(accepts):
            for st in aset:
                if st > 0:
                    acc_tile[p, st] = 1
        A = np.zeros((lanes, G * P), np.uint8)
        for g in range(G):
            for p in range(P):
                A[g * s_tile : (g + 1) * s_tile, g * P + p] = acc_tile[p]
        self.accept_map = A
        # per-pattern programs when every pattern fits the 8-state SWAR tile:
        # with swar_multi on (RRX_SWAR_MULTI=1, off by default, as in the JAX
        # package) the engine runs the combined grep scan slotted, 4 tiny
        # sub-automata per u32 (SwarMultiScanner)
        self.subprograms = (
            [compile_program(n) for n in nfas]
            if P <= 4 and all(n.n_states <= 8 for n in nfas) else None
        )
        self.engine = ScanEngine(prog, device, backend=backend, accept_map=A,
                                 channels_per_record=P, nullable=False,
                                 subprograms=self.subprograms)
        sc = self.engine.device_scanner
        # the per-pattern fallback of the JAX package: the unpacked XLA
        # backend has one accept channel, and so has a sparse program
        # without a scanner
        self._singles: Optional[List[Pattern]] = None
        if sc is None and (not self.engine.packed or prog.tier == "sparse"):
            self._singles = [Pattern(p, device, backend=backend) for p in self.patterns]
        # the u32-word and matmul tiers' channel spans; the bitband and
        # container tiers take spans per pattern (JAX api.py:700)
        self._combined_spans = hasattr(sc, "lazy_spans_mb")
        if self._combined_spans:
            # span channels: sgm [G * P, lanes] = follow[0] restricted to
            # pattern p's positions, posm [lanes, P] position masks
            F0 = np.asarray(prog.F)[0, :s_tile]
            sgm = np.zeros((G * P, lanes), np.uint8)
            posm = np.zeros((lanes, P), np.uint8)
            for g in range(G):
                o = g * s_tile
                for p, (plo, phi) in enumerate(self._ranges):
                    for st in range(max(plo, 1), min(phi, s_tile)):
                        posm[o + st, p] = 1
                        if F0[st]:
                            sgm[g * P + p, o + st] = 1
            sc.set_span_channels(sgm, posm, P)
        self._spanners: Optional[List[Pattern]] = None

    def _pack(self, texts: Sequence[TextLike]):
        data, lengths, B, _ = _pack_texts(texts, self.program.G)
        return data, lengths, B

    def _counts(self, data, lengths, B: int) -> np.ndarray:
        """[B, P] match-end counts of a packed batch, nullable channels
        corrected on the host (an empty match ends at every position)."""
        cnt, _, _ = self.engine.match_stats(data, lengths, seeded=True)
        cnt = cnt.cpu().numpy().reshape(-1, self.P)[:B]
        if self.nullables.any():
            cnt = np.where(self.nullables[None, :], lengths[:B, None] + 1, cnt)
        return cnt

    def count_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        """[B, P] distinct match-end counts per record per pattern."""
        if self._singles is not None:
            return np.stack([p.count_batch(texts) for p in self._singles], axis=1)
        return self._counts(*self._pack(texts))

    def search_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        """[B, P] bool: record contains a match of pattern p."""
        if self._singles is not None:
            return np.stack([p.search_batch(texts) for p in self._singles], axis=1)
        return self.count_batch(texts) > 0

    def grep(self, texts: Sequence[TextLike]) -> np.ndarray:
        return self.search_batch(texts)

    def finditer_batch(
        self, texts: Sequence[TextLike], *, longest: bool = False
    ) -> List[List[List[Tuple[int, int]]]]:
        """[P][B] non-overlapping span lists, one per pattern, under the
        policy of ``Pattern.finditer_batch`` within each pattern. Lazy spans
        of every pattern come from one combined scan (``lazy_spans_mb``:
        one channel reverse pass and one channel span pass, whatever P),
        with the cap pre-sized from the combined counts pass and raised if
        a batch still overflows it; nullable patterns' lazy spans are the
        closed-form empty-match set. Greedy spans, and every span of a
        program on the bitband or container tier, run per pattern through
        ``Pattern``, as in the JAX package."""
        if longest or not self._combined_spans:
            if self._spanners is None:
                self._spanners = self._singles or [
                    Pattern(p, self.engine.device, backend=self.backend) for p in self.patterns]
            return [p.finditer_batch(texts, longest=longest) for p in self._spanners]
        sc = self.engine.device_scanner
        data, lengths, B = self._pack(texts)
        G = max(self.program.G, 1)
        len_g = lengths.reshape(-1, G)
        live = ~self.nullables
        out: List[List[List[Tuple[int, int]]]] = [[] for _ in range(self.P)]
        if live.any():
            # every span ends at a distinct match-end position
            cnt0 = self._counts(data, lengths, B)
            mx = int(cnt0[:, live].max()) if B else 0
            maxlen = int(lengths[:B].max()) if B else 0
            cap = _pow2(min(max(mx, 1), maxlen + 1 if maxlen else 1))
            while True:
                s_buf, e_buf, cnt = sc.lazy_spans_mb(data, len_g, cap=cap)
                c_np = cnt.cpu().numpy()
                if int(c_np[:B][:, live].max(initial=0)) <= cap or cap > maxlen:
                    break
                cap = _grown_cap(cap, maxlen)
            s_np, e_np = s_buf.cpu().numpy(), e_buf.cpu().numpy()
            for p in np.nonzero(live)[0]:
                out[p] = [list(zip(s_np[i, p, : c_np[i, p]].tolist(),
                                   e_np[i, p, : c_np[i, p]].tolist())) for i in range(B)]
        for p in np.nonzero(self.nullables)[0]:
            out[p] = [[(q, q) for q in range(int(lengths[i]) + 1)] for i in range(B)]
        return out
