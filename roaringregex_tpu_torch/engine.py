"""Scan engine: routes a compiled program to its scan tier on one device.

The port of ``roaringregex_tpu/engine.py``'s batched primitives: match
statistics, forward flags, position bitmaps, reverse hits, anchored
rescans and spans. Routing is the JAX engine's on its pallas backend
(``engine.py:209-387``): a program of one record per row (G <= 1) with a
counting plan goes to the counting tier (``CountScanner``) on any tier; a
dense program of up to 256 states to the 8-state SWAR tier when
``swar_spec`` accepts it, else to the u32-word tier when ``word_spec``
does, else to the matmul tier (``PallasScanner``). A sparse program (over
1024 states) whose follow matrix decomposes (``bitband_spec``) and whose
lanes fit ``SPARSE_LANES_MAX`` goes to the bitband tier
(``BitbandScanner``), any other sparse one to the container tier
(``SparseScanner``); so does a multiblock program (257..1024 states) for
which the JAX engine prefers the container kernels to the dense matmul
(:meth:`ScanEngine._multiblock_container_wins`): the bitband tier when it
decomposes, the container tier else. ``RRX_BITBAND=0`` (``bitband``) sends
both to the container tier. Every other multiblock program (a banded one
too) goes to the dense multiblock matmul: the matmul tier's
``PallasScanner`` at its record tile of 384..1024 states.

With an accept map (``accept_map`` [lanes, G * P], ``channels_per_record``
P: the multi-pattern interface of ``MultiPattern``'s combined automaton)
there is no counting plan, no SWAR tier, no seeded alias unless P = 1 and
no window plan: with ``swar_multi`` on (``RRX_SWAR_MULTI=1``) and
``subprograms`` (one program per pattern) that ``swar_multi_spec`` takes,
the program runs on the slotted SWAR scan (``SwarMultiScanner``, up to 4
patterns of at most 8 states, as in the JAX engine), else on the u32-word
tier when ``word_spec`` takes its channels, else on the matmul tier (or, multiblock or sparse, on
the bitband or container tier as above), ``match_stats`` returns [B * P]
per statistic, and every primitive that reads one accept set raises.

A whole-pattern ``X{m,n}`` on the multiblock or sparse tier with no
counting plan may have a seeded alias (:func:`seeded_alias_program`,
``RRX_ALIAS``): its seeded primitives (match stats, forward flags, reverse
hits, the lazy anchored rescan, both bitmaps) run on the alias's engine
(on the backend the caller asked for), as in the JAX package, and its own
route takes the rest.

Backends (``backend``, else ``RRX_BACKEND``; the JAX engine's names):

* ``"pallas"`` (None): the routing above, every tier on its kernels (the
  CUDA kernels on a CUDA device, their plain versions on the CPU). A
  scanner without anchored kernels (counting, container) answers the
  anchored rescans of a dense or multiblock program with
  ``scan_packed.first_end_from`` (``rrx_stream_first_end`` on the card)
  and of a sparse one with ``scan_xla.first_end_from``
  (``engine.py:825-842``). A container program over the container
  kernels' caps (``SPARSE_PARTIAL_MAX`` partial blocks,
  ``SPARSE_LANES_MAX`` lanes) logs the JAX engine's warning and takes the
  ``"xla"`` backend, as there.
* ``"packed"``: every primitive over the mask stream
  (``ops/scan_packed.py``: ``rrx_stream_stats``, ``_flags``, ``_reverse``,
  ``_first_end`` on the card), accept channels included; a sparse
  program takes ``"xla"`` instead, as in the JAX engine.
* ``"xla"``: every primitive in torch ops over the unpacked tables
  (``ops/scan_xla.py``); one accept channel only (``MultiPattern`` scans
  its patterns one by one there).

Off the kernel route ``device_scanner`` is None, the bitmaps and fullmatch
come from unpacked flags and hits, and the API takes its spans in host
rounds. The port never picks a backend by platform: None is the kernel
route on the CPU too.

A sparse program on its own scanner may have a prefilter
(:func:`relaxed_prefilter_program`): a tiny superset-language program
scanned first, whose rejects cannot match; the heavy kernels then run on
the compacted candidate records only (:meth:`ScanEngine._prefilter_apply`),
decided on the device with no host sync.

Engine primitives take raw byte batches: ``data`` [B, L] uint8 and
``lengths`` [B] int32 (numpy or torch), moved to the engine's device.
The device is always the caller's choice: nothing here picks one.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from .compiler.program import DeviceProgram
from .ops import scan_bits as sb
from .ops import scan_packed as sp
from .ops import scan_xla as sx
from .ops.scan_pallas import BANDED_MAX_DIAGS

DENSE_TIERS = ("dense128", "dense256")
MASK32 = sb.MASK32
# the JAX package's RRX_BANDED_MAX_DIAGS (scan_pallas.BANDED_MAX_DIAGS) and
# RRX_SPARSE_PARTIAL_MAX defaults, read by the routing rules
# (_multiblock_container_wins, _big_tier)
SPARSE_PARTIAL_MAX = 120


def seeded_alias_program(prog: DeviceProgram):
    """The program of the ``X{m,}`` alias of a whole-pattern ``X{m,n}`` on
    the multiblock or sparse tier, or None (the JAX package's
    ``seeded_alias_program``, unchanged, on the port's compiler).

    Under seeded semantics (a match may start anywhere) the upper bound is
    unobservable: any chain of L >= m consecutive X-matches ending (or
    starting) at a position contains a min(L, n)-copy sub-chain ending
    (starting) there, so the ends, starts, count, first-end and lazy-span
    sets of ``X{m,n}`` equal those of ``X{m,}``, whose automaton has m
    copies of X instead of n. Unseeded scans (fullmatch, greedy anchored
    rescans) observe the bound and keep the original program."""
    if prog.tier not in ("multiblock", "sparse"):
        return None
    from .ops.scan_pallas import counting_plan
    from .utils.config import get_config

    if not get_config().seeded_alias:
        return None
    if counting_plan(prog) is not None:
        return None  # the counting tier already collapses it
    try:
        from .compiler.nfa import build_nfa_ast
        from .compiler.parser import BOS, EOS, Concat, Lit, Repeat, parse
        from .compiler.program import compile_program

        node = parse(prog.pattern)
        while isinstance(node, Concat) and len(node.parts) == 1:
            node = node.parts[0]
        if not (isinstance(node, Repeat) and node.hi is not None and node.lo >= 1):
            return None

        def has_anchor(nd):
            if isinstance(nd, Lit):
                return BOS in nd.syms or EOS in nd.syms
            parts = getattr(nd, "parts", None) or (
                (nd.child,) if isinstance(nd, Repeat) else ()
            )
            return any(has_anchor(p) for p in parts)

        if has_anchor(node.child):
            return None
        alias_ast = Repeat(node.child, node.lo, None)
        nfa = build_nfa_ast(alias_ast, f"<seeded-alias:{prog.pattern}>")
        if nfa.nullable or nfa.n_states > 256:
            return None
        if nfa.n_states * 2 > prog.n_states:
            return None  # not actually a blowup collapse
        return compile_program(nfa)
    except Exception:  # the alias is best-effort, as in the JAX package
        return None


def relaxed_prefilter_program(prog: DeviceProgram):
    """Tiny superset-language program that prefilters a sparse program, or
    None (the JAX package's ``relaxed_prefilter_program``, unchanged, on
    the port's compiler).

    Replacing every bounded repeat ``X{m,n}`` with ``X{min(m,4),}`` relaxes
    the language to a superset (a chain of m..n copies is also a chain of
    >= min(m, 4) copies), so ``search(P') == False`` proves ``search(P) ==
    False``, and P' collapses the n-fold position blowup to a handful of
    states."""
    if prog.tier != "sparse" or prog.nullable:
        return None
    from .utils.config import get_config

    if not get_config().sparse_prefilter:
        return None
    try:
        from .compiler.nfa import build_nfa_ast
        from .compiler.parser import Alt, Concat, Repeat, parse
        from .compiler.program import compile_program

        changed = []

        def relax(nd):
            if isinstance(nd, Repeat):
                child = relax(nd.child)
                if nd.hi is not None and nd.hi > 1:
                    changed.append(True)
                    return Repeat(child, min(nd.lo, 4), None)
                return Repeat(child, nd.lo, nd.hi)
            if isinstance(nd, Concat):
                return Concat(tuple(relax(p) for p in nd.parts))
            if isinstance(nd, Alt):
                return Alt(tuple(relax(p) for p in nd.parts))
            return nd

        ast = relax(parse(prog.pattern))
        if not changed:
            return None
        nfa = build_nfa_ast(ast, f"<prefilter:{prog.pattern}>")
        if nfa.nullable or nfa.n_states > 64:
            return None
        return compile_program(nfa)
    except Exception:  # the prefilter is best-effort, as in the JAX package
        return None


BACKENDS = ("pallas", "packed", "xla")


class ScanEngine:
    """Per-program engine: holds the device tables and exposes the scan
    primitives. ``backend`` ("pallas" or None: the kernel route, "packed"
    or "xla"; None reads ``RRX_BACKEND``) picks the route, as in the JAX
    engine. ``accept_map`` ([lanes, C] 0/1, C = G *
    ``channels_per_record``) widens the accept reduction to per-channel
    statistics (one combined automaton, one scan); ``nullable`` overrides
    the kernels' nullability (multi-pattern scans turn it off and correct
    nullable channels on the host); ``subprograms`` (one program per
    pattern, ``MultiPattern``'s) enable the slotted SWAR scan when
    ``swar_multi`` is on."""

    def __init__(self, prog: DeviceProgram, device, *, backend=None, accept_map=None,
                 channels_per_record: int = 1, nullable=None, subprograms=None):
        from .ops.scan_pallas import CountScanner, PallasScanner, counting_plan
        from .ops.scan_swar import SwarMultiScanner, SwarScanner, swar_multi_spec, swar_spec
        from .ops.scan_word import WordScanner, word_spec
        from .utils.config import get_config

        self.prog = prog
        self.device = torch.device(device)
        self.P = channels_per_record
        self._channels = accept_map is not None
        self._scanner = None
        self._xla_tables = None
        self._ptables = None
        self._counting = None
        cfg = get_config()
        self.backend_requested = backend  # None: the configured route (the alias keeps it)
        self.backend = backend or cfg.backend or "pallas"
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS} or None, got {self.backend!r}")
        if self.backend == "packed" and prog.tier == "sparse":
            self.backend = "xla"  # the packed engine covers the dense and multiblock tiers
        self._nullable = prog.nullable if nullable is None else bool(nullable)
        if self.backend == "packed":
            self._ptables = sp.packed_tables(prog, self.device, accept_map, self.P)
            return
        if self.backend == "xla":
            return
        plan = (counting_plan(prog)
                if accept_map is None and self.P == 1 and prog.G <= 1 else None)
        self._counting = plan
        if plan is not None:
            # run-length tier: one int per record, no follow table
            self._scanner = CountScanner(prog, plan, self.device, nullable=nullable)
        elif prog.tier not in DENSE_TIERS:
            self._scanner = self._big_tier(prog, accept_map, nullable)
        elif accept_map is None and self.P == 1 and cfg.swar and swar_spec(prog) is not None:
            self._scanner = SwarScanner(prog, self.device, nullable=nullable)
        elif (cfg.swar and cfg.swar_multi and accept_map is not None and subprograms
              and self.P == len(subprograms)
              and (mspec := swar_multi_spec(subprograms)) is not None):
            # 4 patterns per u32, a byte lane each (JAX engine.py:339-360)
            self._scanner = SwarMultiScanner(prog, self.device, mspec, self.P, accept_map,
                                             nullable=nullable)
        elif cfg.swar and word_spec(prog, accept_map, self.P) is not None:
            self._scanner = WordScanner(prog, self.device, accept_map=accept_map, P=self.P,
                                        nullable=nullable)
        else:
            self._scanner = PallasScanner(prog, self.device, accept_map=accept_map,
                                          nullable=nullable)

    def _big_tier(self, prog: DeviceProgram, accept_map, nullable):
        """The scanner of a multiblock or sparse program without a counting
        plan: the JAX engine's rule (``engine.py:235-387``). A sparse
        program takes the bitband tier when ``bitband`` is on,
        ``bitband_spec`` decomposes it and its lanes fit
        ``SPARSE_LANES_MAX``, else the container tier; a multiblock program
        takes the bitband tier (when it decomposes) or the container tier
        when :meth:`_multiblock_container_wins`, else the dense multiblock
        matmul (``PallasScanner``; a dense multiblock program matches no
        ``swar_spec`` or ``word_spec``). A container program over
        ``SPARSE_PARTIAL_MAX`` partial blocks or ``SPARSE_LANES_MAX`` lanes
        logs the JAX engine's warning and goes to the XLA backend (None:
        no scanner)."""
        from .ops.scan_bitband import SPARSE_LANES_MAX, BitbandScanner, bitband_spec
        from .ops.scan_pallas import PallasScanner
        from .ops.scan_sparse import SparseScanner
        from .utils.config import get_config

        if prog.tier != "sparse" and not self._multiblock_container_wins(prog):
            return PallasScanner(prog, self.device, accept_map=accept_map, nullable=nullable)
        spec = bitband_spec(prog) if get_config().bitband else None
        if spec is not None and prog.s_pad <= SPARSE_LANES_MAX:
            return BitbandScanner(prog, self.device, spec, accept_map=accept_map,
                                  nullable=nullable)
        npart = len(prog.sparse_partition[0])
        if npart > SPARSE_PARTIAL_MAX or prog.s_pad > SPARSE_LANES_MAX:
            logging.getLogger(__name__).warning(
                "rrx: sparse automaton (%d partial blocks, %d lanes) exceeds the pallas VMEM "
                "caps (sparse_partial_max=%d, sparse_lanes_max=%d); falling back to the XLA "
                "backend", npart, prog.s_pad, SPARSE_PARTIAL_MAX, SPARSE_LANES_MAX)
            self.backend = "xla"  # the container kernels' tables would not fit
            return None
        return SparseScanner(prog, self.device, accept_map=accept_map, nullable=nullable)

    @staticmethod
    def _multiblock_container_wins(prog: DeviceProgram) -> bool:
        """True if the multiblock program's per-step container MACs (partial
        128 x 128 blocks + accept reduce) undercut the dense lanes^2 follow
        matmul (the JAX engine's rule, unchanged): repetition chains have
        O(S / 128) nonzero blocks, so the dense path wastes most of the
        MXU. A banded follow matrix (<= ``BANDED_MAX_DIAGS`` diagonals)
        keeps the dense tier's banded form."""
        if prog.tier != "multiblock" or prog.fblocks is None:
            return False
        from .ops.scan_pallas import banded_offsets

        if banded_offsets(np.asarray(prog.F).T, BANDED_MAX_DIAGS):
            return False
        pb, _, _, U = prog.sparse_partition
        npart = len(pb)
        if npart > SPARSE_PARTIAL_MAX:
            return False
        sparse_macs = npart * 128 * 128 + int(U.sum()) * 128
        return sparse_macs < 0.7 * prog.lanes * prog.lanes

    def _one_channel(self, what: str) -> None:
        """Raise for a primitive that reads one accept set on an engine with
        accept channels: it must not answer from their union."""
        if self._channels:
            raise ValueError(
                f"ScanEngine.{what}: {self.prog.pattern[:60]!r} is scanned with "
                f"{self.P} accept channels; only match_stats takes channels (and the "
                "scanner's lazy_spans_mb)"
            )

    @property
    def device_scanner(self):
        """The selected kernel scanner (SwarScanner, WordScanner,
        PallasScanner, CountScanner, BitbandScanner or SparseScanner), or
        None off the kernel route (the packed and XLA backends)."""
        return self._scanner

    @property
    def packed(self) -> bool:
        """True when the engine's primitives or anchored rescans run over
        the mask stream (``scan_packed``): the packed backend, and the
        kernel route of a dense or multiblock program."""
        return self.backend == "packed" or (self.backend == "pallas"
                                            and self.prog.tier != "sparse")

    # -- seeded alias: X{m,n} == X{m,} under seeded semantics --------------
    def _seeded_alias(self):
        """Cached engine over ``seeded_alias_program(self.prog)``, or None
        (always None with several accept channels)."""
        if not getattr(self, "_alias_built", False):
            self._alias_built = True
            aprog = seeded_alias_program(self.prog) if self.P == 1 else None
            self._alias = None if aprog is None else ScanEngine(
                aprog, self.device, backend=self.backend_requested)
        return self._alias

    @staticmethod
    def _alias_call(alias, name, data, lengths, *args, **kw):
        """Call ``alias.name``, rounding B up to the alias's packing group
        with zero-length records (the original program has G = 1, the
        alias a dense tier's G)."""
        data = alias._data(data)
        lengths = torch.as_tensor(lengths, device=alias.device)
        G = max(1, alias.prog.G)
        B = data.shape[0]
        pad = -B % G
        if pad:
            data = F.pad(data, (0, 0, 0, pad))
            lengths = F.pad(lengths, (0, pad))
            args = tuple(F.pad(torch.as_tensor(a, device=alias.device), (0, pad)) for a in args)
        out = getattr(alias, name)(data, lengths, *args, **kw)
        if not pad:
            return out
        if isinstance(out, tuple):
            return tuple(o[:B] for o in out)
        return out[:B]

    # -- batches ------------------------------------------------------------
    def _len_g(self, lengths) -> torch.Tensor:
        return torch.as_tensor(lengths, device=self.device).reshape(-1, self.prog.G)

    def _data(self, data) -> torch.Tensor:
        return torch.as_tensor(data, dtype=torch.uint8, device=self.device)

    def _lengths(self, lengths) -> torch.Tensor:
        return torch.as_tensor(lengths, device=self.device).reshape(-1)

    def _words(self, data, lengths) -> torch.Tensor:
        """The [L + 2, B, Wt] mask stream of a batch (the packed primitives'
        input); the kernel route builds the mask stream's tables at its
        first anchored rescan."""
        if self._ptables is None:
            self._ptables = sp.packed_tables(self.prog, self.device)
        return sp.mask_stream_from_bytes(self._ptables, self._data(data), self._lengths(lengths))

    def _classes(self, data, lengths):
        """(the unpacked tables, the [B, L + 2] class stream of a batch):
        the XLA backend's input."""
        if self._xla_tables is None:
            self._xla_tables = sx.device_tables(self.prog, self.device)
        p = self.prog
        cls = sx.encode_stream(self._xla_tables, self._data(data), self._lengths(lengths),
                               p.bos_class, p.eos_class)
        return self._xla_tables, cls

    # -- match statistics ------------------------------------------------------
    def match_stats(self, data, lengths, *, seeded: bool):
        """(count, first_end, any) per accept channel, each flattened to
        [B * channels_per_record] (record-major; [B] for one channel).
        Seeded scans of a program with a seeded alias run on the alias;
        seeded scans of more than 128 records of a prefiltered program run
        on the prefilter's candidates (:meth:`_prefilter_apply`)."""
        alias = self._seeded_alias()
        if seeded and alias is not None:
            return self._alias_call(alias, "match_stats", data, lengths, seeded=True)
        if seeded and self._use_prefilter(data):
            def raw(d, ln, live):
                if self._scanner is None:
                    return self._match_stats_raw(d, ln, seeded=True)
                cnt, first, _, _, anym = self._scanner.match_stats_b(
                    d, self._len_g(ln), seeded=True, live=live)
                return cnt.reshape(-1), first.reshape(-1), anym.reshape(-1)

            return self._prefilter_apply(data, lengths, raw, fills=(0, -1, False))
        return self._match_stats_raw(data, lengths, seeded=seeded)

    def _match_stats_raw(self, data, lengths, *, seeded: bool):
        sc = self._scanner
        if self.backend == "packed":
            cnt, first, anym = sp.match_stats(self._ptables["nfa"], self._words(data, lengths),
                                              self._lengths(lengths), seeded=seeded,
                                              nullable=self._nullable)
            return cnt.reshape(-1), first.reshape(-1), anym.reshape(-1)
        if self.backend == "xla":
            if self._channels:
                raise ValueError(f"{self.prog.pattern[:60]!r}: the XLA backend scans one accept "
                                 "set (MultiPattern scans its patterns one by one there)")
            tables, cls = self._classes(data, lengths)
            return sx.match_stats(tables, cls, self._lengths(lengths), seeded=seeded,
                                  nullable=self.prog.nullable)
        data = self._data(data)
        plan = self._window_plan(data.shape[1], data.shape[0], seeded)
        if plan is not None:
            return self._match_stats_windowed(data, lengths, *plan)
        cnt, first, _, _, anym = sc.match_stats_b(data, self._len_g(lengths), seeded=seeded)
        return cnt.reshape(-1), first.reshape(-1), anym.reshape(-1)

    # -- the sparse tier's prefilter --------------------------------------------
    def _prefilter(self):
        """Lazily built engine of the prefilter program
        (:func:`relaxed_prefilter_program`), or None: only for a
        one-channel sparse program on its own scanner (no counting plan, no
        seeded alias), as in the JAX engine."""
        if not getattr(self, "_prefilter_built", False):
            self._prefilter_built = True
            self._prefilter_eng = None
            if (self.P == 1 and not self._channels and self._counting is None
                    and self.prog.tier == "sparse"
                    and seeded_alias_program(self.prog) is None):
                rp = relaxed_prefilter_program(self.prog)
                if rp is not None:
                    self._prefilter_eng = ScanEngine(rp, self.device,
                                                     backend=self.backend_requested)
        return self._prefilter_eng

    def _use_prefilter(self, data) -> bool:
        return data.shape[0] > 128 and self._prefilter() is not None

    def _prefilter_apply(self, data, lengths, raw_fn, *, fills, extra=()):
        """Run ``raw_fn(data2, lengths2, *extra2, live)`` on the records the
        prefilter accepts, compacted, and scatter each output back along
        axis 0 with its ``fills`` value (the exact result for a record the
        superset scan rejects: it has no match). ``extra`` = ((per-record
        array, fill of an empty slot), ...) forwarded to ``raw_fn``.
        Off the kernel route (no scanner: the XLA backend's match stats)
        the bucket is chosen on the host, one read of the candidate count,
        as the JAX engine's ``lax.cond`` chooses it, and ``raw_fn`` runs
        once, on the bucket or on the whole batch (``live`` None).

        On the kernel route it is decided on the device with no host sync.
        The candidates (a cumsum
        of the prefilter's hit flags) are scattered into a bucket of the
        JAX engine's larger size, B / 4 rounded up to 128 rows (at least
        128); ``raw_fn`` runs on it with ``live`` = min(candidates, bucket)
        (a [1] int32 device tensor: the kernels return at once for a slot
        at or past it, so a sparse batch costs its candidates only, which
        stands in for the JAX engine's smaller B / 16 bucket). ``raw_fn``
        also runs on the whole batch with ``live`` = B when the candidates
        overflow the bucket and 0 otherwise, and ``torch.where`` picks the
        full result exactly then: the answers equal the JAX engine's
        whichever bucket its ``lax.cond`` takes. A batch the bucket would
        not shrink runs ``raw_fn`` on all records (``live`` None)."""
        data = self._data(data)
        dev = self.device
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
        ex = tuple(torch.as_tensor(a, device=dev) for a, _ in extra)
        B = data.shape[0]
        bcap = min(B, max(128, -(-(B // 4) // 128) * 128))
        if bcap >= B:
            return raw_fn(data, lengths, *ex, None)
        _, _, pre = self._alias_call(self._prefilter_eng, "match_stats", data, lengths,
                                     seeded=True)
        pre = pre.reshape(-1)[:B]
        pos = torch.cumsum(pre.to(torch.int64), 0) - 1
        nhits = pos[-1] + 1
        slot = torch.where(pre & (pos < bcap), pos, bcap)
        rows = torch.arange(B, device=dev)
        src = torch.zeros(bcap + 1, dtype=torch.int64, device=dev).scatter_(0, slot, rows)[:bcap]
        valid = torch.arange(bcap, device=dev) < nhits
        over = nhits > bcap
        live_c = nhits.clamp(max=bcap).to(torch.int32).reshape(1)
        live_f = torch.where(over, B, 0).to(torch.int32).reshape(1)
        d2 = data.index_select(0, src)
        l2 = torch.where(valid, lengths.index_select(0, src), 0)
        ex2 = tuple(torch.where(valid, a.index_select(0, src), f) for a, (_, f) in zip(ex, extra))
        host = self._scanner is None
        if host and bool(over):
            return raw_fn(data, lengths, *ex, None)
        outs_c = raw_fn(d2, l2, *ex2, None if host else live_c)
        outs_f = outs_c if host else raw_fn(data, lengths, *ex, live_f)
        single = not isinstance(outs_c, tuple)
        if single:
            outs_c, outs_f = (outs_c,), (outs_f,)
        dst = torch.where(valid, src, B)  # empty slots land in a spare row
        res = []
        for oc, of, f in zip(outs_c, outs_f, fills, strict=True):
            base = torch.full((B + 1,) + tuple(oc.shape[1:]), f, dtype=oc.dtype, device=dev)
            base.index_copy_(0, dst, oc)
            res.append(base[:B] if host else torch.where(over, of, base[:B]))
        return res[0] if single else tuple(res)

    def _window_plan(self, L: int, B: int, seeded: bool):
        """(k, w, h) record window split for the matmul tier's batched scan,
        or None: the JAX engine's rule, unchanged. Exact for (cnt, first,
        any) when every match fits in ``h = prog.horizon`` bytes, the
        pattern is anchor-free and non-nullable; the SWAR tier windows
        itself, the u32-word tier never does, and the counting tier has no
        windowed mode. Off unless ``window_cols`` (``RRX_WINDOW_COLS``) is
        set."""
        from .ops.scan_pallas import PallasScanner
        from .utils.config import get_config

        p = self.prog
        if (
            not seeded
            or type(self._scanner) is not PallasScanner
            or self.P != 1
            or self._scanner.nullable
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

    # -- flags, hits and anchored rescans -------------------------------------
    def forward_flags(self, data, lengths, *, seeded: bool) -> torch.Tensor:
        """[B, T + 1] bool accept flags, T = L + 2 (column 0 = the
        program's nullability, column t + 1 = step t)."""
        self._one_channel("forward_flags")
        alias = self._seeded_alias()
        if seeded and alias is not None:
            return self._alias_call(alias, "forward_flags", data, lengths, seeded=True)
        if self.backend == "packed":
            return sp.forward_flags(self._ptables["nfa"], self._words(data, lengths),
                                    seeded=seeded)
        if self.backend == "xla":
            tables, cls = self._classes(data, lengths)
            return sx.forward_flags(tables, cls, seeded=seeded)
        sc = self._scanner
        if self._use_prefilter(data):
            # a record the superset scan rejects has no accept anywhere
            return self._prefilter_apply(
                data, lengths,
                lambda d, ln, live: sc.forward_flags_b(d, self._len_g(ln), seeded=seeded,
                                                       live=live),
                fills=(False,))
        return sc.forward_flags_b(self._data(data), self._len_g(lengths), seeded=seeded)

    def reverse_hits(self, data, lengths) -> torch.Tensor:
        """[B, L + 2] bool start-position hits (step t = start max(t-1, 0))."""
        self._one_channel("reverse_hits")
        alias = self._seeded_alias()
        if alias is not None:
            return self._alias_call(alias, "reverse_hits", data, lengths)
        if self.backend == "packed":
            return sp.reverse_hits(self._ptables["nfa"], self._words(data, lengths))
        if self.backend == "xla":
            return sx.reverse_hits(*self._classes(data, lengths))
        sc = self._scanner
        if self._use_prefilter(data):
            return self._prefilter_apply(
                data, lengths, lambda d, ln, live: sc.reverse_hits_b(d, self._len_g(ln), live=live),
                fills=(False,))
        return sc.reverse_hits_b(self._data(data), self._len_g(lengths))

    def first_end_from(self, data, lengths, starts, *, longest: bool = False):
        """Anchored-rescan end per record [B] (-1 = none): smallest end (lazy
        policy) or, with ``longest=True``, largest end (greedy leftmost-
        longest, the POSIX policy). The lazy end of X{m,n} and of its
        seeded alias X{m,} is the same m-copy chain; the greedy end
        observes n and stays on the original. Without anchored kernels
        (the counting and container tiers, and the packed and XLA
        backends) the rescan runs over the mask stream
        (``scan_packed.first_end_from``) for a dense or multiblock program
        off the XLA backend, else over the unpacked tables
        (``scan_xla.first_end_from``), as in the JAX engine."""
        self._one_channel("first_end_from")
        alias = self._seeded_alias()
        if not longest and alias is not None:
            return self._alias_call(alias, "first_end_from", data, lengths, starts,
                                    longest=False)
        sc = self._scanner
        if sc is not None and sc.has_anchor:
            def raw(d, ln, st, live=None):
                st = st.reshape(-1, self.prog.G)
                kw = {} if live is None else {"live": live}
                return sc.anchor_end_b(d, self._len_g(ln), st, longest=longest, **kw).reshape(-1)

            if self._use_prefilter(data):
                return self._prefilter_apply(data, lengths, raw, fills=(-1,),
                                             extra=((starts, -1),))
            return raw(self._data(data), lengths, torch.as_tensor(starts, device=self.device))
        starts = torch.as_tensor(starts, device=self.device).reshape(-1)
        if self.backend != "xla" and self.prog.tier != "sparse":
            words = self._words(data, lengths)
            return sp.first_end_from(self._ptables["nfa"], words, self._lengths(lengths), starts,
                                     longest=longest)
        tables, cls = self._classes(data, lengths)
        return sx.first_end_from(tables, cls, self._lengths(lengths), starts, longest=longest)

    # -- spans ------------------------------------------------------------------
    def _span_scanner(self):
        sc = self._scanner
        if sc is None or not sc.has_anchor:
            what = f"the {self.backend} backend" if sc is None else type(sc).__name__
            raise NotImplementedError(
                f"{self.prog.pattern!r}: {what} has no span kernels; "
                "Pattern.finditer_batch takes host rounds over starts_bitmap for it"
            )
        return sc

    def lazy_spans(self, data, lengths, *, cap: int):
        """(starts [B, cap], ends [B, cap], count [B]): lazy spans."""
        self._one_channel("lazy_spans")
        sc = self._span_scanner()
        if self._use_prefilter(data):
            return self._prefilter_apply(
                data, lengths, lambda d, ln, live: sc.lazy_spans_b(d, self._len_g(ln), cap=cap,
                                                                   live=live),
                fills=(-1, -1, 0))
        return sc.lazy_spans_b(self._data(data), self._len_g(lengths), cap=cap)

    def greedy_spans(self, data, lengths, *, cap: int):
        """(starts, ends, count, overflow): greedy (leftmost-longest) spans."""
        self._one_channel("greedy_spans")
        sc = self._span_scanner()
        if self._use_prefilter(data):
            return self._prefilter_apply(
                data, lengths, lambda d, ln, live: sc.greedy_spans_b(d, self._len_g(ln), cap=cap,
                                                                     live=live),
                fills=(-1, -1, 0, False))
        return sc.greedy_spans_b(self._data(data), self._len_g(lengths), cap=cap)

    # -- bitmaps ----------------------------------------------------------------
    # Every scanner writes its flags and hits as bit-packed [B, Wt] words
    # (flags_words_b / hits_words_b): the bitmaps clamp and fold them in the
    # word domain and one bit per position crosses to the host.
    @staticmethod
    def _clamp_words(words: torch.Tensor, lengths: torch.Tensor, nullable: bool) -> torch.Tensor:
        """Word-domain position clamp on [B, Wt] position words (int64
        holding uint32 bit patterns): keep bits t <= len, fold any bit past
        len into bit len, and (nullable) set every position <= len:
        ``scan_xla.ends_bitmap`` / ``starts_bitmap`` on bit-packed words."""
        B, Wt = words.shape
        ln = lengths.to(torch.int64)[:, None]
        wi = torch.arange(Wt, device=words.device)[None, :] * 32
        lo = (ln + 1 - wi).clamp(0, 32)
        keep = torch.where(lo >= 32, MASK32, (torch.ones_like(lo) << lo.clamp(max=31)) - 1)
        tail = ((words & ~keep & MASK32) != 0).any(dim=1)
        out = words & keep
        wl = torch.arange(Wt, device=words.device)[None, :] == ln // 32
        out = out | ((wl & tail[:, None]).to(torch.int64) << (ln % 32))
        if nullable:
            out = out | keep
        return out

    @staticmethod
    def _fetch_words_bitmap(words: torch.Tensor, max_len: int) -> np.ndarray:
        """[B, Wt] position words on the device -> host bool bitmap [B,
        max_len + 1]: one bit per position crosses to the host."""
        w = np.ascontiguousarray(words.to(torch.int64).cpu().numpy().astype(np.uint32))
        bits = np.unpackbits(w.view(np.uint8).reshape(w.shape[0], -1), axis=1,
                             bitorder="little")
        return bits[:, : max_len + 1].astype(bool)

    def _words_prefiltered(self, data, lengths, words_fn):
        """[B, Wt] int64 position words of ``words_fn(data, len_g, live)``
        (prefiltered where the engine has a prefilter: a rejected record's
        words are 0)."""
        def raw(d, ln, live=None):
            kw = {} if live is None else {"live": live}
            w, _ = words_fn(d, self._len_g(ln), **kw)
            return w.to(torch.int64) & MASK32

        if self._use_prefilter(data):
            return self._prefilter_apply(data, lengths, raw, fills=(0,))
        return raw(self._data(data), lengths)

    def ends_bitmap(self, data, lengths, max_len: int) -> np.ndarray:
        """[B, max_len + 1] bool host bitmap: some match ends at position e.
        Off the kernel route: from the seeded forward flags
        (``scan_xla.ends_bitmap``)."""
        self._one_channel("ends_bitmap")
        alias = self._seeded_alias()
        if alias is not None:
            return self._alias_call(alias, "ends_bitmap", data, lengths, max_len=max_len)
        lengths = torch.as_tensor(lengths, device=self.device)
        if self._scanner is None:
            flags = self.forward_flags(data, lengths, seeded=True)
            return sx.ends_bitmap(flags, lengths, max_len, self.prog.nullable,
                                  seeded=True).cpu().numpy()
        sc = self._scanner
        w = self._words_prefiltered(data, lengths,
                                    lambda d, lg, **kw: sc.flags_words_b(d, lg, seeded=True, **kw))
        words = self._clamp_words(w, lengths, self.prog.nullable)
        return self._fetch_words_bitmap(words, max_len)

    def starts_bitmap(self, data, lengths, max_len: int) -> np.ndarray:
        """[B, max_len + 1] bool host bitmap: some match starts at position s.
        Off the kernel route: from the reverse hits
        (``scan_xla.starts_bitmap``)."""
        self._one_channel("starts_bitmap")
        alias = self._seeded_alias()
        if alias is not None:
            return self._alias_call(alias, "starts_bitmap", data, lengths, max_len=max_len)
        lengths = torch.as_tensor(lengths, device=self.device)
        if self._scanner is None:
            hits = self.reverse_hits(data, lengths)
            return sx.starts_bitmap(hits, lengths, max_len, self.prog.nullable).cpu().numpy()
        w = self._words_prefiltered(data, lengths, self._scanner.hits_words_b)
        # start s = max(t - 1, 0): funnel-shift the stream down one bit
        # (steps 0 and 1 both land on s = 0)
        nxt = torch.cat([w[:, 1:], torch.zeros_like(w[:, :1])], dim=1)
        sh = (w >> 1) | ((nxt << 31) & MASK32)
        sh[:, 0] |= w[:, 0] & 1
        words = self._clamp_words(sh, lengths, self.prog.nullable)
        return self._fetch_words_bitmap(words, max_len)

    def fullmatch_flags(self, data, lengths) -> np.ndarray:
        """[B] bool whole-string acceptance: the ``full`` statistic of an
        unseeded scan; off the kernel route, an unseeded flag at an end e =
        len whose step has consumed the whole record."""
        self._one_channel("fullmatch_flags")
        sc = self._scanner
        if sc is None:
            flags = self.forward_flags(data, lengths, seeded=False)
            t = torch.arange(flags.shape[1], device=self.device)[None, :]
            n = self._lengths(lengths).to(torch.int64)[:, None]
            e = (t - 1).clamp(min=0).minimum(n)
            covers = ((t - 1).clamp(min=0) >= n) | (n == 0)
            return (flags & (e == n) & covers).any(dim=1).cpu().numpy()

        def raw(d, ln, live=None):
            kw = {} if live is None else {"live": live}
            return sc.match_stats_b(d, self._len_g(ln), seeded=False, **kw)[3].reshape(-1)

        if self._use_prefilter(data):
            # a prefilter reject (a seeded-superset fact) rules out the
            # whole-string match too
            return self._prefilter_apply(data, lengths, raw, fills=(False,)).cpu().numpy()
        return raw(self._data(data), lengths).cpu().numpy()
