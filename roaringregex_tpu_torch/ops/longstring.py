"""One long string: a single huge string scanned in windows on the card.

The port of ``roaringregex_tpu/ops/longstring.py``. The per-byte step of a
program is the boolean affine map ``v -> (follow(v) & B[c]) | seed``, so one
string's scan splits into windows that run in parallel, each from an entry
state. Where that entry state comes from picks the mode:

* **Overlapped windows** (``FastLongScanner``, bounded-horizon programs): a
  seeded state depends only on the last ``horizon`` steps, so each window
  re-scans ``overlap = horizon + 2`` steps before the ones it owns from the
  empty set and is then exact. One pass: ``rrx_long_count`` (count, any)
  or ``rrx_long_flags`` (the ends), and ``rrx_long_reverse`` for the
  starts. Anchor-free 8-state programs whose classes leave out byte 0 count
  on the SWAR kernel instead (``rrx_swar_stats`` with ``lead``).
* **Summary + replay** (cyclic programs, unseeded scans): pass 1
  (``rrx_long_carry``) scans each block from the S basis states and from
  the empty set with the seeds, giving its affine summary (M, s); a prefix
  over blocks (:func:`prefix_entries`, torch ops) gives each block's entry
  state; pass 2 replays every block from it (``rrx_long_count`` or
  ``rrx_long_flags``).
* **Speculative windows** (cyclic programs, seeded count/any): each
  window's entry state is guessed by a warm-up scan of the ``spec_warmup``
  steps before it (``rrx_long_carry``), the windows replay from the guesses
  with their exits (``rrx_long_count`` with the final state), and the
  guesses hold iff exit_w == entry_{w+1} for every window. That verdict is
  read on the host, once per call, to choose between the speculative value
  and summary + replay (the JAX package selects on the device with
  ``lax.cond``).

``CountLongScanner`` runs counting-plan programs (``X{m,n}`` with a
fixed-length body, config 9 ``a{1,300}``) in overlapped run-length windows
on the counting tier's kernels; ``DotStarLongScanner`` runs ``.*X.*``
(config 12) as a scan of X plus a running OR; ``AliasLongScanner`` runs a
big ``X{m,n}`` through its ``X{m,}`` seeded alias; ``LongScanner`` is the
summary + replay scheme in torch ops (wide tiles without a horizon, the
unseeded scans of wide tiles, the sparse tier's programs that no rewrite
takes, such as config 10's, and the fallback of the rewrites).
:func:`make_long_scanner` picks one per program.

Window geometry is the port's own: one CUDA thread per window (one warp
per window past 256 states), windows of about 4 KB for a 1 GiB string
(2^18 windows, the card's 132 x 2,048 thread slots), so nothing here
follows the TPU's 128-lane column layout. Windows read the string in
place; the SWAR and counting paths take their windows as
an overlapping strided view of one padded copy of the string. Stream
offsets are int32: a string of more than 2^31 - 1 bytes raises
``ValueError``. Everything runs on the caller's device: the card, or the
CPU through the kernels' plain versions.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..compiler.program import DeviceProgram
from . import scan_pallas as spl
from . import scan_xla as sx

MAX_LEN = (1 << 31) - 1
# windows per pass that fill the card: 132 SMs x 2,048 resident threads
TARGET_WINDOWS = 1 << 18
BIG = 1 << 62


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def as_data(text, device) -> torch.Tensor:
    """bytes or a uint8 tensor -> a 1-D uint8 tensor on ``device`` (the
    string itself, no copy when it is already there)."""
    if isinstance(text, (bytes, bytearray, memoryview)):
        buf = bytes(text)
        n = len(buf)
        data = (torch.frombuffer(bytearray(buf), dtype=torch.uint8) if n
                else torch.zeros(0, dtype=torch.uint8))
    else:
        data = torch.as_tensor(text)
        if data.dtype != torch.uint8 or data.dim() != 1:
            raise ValueError(f"a long string is bytes or a 1-D uint8 tensor, got "
                             f"{tuple(data.shape)} {data.dtype}")
    if data.numel() > MAX_LEN:
        raise ValueError(f"a string of {data.numel()} bytes: stream offsets are int32, "
                         f"at most {MAX_LEN} bytes (shard longer strings)")
    return data.to(device)


def bits_of_words(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """Flat int32 bit words -> [nbits] bool, bit g of word g // 32."""
    b = words.contiguous().view(torch.uint8)
    sh = torch.arange(8, dtype=torch.uint8, device=words.device)
    return ((b[:, None] >> sh) & 1).reshape(-1)[:nbits].bool()


def ends_of_flags(f: torch.Tensor, n: int) -> torch.Tensor:
    """[n + 2] per-step accept flags -> [n + 1] ends (step n + 1, the EOS
    step, ends at n)."""
    ends = f[: n + 1].clone()
    ends[n] |= f[n + 1]
    return ends


def starts_of_hits(h: torch.Tensor, n: int) -> torch.Tensor:
    """[n + 2] per-step start hits -> [n + 1] starts (step t starts at
    max(t - 1, 0))."""
    s = h[1 : n + 2].clone()
    s[0] |= h[0]
    return s


def _tail(flags: torch.Tensor, n: int, mode: str):
    """[n + 2] per-step flags -> the mode's value (device tensors)."""
    if mode == "flags":
        return flags
    if mode == "count":
        return flags[:n].sum(dtype=torch.int64) + (flags[n] | flags[n + 1]).to(torch.int64)
    if mode == "any":
        return flags[: n + 2].any()
    return flags[n] | flags[n + 1]  # fullmatch


def _merge_counts(cnt: torch.Tensor, tail: torch.Tensor, mode: str):
    """Per-window (body counts, EOS-side hits) -> the mode's value: the
    EOS-side steps n and n + 1 both end at n and count once."""
    tail_any = tail.any()
    if mode == "full":
        return tail_any
    body = cnt.sum(dtype=torch.int64)
    if mode == "count":
        return body + tail_any.to(torch.int64)
    return (body > 0) | tail_any


# ---------------------------------------------------------------------------
# Summary + replay in torch ops
# ---------------------------------------------------------------------------


def prefix_entries(Ms: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """Entry state [nb, S] bool of every block from the blocks' affine
    summaries (Ms [nb, S, S]: M[i, j] = starting in state i ends in a set
    holding j; ss [nb, S]: states live at the block's end from seeds inside
    it): an inclusive scan of (Ma, sa) o (Mb, sb) = (Ma Mb, sa Mb | sb) by
    doubling (Hillis-Steele, log2(nb) levels of batched 0/1 products in
    float32, exact), then entry_0 = 0 and entry_k = prefix s of block k - 1."""
    nb, S = ss.shape
    M = Ms.to(torch.float32)
    s = ss.to(torch.float32)
    d = 1
    while d < nb:
        sn = s.clone()
        sn[d:] = (((s[:-d, None, :] @ M[d:])[:, 0] > 0) | (s[d:] > 0)).to(torch.float32)
        if 2 * d < nb:
            Mn = M.clone()
            Mn[d:] = (torch.bmm(M[:-d], M[d:]) > 0).to(torch.float32)
            M = Mn
        s = sn
        d *= 2
    return torch.cat([torch.zeros((1, S), dtype=torch.bool, device=ss.device), s[:-1] > 0])


def compact_tables(prog: DeviceProgram, device) -> dict:
    """The dense tables of the summary + replay scheme over the program's
    own S states (not the padded tile: pass 1 steps S + 1 pseudo-records
    per block, so padding would cost in rows and width alike): F [S, S]
    float32 0/1, Bc [c_pad, S] bool, accept [S] bool and the byte -> class
    map. They are the XLA backend's tables (``scan_xla.device_tables``),
    whose F comes from the NFA's follow relation on every tier, so a
    sparse-tier program (no dense ``prog.F``: config 10's
    ``x(ab|c){400,520}y``, ``x(abc|de){1,300}y``) takes them as the JAX
    package's ``LongScanner`` takes ``scan_xla.device_tables``."""
    return sx.device_tables(prog, device)


def _step(tables: dict, v: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """v' = (OR of follow rows over v) & Bc[cls], as a 0/1 product."""
    return ((v.to(torch.float32) @ tables["F"]) > 0) & tables["Bc"][cls]


def block_summaries(tables: dict, cls_b: torch.Tensor, *, seeded: bool):
    """Per-block affine summaries (M [nb, S, S], s [nb, S]) of the class
    stream cut in blocks (cls_b [nb, block]): row i of block b starts from
    basis state i, row S from the empty set with the seeds (every step
    seeded, or unseeded the steps < 2 of block 0)."""
    nb, block = cls_b.shape
    S = tables["F"].shape[0]
    dev = cls_b.device
    v = torch.cat([torch.eye(S, dtype=torch.bool, device=dev),
                   torch.zeros((1, S), dtype=torch.bool, device=dev)]).repeat(nb, 1)
    rows = torch.arange(nb * (S + 1), device=dev)
    acc_row = rows % (S + 1) == S
    first = rows < S + 1
    for t in range(block):
        v[:, 0] |= acc_row if seeded else (acc_row & first & (t < 2))
        v = _step(tables, v, cls_b[:, t].repeat_interleave(S + 1))
    summ = v.reshape(nb, S + 1, S)
    return summ[:, :S], summ[:, S]


def block_replay(tables: dict, cls_b: torch.Tensor, ventry: torch.Tensor, *,
                 seeded: bool) -> torch.Tensor:
    """Accept flags [nb, block] of every block replayed from its entry
    state (ventry [nb, S] bool)."""
    nb, block = cls_b.shape
    dev = cls_b.device
    v = ventry.clone()
    fl = torch.zeros((nb, block), dtype=torch.bool, device=dev)
    g0 = torch.arange(nb, device=dev) == 0
    for t in range(block):
        v[:, 0] |= torch.ones_like(g0) if seeded else (g0 & (t < 2))
        v = _step(tables, v, cls_b[:, t])
        fl[:, t] = (v & tables["accept"]).any(dim=1)
    return fl


def scan_long(tables: dict, data: torch.Tensor, *, block: int, seeded: bool,
              bos_class: int, eos_class: int) -> torch.Tensor:
    """Block-parallel scan of one string: [n + 2] bool accept flags per
    global stream step (summaries, prefix, replay)."""
    n = data.numel()
    dev = data.device
    cls = torch.cat([torch.tensor([bos_class], device=dev),
                     tables["byte_class"][data.to(torch.int64)],
                     torch.tensor([eos_class], device=dev)])
    nb = -(-(n + 2) // block)
    cls_b = torch.nn.functional.pad(cls, (0, nb * block - n - 2)).reshape(nb, block)
    # the last block's summary feeds no entry: blocks 0 .. nb - 2 only (a
    # zero summary stands in for the last one, whose prefix is dropped)
    S = tables["F"].shape[0]
    Ms, ss = block_summaries(tables, cls_b[:-1], seeded=seeded)
    Ms = torch.cat([Ms, torch.zeros((1, S, S), dtype=torch.bool, device=dev)])
    ss = torch.cat([ss, torch.zeros((1, S), dtype=torch.bool, device=dev)])
    ventry = prefix_entries(Ms, ss)
    return block_replay(tables, cls_b, ventry, seeded=seeded).reshape(-1)[: n + 2]


class LongScanner:
    """Summary + replay of one long string in torch ops on the device: the
    JAX package's portable ``LongScanner`` (XLA there). Pass 1 steps each
    block's S + 1 pseudo-records as [(nb - 1) (S + 1), S] x [S, S] 0/1
    products (the last block's summary feeds no entry), the prefix gives
    the entry states, pass 2 replays the blocks with their accept flags.
    Serves wide tiles without a horizon, the sparse tier's programs that no
    rewrite takes (config 10's ``x(ab|c){400,520}y``: 1,563 states, pass 1
    ~2 S^2 operations a byte) and the rewrites' fallback (the unseeded
    scans of an ``X{m,n}`` alias), all over :func:`compact_tables`."""

    def __init__(self, prog: DeviceProgram, device, block: int = 4096):
        self.prog = prog
        self.device = torch.device(device)
        self.block = block
        self.tables = compact_tables(prog, self.device)

    def _flags(self, data: torch.Tensor, n: int, seeded: bool) -> torch.Tensor:
        """[n + 2] bool accept flags per global stream step."""
        return scan_long(self.tables, data, block=self.block, seeded=seeded,
                         bos_class=self.prog.bos_class, eos_class=self.prog.eos_class)

    def _run(self, text, seeded: bool, mode: str):
        data = as_data(text, self.device)
        return _tail(self._flags(data, data.numel(), seeded), data.numel(), mode)

    def flags(self, text, *, seeded: bool = True) -> torch.Tensor:
        return self._run(text, seeded, "flags")

    def ends_bitmap(self, text) -> np.ndarray:
        """[len + 1] bool: some match ends at e."""
        data = as_data(text, self.device)
        n = data.numel()
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        return ends_of_flags(self._flags(data, n, True), n).cpu().numpy()

    def count_ends(self, text) -> int:
        return int(self.ends_bitmap(text).sum())

    def search(self, text) -> bool:
        return bool(self.ends_bitmap(text).any())

    def fullmatch(self, text) -> bool:
        data = as_data(text, self.device)
        n = data.numel()
        if n == 0 and self.prog.nullable:
            return True
        return bool(_tail(self._flags(data, n, False), n, "full"))


# ---------------------------------------------------------------------------
# Windows on the kernels of the matmul tier (and the SWAR tier)
# ---------------------------------------------------------------------------


def _window_view(data: torch.Tensor, n: int, nw: int, blk: int, lead: int, width: int,
                 fill: int) -> torch.Tensor:
    """[nw, width] overlapping windows of one padded copy of the string:
    row w holds bytes [w * blk - lead, w * blk - lead + width), ``fill``
    outside the string (blk and width multiples of 16: every row starts 16
    bytes aligned)."""
    ext = torch.full(((nw - 1) * blk + width,), fill, dtype=torch.uint8, device=data.device)
    m = min(n, ext.numel() - lead)
    if m > 0:
        ext[lead : lead + m] = data[:m]
    return ext.as_strided((nw, width), (blk, 1))


class FastLongScanner:
    """Long-string scans of a dense program of up to 1024 states on the
    window kernels (``csrc/scan_long.cu`` up to 256 states,
    ``csrc/scan_long_wide.cu`` past them; see the module docstring for the
    three modes). Wide tiles (s_tile > 32) run their seeded scans in
    overlapped windows only; their unseeded scans go to
    :class:`LongScanner`, as in the JAX package. A wide tile without a
    horizon, or a tile of more than 1024 states, raises ValueError: the
    callers test :func:`fast_long_takes` first and take :class:`LongScanner`
    for such programs."""

    def __init__(self, prog: DeviceProgram, device, block: int = 4096):
        if prog.F is None:
            raise ValueError(f"{prog.pattern!r}: tier {prog.tier} has no dense follow matrix")
        if block < 32 or block % 32:
            raise ValueError(f"block must be a positive multiple of 32, got {block}")
        if prog.s_tile > spl.MAX_S_TILE:
            raise ValueError(f"{prog.pattern!r}: s_tile {prog.s_tile} is wider than the window "
                             f"kernels' {spl.MAX_S_TILE} states")
        self.prog = prog
        self.device = torch.device(device)
        self.block = block
        self.tables = spl.device_nfa_tables(prog, self.device)
        self.S, self.s_tile = prog.n_states, prog.s_tile
        h = prog.horizon
        self.overlap = h + 2 if (h is not None and h + 2 <= block // 8) else None
        self._wide = prog.s_tile > 32
        if self._wide and self.overlap is None:
            raise ValueError(
                "wide-tile long mode needs a bounded horizon "
                f"(s_tile={prog.s_tile}, horizon={h}, block={block})"
            )
        self._portable: Optional[LongScanner] = None
        self._swov_built = False
        self._swov = None
        self._basis = None

    # -- geometry -----------------------------------------------------------
    def _ov_block(self, n: int) -> int:
        """Window length of the overlapped paths: enough windows to fill the
        card (TARGET_WINDOWS), at least 256 bytes and 8 overlaps long (the
        re-scan tax o / block stays small), at most ``block``; a multiple
        of 32 (the flag words of a window are its own)."""
        blk = _round_up(-(-(n + 2) // TARGET_WINDOWS), 32)
        return min(max(256, _round_up(8 * (self.overlap or 0), 32), blk), self.block)

    def _ov_geom(self, n: int) -> spl.LongGeom:
        blk, o = self._ov_block(n), self.overlap
        return spl.LongGeom(n, -(-(n + 2) // blk), blk, o, blk + o)

    # -- SWAR overlapped count/any --------------------------------------------
    def _swar_ov_scanner(self):
        """Cached SwarScanner for the overlapped count/any path, or None when
        it does not apply: the window batch is an [nw, block + o] record
        batch, so an anchor-free, non-nullable 8-state spec runs it on
        ``SwarScanner.match_stats_b(seeded=True, lead=o)``. Kept off: BOS/EOS
        specs (window edges are not record edges) and classes that hold byte
        0 (window 0's lead bytes are zero-filled)."""
        if self._swov_built:
            return self._swov
        self._swov_built = True
        from ..utils.config import get_config
        from .scan_swar import SwarScanner, swar_spec

        if not get_config().swar or self.prog.nullable or self.overlap is None:
            return None
        sp = swar_spec(self.prog)
        if sp is None or sp.has_bos or sp.has_eos:
            return None
        if not all(lo >= 1 for runs, _b, _e in sp.gates for lo, _hi in runs):
            return None
        self._swov = SwarScanner(self.prog, self.device, nullable=False)
        return self._swov

    def _swar_ov_stats(self, data: torch.Tensor, n: int):
        """(cnt [nw], first [nw] global end or BIG) of the SWAR windows."""
        o = self.overlap
        blk = _round_up(self._ov_block(n), 16)
        nw = max(1, -(-n // blk))
        win = _window_view(data, n, nw, blk, o, _round_up(blk + o, 16), 0)
        w0 = torch.arange(nw, dtype=torch.int64, device=self.device) * blk
        lens = (n - w0 + o).clamp(0, blk + o).to(torch.int32)
        cnt, first, _l, _f, _a = self._swov.match_stats_b(win, lens.reshape(-1, 1), seeded=True,
                                                          lead=o)
        cnt, first = cnt.reshape(-1), first.reshape(-1).to(torch.int64)
        return cnt, torch.where(first >= 0, first + w0 - o, BIG)

    def _swar_ov_impl(self, data, n: int, mode: str):
        cnt, _ = self._swar_ov_stats(data, n)
        if mode == "any":
            return (cnt > 0).any()
        return cnt.sum(dtype=torch.int64)

    def _swar_ov_first(self, data, n: int):
        """(any, global first end) through the SWAR windows: what the
        ``.*X.*`` epilogue needs on pure-ASCII text."""
        cnt, fg = self._swar_ov_stats(data, n)
        return (cnt > 0).any(), fg.min()

    # -- overlapped windows on the matmul step ------------------------------------
    def _ov_impl(self, data, n: int, mode: str):
        geom = self._ov_geom(n)
        if mode in ("count", "any"):
            cnt, tail, _ = spl.long_count(data, geom, self.tables, seeded=True)
            return _merge_counts(cnt, tail, mode)
        words = spl.long_flags(data, geom, self.tables, seeded=True)
        return _tail(bits_of_words(words, n + 2), n, mode)

    # -- summary + replay -----------------------------------------------------------
    def _basis_words(self) -> torch.Tensor:
        """[S + 1, W] int32 entry states of one block's pseudo-records: basis
        state i for i < S, the empty set for the seed accumulator."""
        if self._basis is None:
            S = self.S
            v = torch.zeros((S + 1, self.s_tile), dtype=torch.bool, device=self.device)
            v[torch.arange(S), torch.arange(S)] = True
            self._basis = spl._state_words(v, self.s_tile)
        return self._basis

    def _entries(self, data, n: int, seeded: bool) -> torch.Tensor:
        """Pass 1 and the prefix: [nb, W] int32 entry state of every block."""
        S, blk = self.S, self.block
        nb = -(-(n + 2) // blk)
        P1 = S + 1
        dev = self.device
        v0 = self._basis_words().repeat(nb, 1)
        j = torch.arange(nb * P1, device=dev)
        gate = (j % P1 == S) & (torch.tensor(seeded, device=dev) | (j < P1))
        geom1 = spl.LongGeom(n, nb * P1, blk, 0, blk, P1)
        vf = spl.long_carry(data, geom1, self.tables, v0, gate, seeded=seeded)
        bits = spl._bit_rows(vf.to(torch.int64) & 0xFFFFFFFF, self.s_tile)
        summ = bits.reshape(nb, P1, self.s_tile)[:, :, :S]
        ventry = prefix_entries(summ[:, :S], summ[:, S])
        full = torch.zeros((nb, self.s_tile), dtype=torch.bool, device=dev)
        full[:, :S] = ventry
        return spl._state_words(full, self.s_tile)

    def _sum_impl(self, data, n: int, seeded: bool, mode: str):
        blk = self.block
        nb = -(-(n + 2) // blk)
        v0 = self._entries(data, n, seeded)
        gate = None if seeded else (torch.arange(nb, device=self.device) == 0)
        geom2 = spl.LongGeom(n, nb, blk, 0, blk)
        if mode in ("count", "any", "full"):
            cnt, tail, _ = spl.long_count(data, geom2, self.tables, v0, gate, seeded=seeded)
            return _merge_counts(cnt, tail, mode)
        words = spl.long_flags(data, geom2, self.tables, v0, gate, seeded=seeded)
        return _tail(bits_of_words(words, n + 2), n, mode)

    # -- speculative windows ------------------------------------------------------
    def _spec_impl(self, data, n: int, mode: str, W: int):
        """(value, ok): every window's entry guessed by a W-step warm-up from
        the empty set, the windows replayed from the guesses with their exits
        in one pass, and ok = every exit equals the next window's guess (then
        the guesses are a consistent execution from the exact entry_0 = 0, so
        the value is exact)."""
        blk = self.block
        nb = -(-(n + 2) // blk)
        E = spl.long_carry(data, spl.LongGeom(n, nb, blk, W, W), self.tables, seeded=True)
        E[0] = 0  # window 0 starts at the stream's head: its entry is exactly empty
        cnt, tail, vf = spl.long_count(data, spl.LongGeom(n, nb, blk, 0, blk), self.tables, E,
                                       seeded=True, final=True)
        ok = (vf[:-1] == E[1:]).all() if nb > 1 else torch.ones((), dtype=torch.bool)
        return _merge_counts(cnt, tail, mode), ok

    def _spec_or_summary(self, data, n: int, mode: str, W: int):
        """The speculative value when it validates, else summary + replay.
        The verdict crosses to the host once per call."""
        val, ok = self._spec_impl(data, n, mode, W)
        if bool(ok):
            return val
        return self._sum_impl(data, n, True, mode)

    # -- dispatch ----------------------------------------------------------------
    def _run(self, text, seeded: bool, mode: str):
        data = as_data(text, self.device)
        n = data.numel()
        if seeded and self.overlap is not None:
            if mode in ("count", "any") and n > 0 and self._swar_ov_scanner() is not None:
                return self._swar_ov_impl(data, n, mode)
            return self._ov_impl(data, n, mode)
        if seeded and mode in ("count", "any") and not self._wide and n > 0:
            from ..utils.config import get_config

            W = get_config().spec_warmup
            if W and n + 2 > self.block:
                return self._spec_or_summary(data, n, mode, W)
        if self._wide:
            if self._portable is None:
                self._portable = LongScanner(self.prog, self.device, block=4096)
            return _tail(self._portable._flags(data, n, seeded), n, mode)
        return self._sum_impl(data, n, seeded, mode)

    # -- public API -----------------------------------------------------------------
    def flags(self, text, *, seeded: bool = True) -> torch.Tensor:
        """[len + 2] bool accept flags per global stream step, on the
        device. ``text`` is bytes or a uint8 tensor (on the device already,
        for repeated scans)."""
        return self._run(text, seeded, "flags")

    def _rev_impl(self, data, n: int) -> torch.Tensor:
        """[n + 2] bool start hits per global stream step: overlapped reverse
        windows (a suffix overlap: the reverse influence dies within the
        horizon)."""
        blk, o = self._ov_block(n), self.overlap
        geom = spl.LongGeom(n, -(-(n + 2) // blk), blk, 0, blk + o)
        return bits_of_words(spl.long_reverse(data, geom, self.tables), n + 2)

    def starts_bitmap(self, text) -> np.ndarray:
        """[len + 1] bool: some match starts at s. Bounded-horizon programs
        only; a cyclic one raises ValueError (count, search and fullmatch
        still work there)."""
        if self.overlap is None:
            raise ValueError(
                "long-string start/span extraction needs a bounded-horizon "
                f"(acyclic) pattern; {self.prog.pattern!r} has unbounded match length"
            )
        data = as_data(text, self.device)
        n = data.numel()
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        return starts_of_hits(self._rev_impl(data, n), n).cpu().numpy()

    def ends_bitmap(self, text) -> np.ndarray:
        """[len + 1] bool on the host: some match ends at e."""
        data = as_data(text, self.device)
        n = data.numel()
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        return ends_of_flags(self.flags(data), n).cpu().numpy()

    def count_ends(self, text) -> int:
        if self.prog.nullable:
            return as_data(text, self.device).numel() + 1
        return int(self._run(text, True, "count"))

    def search(self, text) -> bool:
        if self.prog.nullable:
            return True
        return bool(self._run(text, True, "any"))

    def fullmatch(self, text) -> bool:
        """Whole-string acceptance. The empty string is scanned unless the
        program is nullable: ``a?$`` accepts it without being nullable (the
        JAX scanner answers it with the nullability alone)."""
        data = as_data(text, self.device)
        if data.numel() == 0 and self.prog.nullable:
            return True
        return bool(self._run(data, False, "full"))


# ---------------------------------------------------------------------------
# Counting-plan programs: overlapped run-length windows
# ---------------------------------------------------------------------------


def _in_class(d: torch.Tensor, runs) -> torch.Tensor:
    ok = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    for lo, hi in runs:
        ok |= (d >= lo) & (d <= hi)
    return ok


class CountLongScanner:
    """One long string of a counting-plan program (``X{m,n}`` with a
    fixed-length body: ``a{1,300}``, ``(ab){2,600}``, ...). The seeded
    accept at a position depends only on the last m * k bytes, so the
    string splits into windows that re-scan ``lead = m * k`` context bytes
    and are then exact: one batched pass through the counting tier's
    kernels (``CountScanner``: ``rrx_count_stats`` with ``lead``,
    ``rrx_count_flags``, ``rrx_count_reverse``). Fullmatch and spans have
    closed forms (no scan)."""

    def __init__(self, prog: DeviceProgram, plan, device, block: int = 4096):
        self.prog = prog
        self.device = torch.device(device)
        self.m, self.n, self.body = plan
        self.k = len(self.body[0])
        self.lead = max(self.m, 1) * self.k
        self.block = _round_up(max(block, 4 * self.lead), 16)
        # duck-types FastLongScanner for Pattern.finditer_long
        self.overlap = self.lead
        self.cs = spl.CountScanner(prog, plan, self.device)

    def _win(self, data, n: int, right: bool):
        """([nw, Lw16] windows, [nw] lens, nw). ``right=False``: window w
        holds bytes [w*blk - lead, w*blk + blk) (0x80, a dead byte, before
        the string); ``right=True``: bytes [w*blk, w*blk + blk + lead) (the
        right context of the reverse pass)."""
        blk, lead = self.block, self.lead
        nw = max(1, -(-n // blk))
        win = _window_view(data, n, nw, blk, 0 if right else lead, _round_up(lead + blk, 16), 128)
        w = torch.arange(nw, dtype=torch.int64, device=self.device) * blk
        lens = (n - w).clamp(max=blk + lead) if right else lead + (n - w).clamp(0, blk)
        return win, lens.to(torch.int32), nw

    def _stats_impl(self, data, n: int):
        win, lens, nw = self._win(data, n, right=False)
        cnt, first, last, _, _ = self.cs.match_stats_b(win, lens.reshape(-1, 1), seeded=True,
                                                       lead=self.lead)
        cnt, first, last = (x.reshape(-1).to(torch.int64) for x in (cnt, first, last))
        off = torch.arange(nw, dtype=torch.int64, device=self.device) * self.block - self.lead
        gfirst = torch.where(first >= 0, first + off, BIG).min()
        glast = torch.where(last >= 0, last + off, -1).max()
        total = cnt.sum()
        return total, torch.where(total > 0, gfirst, -1), glast

    def long_stats(self, text):
        """(count, first_end, last_end) over the whole string."""
        data = as_data(text, self.device)
        n = data.numel()
        if self.prog.nullable:
            return n + 1, 0, n
        if n == 0:
            return 0, -1, -1
        total, first, last = self._stats_impl(data, n)
        return int(total), int(first), int(last)

    def _run(self, text, seeded: bool, mode: str):
        data = as_data(text, self.device)
        n = data.numel()
        if mode == "full":
            return self._full_value(data, n)
        if not seeded or mode not in ("count", "any"):
            raise ValueError(f"CountLongScanner: unsupported (seeded={seeded}, mode={mode!r}); "
                             "the counting tier has no flag stream")
        if n == 0:
            return torch.zeros((), dtype=torch.int64)
        total, _, _ = self._stats_impl(data, n)
        return total if mode == "count" else total > 0

    def count_ends(self, text) -> int:
        return self.long_stats(text)[0]

    def search(self, text) -> bool:
        return self.count_ends(text) > 0

    def _full_value(self, data, n: int) -> bool:
        """Whole-string acceptance in closed form: n = j * k with m <= j <= n
        and every body copy in some branch."""
        if n == 0:
            return self.prog.nullable
        k, mm = self.k, max(self.m, 1)
        j = n // k
        if n % k or j < mm or (self.n and j > self.n):
            return False
        d = data[: j * k].reshape(j, k).to(torch.int32)
        occ = torch.zeros(j, dtype=torch.bool, device=self.device)
        for br in self.body:
            bok = torch.ones(j, dtype=torch.bool, device=self.device)
            for q in range(k):
                bok &= _in_class(d[:, q], br[q])
            occ |= bok
        return bool(occ.all())

    def fullmatch(self, text) -> bool:
        data = as_data(text, self.device)
        return self._full_value(data, data.numel())

    def _ends_impl(self, data, n: int) -> torch.Tensor:
        """[n] bool: some match ends at positions 1..n."""
        win, lens, nw = self._win(data, n, right=False)
        fl = self.cs.forward_flags_b(win, lens.reshape(-1, 1), seeded=True)
        lead, blk = self.lead, self.block
        # column c = step c - 1; window-local ends e in (lead, lead + blk]
        return fl[:nw, lead + 2 : lead + 2 + blk].reshape(-1)[:n]

    def ends_bitmap(self, text) -> np.ndarray:
        """[n + 1] bool; bit e = some match ends at e."""
        data = as_data(text, self.device)
        n = data.numel()
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        out = np.zeros(n + 1, bool)
        if n:
            out[1:] = self._ends_impl(data, n).cpu().numpy()
        return out

    def _starts_impl(self, data, n: int) -> torch.Tensor:
        win, lens, nw = self._win(data, n, right=True)
        h = self.cs.reverse_hits_b(win, lens.reshape(-1, 1))
        return h[:nw, 1 : 1 + self.block].reshape(-1)[:n]

    def starts_bitmap(self, text) -> np.ndarray:
        """[n + 1] bool; bit s = some match starts at s."""
        data = as_data(text, self.device)
        n = data.numel()
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        out = np.zeros(n + 1, bool)
        if n:
            out[:n] = self._starts_impl(data, n).cpu().numpy()
        return out

    def _copies_from(self, arr: np.ndarray) -> np.ndarray:
        """[n] int64: consecutive body copies starting at each position."""
        n = arr.shape[0]
        k = self.k
        nocc = max(n - k + 1, 0)
        occ = np.zeros(nocc, bool)
        for br in self.body:
            bok = np.ones(nocc, bool)
            for q, runs in enumerate(br):
                a = arr[q : q + nocc]
                ok = np.zeros(nocc, bool)
                for lo, hi in runs:
                    ok |= (a >= lo) & (a <= hi)
                bok &= ok
            occ |= bok
        C = np.zeros(n + k, np.int64)
        for r in range(k):
            o = occ[r::k] if r < occ.shape[0] else np.zeros(0, bool)
            m = o.shape[0]
            if not m:
                continue
            nxt = np.where(~o)[0]
            if len(nxt):
                pos = np.searchsorted(nxt, np.arange(m), side="left")
                safe = np.minimum(pos, len(nxt) - 1)
                bound = np.where(pos < len(nxt), nxt[safe], m)
            else:
                bound = np.full(m, m, np.int64)
            C[r::k][:m] = bound - np.arange(m)
        return C[:n]

    def spans(self, text, *, longest: bool = False):
        """Non-overlapping spans in closed form: a lazy match from s is m
        body copies, a greedy one min(copies(s), n): a host walk over the
        copies array (X{m,} too). Not for nullable programs."""
        if self.prog.nullable:
            raise ValueError("nullable spans are answered by Pattern.finditer_long")
        if isinstance(text, (bytes, bytearray)):
            arr = np.frombuffer(bytes(text), np.uint8)
        else:
            arr = torch.as_tensor(text).cpu().numpy().astype(np.uint8)
        k, mm = self.k, max(self.m, 1)
        C = self._copies_from(arr)
        starts = np.where(C >= mm)[0]
        out = []
        i = 0
        while i < starts.shape[0]:
            s = int(starts[i])
            cap = int(C[s]) if not self.n else min(int(C[s]), self.n)
            e = s + (cap if longest else mm) * k
            out.append((s, e))
            i = int(np.searchsorted(starts, e, side="left"))
        return out


# ---------------------------------------------------------------------------
# Rewrites: `.*X.*` and the X{m,n} seeded alias
# ---------------------------------------------------------------------------


def _cummax(x: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Running max of a 1-D int32 tensor in two levels of ``torch.cummax``:
    within rows of ``chunk`` and over the rows' maxima, whose scans run in
    parallel (a 1-D cummax of 2^30 elements runs as one sequential scan:
    5.7 s on an H100)."""
    n = x.numel()
    if n <= chunk:
        return torch.cummax(x, dim=0).values
    low = torch.iinfo(x.dtype).min
    rows = torch.nn.functional.pad(x, (0, -n % chunk), value=low).reshape(-1, chunk)
    local = torch.cummax(rows, dim=1).values
    carry = _cummax(local[:, -1], chunk)
    carry = torch.cat([carry.new_full((1,), low), carry[:-1]])
    return torch.maximum(local, carry[:, None]).reshape(-1)[:n]


def dotstar_core(prog: DeviceProgram):
    """(core_prog, had_trailing_dotstar) for `.*X.*`-shaped patterns, or
    None (the JAX package's builder, unchanged, on the port's compiler).
    Under seeded ends a leading ``.*`` is redundant and a trailing ``.*``
    turns the ends into a segmented running OR of X's ends (segments break
    at bytes >= 0x80, which ``.`` does not match). X must be non-nullable
    and anchor-free."""
    from ..compiler.nfa import build_nfa_ast
    from ..compiler.parser import Concat, Lit, Repeat, parse
    from ..compiler.program import compile_program

    try:
        node = parse(prog.pattern)
    except Exception:
        return None
    parts = list(node.parts) if isinstance(node, Concat) else [node]
    any_syms = frozenset(range(0x80))

    def is_ds(nd):
        return (
            isinstance(nd, Repeat)
            and nd.lo == 0
            and nd.hi is None
            and isinstance(nd.child, Lit)
            and nd.child.syms == any_syms
        )

    lead = 0
    while lead < len(parts) and is_ds(parts[lead]):
        lead += 1
    trail = 0
    while len(parts) - lead - trail > 0 and is_ds(parts[-1 - trail]):
        trail += 1
    if (lead == 0 and trail == 0) or len(parts) - lead - trail < 1:
        return None
    core_parts = tuple(parts[lead : len(parts) - trail])
    core_ast = core_parts[0] if len(core_parts) == 1 else Concat(core_parts)
    try:
        nfa = build_nfa_ast(core_ast, f"<core:{prog.pattern}>")
    except Exception:
        return None
    if nfa.nullable:
        return None
    core = compile_program(nfa)
    if core.uses_anchor:
        return None
    return core, trail > 0


class DotStarLongScanner:
    """Seeded long-string scans of `.*X.*` rewrites (:func:`dotstar_core`):
    a scan of X, its ends, and for a trailing ``.*`` a running OR. On
    pure-ASCII text a count needs only X's global first end (the SWAR
    windows' ``first``); text with bytes >= 0x80 takes the segmented
    running OR over X's flags (``rrx_long_flags``) in torch ``cummax``. The
    branch is chosen on the host (one check of the string per call; the
    JAX package selects on the device). Fullmatch, starts and unseeded
    flags go to a scanner of the original pattern."""

    def __init__(self, prog, core_prog, trail: bool, device, block: int = 4096):
        self.prog = prog
        self.core_prog = core_prog
        self.trail = trail
        self.device = torch.device(device)
        self.block = block
        self.inner = make_long_scanner(core_prog, self.device, block)
        self.overlap = getattr(self.inner, "overlap", None)
        self._generic = None

    def _fallback(self):
        if self._generic is None:
            if fast_long_takes(self.prog, self.block):
                self._generic = FastLongScanner(self.prog, self.device, block=self.block)
            else:
                self._generic = LongScanner(self.prog, self.device, block=min(self.block, 4096))
        return self._generic

    def _inner_ends(self, data, n: int) -> torch.Tensor:
        """[n + 1] bool ends of the core on the device (e = 0 impossible:
        the core is non-nullable)."""
        inner = self.inner
        if isinstance(inner, CountLongScanner):
            ends = torch.zeros(n + 1, dtype=torch.bool, device=self.device)
            if n:
                ends[1:] = inner._ends_impl(data, n)
            return ends
        if isinstance(inner, LongScanner):
            return ends_of_flags(inner._flags(data, n, True), n)
        return ends_of_flags(inner._run(data, True, "flags"), n)

    def _running_or(self, ends: torch.Tensor, data, n: int) -> torch.Tensor:
        """e is a P end iff some X end e' <= e has no dead byte in [e', e)."""
        dev = self.device
        e_idx = torch.arange(n + 1, dtype=torch.int32, device=dev)  # n < 2^31
        last_end = _cummax(torch.where(ends, e_idx, -1))
        dd = torch.where(data[:n] >= 0x80, e_idx[1:], 0)
        D = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), _cummax(dd)])
        return (last_end >= 0) & (last_end >= D)

    def _epilogue(self, ends, data, n: int, mode: str):
        if not (self.trail and n):
            if mode == "count":
                return ends.sum(dtype=torch.int64)
            return ends.any() if mode == "any" else ends
        if mode == "any":
            return ends.any()  # a trailing .* can be empty: any X end is a P end
        if mode == "ends" or bool((data[:n] >= 0x80).any()):
            out = self._running_or(ends, data, n)
            return out if mode == "ends" else out.sum(dtype=torch.int64)
        # pure ASCII: every e >= the first X end is a P end
        hit = ends.any()
        first = torch.argmax(ends.to(torch.uint8)).to(torch.int64)
        return torch.where(hit, n + 1 - first, 0)

    def _count_trail_impl(self, data, n: int):
        """Trailing-``.*`` count: on pure-ASCII text n + 1 - (X's global
        first end) from the SWAR windows, no flag stream; with bytes >= 0x80
        the running OR over X's flags (``rrx_long_flags``)."""
        if bool((data[:n] >= 0x80).any()):
            ends = ends_of_flags(self.inner._ov_impl(data, n, "flags"), n)
            return self._running_or(ends, data, n).sum(dtype=torch.int64)
        anyg, firstg = self.inner._swar_ov_first(data, n)
        return torch.where(anyg, n + 1 - firstg, 0)

    def _run(self, text, seeded: bool, mode: str):
        if seeded and mode in ("count", "any"):
            if not self.trail and hasattr(self.inner, "_run"):
                return self.inner._run(text, seeded, mode)
            data = as_data(text, self.device)
            n = data.numel()
            if mode == "any" and hasattr(self.inner, "_run"):
                return self.inner._run(data, seeded, "any")
            if (mode == "count" and n > 0 and isinstance(self.inner, FastLongScanner)
                    and self.inner.overlap is not None
                    and self.inner._swar_ov_scanner() is not None):
                return self._count_trail_impl(data, n)
            return self._epilogue(self._inner_ends(data, n), data, n, mode)
        return self._fallback()._run(text, seeded, mode)

    def ends_bitmap(self, text) -> np.ndarray:
        data = as_data(text, self.device)
        n = data.numel()
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        return self._epilogue(self._inner_ends(data, n), data, n, "ends").cpu().numpy()

    def count_ends(self, text) -> int:
        if self.prog.nullable:
            return as_data(text, self.device).numel() + 1
        return int(self._run(text, True, "count"))

    def search(self, text) -> bool:
        if self.prog.nullable:
            return True
        return bool(self._run(text, True, "any"))

    def fullmatch(self, text) -> bool:
        return bool(self._fallback().fullmatch(text))

    def starts_bitmap(self, text) -> np.ndarray:
        return self._fallback().starts_bitmap(text)

    def flags(self, text, *, seeded: bool = True):
        return self._fallback().flags(text, seeded=seeded)


class AliasLongScanner(DotStarLongScanner):
    """Long-string scans of a whole-pattern X{m,n} blowup through its X{m,}
    seeded alias (``engine.seeded_alias_program``): ends and starts are the
    same under seeded semantics, so count, search and the bitmaps run on
    the alias; fullmatch keeps the original program."""

    def __init__(self, prog, core_prog, device, block: int = 4096):
        super().__init__(prog, core_prog, False, device, block)

    def starts_bitmap(self, text) -> np.ndarray:
        inner = self.inner
        if hasattr(inner, "starts_bitmap"):
            return inner.starts_bitmap(text)
        raise ValueError(
            "start extraction over one long string needs a bounded-horizon scanner; "
            f"{self.prog.pattern!r} routes through the cyclic X{{m,}} alias: use the batched "
            "record API for spans"
        )


def make_long_scanner(prog: DeviceProgram, device, block: int = 4096):
    """The long-string scanner for a program (the JAX package's choice):
    the `.*X.*` and X{m,n}-alias rewrites first, run-length windows for
    counting-plan programs, the window kernels for dense tiles of up to 32
    states (and wider ones of up to 1024 states with a horizon, the block
    grown to eight overlaps), :class:`LongScanner` otherwise."""
    from ..engine import seeded_alias_program

    if not prog.nullable and prog.horizon is None:
        ds = dotstar_core(prog)
        if ds is not None:
            core_prog, trail = ds
            if core_prog.horizon is not None or spl.counting_plan(core_prog):
                return DotStarLongScanner(prog, core_prog, trail, device, block)
    if prog.tier in ("multiblock", "sparse") and not prog.nullable:
        aprog = seeded_alias_program(prog)
        if aprog is not None:
            return AliasLongScanner(prog, aprog, device, block)
    plan = spl.counting_plan(prog)
    if plan is not None:
        m, _, branches = plan
        if max(m, 1) * len(branches[0]) <= 1 << 16:
            return CountLongScanner(prog, plan, device, block=block)
    if fast_long_takes(prog, block):
        return FastLongScanner(prog, device, block=block)
    if prog.horizon is not None:
        blk = max(block, _round_up(8 * (prog.horizon + 2), 32))
        if fast_long_takes(prog, blk):
            return FastLongScanner(prog, device, block=blk)
    return LongScanner(prog, device, block=min(block, 4096))


def fast_long_takes(prog: DeviceProgram, block: int) -> bool:
    """Whether :class:`FastLongScanner` runs the program in windows of
    ``block`` bytes: a dense follow matrix, a tile the window kernels hold
    (at most ``MAX_S_TILE`` = 1024 states) and, past 32 states, a horizon
    whose overlap fits in an eighth of the window."""
    if prog.F is None or prog.s_tile > spl.MAX_S_TILE:
        return False
    return prog.s_tile <= 32 or (prog.horizon is not None and prog.horizon + 2 <= block // 8)
