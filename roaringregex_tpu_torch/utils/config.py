"""Configuration knobs the port reads, with the JAX package's ``RRX_*``
names and defaults (``roaringregex_tpu/utils/config.py``), so one
environment configures both packages alike. One default differs on
purpose: ``backend`` None is the kernel route on every device, where the
JAX package picks its ``packed`` backend off a TPU."""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclass(frozen=True)
class RrxConfig:
    # backend (RRX_BACKEND), read by ScanEngine when the caller names none:
    # None or "pallas" = the kernel route (every tier's CUDA kernels on a
    # CUDA device, their plain versions on the CPU), "packed" = the mask
    # stream's primitives (ops/scan_packed.py), "xla" = the unpacked torch-op
    # engine (ops/scan_xla.py). The JAX package picks "packed" by default
    # off a TPU; the port never picks a backend by platform: the caller
    # chooses "xla" or "packed" explicitly
    backend: Optional[str] = field(
        default_factory=lambda: os.environ.get("RRX_BACKEND") or None
    )
    # largest state count with fully dense tables (tier cut-off)
    dense_max: int = field(default_factory=lambda: _env_int("RRX_DENSE_MAX", 1024))
    # windowed batch scan on the matmul tier: split long records into
    # overlapped windows until the batch is ~this many rows wide (exact for
    # bounded-horizon anchor-free non-nullable patterns; engine
    # _window_plan). 0 (default) = off, as in the JAX package
    window_cols: int = field(
        default_factory=lambda: _env_int("RRX_WINDOW_COLS", 0)
    )
    # SWAR / u32-word bit-set scan tiers on/off (RRX_SWAR=0: off, and their
    # programs run on the matmul tier, as in the JAX package)
    swar: bool = field(
        default_factory=lambda: os.environ.get("RRX_SWAR", "1") != "0"
    )
    # tall-narrow window target: split long records into overlapped
    # windows until the batch is ~this many 32-record columns wide (exact
    # for bounded-horizon anchor-free non-nullable patterns); 0 = never
    swar_window_cols: int = field(
        default_factory=lambda: _env_int("RRX_SWAR_WINDOW_COLS", 1024)
    )
    # slotted multi-pattern SWAR (ops/scan_swar.SwarMultiScanner: up to 4
    # patterns of at most 8 states in one u32, a byte lane each) for a
    # MultiPattern whose patterns all fit; off by default, as in the JAX
    # package (RRX_SWAR_MULTI=1 turns it on)
    swar_multi: bool = field(
        default_factory=lambda: os.environ.get("RRX_SWAR_MULTI", "0") == "1"
    )

    # seeded-alias rewrite of a whole-pattern X{m,n} on the multiblock and
    # sparse tiers (engine.seeded_alias_program: its seeded primitives run
    # on the X{m,} alias); RRX_ALIAS=0 keeps the original program, on its
    # own tier, for every primitive
    seeded_alias: bool = field(
        default_factory=lambda: os.environ.get("RRX_ALIAS", "1") != "0"
    )
    # the bitband tier for multiblock and sparse programs whose follow
    # matrix decomposes (engine._big_tier); RRX_BITBAND=0 sends them to the
    # container tier
    bitband: bool = field(
        default_factory=lambda: os.environ.get("RRX_BITBAND", "1") != "0"
    )

    # prefilter of the sparse tier: a tiny superset-language scan first,
    # the heavy kernels only on the compacted candidate records
    # (engine.relaxed_prefilter_program)
    sparse_prefilter: bool = field(
        default_factory=lambda: os.environ.get("RRX_SPARSE_PREFILTER", "1") != "0"
    )

    # one-long-string mode: window (block) length in bytes
    long_block: int = field(default_factory=lambda: _env_int("RRX_LONG_BLOCK", 4096))
    # speculative long-string windows for cyclic patterns: warm-up steps
    # used to guess each window's entry state, validated exactly (exit_w ==
    # entry_{w+1}); 0 = off, every cyclic scan takes summary + replay
    spec_warmup: int = field(default_factory=lambda: _env_int("RRX_SPEC_WARMUP", 512))

    def with_(self, **kw) -> "RrxConfig":
        return replace(self, **kw)


_config: RrxConfig = RrxConfig()


def get_config() -> RrxConfig:
    return _config


def set_config(cfg: RrxConfig) -> RrxConfig:
    global _config
    _config = cfg
    return _config
