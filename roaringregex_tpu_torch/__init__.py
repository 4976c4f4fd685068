"""roaringregex_tpu_torch -- the PyTorch and CUDA port of roaringregex_tpu.

The JAX package ``roaringregex_tpu`` is the reference. This package runs
its batched API on an NVIDIA H100 through hand-written CUDA kernels and on
the CPU through their plain PyTorch versions; it imports torch and never
jax. ``compile(pattern, device, backend=None)`` gives a ``Pattern``:
match stats (``search_batch``, ``count_batch``, ``grep``,
``fullmatch_batch``, ``fullmatch``), match positions (``ends_batch``,
``starts_batch``), spans (``finditer_batch``, ``finditer``, ``findall``,
``search``, ``match``) and one long string (``Pattern.long``,
``finditer_long``, ``rev_long``); ``MultiPattern`` scans P patterns in one
combined-automaton pass.

Tiers of the kernel route (backend "pallas", the default), by program:
the 8-state SWAR tier and the u32-word tier (up to 32 states;
``csrc/scan_bits.cu``, spans in ``csrc/scan_spans.cu``), the matmul tier
(33..256 states, ``csrc/scan_nfa.cu``; 257..1024 states, the dense
multiblock matmul, ``csrc/scan_nfa_wide.cu``), the counting tier (a
whole-pattern ``X{m,n}`` of a fixed-length body, ``csrc/scan_count.cu``),
the bitband tier (multiblock and sparse programs whose follow matrix
decomposes, config 10, ``csrc/scan_bitband.cu``) behind the sparse
prefilter, the container tier (other sparse and container-favoured
multiblock programs, ``csrc/scan_sparse.cu``) and the seeded ``X{m,}``
alias of a big ``X{m,n}``; one long string in windows
(``csrc/scan_long.cu``, ``csrc/scan_long_wide.cu``, shared step headers
``csrc/scan_core.cuh``, ``scan_nfa.cuh``, ``scan_nfa_wide.cuh``,
``scan_long.cuh``) or by summary + replay in torch ops. The other two
backends are the JAX package's plain ones: "packed", every primitive over
a precomputed mask stream (``ops/scan_packed.py`` on
``csrc/scan_stream.cu``, which also serves the kernel route's anchored
rescans of counting-tier programs), and "xla", torch ops over the unpacked
tables (``ops/scan_xla.py``), which also takes a container program past
the container kernels' caps, as in the JAX engine.
"""

from .api import Match, MultiPattern, Pattern, compile  # noqa: F401
from .compiler.nfa import NFA, build_nfa, combine_nfas  # noqa: F401
from .compiler.parser import RegexSyntaxError, parse  # noqa: F401
from .compiler.program import DeviceProgram, compile_program, from_reference  # noqa: F401
from .engine import ScanEngine  # noqa: F401

__version__ = "0.1.0"
