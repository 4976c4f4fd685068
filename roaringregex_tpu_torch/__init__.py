"""roaringregex_tpu_torch -- the PyTorch and CUDA port of roaringregex_tpu.

The JAX package ``roaringregex_tpu`` is the reference. This package runs
its batched match-stats path (``compile`` -> ``search_batch`` /
``count_batch`` / ``grep`` / ``fullmatch_batch`` / ``fullmatch``), match
positions (``ends_batch``, ``starts_batch``) and span extraction
(``finditer_batch``, ``finditer``, ``findall``, ``search``, ``match``)
for dense programs of up to 256 states (the SWAR, u32-word and matmul
tiers), for whole-pattern ``X{m,n}`` of a fixed-length body (the counting
tier) and for the seeded scans of a whole-pattern ``X{m,n}`` through its
``X{m,}`` alias, ``MultiPattern`` (P patterns in one combined-automaton
pass) and one long string (``Pattern.long``, ``finditer_long``), on an
NVIDIA H100 through hand-written CUDA kernels (``csrc/scan_bits.cu``,
``csrc/scan_spans.cu``, ``csrc/scan_nfa.cu``, ``csrc/scan_count.cu``,
``csrc/scan_long.cu``) and on the CPU through their plain PyTorch
versions. It imports torch and never jax.
"""

from .api import Match, MultiPattern, Pattern, compile  # noqa: F401
from .compiler.nfa import NFA, build_nfa, combine_nfas  # noqa: F401
from .compiler.parser import RegexSyntaxError, parse  # noqa: F401
from .compiler.program import DeviceProgram, compile_program, from_reference  # noqa: F401
from .engine import ScanEngine  # noqa: F401

__version__ = "0.1.0"
