from .nfa import NFA, build_nfa  # noqa: F401
from .parser import BOS, EOS, NSYM, RegexSyntaxError, parse  # noqa: F401
