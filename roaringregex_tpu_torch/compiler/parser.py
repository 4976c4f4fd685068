"""POSIX-ERE parser: pattern string -> AST.

Covers the feature grid of the reference engine (RoaringRegex
``src/Parser.cpp:40-159``): literals, ``\\`` escapes, ``.``, bracket
expressions ``[...]`` with ranges / leading-``^`` complement / inner escapes,
groups ``(...)``, alternation ``|``, and the quantifiers ``*`` ``+`` ``?``
``{m}`` ``{m,}`` ``{m,n}``.

Differences from the reference (all deliberate, see SURVEY.md SS2.12):

* Anchors ``^`` / ``$`` compile to literal *virtual symbols* BOS/EOS that the
  scanner injects at the string boundaries, so they actually work (the
  reference compiles them to unmatchable NUL literals, Parser.cpp:142-146).
* Malformed patterns raise :class:`RegexSyntaxError` instead of crashing via
  stack underflow (reference aborts on e.g. a trailing ``|``).
* ``{0,n}`` is well defined (``(R?){n}``); the reference's behavior there is
  accidental (Parser.cpp:126).

The grammar is standard ERE precedence (closure > concatenation >
alternation), matching the reference's stack-machine reduction order
(Parser.cpp:49-79) which was verified behaviorally in SURVEY.md SS4.3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# Virtual symbols. Real input bytes occupy 0..127 (the reference is
# ASCII-only: transition rows stop at 0x80, NFA.cc:25). BOS/EOS are injected
# by the scanner before/after the text so anchors become ordinary
# transitions -- fully vectorizable, no zero-width assertion machinery.
BOS = 128
EOS = 129
NSYM = 130  # symbol alphabet size (0..127 bytes, 128 BOS, 129 EOS)

ASCII_ALL = frozenset(range(128))


class RegexSyntaxError(ValueError):
    """Raised on malformed patterns (reference: runtime_error / abort)."""


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    pass


@dataclass(frozen=True)
class Empty(Node):
    """Matches the empty string (reference: 1-state epsilon NFA, NFA.cc:42)."""


@dataclass(frozen=True)
class Lit(Node):
    """One occurrence of a symbol class (reference: 2-state NFA, NFA.cc:50-71).

    ``syms`` is a frozenset of symbol ids in [0, NSYM). A plain literal is a
    singleton; ``.`` and bracket expressions are larger sets; anchors are
    the singletons {BOS} / {EOS}.
    """

    syms: frozenset

    def __post_init__(self):
        if not self.syms:
            raise RegexSyntaxError("empty character class")


@dataclass(frozen=True)
class Concat(Node):
    parts: Tuple[Node, ...]


@dataclass(frozen=True)
class Alt(Node):
    parts: Tuple[Node, ...]


@dataclass(frozen=True)
class Repeat(Node):
    """Bounded/unbounded repetition. ``hi=None`` means unbounded.

    ``*`` = Repeat(0, None); ``+`` = Repeat(1, None); ``?`` = Repeat(0, 1);
    ``{m}`` = Repeat(m, m); ``{m,}`` = Repeat(m, None); ``{m,n}``.
    Expansion into duplicated positions happens in the Glushkov builder so
    each copy gets fresh NFA states -- the same state blowup the reference
    produces via its ``repeat()`` deep copies (Parser.cpp:80-83), which is
    what forces ``a{1,300}``-class patterns onto the block-sparse tier.
    """

    child: Node
    lo: int
    hi: Optional[int]


# --------------------------------------------------------------------------
# Parser (recursive descent)
# --------------------------------------------------------------------------


class _Parser:
    def __init__(self, pattern: str):
        self.pat = pattern
        self.pos = 0

    # -- stream helpers -----------------------------------------------------
    def _peek(self) -> Optional[str]:
        return self.pat[self.pos] if self.pos < len(self.pat) else None

    def _next(self) -> str:
        ch = self._peek()
        if ch is None:
            raise RegexSyntaxError("unexpected end of pattern")
        self.pos += 1
        return ch

    def _expect(self, ch: str):
        if self._peek() != ch:
            raise RegexSyntaxError(f"expected {ch!r} at position {self.pos}")
        self.pos += 1

    # -- grammar ------------------------------------------------------------
    def parse(self) -> Node:
        node = self._alternation()
        if self.pos != len(self.pat):
            # e.g. an unbalanced ')'
            raise RegexSyntaxError(
                f"unexpected {self.pat[self.pos]!r} at position {self.pos}"
            )
        return node

    def _alternation(self) -> Node:
        parts = [self._concat()]
        while self._peek() == "|":
            self._next()
            parts.append(self._concat())
        if len(parts) > 1 and any(isinstance(p, Empty) for p in parts):
            # POSIX leaves '|' adjacent to nothing undefined; the reference
            # aborts via stack underflow (SURVEY.md SS2.7). We reject.
            raise RegexSyntaxError("empty alternation branch")
        return parts[0] if len(parts) == 1 else Alt(tuple(parts))

    def _concat(self) -> Node:
        parts = []
        while True:
            ch = self._peek()
            if ch is None or ch in "|)":
                break
            parts.append(self._repeat())
        if not parts:
            return Empty()
        return parts[0] if len(parts) == 1 else Concat(tuple(parts))

    def _repeat(self) -> Node:
        node = self._atom()
        while True:
            ch = self._peek()
            if ch == "*":
                self._next()
                node = Repeat(node, 0, None)
            elif ch == "+":
                self._next()
                node = Repeat(node, 1, None)
            elif ch == "?":
                self._next()
                node = Repeat(node, 0, 1)
            elif ch == "{":
                node = self._braces(node)
            else:
                return node
            if isinstance(node.child, Empty):
                node = Empty()  # quantified empty is empty

    def _braces(self, node: Node) -> Repeat:
        """Parse {m}, {m,}, {m,n} (reference: Parser.cpp:123-141)."""
        self._expect("{")
        lo = self._int("repetition lower bound")
        hi: Optional[int]
        if self._peek() == ",":
            self._next()
            if self._peek() == "}":
                hi = None
            else:
                hi = self._int("repetition upper bound")
        else:
            hi = lo
        self._expect("}")
        if hi is not None and hi < lo:
            raise RegexSyntaxError(f"invalid repetition bounds {{{lo},{hi}}}")
        return Repeat(node, lo, hi)

    def _int(self, what: str) -> int:
        start = self.pos
        while self._peek() is not None and self._peek().isdigit():
            self.pos += 1
        if self.pos == start:
            raise RegexSyntaxError(f"expected {what} at position {self.pos}")
        return int(self.pat[start : self.pos])

    def _atom(self) -> Node:
        ch = self._next()
        if ch == "(":
            node = self._alternation()
            self._expect(")")
            return node
        if ch == "[":
            return Lit(self._bracket())
        if ch == ".":
            # Reference: complemented-empty charset = all bytes 0..127
            # (Parser.cpp:106-112). Matches newline too (no DOTALL concept).
            return Lit(ASCII_ALL)
        if ch == "^":
            return Lit(frozenset({BOS}))
        if ch == "$":
            return Lit(frozenset({EOS}))
        if ch == "\\":
            # Reference escape mechanism: the escaped char falls through to
            # the literal arm (Parser.cpp:92, 147-150). No \d/\w classes.
            esc = self._next()
            return Lit(frozenset({_byte(esc)}))
        if ch in "*+?{":
            raise RegexSyntaxError(f"quantifier {ch!r} with nothing to repeat")
        if ch == ")":
            raise RegexSyntaxError("unbalanced ')'")
        return Lit(frozenset({_byte(ch)}))

    def _bracket(self) -> frozenset:
        """Bracket expression (reference: bracket_expression, Parser.cpp:16-39).

        Leading ``^`` complements (within 0..127); ``a-z`` inclusive ranges;
        ``\\x`` escapes members; ``]`` terminates unless escaped (the
        reference requires ``[\\]]``, verified SURVEY.md SS4.3).
        """
        members = set()
        negate = False
        if self._peek() == "^":
            self._next()
            negate = True
        while True:
            ch = self._peek()
            if ch is None:
                raise RegexSyntaxError("unterminated bracket expression")
            if ch == "]":
                self._next()
                break
            self._next()
            if ch == "\\":
                ch = self._next()
                members.add(_byte(ch))
                continue
            # range?
            if self._peek() == "-" and self.pos + 1 < len(self.pat) and self.pat[
                self.pos + 1
            ] not in "]":
                self._next()  # consume '-'
                hi_ch = self._next()
                if hi_ch == "\\":
                    hi_ch = self._next()
                lo_b, hi_b = _byte(ch), _byte(hi_ch)
                if hi_b < lo_b:
                    raise RegexSyntaxError(f"reversed range {ch}-{hi_ch}")
                members.update(range(lo_b, hi_b + 1))
            else:
                members.add(_byte(ch))
        if negate:
            members = ASCII_ALL - members
        if not members:
            raise RegexSyntaxError("empty bracket expression")
        return frozenset(members)


def _byte(ch: str) -> int:
    b = ord(ch)
    if b > 127:
        raise RegexSyntaxError(f"non-ASCII character {ch!r} (reference is ASCII-only)")
    return b


def parse(pattern: str) -> Node:
    """Parse a POSIX-ERE pattern into an AST."""
    return _Parser(pattern).parse()


def reverse_node(node: Node) -> Node:
    """AST of the reversed language: rev(L(node)) = L(reverse_node(node)).

    Concatenation order flips, anchors swap (^ becomes an end-of-reversed
    -string constraint and vice versa), everything else is pointwise.
    Used for long-string start extraction: a match of P starts at s in
    text iff a match of rev(P) ends at len - s in reversed text — the
    *intended* backward-scan capability of the reference (mirrored bwd
    transition rows, NFA.cc:52-53; never reachable there, regex.h:145-146)
    expressed as a second forward program instead of a second table."""
    if isinstance(node, Concat):
        return Concat(tuple(reverse_node(p) for p in reversed(node.parts)))
    if isinstance(node, Alt):
        return Alt(tuple(reverse_node(p) for p in node.parts))
    if isinstance(node, Repeat):
        return Repeat(reverse_node(node.child), node.lo, node.hi)
    if isinstance(node, Lit):
        syms = set(node.syms)
        swapped = (syms - {BOS, EOS}) | (
            {EOS} if BOS in syms else set()
        ) | ({BOS} if EOS in syms else set())
        return Lit(frozenset(swapped))
    return node
