"""AST -> Glushkov position NFA (epsilon-free, factorized).

Carried over from ``roaringregex_tpu/compiler/nfa.py`` so that the port
compiles patterns without importing the JAX package. The construction is
the classical Glushkov automaton, whose transition function factorizes as

    delta(D, c) = follow(D)  INTERSECT  B[c]

where ``follow(D)`` is byte independent and ``B[c]`` is a per-symbol state
mask. The scan kernels rest on that split: the follow relation is static,
the only byte-dependent work is one mask lookup per step.

Differences from the JAX package's module: ``build_nfa`` runs the
pure-Python build only (the native C++ compiler is not ported yet; its
output is identical). ``combine_nfas`` (the multi-pattern union behind
``MultiPattern``) is the JAX package's, unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import numpy as np

from .parser import BOS, EOS, NSYM, Alt, Concat, Empty, Lit, Node, Repeat, parse

# Hard cap so pathological patterns fail loudly instead of allocating
# gigabyte tables.
MAX_STATES = 16384


class PatternTooLargeError(ValueError):
    pass


def count_positions(node: Node) -> int:
    """Number of Glushkov positions after Repeat expansion (excl. state 0)."""
    if isinstance(node, Empty):
        return 0
    if isinstance(node, Lit):
        return 1
    if isinstance(node, Concat) or isinstance(node, Alt):
        return sum(count_positions(p) for p in node.parts)
    if isinstance(node, Repeat):
        c = count_positions(node.child)
        if node.hi is None:
            # R{m,} = R^max(m,1) with the last copy starred
            return c * max(node.lo, 1)
        if node.hi == 0:
            return 0
        # R{m,n} = R^m (R?)^(n-m)
        return c * node.hi
    raise TypeError(node)


@dataclass
class _G:
    """Glushkov attributes of a subexpression."""

    nullable: bool
    first: Set[int]
    last: Set[int]


class _Builder:
    def __init__(self):
        self.labels: List[frozenset] = []  # symbol class per position (1-based)
        self.follow: List[Set[int]] = []  # follow set per position (1-based)

    def new_pos(self, syms: frozenset) -> int:
        self.labels.append(syms)
        self.follow.append(set())
        return len(self.labels)  # positions are 1-based; 0 is the initial state

    def build(self, node: Node) -> _G:
        if isinstance(node, Empty):
            return _G(True, set(), set())
        if isinstance(node, Lit):
            p = self.new_pos(node.syms)
            return _G(False, {p}, {p})
        if isinstance(node, Concat):
            g = self.build(node.parts[0])
            for part in node.parts[1:]:
                h = self.build(part)
                for p in g.last:
                    self.follow[p - 1] |= h.first
                g = _G(
                    g.nullable and h.nullable,
                    g.first | h.first if g.nullable else g.first,
                    h.last | g.last if h.nullable else h.last,
                )
            return g
        if isinstance(node, Alt):
            gs = [self.build(p) for p in node.parts]
            return _G(
                any(g.nullable for g in gs),
                set().union(*(g.first for g in gs)),
                set().union(*(g.last for g in gs)),
            )
        if isinstance(node, Repeat):
            return self._repeat(node)
        raise TypeError(node)

    def _star(self, g: _G) -> _G:
        """Kleene closure: loop last -> first."""
        for p in g.last:
            self.follow[p - 1] |= g.first
        return _G(True, g.first, g.last)

    def _plus(self, g: _G) -> _G:
        """One-or-more: same follow loop as star, nullability unchanged."""
        for p in g.last:
            self.follow[p - 1] |= g.first
        return g

    def _repeat(self, node: Repeat) -> _G:
        """Expand {m,n} by duplicating the child with fresh positions:
        R{m,} = R^m with the last copy looping, R{m,n} = R^m (R?)^{n-m}."""
        child, lo, hi = node.child, node.lo, node.hi
        if hi == 0:
            return _G(True, set(), set())
        if hi is None:
            if lo == 0:  # R*
                return self._star(self.build(child))
            # R{m,} = R^{m-1} . R+  (the last copy loops but stays mandatory)
            gs = [self.build(child) for _ in range(lo)]
            gs[-1] = self._plus(gs[-1])
            return self._concat_gs(gs)
        gs = [self.build(child) for _ in range(lo)]
        for _ in range(hi - lo):
            g = self.build(child)
            gs.append(_G(True, g.first, g.last))  # optionalized copy
        return self._concat_gs(gs)

    def _concat_gs(self, gs: List[_G]) -> _G:
        g = gs[0]
        for h in gs[1:]:
            for p in g.last:
                self.follow[p - 1] |= h.first
            g = _G(
                g.nullable and h.nullable,
                g.first | h.first if g.nullable else g.first,
                h.last | g.last if h.nullable else h.last,
            )
        return g


@dataclass
class NFA:
    """Logical epsilon-free position NFA.

    State 0 is the initial state; states 1..n_states-1 are Glushkov
    positions. ``follow[i]`` includes state 0's row = first(root).
    Acceptance: D intersects ``accept``; transitions:
    ``delta(D, sym) = (U_{i in D} follow[i]) & B[sym]``.

    The follow relation is stored as Python sets (``follow_sets``) or as
    an edge array (``edges`` [nnz, 2] int32, sorted by source); the edge
    array materializes lazily from the sets.
    """

    pattern: str
    n_states: int
    labels: List[frozenset]  # per position 1..n-1 (index p-1)
    follow_sets: Optional[List[Set[int]]] = None  # index by state 0..n-1
    accept_set: Set[int] = None
    nullable: bool = False
    edges: Optional[np.ndarray] = None  # [nnz, 2] int32, sorted by source

    def __post_init__(self):
        if self.follow_sets is None and self.edges is None:
            raise ValueError("NFA needs follow_sets or edges")

    _follow_mat: Optional[np.ndarray] = None
    _symtab: Optional[np.ndarray] = None
    _accept_vec: Optional[np.ndarray] = None

    def get_follow_sets(self) -> List[Set[int]]:
        """List-of-sets view (materialized on demand from the edge array)."""
        if self.follow_sets is None:
            e = self.edges
            splits = np.searchsorted(e[:, 0], np.arange(1, self.n_states))
            self.follow_sets = [set(p.tolist()) for p in np.split(e[:, 1], splits)]
        return self.follow_sets

    def get_edges(self) -> np.ndarray:
        """Edge-array view (materialized on demand from the sets)."""
        if self.edges is None:
            pairs = [
                (i, j)
                for i, fs in enumerate(self.follow_sets)
                for j in sorted(fs)
            ]
            self.edges = np.array(pairs, dtype=np.int32).reshape(-1, 2)
        return self.edges

    @property
    def follow_matrix(self) -> np.ndarray:
        """[S, S] uint8; F[i, j] = 1 iff j in follow(i)."""
        if self._follow_mat is None:
            S = self.n_states
            F = np.zeros((S, S), dtype=np.uint8)
            e = self.get_edges()
            if len(e):
                F[e[:, 0], e[:, 1]] = 1
            self._follow_mat = F
        return self._follow_mat

    @property
    def symtab(self) -> np.ndarray:
        """[NSYM, S] uint8; B[c, p] = 1 iff c in label(p). Column 0 is zero
        (the initial state is never entered)."""
        if self._symtab is None:
            S = self.n_states
            B = np.zeros((NSYM, S), dtype=np.uint8)
            for p, syms in enumerate(self.labels, start=1):
                for c in syms:
                    B[c, p] = 1
            self._symtab = B
        return self._symtab

    @property
    def accept_vec(self) -> np.ndarray:
        if self._accept_vec is None:
            v = np.zeros(self.n_states, dtype=np.uint8)
            for p in self.accept_set:
                v[p] = 1
            self._accept_vec = v
        return self._accept_vec

    def dump(self, full: bool = False) -> str:
        """Human-readable NFA dump: pattern, accept set, and each state's
        follow set and label. With ``full=True``, also the per-state
        per-symbol forward and backward transition rows, grouped into
        maximal symbol runs with identical targets (all-empty rows left
        out). The JAX package's ``NFA.dump``, line for line."""
        lines = [
            f"pattern: {self.pattern!r}",
            f"states: {self.n_states} (state 0 = initial)",
            f"accept: {sorted(self.accept_set)}  nullable: {self.nullable}",
        ]
        fs = self.get_follow_sets()
        for i in range(self.n_states):
            lab = "" if i == 0 else f"  label={_fmt_syms(self.labels[i - 1])}"
            lines.append(f"  {i}: follow={sorted(fs[i])}{lab}")
        if not full:
            return "\n".join(lines)

        def sym_name(c: int) -> str:
            if c == BOS:
                return "BOS(^)"
            if c == EOS:
                return "EOS($)"
            return repr(chr(c)) if 32 <= c < 127 else f"\\x{c:02x}"

        def runs_of(row):
            """row: sym -> targets; [(lo, hi, targets)] over maximal runs."""
            out = []
            for c in range(NSYM):
                t = row.get(c)
                if not t:
                    continue
                if out and out[-1][1] == c - 1 and out[-1][2] == t:
                    out[-1] = (out[-1][0], c, t)
                else:
                    out.append((c, c, t))
            return out

        B = self.symtab  # [NSYM, S]
        lines.append("transition rows (fwd: state -byte-> targets; "
                     "bwd: mirrored predecessor rows):")
        for i in range(self.n_states):
            fwd = {}
            for t in sorted(fs[i]):
                for c in np.nonzero(B[:, t])[0]:
                    fwd.setdefault(int(c), set()).add(t)
            bwd = {}
            if i > 0:
                preds = [s for s in range(self.n_states) if i in fs[s]]
                for c in np.nonzero(B[:, i])[0]:
                    bwd[int(c)] = set(preds)
            row_lines = []
            for lo, hi, t in runs_of(fwd):
                span = sym_name(lo) if lo == hi else f"{sym_name(lo)}-{sym_name(hi)}"
                row_lines.append(f"    fwd {span} -> {sorted(t)}")
            for lo, hi, t in runs_of(bwd):
                span = sym_name(lo) if lo == hi else f"{sym_name(lo)}-{sym_name(hi)}"
                row_lines.append(f"    bwd {span} -> {sorted(t)}")
            if row_lines:
                lines.append(f"  state {i}:")
                lines.extend(row_lines)
        return "\n".join(lines)


def _fmt_syms(syms: frozenset) -> str:
    names = []
    for c in sorted(syms):
        if c == BOS:
            names.append("^")
        elif c == EOS:
            names.append("$")
        elif 32 <= c < 127:
            names.append(chr(c))
        else:
            names.append(f"\\x{c:02x}")
    if len(names) > 12:
        return f"[{''.join(names[:12])}...{len(names)} syms]"
    return f"[{''.join(names)}]"


def build_nfa(pattern: str) -> NFA:
    """Compile a pattern to its Glushkov NFA (pure-Python build)."""
    return build_nfa_ast(parse(pattern), pattern)


def build_nfa_ast(ast, pattern: str) -> NFA:
    """Glushkov build from an already-parsed AST node. ``pattern`` is only
    a label."""
    n_pos = count_positions(ast)
    if n_pos + 1 > MAX_STATES:
        raise PatternTooLargeError(
            f"pattern needs {n_pos + 1} states > MAX_STATES={MAX_STATES}"
        )
    b = _Builder()
    g = b.build(ast)
    assert len(b.labels) == n_pos, (len(b.labels), n_pos)
    follow_sets: List[Set[int]] = [set(g.first)] + [set(fs) for fs in b.follow]
    accept = set(g.last)
    if g.nullable:
        accept.add(0)
    return NFA(
        pattern=pattern,
        n_states=n_pos + 1,
        labels=b.labels,
        follow_sets=follow_sets,
        accept_set=accept,
        nullable=g.nullable,
    )


def combine_nfas(nfas: List[NFA]) -> Tuple[NFA, List[Set[int]]]:
    """Union-combine NFAs into one automaton with a shared start state and
    disjoint position ranges: the Glushkov union, scanning P patterns in
    one pass (multi-pattern grep). Returns the combined NFA and the
    per-pattern accept sets in combined state ids (state 0 belongs to
    pattern p's accept set iff pattern p is nullable)."""
    n_states = 1 + sum(n.n_states - 1 for n in nfas)
    labels: List[frozenset] = []
    follow_sets: List[Set[int]] = [set()]
    accept_all: Set[int] = set()
    accepts: List[Set[int]] = []
    off = 0
    for n in nfas:
        fs = n.get_follow_sets()
        follow_sets[0] |= {p + off for p in fs[0]}
        for i in range(1, n.n_states):
            follow_sets.append({j + off for j in fs[i]})
        labels.extend(n.labels)
        acc = {p + off if p else 0 for p in n.accept_set}
        accepts.append(acc)
        accept_all |= acc
        off += n.n_states - 1
    combined = NFA(
        pattern="|".join(f"({n.pattern})" for n in nfas),
        n_states=n_states,
        labels=labels,
        follow_sets=follow_sets,
        accept_set=accept_all,
        nullable=any(n.nullable for n in nfas),
    )
    return combined, accepts
