"""Core symbolic IR: Word / Term, smart constructors, substitution, unrolling.

Behavioral model: the reference's ``SymbolicWord`` / ``SymbolicTerm``
(symbolics/01_Types.jl:36-56) with the smart constructors and
Einstein-index bookkeeping of ``construct_Term`` (symbolics/04_Term.jl:45-130)
and the dumb-index unrolling of ``unroll_Dumb_Indices``
(symbolics/04_Term.jl:239-261).  Unlike the reference, the IR here is
immutable (hash-consing-friendly, safe to cache across jit traces).

Conventions
-----------
* numbers are Python floats,
* an index is an ``int`` (1-based concrete component) or a ``str`` (a free or
  summed "dumb" index symbol),
* an index symbol appearing twice in a product is summed (dumb), three times
  is an error,
* ``Word`` holds (base symbol, time-derivative order, component ids,
  spatial-derivative ids); symmetric rank-2 variables keep c_ids sorted,
  sd_ids are always sorted (mixed partials commute).
"""

from __future__ import annotations

import itertools
from typing import Iterable, Sequence, Tuple, Union

IndexSym = Union[int, str]

_gensym_counter = itertools.count()


def gensym(prefix: str = "g") -> str:
    """A fresh index symbol that cannot collide with user symbols.
    Zero-padded so lexicographic order equals creation order (sd_ids are
    kept sorted, and derivative-tensor index bookkeeping relies on the
    creation order surviving that sort)."""
    return f"#{prefix}{next(_gensym_counter):09d}"


def _id_sort_key(x: IndexSym):
    # concrete ints sort before symbols (matches Base.isless(::Integer,::Symbol))
    return (0, x, "") if isinstance(x, int) else (1, 0, x)


class Word:
    """A single indexed variable occurrence, e.g. ``u[i].d(j)`` = u_{i,j}."""

    __slots__ = ("base", "td", "c_ids", "sd_ids", "symmetric", "_hash")

    def __init__(self, base: str, td: int = 0,
                 c_ids: Sequence[IndexSym] = (),
                 sd_ids: Sequence[IndexSym] = (),
                 symmetric: bool = False):
        c_ids = tuple(c_ids)
        if symmetric and len(c_ids) == 2:
            c_ids = tuple(sorted(c_ids, key=_id_sort_key))
        object.__setattr__ if False else None
        self.base = base
        self.td = int(td)
        self.c_ids = c_ids
        self.sd_ids = tuple(sorted(sd_ids, key=_id_sort_key))
        self.symmetric = bool(symmetric)
        self._hash = hash((base, self.td, self.c_ids, self.sd_ids))

    def replace(self, **kw) -> "Word":
        d = dict(base=self.base, td=self.td, c_ids=self.c_ids,
                 sd_ids=self.sd_ids, symmetric=self.symmetric)
        d.update(kw)
        return Word(**d)

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, Word) and self.base == other.base
                and self.td == other.td and self.c_ids == other.c_ids
                and self.sd_ids == other.sd_ids)

    def __repr__(self):
        s = self.base
        if self.c_ids:
            s += "{" + ",".join(map(str, self.c_ids)) + "}"
        if self.td:
            s += ",t" * self.td
        if self.sd_ids:
            s += ";" + ",".join(map(str, self.sd_ids))
        return s


class Term:
    """An operation node; ``op`` in {'+', '*', '^', 'Bilinear', 'var_delta',
    'd', or a function name like 'log'/'ifelse'/user functions}."""

    __slots__ = ("op", "subterms", "free", "dumb", "_hash")

    def __init__(self, op: str, subterms: Sequence, free: Sequence[str],
                 dumb: Sequence[str]):
        self.op = op
        self.subterms = tuple(subterms)
        self.free = tuple(free)
        self.dumb = tuple(dumb)
        self._hash = hash((op, self.subterms))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, Term) and self.op == other.op
                and self.subterms == other.subterms)

    def __repr__(self):
        from .visualize import visualize
        return visualize(self)


GroundTerm = Union[float, Word, Term]


# ---------------------------------------------------------------------------
# index bookkeeping
# ---------------------------------------------------------------------------

def parse_word_index(w: Word) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """Free/dumb index split of a single word (symbolics/03_Word.jl:15-32)."""
    free, dumb = [], []
    for a in (*w.c_ids, *w.sd_ids):
        if isinstance(a, int):
            continue
        if a in dumb:
            raise ValueError(f"index {a!r} appears 3 times in {w!r}")
        if a in free:
            free.remove(a)
            dumb.append(a)
        else:
            free.append(a)
    return tuple(free), tuple(dumb)


def free_index(t: GroundTerm) -> Tuple[str, ...]:
    if isinstance(t, Term):
        return t.free
    if isinstance(t, Word):
        return parse_word_index(t)[0]
    return ()


def dumb_index(t: GroundTerm) -> Tuple[str, ...]:
    if isinstance(t, Term):
        return t.dumb
    if isinstance(t, Word):
        return parse_word_index(t)[1]
    return ()


def _sort_key(t: GroundTerm):
    """Deterministic canonical ordering; numbers always first so the
    like-term merger can rely on a leading numeric coefficient."""
    if isinstance(t, (int, float)):
        return (0, "", float(t))
    if isinstance(t, Word):
        return (1, f"{t.base}|{t.td}|{t.c_ids}|{t.sd_ids}", 0.0)
    return (2, f"{t.op}|" + "|".join(str(_sort_key(s)) for s in t.subterms), 0.0)


# ---------------------------------------------------------------------------
# smart constructors (constant folding + index checks)
# ---------------------------------------------------------------------------

def construct_term(op: str, subterms: Sequence[GroundTerm]) -> GroundTerm:
    """Build an op node with the constant folding / index rules of
    symbolics/04_Term.jl:45-130."""
    subterms = list(subterms)

    if op == "+":
        nums = [s for s in subterms if isinstance(s, (int, float))]
        rest = [s for s in subterms if not isinstance(s, (int, float))]
        num = float(sum(nums)) if nums else 0.0
        if not rest:
            return num
        if num != 0.0:
            rest = [num] + rest
        elif len(rest) == 1:
            return rest[0]
        rest.sort(key=_sort_key)
        fset = sorted(free_index(rest[-1]))  # last one is never a number
        for s in rest:
            if isinstance(s, (int, float)):
                if fset:
                    raise ValueError("number summed with a free-index term")
                continue
            if sorted(free_index(s)) != fset:
                raise ValueError(
                    f"addends must share free indices: {fset} vs "
                    f"{sorted(free_index(s))} in {s!r}")
        return Term("+", rest, tuple(fset), ())

    if op == "*":
        nums = [s for s in subterms if isinstance(s, (int, float))]
        rest = [s for s in subterms if not isinstance(s, (int, float))]
        num = 1.0
        for v in nums:
            num *= float(v)
        if not rest:
            return num
        if num == 0.0:
            return 0.0
        if num == 1.0:
            if len(rest) == 1:
                return rest[0]
            subterms = rest
        else:
            subterms = [num] + rest
        subterms.sort(key=_sort_key)
        # fall through to generic index bookkeeping

    elif op == "^":
        b, e = subterms
        if isinstance(b, (int, float)) and isinstance(e, (int, float)):
            return float(b) ** float(e)
        if isinstance(e, (int, float)):
            if e == 0:
                return 1.0
            if e == 1:
                return b
        if isinstance(b, (int, float)):
            if b == 0:
                return 0.0
            if b == 1:
                return 1.0
        if free_index(b) or free_index(e):
            raise ValueError(f"free index in power base/exponent: {subterms!r}")
        return Term("^", [b, e], (), ())

    elif op == "Bilinear":
        if len(subterms) != 2:
            raise ValueError("Bilinear takes exactly (dual, base)")
        if isinstance(subterms[0], (int, float)):
            return 0.0
        if isinstance(subterms[1], (int, float)) and subterms[1] == 0.0:
            return 0.0
        # fall through

    elif op == "-":
        if len(subterms) == 1:
            return mul([-1.0, subterms[0]])
        if len(subterms) == 2:
            return add([subterms[0], mul([-1.0, subterms[1]])])
        raise ValueError("minus takes 1 or 2 subterms")

    elif op == "/":
        if len(subterms) != 2:
            raise ValueError("division takes 2 subterms")
        return mul([subterms[0], construct_term("^", [subterms[1], -1.0])])

    elif not subterms:
        return Term(op, [], (), ())

    # generic Einstein bookkeeping across subterms ('*', 'Bilinear', calls)
    free: list = list(free_index(subterms[0]))
    dumb: list = []
    for s in subterms[1:]:
        for ix in free_index(s):
            if ix in dumb:
                raise ValueError(f"index {ix!r} appears 3 times")
            if ix in free:
                free.remove(ix)
                dumb.append(ix)
            else:
                free.append(ix)
    total = free + dumb
    # rename inner dumb indices that collide with this level's indices
    out = []
    for s in subterms:
        for ix in total:
            if ix in dumb_index(s):
                s = _substitute(s, ix, gensym())
        out.append(s)
    return Term(op, out, tuple(free), tuple(dumb))


def add(subterms: Iterable[GroundTerm]) -> GroundTerm:
    return construct_term("+", list(subterms))


def mul(subterms: Iterable[GroundTerm]) -> GroundTerm:
    return construct_term("*", list(subterms))


def pow_(b: GroundTerm, e: GroundTerm) -> GroundTerm:
    return construct_term("^", [b, e])


def bilinear_term(dual: GroundTerm, base: GroundTerm) -> GroundTerm:
    return construct_term("Bilinear", [dual, base])


def call(op: str, *args: GroundTerm) -> GroundTerm:
    return construct_term(op, list(args))


def refresh(t: GroundTerm) -> GroundTerm:
    return construct_term(t.op, t.subterms) if isinstance(t, Term) else t


# ---------------------------------------------------------------------------
# index substitution (capture-avoiding)
# ---------------------------------------------------------------------------

def _substitute(t: GroundTerm, src: str, target: IndexSym) -> GroundTerm:
    if isinstance(t, (int, float)):
        return t
    if isinstance(t, Word):
        wfree, wdumb = parse_word_index(t)
        if src in wfree and isinstance(target, str) and target in wdumb:
            t = _substitute(t, target, gensym())
        if src not in (*t.c_ids, *t.sd_ids):
            return t
        c_ids = tuple(target if x == src else x for x in t.c_ids)
        sd_ids = tuple(target if x == src else x for x in t.sd_ids)
        return Word(t.base, t.td, c_ids, sd_ids, t.symmetric)
    # Term
    if src not in t.free and src not in t.dumb:
        return t
    if isinstance(target, str) and target in t.dumb:
        t = _substitute(t, target, gensym())
    subs = [_substitute(s, src, target) for s in t.subterms]
    return construct_term(t.op, subs)


def substitute(t: GroundTerm, srcs: Sequence[IndexSym],
               targets: Sequence[IndexSym]) -> GroundTerm:
    """Parallel index substitution with placeholder staging
    (symbolics/04_Term.jl:210-227)."""
    staged = []
    for s, tgt in zip(srcs, targets):
        if s == tgt:
            continue
        if isinstance(tgt, int):
            t = _substitute(t, s, tgt)
        else:
            ph = gensym()
            t = _substitute(t, s, ph)
            staged.append((ph, tgt))
    for ph, tgt in staged:
        t = _substitute(t, ph, tgt)
    return t


_DEFAULT_INDEX_POOL = ["i", "j", "k", "l", "m", "n", "o", "p", "q", "r", "s"]


def generate_index(n: int):
    if n <= len(_DEFAULT_INDEX_POOL):
        return _DEFAULT_INDEX_POOL[:n]
    return _DEFAULT_INDEX_POOL + [
        f"i{k}" for k in range(n - len(_DEFAULT_INDEX_POOL))]


def reindex(t: GroundTerm, src_ids: Sequence[str]):
    """Rename free indices to the canonical pool i, j, k, ..."""
    targets = generate_index(len(src_ids))
    return targets, substitute(t, list(src_ids), targets)


# ---------------------------------------------------------------------------
# dumb-index unrolling: explicit dim-way sums
# ---------------------------------------------------------------------------

def unroll_dumb_indices(t: GroundTerm, dim: int) -> GroundTerm:
    """Expand every summed index into an explicit sum over 1..dim
    (symbolics/04_Term.jl:239-261).  After unrolling (and index
    instantiation of any remaining free indices) all ids are concrete."""
    if isinstance(t, (int, float)):
        return t
    if isinstance(t, Word):
        dumb = parse_word_index(t)[1]
        if not dumb:
            return t
        out = []
        for combo in itertools.product(range(1, dim + 1), repeat=len(dumb)):
            out.append(substitute(t, list(dumb), list(combo)))
        return add(out)
    # Term: unroll children first, then this level's dumb indices
    subs = [unroll_dumb_indices(s, dim) for s in t.subterms]
    t2 = construct_term(t.op, subs)
    if not isinstance(t2, Term) or not t2.dumb:
        return t2
    dumb = t2.dumb
    out = []
    for combo in itertools.product(range(1, dim + 1), repeat=len(dumb)):
        out.append(substitute(t2, list(dumb), list(combo)))
    return add(out)


# ---------------------------------------------------------------------------
# Voigt symmetric-tensor component maps (symbolics/03_Word.jl:34-55)
# ---------------------------------------------------------------------------

_VOIGT_2D = ((1, 3), (3, 2))
_VOIGT_3D = ((1, 6, 5), (6, 2, 4), (5, 4, 3))
_INV_VOIGT_2D = ((1, 1), (2, 2), (1, 2))
_INV_VOIGT_3D = ((1, 1), (2, 2), (3, 3), (2, 3), (1, 3), (1, 2))


def voigt_id(i: int, j: int, dim: int) -> int:
    if dim == 2:
        return _VOIGT_2D[i - 1][j - 1]
    if dim == 3:
        return _VOIGT_3D[i - 1][j - 1]
    raise ValueError("Voigt symmetry defined for dim 2 and 3 only")


def inverse_voigt_id(v: int, dim: int) -> Tuple[int, int]:
    if dim == 2:
        return _INV_VOIGT_2D[v - 1]
    if dim == 3:
        return _INV_VOIGT_3D[v - 1]
    raise ValueError("Voigt symmetry defined for dim 2 and 3 only")


def voigt_size(dim: int) -> int:
    return 3 if dim == 2 else 6
