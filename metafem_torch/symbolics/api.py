"""User-facing expression DSL.

The reference's macro syntax ``-k * Bilinear(T{;i}, T{;i}) + Bilinear(T, s)``
becomes plain Python:

    T = domain.internal_var("T")
    s = domain.external_var("s", "CONTROLPOINT_VAR")
    i = mf.index("i")
    wf = -k * mf.Bilinear(T.d(i), T.d(i)) + mf.Bilinear(T, s)

``u[i]`` selects a component, ``.d(i, j)`` appends spatial derivatives,
``.dt()`` bumps the time-derivative order.  Numbers are folded eagerly.
"""

from __future__ import annotations

from typing import Sequence, Union

from .ir import (GroundTerm, Word, add, bilinear_term, call, construct_term,
                 inverse_voigt_id, mul, pow_, voigt_id)
from .registry import VariableRegistry


def index(name: str) -> str:
    return name


def indices(names: str) -> list:
    return names.split()


class Expr:
    """Thin operator-overloading wrapper over a GroundTerm."""

    __slots__ = ("term",)

    def __init__(self, term: GroundTerm):
        if isinstance(term, Expr):
            term = term.term
        self.term = term

    def __add__(self, o):
        return Expr(add([self.term, as_term(o)]))

    __radd__ = __add__

    def __sub__(self, o):
        return Expr(construct_term("-", [self.term, as_term(o)]))

    def __rsub__(self, o):
        return Expr(construct_term("-", [as_term(o), self.term]))

    def __mul__(self, o):
        return Expr(mul([self.term, as_term(o)]))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return Expr(construct_term("/", [self.term, as_term(o)]))

    def __rtruediv__(self, o):
        return Expr(construct_term("/", [as_term(o), self.term]))

    def __pow__(self, o):
        return Expr(pow_(self.term, as_term(o)))

    def __neg__(self):
        return Expr(mul([-1.0, self.term]))

    def __repr__(self):
        from .visualize import visualize
        return f"Expr({visualize(self.term)})"


ExprLike = Union[Expr, "SymRef", float, int, GroundTerm]


def as_term(x: ExprLike) -> GroundTerm:
    if isinstance(x, Expr):
        return x.term
    if isinstance(x, SymRef):
        return x._word()
    if isinstance(x, (int, float)):
        return float(x)
    return x  # already a Word/Term


class SymRef:
    """Handle for a declared variable; builds Words on indexing/derivation."""

    __slots__ = ("name", "registry", "td", "c_ids", "sd_ids")

    def __init__(self, name: str, registry: VariableRegistry,
                 td: int = 0, c_ids=(), sd_ids=()):
        self.name = name
        self.registry = registry
        self.td = td
        self.c_ids = tuple(c_ids)
        self.sd_ids = tuple(sd_ids)

    def _word(self) -> Word:
        return Word(self.name, self.td, self.c_ids, self.sd_ids,
                    symmetric=self.registry.is_symmetric(self.name))

    def __getitem__(self, ids) -> "SymRef":
        if not isinstance(ids, tuple):
            ids = (ids,)
        if self.c_ids:
            raise ValueError(f"{self.name} already has component indices")
        return SymRef(self.name, self.registry, self.td, ids, self.sd_ids)

    def d(self, *ids) -> "SymRef":
        """Spatial derivative(s): u[i].d(j) == u_{i,j}."""
        return SymRef(self.name, self.registry, self.td, self.c_ids,
                      self.sd_ids + tuple(ids))

    def dt(self, order: int = 1) -> "SymRef":
        """Time derivative: T.dt() == Ṫ."""
        return SymRef(self.name, self.registry, self.td + order, self.c_ids,
                      self.sd_ids)

    # arithmetic: delegate through Expr
    def __add__(self, o):
        return Expr(self._word()) + o

    __radd__ = __add__

    def __sub__(self, o):
        return Expr(self._word()) - o

    def __rsub__(self, o):
        return Expr(as_term(o)) - Expr(self._word())

    def __mul__(self, o):
        return Expr(self._word()) * o

    __rmul__ = __mul__

    def __truediv__(self, o):
        return Expr(self._word()) / o

    def __rtruediv__(self, o):
        return Expr(as_term(o)) / Expr(self._word())

    def __pow__(self, o):
        return Expr(self._word()) ** o

    def __neg__(self):
        return -Expr(self._word())

    def __repr__(self):
        return f"SymRef({self._word()!r})"


def Bilinear(dual: ExprLike, base: ExprLike) -> Expr:
    return Expr(bilinear_term(as_term(dual), as_term(base)))


def fn(name: str, *args: ExprLike) -> Expr:
    """A named scalar function applied pointwise (log, exp, user callbacks)."""
    return Expr(call(name, *[as_term(a) for a in args]))


def d(expr: ExprLike, wrt: ExprLike) -> Expr:
    """Named symbolic derivative d(expr, word), e.g. the first
    Piola-Kirchhoff stress P{i,j} = d(W, F{i,j}) — materialized lazily as a
    derivative tensor (the analog of get_TensorDiff!,
    symbolics/08_Tensor.jl:94-118)."""
    wrt_term = as_term(wrt)
    if not isinstance(wrt_term, Word):
        raise ValueError("d(expr, wrt): wrt must be a single indexed "
                         "variable, e.g. F[i, j]")
    return Expr(call("d", as_term(expr), wrt_term))


def log(x: ExprLike) -> Expr:
    return fn("log", x)


def ifelse(cond: ExprLike, a: ExprLike, b: ExprLike) -> Expr:
    return fn("ifelse", cond, a, b)


# ---------------------------------------------------------------------------
# word -> flat scalar symbol (controlpoint column / VTK field names);
# mirrors word_To_Sym (symbolics/03_Word.jl:57-79)
# ---------------------------------------------------------------------------

def word_to_sym(dim: int, base: str, td: int, c_ids: Sequence[int],
                sd_ids: Sequence[int], symmetric: bool = False) -> str:
    name = base
    if len(c_ids) == 1:
        name = f"{name}{c_ids[0]}"
    elif len(c_ids) >= 2:
        if symmetric:
            name = f"{name}{voigt_id(c_ids[0], c_ids[1], dim)}"
        else:
            flat = 1 + sum((c - 1) * dim ** k for k, c in enumerate(c_ids))
            name = f"{name}{flat}"
    if td > 0:
        name = f"{name}_{'t' * td}"
    if sd_ids:
        name = f"{name}_{''.join(str(s) for s in sd_ids)}"
    return name


def word_total_sym(dim: int, w: Word) -> str:
    return word_to_sym(dim, w.base, w.td, w.c_ids, w.sd_ids, w.symmetric)


def word_local_sym(dim: int, w: Word) -> str:
    """Name with time derivative but no spatial derivative (a controlpoint
    column name, e.g. 'T_t', 'd1')."""
    return word_to_sym(dim, w.base, w.td, w.c_ids, (), w.symmetric)


def word_base_sym(dim: int, w: Word) -> str:
    """Base DOF name (no derivatives at all), e.g. 'd1' for d{1;t,x}."""
    return word_to_sym(dim, w.base, 0, w.c_ids, (), w.symmetric)
