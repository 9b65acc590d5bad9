"""Sparse multivariate polynomial algebra (host-side, trace time only).

Equivalent in capability to the reference's ``Polynomial{dim}``
(misc/03_Polynomial.jl): +, -, *, ^, variable substitution, analytic
derivatives and point evaluation.  Used exclusively to build element shape
functions and their reference-space derivative tables, which are then baked
into dense numpy arrays — nothing symbolic survives to device code.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

Orders = Tuple[int, ...]


class Polynomial:
    __slots__ = ("dim", "terms")

    def __init__(self, dim: int, terms: Dict[Orders, float] | None = None):
        self.dim = dim
        self.terms: Dict[Orders, float] = {}
        if terms:
            for o, c in terms.items():
                if c != 0.0:
                    self.terms[tuple(o)] = self.terms.get(tuple(o), 0.0) + c

    # -- constructors -------------------------------------------------------
    @classmethod
    def constant(cls, dim: int, c: float) -> "Polynomial":
        return cls(dim, {tuple([0] * dim): float(c)})

    @classmethod
    def variable(cls, dim: int, axis: int, coeff: float = 1.0) -> "Polynomial":
        """coeff * x_axis (axis is 0-based)."""
        o = [0] * dim
        o[axis] = 1
        return cls(dim, {tuple(o): float(coeff)})

    # -- algebra -------------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, (int, float)):
            other = Polynomial.constant(self.dim, other)
        out = dict(self.terms)
        for o, c in other.terms.items():
            out[o] = out.get(o, 0.0) + c
        return Polynomial(self.dim, out)

    __radd__ = __add__

    def __neg__(self):
        return Polynomial(self.dim, {o: -c for o, c in self.terms.items()})

    def __sub__(self, other):
        if isinstance(other, (int, float)):
            other = Polynomial.constant(self.dim, other)
        return self + (-other)

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return Polynomial(self.dim,
                              {o: c * other for o, c in self.terms.items()})
        out: Dict[Orders, float] = {}
        for o1, c1 in self.terms.items():
            for o2, c2 in other.terms.items():
                o = tuple(a + b for a, b in zip(o1, o2))
                out[o] = out.get(o, 0.0) + c1 * c2
        return Polynomial(self.dim, out)

    __rmul__ = __mul__

    def __truediv__(self, v: float):
        return self * (1.0 / v)

    def __pow__(self, n: int):
        out = Polynomial.constant(self.dim, 1.0)
        for _ in range(int(n)):
            out = out * self
        return out

    # -- calculus ------------------------------------------------------------
    def derivative(self, orders: Sequence[int]) -> "Polynomial":
        """Mixed partial: d^{orders[0]}/dx0^... etc."""
        out: Dict[Orders, float] = {}
        for o, c in self.terms.items():
            oo = list(o)
            coeff = c
            ok = True
            for axis, k in enumerate(orders):
                for _ in range(k):
                    if oo[axis] == 0:
                        ok = False
                        break
                    coeff *= oo[axis]
                    oo[axis] -= 1
                if not ok:
                    break
            if ok and coeff != 0.0:
                t = tuple(oo)
                out[t] = out.get(t, 0.0) + coeff
        return Polynomial(self.dim, out)

    def substitute(self, axis: int, repl: "Polynomial") -> "Polynomial":
        """Replace variable ``axis`` by the polynomial ``repl`` (same or
        different dim — output dim follows ``repl``)."""
        out = Polynomial.constant(repl.dim, 0.0)
        for o, c in self.terms.items():
            term = Polynomial.constant(repl.dim, c)
            for ax, k in enumerate(o):
                if ax == axis:
                    term = term * (repl ** k)
                else:
                    # variable must map identically (only valid if dims align)
                    term = term * (Polynomial.variable(repl.dim, ax) ** k)
            out = out + term
        return out

    def evaluate(self, pos: Sequence[float]) -> float:
        total = 0.0
        for o, c in self.terms.items():
            v = c
            for ax, k in enumerate(o):
                v *= pos[ax] ** k
            total += v
        return total

    def __repr__(self):
        if not self.terms:
            return "0"
        parts = []
        for o, c in sorted(self.terms.items()):
            mono = "".join(f"x{ax}^{k}" for ax, k in enumerate(o) if k)
            parts.append(f"{c:g}{mono}")
        return " + ".join(parts)
