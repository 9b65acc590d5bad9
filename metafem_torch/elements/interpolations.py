"""Shape-function construction on the unit reference elements.

Families (same coverage as the reference's 102_Interpolations.jl):
* tensor-product Lagrange on [0,1]^dim, arbitrary order,
* barycentric Lagrange on the unit simplex, arbitrary order,
* serendipity on [0,1]^dim, orders 2-3 (vertex + edge nodes only).

Node ordering conventions match structures.py (lexicographic, x fastest).
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np

from .polynomial import Polynomial


def lagrange_1d(order: int) -> List[Polynomial]:
    """1D Lagrange basis on nodes i/order, i = 0..order (dim-1 polys)."""
    nodes = [i / order for i in range(order + 1)]
    funcs = []
    for i, xi in enumerate(nodes):
        p = Polynomial.constant(1, 1.0)
        for j, xj in enumerate(nodes):
            if j == i:
                continue
            p = p * Polynomial(1, {(1,): 1.0 / (xi - xj),
                                   (0,): -xj / (xi - xj)})
        funcs.append(p)
    return funcs


def _embed_1d(p1d: Polynomial, dim: int, axis: int) -> Polynomial:
    """Lift a 1D polynomial to dim variables acting on x_axis."""
    out = Polynomial.constant(dim, 0.0)
    for (k,), c in p1d.terms.items():
        out = out + Polynomial.variable(dim, axis) ** k * c
    return out


def cube_lagrange(order: int, dim: int) -> List[Polynomial]:
    """Product basis; node id lexicographic with x fastest."""
    f1 = lagrange_1d(order)
    per_axis = [[_embed_1d(f, dim, ax) for f in f1] for ax in range(dim)]
    out = []
    for combo in _lex_product(order + 1, dim):
        p = Polynomial.constant(dim, 1.0)
        for ax in range(dim):
            p = p * per_axis[ax][combo[ax]]
        out.append(p)
    return out


def _lex_product(n: int, dim: int):
    """All dim-tuples over range(n) with the FIRST axis varying fastest."""
    for combo in itertools.product(range(n), repeat=dim):
        yield tuple(reversed(combo))


def simplex_lagrange(order: int, dim: int) -> List[Polynomial]:
    """Barycentric Lagrange on the unit simplex.  phi for node with
    barycentric multi-index (a_0..a_dim), sum a = order, is
    prod_i prod_{m=0}^{a_i-1} (order * t_i - m) / (a_i - m) where t_i are
    the barycentric coordinates.  Node id: lexicographic in (i, j, ...)
    over x fastest with sum <= order (same as the reference numbering)."""
    # barycentric coordinate polynomials t_1..t_dim = x_i, t_0 = 1 - sum x
    tcoords = [Polynomial.variable(dim, ax) for ax in range(dim)]
    t_last = Polynomial.constant(dim, 1.0)
    for ax in range(dim):
        t_last = t_last - Polynomial.variable(dim, ax)

    def ramp(t: Polynomial, a: int) -> Polynomial:
        p = Polynomial.constant(dim, 1.0)
        for m in range(a):
            p = p * (t * order - m) / (a - m)
        return p

    out = []
    for combo in _lex_product(order + 1, dim):
        a_last = order - sum(combo)
        if a_last < 0:
            continue
        p = ramp(t_last, a_last)
        for ax in range(dim):
            p = p * ramp(tcoords[ax], combo[ax])
        out.append(p)
    return out


def cube_serendipity(order: int, dim: int) -> List[Polynomial]:
    """Serendipity basis, orders 2-3: one function per vertex plus
    (order-1) per edge.  Vertex ordering: lexicographic over corners
    (x fastest); edge ordering: by edge direction axis, then minor corner
    coords lexicographic (matches structures.serendipity_*)."""
    xs = [Polynomial.variable(dim, ax) for ax in range(dim)]
    out: List[Polynomial] = []

    for corner in _lex_product(2, dim):
        # product of opposite-face hat functions
        p = Polynomial.constant(dim, 1.0)
        for ax in range(dim):
            p = p * ((1.0 - corner[ax]) - xs[ax])
        if order == 2:
            s = [1.0 - 2.0 * c for c in corner]
            plane = Polynomial.constant(
                dim, float(np.dot(s, corner)) + 1.0 / order)
            for ax in range(dim):
                plane = plane - xs[ax] * s[ax]
            p = p * plane
        elif order == 3:
            rad = Polynomial.constant(
                dim, -((1.0 / 6.0) ** 2 + (dim - 1) * 0.25))
            for ax in range(dim):
                sq = (xs[ax] - 0.5)
                rad = rad + sq * sq
            p = p * rad
        else:
            raise ValueError("serendipity supported for order 2 and 3")
        p = p / p.evaluate(corner)
        out.append(p)

    for edge_ax in range(dim):
        minor = [ax for ax in range(dim) if ax != edge_ax]
        for mcorner in _lex_product(2, dim - 1):
            base = Polynomial.constant(dim, 1.0)
            for k, ax in enumerate(minor):
                base = base * ((1.0 - mcorner[k]) - xs[ax])
            for node in range(1, order):
                p = base
                for i in range(order + 1):
                    if i == node:
                        continue
                    p = p * (xs[edge_ax] - i / order)
                coords = [node / order] * dim
                for k, ax in enumerate(minor):
                    coords[ax] = float(mcorner[k])
                p = p / p.evaluate(coords)
                out.append(p)
    return out


def evaluate_itp_funcs(itp_funcs: List[Polynomial], max_sd_order: int,
                       itg_pos: np.ndarray) -> np.ndarray:
    """Dense table ref_itp_vals[nq, n_itp, (max_sd+1)^dim as multi-axis],
    axis d index = derivative order along dim d (0 = value).  Mirrors
    evaluate_Itp_Funcs (01_Classical_DIscretization.jl:83-98)."""
    dim = itp_funcs[0].dim
    nq = len(itg_pos)
    na = len(itp_funcs)
    shape = (nq, na) + (max_sd_order + 1,) * dim
    vals = np.zeros(shape)
    for orders in itertools.product(range(max_sd_order + 1), repeat=dim):
        for a, f in enumerate(itp_funcs):
            g = f.derivative(orders)
            for q in range(nq):
                vals[(q, a) + orders] = g.evaluate(itg_pos[q])
    return vals
