"""Classical (isoparametric Gauss) spatial discretization.

Bundles, per element type: the shape-function/derivative tables evaluated at
the domain quadrature points (``ref_itp_vals``) and at each local face's
boundary quadrature points (``bdy_ref_itp_vals``), plus weights and
reference tangent frames — the analog of ``Classical_Discretization``
(01_Classical_DIscretization.jl:1-98), as plain numpy constants ready to be
closed over by jitted assembly functions.

Derivative-table layout: the reference keeps a dense (max_sd+1)^dim
multi-axis; here the table is flattened to a mode list ``sd_modes`` of
derivative multi-orders (e.g. 2D order-1: [(0,0),(1,0),(0,1)]) so the
assembly einsums contract only the modes that exist.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import numpy as np

from . import quadrature as quad
from .structures import ElementType, make_element_type


def sd_mode_list(dim: int, max_sd_order: int) -> List[Tuple[int, ...]]:
    """All derivative multi-orders with total order <= max_sd_order,
    ordered by total order then lexicographically; mode 0 is the value."""
    modes = []
    for total in range(max_sd_order + 1):
        for combo in itertools.product(range(total + 1), repeat=dim):
            if sum(combo) == total:
                modes.append(combo)
    return modes


def sd_ids_to_mode(dim: int, sd_ids: Tuple[int, ...],
                   modes: List[Tuple[int, ...]]) -> int:
    """Map a sorted tuple of 1-based derivative dims, e.g. (1, 1, 3), to the
    flat mode index."""
    counts = [0] * dim
    for d in sd_ids:
        counts[d - 1] += 1
    return modes.index(tuple(counts))


def _eval_table(et: ElementType, modes, itg_pos: np.ndarray) -> np.ndarray:
    """ref_vals[nq, n_cp, n_modes]."""
    nq, na = len(itg_pos), et.n_cp
    vals = np.zeros((nq, na, len(modes)))
    for m, orders in enumerate(modes):
        for a, f in enumerate(et.itp_funcs):
            g = f.derivative(orders)
            for q in range(nq):
                vals[q, a, m] = g.evaluate(itg_pos[q])
    return vals


@dataclasses.dataclass
class ClassicalDiscretization:
    element_type: ElementType
    max_sd_order: int
    itg_order: int
    sd_modes: List[Tuple[int, ...]]
    # domain rule
    itg_pos: np.ndarray          # [nq, dim]
    itg_weight: np.ndarray       # [nq]
    ref_itp_vals: np.ndarray     # [nq, n_cp, n_modes]
    # boundary rules, one per local face
    bdy_itg_pos: List[np.ndarray]        # [nqb, dim] each
    bdy_itg_weights: List[np.ndarray]    # [nqb]
    bdy_tangents: List[np.ndarray]       # [nqb, dim, dim-1]
    bdy_ref_itp_vals: List[np.ndarray]   # [nqb, n_cp, n_modes]

    @property
    def n_itg(self) -> int:
        return len(self.itg_weight)

    @property
    def n_bdy_itg(self) -> int:
        return len(self.bdy_itg_weights[0])

    @property
    def n_faces(self) -> int:
        return len(self.bdy_itg_weights)


def initialize_classical_element(dim: int, shape: str, itp_order: int,
                                 max_sd_order: int, itg_order: int,
                                 itp_type: str = "Lagrange",
                                 ) -> ClassicalDiscretization:
    et = make_element_type(dim, shape, itp_order, itp_type)
    modes = sd_mode_list(dim, max_sd_order)
    if shape == "CUBE":
        itg_pos, itg_w = quad.cube_domain(itg_order, dim)
        faces = quad.cube_boundary(itg_order, dim)
    else:
        if dim == 2:
            itg_pos, itg_w = quad.triangle_domain(itg_order)
            faces = quad.triangle_boundary(itg_order)
        else:
            itg_pos, itg_w = quad.tet_domain(itg_order)
            faces = quad.tet_boundary(itg_order)
    ref_vals = _eval_table(et, modes, itg_pos)
    bpos, bw, btan, bvals = [], [], [], []
    for (pos, w, tan) in faces:
        bpos.append(pos)
        bw.append(w)
        btan.append(tan)
        bvals.append(_eval_table(et, modes, pos))
    return ClassicalDiscretization(
        element_type=et, max_sd_order=max_sd_order, itg_order=itg_order,
        sd_modes=modes, itg_pos=itg_pos, itg_weight=itg_w,
        ref_itp_vals=ref_vals, bdy_itg_pos=bpos, bdy_itg_weights=bw,
        bdy_tangents=btan, bdy_ref_itp_vals=bvals)
