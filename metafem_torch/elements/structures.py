"""Element type definitions: node placement + local topology.

Covers the reference's element menu (101_Structures.jl): Lagrange on
quad/hex (arbitrary order), Lagrange on triangle/tet (arbitrary order),
Serendipity on quad/hex (orders 2-3).

Design difference vs the reference: the reference stores per-entity cp-id
tables with explicit orientation-alignment data
(segment_start_vertex/face_start_segments) because it generates shared
control points entity-by-entity on the GPU; here shared control points are
deduplicated by quantized physical position on the host (lexsort + unique),
which handles every order and orientation uniformly, so the element type
only needs reference node positions and local face loops.

Conventions (0-based):
* quad vertices   (0,0),(1,0),(1,1),(0,1); faces 1-4: bottom(y=0),
  right(x=1), top(y=1), left(x=0) — aligned with quadrature.cube_boundary
* hex vertices    bottom quad then top quad (z=1); faces: z=0, y=0, x=1,
  y=1, x=0, z=1
* triangle vertices (0,0),(1,0),(0,1); faces: v01, v12, v20
* tet vertices    (0,0,0),(1,0,0),(0,1,0),(0,0,1); faces: z=0 (012),
  y=0 (013), slant (123), x=0 (023)
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Tuple

import numpy as np

from .interpolations import (cube_lagrange, cube_serendipity, _lex_product,
                             simplex_lagrange)
from .polynomial import Polynomial

QUAD_VERTS = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=float)
HEX_VERTS = np.vstack([np.hstack([QUAD_VERTS, np.zeros((4, 1))]),
                       np.hstack([QUAD_VERTS, np.ones((4, 1))])])
TRI_VERTS = np.array([[0, 0], [1, 0], [0, 1]], dtype=float)
TET_VERTS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     dtype=float)

QUAD_FACES = ((0, 1), (1, 2), (2, 3), (3, 0))
TRI_FACES = ((0, 1), (1, 2), (2, 0))
HEX_FACES = ((0, 1, 2, 3), (0, 1, 5, 4), (1, 2, 6, 5),
             (3, 2, 6, 7), (0, 3, 7, 4), (4, 5, 6, 7))
TET_FACES = ((0, 1, 2), (0, 1, 3), (1, 2, 3), (0, 2, 3))

# local segments (for 3D edge bookkeeping / VTK quadratic orderings)
HEX_SEGS = ((0, 1), (1, 2), (3, 2), (0, 3),
            (0, 4), (1, 5), (2, 6), (3, 7),
            (4, 5), (5, 6), (7, 6), (4, 7))
TET_SEGS = ((0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3))


@dataclasses.dataclass
class ElementType:
    dim: int
    shape: str            # 'CUBE' | 'SIMPLEX'
    itp_type: str         # 'Lagrange' | 'Serendipity'
    order: int
    node_pos: np.ndarray  # [n_cp, dim] reference coords (itp-func aligned)
    itp_funcs: List[Polynomial]
    vertices: np.ndarray  # [n_vert, dim] corner reference coords
    local_faces: Tuple[Tuple[int, ...], ...]

    @property
    def n_cp(self) -> int:
        return len(self.itp_funcs)

    @property
    def n_vert(self) -> int:
        return len(self.vertices)

    def corner_weights(self) -> np.ndarray:
        """P1 geometric weights w[n_cp, n_vert]: physical cp position =
        w @ corner coordinates (elements are straight-sided)."""
        n = self.node_pos.shape[0]
        w = np.zeros((n, self.n_vert))
        if self.shape == "CUBE":
            for v, vc in enumerate(self.vertices):
                prod = np.ones(n)
                for d in range(self.dim):
                    x = self.node_pos[:, d]
                    prod = prod * ((1 - vc[d]) * (1 - x) + vc[d] * x)
                w[:, v] = prod
        else:  # SIMPLEX: barycentric
            w[:, 0] = 1.0 - self.node_pos.sum(axis=1)
            for d in range(self.dim):
                w[:, d + 1] = self.node_pos[:, d]
        return w


def _cube_lagrange_nodes(order: int, dim: int) -> np.ndarray:
    return np.array([[c / order for c in combo]
                     for combo in _lex_product(order + 1, dim)])


def _simplex_lagrange_nodes(order: int, dim: int) -> np.ndarray:
    out = []
    for combo in _lex_product(order + 1, dim):
        if sum(combo) <= order:
            out.append([c / order for c in combo])
    return np.array(out)


def _serendipity_nodes(order: int, dim: int) -> np.ndarray:
    out = [[float(c) for c in corner] for corner in _lex_product(2, dim)]
    for edge_ax in range(dim):
        minor = [ax for ax in range(dim) if ax != edge_ax]
        for mcorner in _lex_product(2, dim - 1):
            for node in range(1, order):
                p = [0.0] * dim
                p[edge_ax] = node / order
                for k, ax in enumerate(minor):
                    p[ax] = float(mcorner[k])
                out.append(p)
    return np.array(out)


def make_element_type(dim: int, shape: str, itp_order: int,
                      itp_type: str = "Lagrange") -> ElementType:
    if shape == "CUBE":
        verts = QUAD_VERTS if dim == 2 else HEX_VERTS
        faces = QUAD_FACES if dim == 2 else HEX_FACES
        if itp_type not in ("Lagrange", "Serendipity"):
            raise ValueError(f"unknown itp_type {itp_type!r}")
        if itp_type == "Serendipity" and itp_order >= 2:
            funcs = cube_serendipity(itp_order, dim)
            nodes = _serendipity_nodes(itp_order, dim)
        else:
            funcs = cube_lagrange(itp_order, dim)
            nodes = _cube_lagrange_nodes(itp_order, dim)
            itp_type = "Lagrange"
    elif shape == "SIMPLEX":
        verts = TRI_VERTS if dim == 2 else TET_VERTS
        faces = TRI_FACES if dim == 2 else TET_FACES
        funcs = simplex_lagrange(itp_order, dim)
        nodes = _simplex_lagrange_nodes(itp_order, dim)
        itp_type = "Lagrange"
    else:
        raise ValueError(f"unknown shape {shape!r} (CUBE or SIMPLEX)")
    if dim not in (2, 3):
        raise ValueError("dim must be 2 or 3")
    return ElementType(dim=dim, shape=shape, itp_type=itp_type,
                       order=itp_order, node_pos=nodes, itp_funcs=funcs,
                       vertices=np.asarray(verts, dtype=float),
                       local_faces=faces)
