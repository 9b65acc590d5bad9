"""Structured lattice mesh builders: make_square / make_brick.

Same capability as the reference's 201_Helper_TM.jl: quad/hex lattices, or
simplex splits (2 triangles per quad; 5 tets per hex with odd/even parity
flip so neighboring hexes' diagonals match).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np


def make_square(size: Tuple[float, float], n: Tuple[int, int],
                shape: str = "CUBE"):
    """Returns (vert[nv, 2], connections[ne, per_el]) 0-based."""
    nx, ny = n
    dx = (size[0] / nx, size[1] / ny)
    xs = np.arange(nx + 1) * dx[0]
    ys = np.arange(ny + 1) * dx[1]
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vert = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    quads = []
    for i in range(nx):
        for j in range(ny):
            quads.append([vid(i, j), vid(i + 1, j),
                          vid(i + 1, j + 1), vid(i, j + 1)])
    quads = np.asarray(quads, dtype=np.int64)
    if shape == "CUBE":
        return vert, quads
    if shape == "SIMPLEX":
        # split each quad into (v0, v1, v3) and (v2, v3, v1)
        t1 = quads[:, [0, 1, 3]]
        t2 = quads[:, [2, 3, 1]]
        return vert, np.vstack([t1, t2])
    raise ValueError(f"unknown shape {shape!r}")


def make_brick(size: Tuple[float, float, float], n: Tuple[int, int, int],
               shape: str = "CUBE"):
    nx, ny, nz = n
    dx = tuple(size[d] / n[d] for d in range(3))
    axes = [np.arange(n[d] + 1) * dx[d] for d in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    vert = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    hexes = []
    parity = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                hexes.append([
                    vid(i, j, k), vid(i + 1, j, k),
                    vid(i + 1, j + 1, k), vid(i, j + 1, k),
                    vid(i, j, k + 1), vid(i + 1, j, k + 1),
                    vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1)])
                parity.append((i + j + k) % 2)
    hexes = np.asarray(hexes, dtype=np.int64)
    parity = np.asarray(parity, dtype=bool)
    if shape == "CUBE":
        return vert, hexes
    if shape == "SIMPLEX":
        # 5-tet split; the corner-tet diagonal choice alternates with
        # lattice parity so faces of adjacent hexes are compatible
        fwd = [(0, 1, 3, 4), (2, 3, 1, 6), (7, 6, 4, 3), (5, 4, 6, 1),
               (3, 6, 4, 1)]
        bwd = [(4, 7, 5, 0), (1, 0, 5, 2), (6, 5, 7, 2), (3, 0, 2, 7),
               (0, 2, 7, 5)]
        tets = []
        for e in range(len(hexes)):
            pattern = fwd if parity[e] else bwd
            for tet in pattern:
                tets.append(hexes[e][list(tet)])
        return vert, np.asarray(tets, dtype=np.int64)
    raise ValueError(f"unknown shape {shape!r}")


def select_facets(mesh, predicate) -> np.ndarray:
    """Boundary facet ids whose center satisfies ``predicate(x)`` where x is
    [n, dim]; convenience for boundary-group selection in scripts."""
    bids = mesh.boundary_facet_ids()
    centers = mesh.facet_centers()[bids]
    mask = predicate(centers)
    return bids[np.asarray(mask, dtype=bool)]


def refine_simplex(vert: np.ndarray, conn: np.ndarray):
    """One level of uniform simplex refinement: every triangle splits
    into 4, every tet into 8 (corner cut + Bey's 4-tet octahedron split
    along the e02-e13 diagonal — shape quality stays bounded under
    repeated refinement).  New vertices are shared edge midpoints.

    The reference has no refinement helper; this exists to scale its
    fixed example meshes (e.g. the pikachu tet mesh,
    examples/thermal_conduction/3D_COMSOL_Mesh.mphtxt) to the multi-
    million-DOF sizes the TPU solvers target.

    Returns (vert, conn) with the original vertices first."""
    vert = np.asarray(vert, dtype=np.float64)
    conn = np.asarray(conn, dtype=np.int64)
    n_corner = conn.shape[1]
    if n_corner == 3:                                    # triangles
        edge_list = [(0, 1), (0, 2), (1, 2)]
    elif n_corner == 4 and vert.shape[1] == 3:           # tets
        edge_list = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    else:
        raise ValueError("refine_simplex supports 2D triangles and 3D "
                         "tets (got %d corners in %dD)"
                         % (n_corner, vert.shape[1]))
    eps = np.stack([conn[:, list(e)] for e in edge_list], 1)
    eps_s = np.sort(eps.reshape(-1, 2), axis=1)
    uniq, inv = np.unique(eps_s, axis=0, return_inverse=True)
    mid = 0.5 * (vert[uniq[:, 0]] + vert[uniq[:, 1]])
    m = inv.reshape(len(conn), len(edge_list)) + len(vert)
    v = np.concatenate([vert, mid])
    if n_corner == 3:
        a, b, c = conn.T
        e01, e02, e12 = m.T
        new = np.stack([
            np.stack([a, e01, e02], 1), np.stack([e01, b, e12], 1),
            np.stack([e02, e12, c], 1), np.stack([e01, e12, e02], 1),
        ], 1).reshape(-1, 3)
    else:
        a, b, c, d = conn.T
        e01, e02, e03, e12, e13, e23 = m.T
        new = np.stack([
            np.stack([a, e01, e02, e03], 1),
            np.stack([e01, b, e12, e13], 1),
            np.stack([e02, e12, c, e23], 1),
            np.stack([e03, e13, e23, d], 1),
            np.stack([e01, e02, e03, e13], 1),
            np.stack([e01, e02, e13, e12], 1),
            np.stack([e02, e03, e13, e23], 1),
            np.stack([e02, e12, e23, e13], 1),
        ], 1).reshape(-1, 4)
    return v, new
