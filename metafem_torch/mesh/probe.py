"""Point probing: evaluate a controlpoint field at arbitrary physical
points (the capability behind the reference's paraview line sampling used
for its COMSOL comparisons, examples/thermal_conduction/3D_Script.jl:66-96).

Element location is host-side numpy (one-time): for SIMPLEX meshes the
physical->reference map is affine and solved directly; for CUBE meshes the
(bi/tri-)linear map is inverted by a few Newton steps per point.  Field
evaluation then uses the element type's interpolation polynomials at the
located reference coordinates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..elements.structures import ElementType
from .fem_mesh import WPMesh
from .ref_geometry import GeoMesh


def locate_points(geo: GeoMesh, pts: np.ndarray,
                  tol: float = 1e-8) -> Tuple[np.ndarray, np.ndarray]:
    """(element id, reference coords) per point; element id -1 if outside."""
    pts = np.asarray(pts, dtype=float)
    n_pts = len(pts)
    el_of = np.full(n_pts, -1, dtype=np.int64)
    ref = np.zeros((n_pts, geo.dim))
    corners = geo.vert[geo.connections]        # [E, nv, dim]

    if geo.shape == "SIMPLEX":
        v0 = corners[:, 0, :]                   # [E, dim]
        A = np.stack([corners[:, k + 1, :] - v0
                      for k in range(geo.dim)], axis=-1)  # [E, dim, dim]
        Ainv = np.linalg.inv(A)                 # [E, dim, dim]
        # chunk over points to bound memory
        for s in range(0, n_pts, 256):
            p = pts[s:s + 256]                  # [P, dim]
            lam = np.einsum("eij,epj->epi", Ainv,
                            p[None, :, :] - v0[:, None, :])  # [E, P, dim]
            ok = (lam >= -tol).all(axis=2) & (lam.sum(axis=2) <= 1 + tol)
            e_hit, p_hit = np.nonzero(ok)
            # first hit per point wins
            seen = {}
            for e, pp in zip(e_hit, p_hit):
                if pp not in seen:
                    seen[pp] = e
            for pp, e in seen.items():
                el_of[s + pp] = e
                ref[s + pp] = lam[e, pp]
        return el_of, ref

    # CUBE: bounding-box candidates + Newton inversion of the linear map
    lo = corners.min(axis=1)                    # [E, dim]
    hi = corners.max(axis=1)
    for ip, p in enumerate(pts):
        cand = np.nonzero(((p >= lo - tol) & (p <= hi + tol)).all(axis=1))[0]
        for e in cand:
            xi = np.full(geo.dim, 0.5)
            c = corners[e]                      # [nv, dim]
            ok = True
            for _ in range(30):
                w, dw = _cube_weights(xi, geo.dim)
                r = w @ c - p
                J = np.einsum("vd,vk->dk", c, dw)
                try:
                    xi = xi - np.linalg.solve(J, r)
                except np.linalg.LinAlgError:
                    ok = False
                    break
                if not np.isfinite(xi).all() or np.abs(xi).max() > 10:
                    ok = False  # diverged: p not in this candidate
                    break
            if not ok:
                continue
            if (xi >= -tol).all() and (xi <= 1 + tol).all():
                w, _ = _cube_weights(np.clip(xi, 0, 1), geo.dim)
                if np.abs(w @ c - p).max() < 1e-6 * max(1.0,
                                                        np.abs(p).max()):
                    el_of[ip] = e
                    ref[ip] = np.clip(xi, 0.0, 1.0)
                    break
    return el_of, ref


def _cube_weights(xi, dim):
    """P1 tensor weights + derivatives for the corner ordering of
    QUAD_VERTS/HEX_VERTS."""
    from ..elements.structures import HEX_VERTS, QUAD_VERTS
    verts = QUAD_VERTS if dim == 2 else HEX_VERTS
    n = len(verts)
    w = np.ones(n)
    dw = np.zeros((n, dim))
    for v in range(n):
        facs = [(1 - verts[v, d]) * (1 - xi[d]) + verts[v, d] * xi[d]
                for d in range(dim)]
        w[v] = np.prod(facs)
        for d in range(dim):
            dfd = 2 * verts[v, d] - 1
            dw[v, d] = dfd * np.prod([facs[k] for k in range(dim)
                                      if k != d])
    return w, dw


def probe_field(geo: GeoMesh, mesh: WPMesh, et: ElementType,
                field: str, pts: np.ndarray) -> np.ndarray:
    """Field values at physical points (NaN outside the mesh)."""
    el_of, ref = locate_points(geo, np.asarray(pts, dtype=float))
    vals = np.full(len(pts), np.nan)
    col = mesh.fields[field]
    for ip, (e, xi) in enumerate(zip(el_of, ref)):
        if e < 0:
            continue
        phis = np.array([f.evaluate(xi) for f in et.itp_funcs])
        vals[ip] = phis @ col[mesh.el_cp[e]]
    return vals


def probe_gradient(geo: GeoMesh, mesh: WPMesh, et: ElementType,
                   field: str, pts: np.ndarray) -> np.ndarray:
    """Physical gradients [n_pts, dim] of a field at arbitrary points
    (NaN outside): shape-function reference gradients pushed through the
    inverse geometry jacobian of the (straight-sided) element."""
    pts = np.asarray(pts, dtype=float)
    el_of, ref = locate_points(geo, pts)
    dim = geo.dim
    grads = np.full((len(pts), dim), np.nan)
    col = mesh.fields[field]
    corners = geo.vert[geo.connections]
    unit = [tuple(1 if k == d else 0 for k in range(dim))
            for d in range(dim)]
    for ip, (e, xi) in enumerate(zip(el_of, ref)):
        if e < 0:
            continue
        dphi = np.array([[f.derivative(unit[d]).evaluate(xi)
                          for d in range(dim)] for f in et.itp_funcs])
        if geo.shape == "SIMPLEX":
            v0 = corners[e, 0]
            J = np.stack([corners[e, k + 1] - v0 for k in range(dim)],
                         axis=-1)                       # dx/dxi [d, k]
        else:
            _, dw = _cube_weights(xi, dim)
            J = np.einsum("vd,vk->dk", corners[e], dw)
        vals = col[mesh.el_cp[e]]
        grads[ip] = np.linalg.solve(J.T, dphi.T @ vals)
    return grads
