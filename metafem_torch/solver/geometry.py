"""Jacobian / physical-derivative-table update (batched tensor code).

Port of ``metafem/solver/geometry.py``; the einsums stay einsums
(``torch.einsum``).

The analog of the reference's metaprogrammed per-element updaters
(mesh/unstructured_mesh/4_Update_Integrator.jl): the jacobian is an einsum of
the reference gradient table with element coordinates, the inverse is the
analytic 2x2/3x3 formula, and physical derivatives of any order are the
multi-index contraction of reference derivatives with inverse-jacobian
factors (gen_Kernel_Itpval, 4_Update_Integrator.jl:125-154 — like the
reference, mapping-curvature terms are neglected for order >= 2, exact for
affine elements).

Every table is built in the dtype and on the device of the coordinates
it is given.
"""

from __future__ import annotations

import itertools
from typing import List, Tuple

import torch
import numpy as np

from ..elements.discretization import ClassicalDiscretization


def _mode_index(modes: List[Tuple[int, ...]], counts: Tuple[int, ...]) -> int:
    return modes.index(counts)


def _dense_ref_table(disc_vals: np.ndarray, modes, dim: int,
                     order: int) -> np.ndarray:
    """Reference derivative table of total order ``order`` as a dense
    [nq, n_itp, dim, ..., dim] (order axes) array; symmetric in the
    derivative axes (partials commute)."""
    nq, na = disc_vals.shape[:2]
    out = np.zeros((nq, na) + (dim,) * order)
    for combo in itertools.product(range(dim), repeat=order):
        counts = [0] * dim
        for c in combo:
            counts[c] += 1
        out[(slice(None), slice(None)) + combo] = \
            disc_vals[:, :, _mode_index(modes, tuple(counts))]
    return out


_AX = "uvwxyzUVWXYZ"


def _physical_itp_vals(ref_vals: np.ndarray, inv_jac: torch.Tensor,
                       modes, dim: int, max_sd_order: int) -> torch.Tensor:
    """itg_vals[E, nq, n_itp, n_modes]: physical-space derivative tables.

    For total order k:  phys[..., i1..ik] =
        ref[..., m1..mk] * invJ[m1,i1] * ... * invJ[mk,ik]
    """
    n_el = inv_jac.shape[0]
    dtype = inv_jac.dtype
    nq, na = ref_vals.shape[:2]
    dev = inv_jac.device
    cols = [torch.as_tensor(ref_vals[:, :, 0], dtype=dtype, device=dev
                            ).expand(n_el, nq, na)]  # mode 0 = value
    for order in range(1, max_sd_order + 1):
        dense_ref = torch.as_tensor(
            _dense_ref_table(ref_vals, modes, dim, order), dtype=dtype,
            device=dev)
        ref_axes = _AX[:order]
        phys_axes = _AX[order:2 * order]
        # 'qaUV...,eqUu,eqVv,...->eqauv...'
        spec = (f"qa{ref_axes.upper()},"
                + ",".join(f"eq{r.upper()}{p}"
                           for r, p in zip(ref_axes, phys_axes))
                + f"->eqa{phys_axes}")
        phys = torch.einsum(spec, dense_ref,
                            *([inv_jac] * order))  # [E,nq,na,dim^order]
        # extract one representative per unordered physical mode
        for counts in [m for m in modes if sum(m) == order]:
            idx = tuple(itertools.chain.from_iterable(
                [d] * c for d, c in enumerate(counts)))
            cols.append(phys[(Ellipsis,) + idx])
    return torch.stack(cols, dim=-1)


def _inverse_and_det(jac: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic 2x2/3x3 inverse + determinant over [..., dim, dim]
    (inv_Jac_2D/3D, 4_Update_Integrator.jl:77-121)."""
    dim = jac.shape[-1]
    if dim == 2:
        a, b = jac[..., 0, 0], jac[..., 0, 1]
        c, d = jac[..., 1, 0], jac[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], -1),
                         torch.stack([-c, a], -1)], -2) / det[..., None, None]
        return inv, det
    if dim == 3:
        det = (jac[..., 0, 0] * (jac[..., 1, 1] * jac[..., 2, 2]
                                 - jac[..., 1, 2] * jac[..., 2, 1])
               - jac[..., 0, 1] * (jac[..., 1, 0] * jac[..., 2, 2]
                                   - jac[..., 1, 2] * jac[..., 2, 0])
               + jac[..., 0, 2] * (jac[..., 1, 0] * jac[..., 2, 1]
                                   - jac[..., 1, 1] * jac[..., 2, 0]))

        def cof(i1, i2, j1, j2):
            return (jac[..., i1, j1] * jac[..., i2, j2]
                    - jac[..., i1, j2] * jac[..., i2, j1])

        inv = torch.stack([
            torch.stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)], -1),
            torch.stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)], -1),
            torch.stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)], -1),
        ], -2) / det[..., None, None]
        return inv, det
    raise ValueError(f"unsupported dim {dim}")


def _jacobian(ref_vals: np.ndarray, modes, dim: int,
              coords_el: torch.Tensor) -> torch.Tensor:
    """J[e, q, i, m] = d x_i / d xi_m  — einsum of the first-derivative
    reference table with element coordinates."""
    grad_cols = []
    for m in range(dim):
        counts = tuple(1 if d == m else 0 for d in range(dim))
        grad_cols.append(ref_vals[:, :, _mode_index(modes, counts)])
    ref_grad = np.stack(grad_cols, axis=-1)            # [nq, na, dim(m)]
    return torch.einsum("qam,ead->eqdm",
                        torch.as_tensor(ref_grad, dtype=coords_el.dtype,
                                        device=coords_el.device),
                        coords_el)


def update_element_geometry(cp_coords: torch.Tensor, el_cp: torch.Tensor,
                            disc: ClassicalDiscretization,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (itg_vals[E, nq, n_itp, n_modes], itg_weights[E, nq])."""
    dim = disc.element_type.dim
    coords_el = cp_coords[el_cp]                        # [E, na, dim]
    jac = _jacobian(disc.ref_itp_vals, disc.sd_modes, dim, coords_el)
    inv_jac, det = _inverse_and_det(jac)
    itg_vals = _physical_itp_vals(disc.ref_itp_vals, inv_jac, disc.sd_modes,
                                  dim, disc.max_sd_order)
    itg_weights = torch.as_tensor(disc.itg_weight, dtype=det.dtype,
                                  device=det.device)[None, :] * det
    return itg_vals, itg_weights


def update_facet_geometry(cp_coords: torch.Tensor, el_cp_f: torch.Tensor,
                          disc: ClassicalDiscretization, eindex: int,
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Facet tables for all facets sharing local face ``eindex``:
    (itg_vals[F, nqb, n_itp, n_modes], weights[F, nqb], normals[F, nqb, dim]).

    The surface measure is the tangent-frame push-forward determinant
    (update_Basic_Tangent/Normal, 4_Update_Integrator.jl:163-227)."""
    dim = disc.element_type.dim
    ref_vals = disc.bdy_ref_itp_vals[eindex]
    coords_el = cp_coords[el_cp_f]                      # [F, na, dim]
    jac = _jacobian(ref_vals, disc.sd_modes, dim, coords_el)
    inv_jac, _ = _inverse_and_det(jac)
    itg_vals = _physical_itp_vals(ref_vals, inv_jac, disc.sd_modes,
                                  dim, disc.max_sd_order)
    # push reference tangents [nqb, dim, dim-1] to physical space
    ref_tan = torch.as_tensor(disc.bdy_tangents[eindex], dtype=jac.dtype,
                              device=jac.device)
    tan = torch.einsum("fqdm,qmr->fqdr", jac, ref_tan)  # [F,nqb,dim,dim-1]
    if dim == 2:
        t = tan[..., 0]                                 # [F, nqb, 2]
        bdy_det = torch.sqrt(t[..., 0] ** 2 + t[..., 1] ** 2)
        normal = torch.stack([t[..., 1], -t[..., 0]], -1) / bdy_det[..., None]
    else:
        t1, t2 = tan[..., 0], tan[..., 1]
        rn = torch.linalg.cross(t1, t2)
        bdy_det = torch.linalg.vector_norm(rn, dim=-1)
        normal = rn / bdy_det[..., None]
    weights = torch.as_tensor(disc.bdy_itg_weights[eindex],
                              dtype=bdy_det.dtype,
                              device=bdy_det.device)[None, :] * bdy_det
    return itg_vals, weights, normal
