"""Steady thermal conduction with pikachu's weak form on a synthetic
unstructured tet mesh: the production configuration of the reference's
flagship unstructured workload (benchmarks/pikachu_scale.py) without
its COMSOL mesh file.

The mesh is a ``make_brick((1.0, 0.7, 0.7), nel, shape="SIMPLEX")``
brick (5 tets per cell) with its interior vertices jittered by 0.18 h,
so the control points land on no lattice: the mesh gets a Morton
numbering, its tangent a BSR tail of 8 x 8 blocks once the tail passes
``blk_min_tail`` entries, and its preconditioner is the
auxiliary-space multigrid.  The weak form and constants are pikachu's
(examples/pikachu_3d.py:20,37-43): conduction 0.6, convection 25 to an
ambient 293.15 K on every face, a source of 1600.  Order-2 tets with
itg_order 5, as pikachu refine-2 runs them; nel=(73, 51, 51) gives
1,369,650 DOF (pikachu refine-2: 1,358,969).

    python3 -m metafem_torch.examples.pikachu_brick --cpu --nel 6 4 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import metafem_torch as mf
from metafem_torch import Bilinear, FEM_Domain

#: examples/pikachu_3d.py:20
K_COND, H_CONV, T_ENV, SOURCE = 0.6, 25.0, 273.15 + 20, 1600.0
#: the brick's extent
EXTENT = (1.0, 0.7, 0.7)
#: the vertex jitter, in units of the cell size h (uniform, +-h/2 x it)
JITTER = 0.18


def brick_arrays(nel):
    """(vertices, tets) of the brick with its interior vertices moved by
    up to JITTER h / 2 per axis (uniform, numpy seeded 2)."""
    vert, conn = mf.make_brick(EXTENT, tuple(nel), shape="SIMPLEX")
    vert = np.asarray(vert, np.float64)
    rng = np.random.default_rng(2)
    h = min(EXTENT[d] / nel[d] for d in range(3))
    interior = np.ones(len(vert), bool)
    for d in range(3):
        interior &= (vert[:, d] > 1e-9) & (vert[:, d] < EXTENT[d] - 1e-9)
    vert = vert + JITTER * h * interior[:, None] * (
        rng.random(vert.shape) - 0.5)
    return vert, np.asarray(conn)


def build(nel=(73, 51, 51), device=None, lattice_pad: int = 1,
          **layout_opts):
    """(domain, mesh) of the brick, compiled, float32, at the ambient
    temperature, converge_tol 1e-6.  ``layout_opts`` forward to
    ``assemble_global_variables``; the tail is a BSR tail at every size
    (``blk_min_tail=1``), as pikachu's passes the default threshold.
    ``lattice_pad``: ghost control points up to a multiple of it (the
    rank count of a row-sharded run, ``mesh_classical``)."""
    vert, conn = brick_arrays(nel)
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(3, dtype=torch.float32, device=device)
    wp = dom.add_workpiece(geo)
    bg = dom.add_boundary(wp, geo.boundary_facet_ids())
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    i = mf.index("i")
    dom.assign_workpiece_weakform(
        wp, -K_COND * Bilinear(T.d(i), T.d(i)) + Bilinear(T, s))
    dom.assign_boundary_weakform(wp, bg, H_CONV * Bilinear(T, T_ENV - T))
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=2, itg_order=5, lattice_pad=lattice_pad)
    dom.assemble_global_variables(**{"blk_min_tail": 1, **layout_opts})
    dom.compile()
    dom.converge_tol = 1e-6
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "T", np.full(mesh.n_cp, T_ENV))
    dom.set_field(wp, "s", np.full(mesh.n_cp, SOURCE))
    dom.refresh_fields()
    dom.assemble_x()
    return dom, mesh


def main(argv=None) -> None:
    from metafem_torch.linsolve import krylov
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nel", type=int, nargs=3, default=(73, 51, 51))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    dom, mesh = build(tuple(args.nel), device="cpu" if args.cpu else None)
    dom.freeze_linear_tangent()
    dom.freeze_refined_residual()
    dom.setup_auxmg()
    dom.free_volume_tables()
    step = dom.make_refined_step(sv_func=krylov.bicgstab, precond="auxmg",
                                 maxiter=12, max_refine=40, max_pass=1,
                                 forcing=0.3)
    x, _, res, refines = step(dom._runtime_state(), dom.x, 0.0, 1.0)
    print(f"nel={tuple(args.nel)} DOF {dom.pattern.basicfield_size}: "
          f"residual {res:.3e} after {refines} refines, T in "
          f"[{float(x.min()):.3f}, {float(x.max()):.3f}] K, "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
