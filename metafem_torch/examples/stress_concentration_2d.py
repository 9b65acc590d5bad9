"""Stress concentration around a hole in a tension plate, mesh imported
from Abaqus .inp — the reference's mesh-reader + stress-recovery benchmark
(examples/linear_elasticity/stress_concentration/2D_Script.jl), validated
against Abaqus S22 line data (2D_Abaqus_x.csv / 2D_Abaqus_y.csv).

The 5x5 plate has a quarter hole of radius 1 at the (5, 0) corner;
symmetry via penalty (d1 = 0 on x = 0, d2 = 0 on y = 0), unit sigma_yy
traction on the top.  Serendipity order-2 quads, two displacement
components (C=2), GMRES(20) with right-Jacobi scaling.

The mesh and the Abaqus lines live in the reference checkout (REF_DIR);
``ref_dir=`` (or ``--mesh FILE``) reads the mesh from elsewhere, e.g. one
written by ``chip_smoke.write_inp(path, *chip_smoke.plate_2d())``:

    python3 -m metafem_torch.examples.stress_concentration_2d --cpu \\
        --mesh plate.inp

Without the Abaqus CSVs beside the mesh the line comparison is skipped.
"""

import argparse
import os

import numpy as np

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.linsolve import krylov
from metafem_torch.mesh.probe import probe_gradient
from metafem_torch.solver.domain import FEM_Domain

REF_DIR = ("/root/reference/examples/linear_elasticity/"
           "stress_concentration")
MESH_NAME = "2D_Mesh.inp"


def solve(verbose=False, ref_dir=None, mesh_path=None, device=None,
          layout_opts=None):
    """The solved plate: (domain, geometry, workpiece id, parameters);
    the parameters hold lam, mu and the step's final ``residual``.  The
    mesh is ``mesh_path``, else ``2D_Mesh.inp`` in ``ref_dir`` (default
    REF_DIR).  ``layout_opts`` forward to ``assemble_global_variables``
    (e.g. ``{"blk_min_tail": 1}`` forces a BSR tail)."""
    if mesh_path is None:
        mesh_path = os.path.join(ref_dir or REF_DIR, MESH_NAME)
    vert, conn = mf.read_mesh(mesh_path)
    geo = mf.construct_total_mesh(vert, conn)
    L, eps_g = 5.0, 0.05
    dom = FEM_Domain(2, device=device)
    wp = dom.add_workpiece(geo)
    left = mf.select_facets(geo, lambda c: c[:, 0] < eps_g)
    bottom = mf.select_facets(geo, lambda c: c[:, 1] < eps_g)
    top = mf.select_facets(geo, lambda c: c[:, 1] > L - eps_g)
    bg_d1 = dom.add_boundary(wp, left)
    bg_d2 = dom.add_boundary(wp, bottom)
    bg_load = dom.add_boundary(wp, top)

    E, nu = 210e9, 0.3
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    tau_b = 10000 * E / L ** 2

    d_ = dom.internal_var("d")
    dw = dom.external_var("dw", "CONTROLPOINT_VAR")
    sl = dom.external_var("sl", "CONTROLPOINT_VAR", "SYMMETRIC_TENSOR")
    n = dom.sym("n")
    delta = dom.sym("delta")
    i, j, m = mf.indices("i j m")
    eps = dom.define("eps", [i, j], (d_[i].d(j) + d_[j].d(i)) / 2.0)
    sig = dom.define("sig", [i, j],
                     lam * delta[i, j] * eps[m, m] + 2 * mu * eps[i, j])

    dom.assign_workpiece_weakform(wp, -Bilinear(eps[i, j], sig[i, j]))
    dom.assign_boundary_weakform(
        wp, bg_d1, tau_b * Bilinear(d_[1], dw[1] - d_[1]))
    dom.assign_boundary_weakform(
        wp, bg_d2, tau_b * Bilinear(d_[2], dw[2] - d_[2]))
    dom.assign_boundary_weakform(
        wp, bg_load, Bilinear(d_[2], sl[2, 2] * n[2]))

    dom.initialize_local_assembly()
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity")
    dom.assemble_global_variables(**(layout_opts or {}))
    dom.compile()
    dom.converge_tol = 1e-8
    dom.linear_solver = dom.make_iterative_solver(
        sv_func=krylov.gmres, maxiter=2000, max_pass=20, s=20)

    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "sl2", np.ones(mesh.n_cp))  # sigma_yy = 1
    dom.refresh_fields()
    res = dom.update_one_step(max_iter=4, verbose=verbose)
    dom.dessemble_x()
    return dom, geo, wp, dict(lam=lam, mu=mu, residual=res)


def s22_at(dom, geo, wp, pts, p):
    """sigma_22 = lam*(e11 + e22) + 2 mu e22 from probed gradients."""
    mesh = dom.workpieces[wp].mesh
    et = dom.workpieces[wp].disc.element_type
    g1 = probe_gradient(geo, mesh, et, "d1", pts)
    g2 = probe_gradient(geo, mesh, et, "d2", pts)
    e11, e22 = g1[:, 0], g2[:, 1]
    return p["lam"] * (e11 + e22) + 2 * p["mu"] * e22


def abaqus_line(name, ref_dir=None):
    raw = np.genfromtxt(os.path.join(ref_dir or REF_DIR, name),
                        delimiter=",", skip_header=1)
    pts = raw[:, 5:7]
    s22 = raw[:, 3]
    return pts, s22


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mesh", help="the .inp mesh (default: REF_DIR's)")
    args = ap.parse_args(argv)
    ref_dir = os.path.dirname(args.mesh) if args.mesh else REF_DIR
    dom, geo, wp, p = solve(verbose=True, mesh_path=args.mesh,
                            device="cpu" if args.cpu else None)
    mesh = dom.workpieces[wp].mesh
    print(f"residue = {p['residual']:.3e}, n_cp = {mesh.n_cp}, "
          f"d2 range = [{mesh.fields['d2'].min():.4e}, "
          f"{mesh.fields['d2'].max():.4e}]")
    pts = np.array([[3.92, 0.0], [3.8, 0.0], [3.6, 0.0]])
    print(f"S22 at {pts.tolist()}: {s22_at(dom, geo, wp, pts, p)}")
    for name, inside in (("2D_Abaqus_x.csv",
                          lambda q: q[:, 0] < 3.99),
                         ("2D_Abaqus_y.csv",
                          lambda q: q[:, 1] > 1.01)):
        if not os.path.exists(os.path.join(ref_dir, name)):
            print(f"{name}: not found in {ref_dir}; Abaqus comparison "
                  f"skipped")
            continue
        pts, s22_ref = abaqus_line(name, ref_dir)
        keep = inside(pts)
        got = s22_at(dom, geo, wp, pts[keep], p)
        ok = ~np.isnan(got)
        err = np.abs(got[ok] - s22_ref[keep][ok])
        print(f"{name}: {ok.sum()} pts, max |dS22| = {err.max():.4f}, "
              f"mean = {err.mean():.4f} (nominal load 1.0)")


if __name__ == "__main__":
    main()
