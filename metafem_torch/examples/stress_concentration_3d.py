"""3D stress concentration around a hole, mesh imported from Abaqus
.inp — the reference's 3D elasticity benchmark
(examples/linear_elasticity/stress_concentration/3D_Script.jl),
validated against Abaqus S22 line data (3D_Abaqus_x.csv /
3D_Abaqus_y.csv).

The 5x5x5 block has a quarter hole of radius 1 along the (0, 0, z)
edge; symmetry via penalty (d1 = 0 on x = 0, d2 = 0 on y = 0, d3 = 0 on
z = 0), unit sigma_yy traction on y = L (3D_Script.jl:16-57).
Serendipity order-2 hexes, three displacement components (C=3).

The mesh and the Abaqus lines live in the reference checkout (REF_DIR);
``ref_dir=`` (or ``--mesh FILE``) reads the mesh from elsewhere, e.g. one
written by ``chip_smoke.write_inp(path, *chip_smoke.block_3d())``:

    python3 -m metafem_torch.examples.stress_concentration_3d --cpu \\
        --mesh block.inp

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
MESH_NAME = "3D_Mesh.inp"


def solve(verbose=False, solver="lu", ref_dir=None, mesh_path=None,
          device=None, layout_opts=None):
    """``solver``: 'lu' (host splu — fastest for this ~60k-DOF one-shot
    linear solve) or 'idrs' (the reference's Krylov choice,
    3D_Script.jl:71).  The mesh is ``mesh_path``, else ``3D_Mesh.inp``
    in ``ref_dir`` (default REF_DIR); ``layout_opts`` forward to
    ``assemble_global_variables``.  Returns (domain, geometry, workpiece
    id, parameters); the parameters hold lam, mu and the step's final
    ``residual``."""
    if mesh_path is None:
        mesh_path = os.path.join(ref_dir or REF_DIR, MESH_NAME)
    vert, conn = mf.read_mesh(mesh_path)
    geo = mf.construct_total_mesh(vert, conn)
    L, eps_g = 5.0, 0.05
    dom = FEM_Domain(3, device=device)
    wp = dom.add_workpiece(geo)
    left = mf.select_facets(geo, lambda c: c[:, 0] < eps_g)
    front = mf.select_facets(geo, lambda c: c[:, 1] < eps_g)
    bottom = mf.select_facets(geo, lambda c: c[:, 2] < eps_g)
    back = mf.select_facets(geo, lambda c: c[:, 1] > L - eps_g)
    bg_d1 = dom.add_boundary(wp, left)
    bg_d2 = dom.add_boundary(wp, front)
    bg_d3 = dom.add_boundary(wp, bottom)
    bg_load = dom.add_boundary(wp, back)

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
        wp, bg_d3, tau_b * Bilinear(d_[3], dw[3] - d_[3]))
    dom.assign_boundary_weakform(
        wp, bg_load, Bilinear(d_[2], sl[2, 2] * n[2]))

    dom.initialize_local_assembly()
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity")
    dom.assemble_global_variables(**(layout_opts or {}))
    dom.compile()
    dom.converge_tol = 1e-8
    if solver == "lu":
        dom.linear_solver = dom.make_direct_solver()
    else:
        dom.linear_solver = dom.make_iterative_solver(
            sv_func=krylov.idrs, maxiter=2000, max_pass=20, s=8)

    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "sl2", np.ones(mesh.n_cp))  # sigma_yy = 1
    dom.refresh_fields()
    res = dom.update_one_step(max_iter=4, verbose=verbose)
    dom.dessemble_x()
    return dom, geo, wp, dict(lam=lam, mu=mu, residual=res)


def s22_at(dom, geo, wp, pts, p):
    """sigma_22 = lam*tr(eps) + 2 mu eps_22 from probed gradients."""
    mesh = dom.workpieces[wp].mesh
    et = dom.workpieces[wp].disc.element_type
    g1 = probe_gradient(geo, mesh, et, "d1", pts)
    g2 = probe_gradient(geo, mesh, et, "d2", pts)
    g3 = probe_gradient(geo, mesh, et, "d3", pts)
    tr = g1[:, 0] + g2[:, 1] + g3[:, 2]
    return p["lam"] * tr + 2 * p["mu"] * g2[:, 1]


def abaqus_line(name, ref_dir=None):
    """(points [N,3], S22 [N]) from the paraview-sampled Abaqus CSVs
    (columns S-S11, S-S22, Points:0/1/2)."""
    raw = np.genfromtxt(os.path.join(ref_dir or REF_DIR, name),
                        delimiter=",", skip_header=1)
    return raw[:, 2:5], raw[:, 1]


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
    pts = np.array([[1.25, 0.0, 0.0], [1.75, 0.0, 0.0], [2.5, 0.0, 0.0]])
    print(f"S22 at {pts.tolist()}: {s22_at(dom, geo, wp, pts, p)}")
    # sample lines run at z=0 from the hole edge (r=1) outward; points
    # with sqrt(x^2+y^2) <= 1 are inside the hole (paraview reports the
    # nearest-element value there) and are excluded
    for name in ("3D_Abaqus_x.csv", "3D_Abaqus_y.csv"):
        if not os.path.exists(os.path.join(ref_dir, name)):
            print(f"{name}: not found in {ref_dir}; Abaqus comparison "
                  f"skipped")
            continue
        pts, s22_ref = abaqus_line(name, ref_dir)
        keep = np.hypot(pts[:, 0], pts[:, 1]) > 1.15
        got = s22_at(dom, geo, wp, pts[keep], p)
        ok = ~np.isnan(got)
        err = np.abs(got[ok] - s22_ref[keep][ok])
        print(f"{name}: {ok.sum()} pts, max |dS22| = {err.max():.4f}, "
              f"mean = {err.mean():.4f} (nominal load 1.0)")


if __name__ == "__main__":
    main()
