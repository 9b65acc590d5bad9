"""3D steady Stokes-to-Navier-Stokes flow past a cylinder in a duct — the
reference's unstructured-flow example (examples/incompressible_flow/
cylinder_flow/3D_MetaFEM_Script.jl): COMSOL tet mesh, parabolic inflow,
pressure-penalized outflow, SUPG-stabilized equal-order u-p, one implicit
step to the (low-Re) steady solution, validated against COMSOL line data
(COMSOL_y2.csv = u1 along the duct axis line, COMSOL_y3.csv = pressure).
Velocity and pressure give four components per control point (C=4);
IDR(8) with left-Jacobi preconditioning solves each Newton update.

The COMSOL mesh is body-fitted around the cylinder and lives in the
reference checkout (MESH_PATH).  ``mesh_path=`` (or ``--mesh FILE``)
reads another .mphtxt tet mesh of the 2.5 x 0.41 x 0.41 duct.
``chip_smoke.duct(nel)`` makes one without that file: a jittered 5-tet
brick from which the cells within 0.05 of the cylinder's axis are cut,
so its cylinder is a stepped surface rather than the reference's
body-fitted one; every face other than the inlet and the outlet falls in
``bg_fix`` through the facet test below, the obstacle's with the walls:

    python3 -m metafem_torch.examples.cylinder_flow_3d --cpu \\
        --mesh duct.mphtxt

Without the COMSOL CSV beside the mesh the line comparison is skipped.
"""

import argparse
import os

import numpy as np

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.linsolve import krylov
from metafem_torch.solver.domain import FEM_Domain

REF_DIR = "/root/reference/examples/incompressible_flow/cylinder_flow"
MESH_PATH = os.path.join(REF_DIR, "3D_COMSOL_Mesh.mphtxt")

L, H = 2.5, 0.41
RHO, MU = 1e3, 1.0
DX, CB = 0.02, 128
UM = 0.45


def build(itp_order=2, itg_order=6, mesh_path=None, device=None):
    """(domain, geometry, workpiece id), compiled, with the reference's
    IDR(8) solver; the mesh is ``mesh_path`` (default MESH_PATH)."""
    vert, conn = mf.read_mesh(mesh_path or MESH_PATH)
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(3, device=device)
    wp = dom.add_workpiece(geo)
    bids = geo.boundary_facet_ids()
    centers = geo.facet_centers()[bids]
    eps_g = 0.01
    is_left = np.abs(centers[:, 0]) < eps_g
    is_right = np.abs(centers[:, 0] - L) < eps_g
    bg_fix = dom.add_boundary(wp, bids[~(is_left | is_right)])
    bg_in = dom.add_boundary(wp, bids[is_left])
    bg_out = dom.add_boundary(wp, bids[is_right])

    nu = MU / RHO
    tau_b = nu * CB / DX
    tau_p = CB * DX / MU

    u = dom.internal_var("u")
    p = dom.internal_var("p")
    uw = dom.external_var("uw", "CONTROLPOINT_VAR")
    tau_m = dom.external_var("tau_m", "CONTROLPOINT_VAR")
    tau_c = dom.external_var("tau_c", "CONTROLPOINT_VAR")
    n = dom.sym("n")
    i, j, m = mf.indices("i j m")

    Rc = dom.define("Rc", [], u[m].d(m))
    Rm = dom.define("Rm", [i], u[m] * u[i].d(m) + p.d(i) / RHO
                    - nu * u[i].d(m, m))

    ns_base = (-RHO * Bilinear(u[i].d(j), u[i] * u[j])
               - Bilinear(u[i].d(i), p) + Bilinear(p, u[i].d(i))
               + MU * Bilinear(u[i].d(j), u[i].d(j)))
    ns_supg = (tau_m * RHO * Bilinear(u[i].d(j), Rm[i] * u[j])
               + tau_m * Bilinear(p.d(i), Rm[i])
               + tau_c * RHO * Bilinear(u[i].d(i), Rc))
    bdy_base = (Bilinear(u[i], p * n[i])
                - MU * Bilinear(u[i], u[i].d(j) * n[j]))
    bdy_in = (RHO * Bilinear(u[i], uw[i] * uw[j] * n[j])
              + Bilinear(p, (uw[i] - u[i]) * n[i])
              + MU * Bilinear(u[i].d(j), (uw[i] - u[i]) * n[j])
              + tau_b * RHO * Bilinear(u[i], u[i] - uw[i]))
    bdy_out = (RHO * Bilinear(u[i], u[i] * u[j] * n[j])
               + tau_p * Bilinear(p, p))
    bdy_fix = (Bilinear(p, -1.0 * u[i] * n[i])
               + MU * Bilinear(u[i].d(j), -1.0 * u[i] * n[j])
               + tau_b * RHO * Bilinear(u[i], u[i]))

    dom.assign_workpiece_weakform(wp, ns_base + ns_supg)
    dom.assign_boundary_weakform(wp, bg_in, bdy_base + bdy_in)
    dom.assign_boundary_weakform(wp, bg_out, bdy_base + bdy_out)
    dom.assign_boundary_weakform(wp, bg_fix, bdy_base + bdy_fix)
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=itp_order, itg_order=itg_order)
    dom.assemble_global_variables()
    dom.compile()
    dom.converge_tol = 1e-6
    dom.linear_solver = dom.make_iterative_solver(
        sv_func=krylov.idrs, maxiter=2000, max_pass=10, s=8,
        use_pl_jacobi=True)
    return dom, geo, wp


def solve(dom, geo, wp, verbose=False):
    mesh = dom.workpieces[wp].mesh
    c = mesh.cp_coords
    nu = MU / RHO
    uw1 = (16 * UM / H ** 4) * (c[:, 1] * c[:, 2]
                                * (H - c[:, 1]) * (H - c[:, 2]))
    tau_m = np.full(mesh.n_cp,
                    (9 * 16 * nu ** 2 * 3 / DX ** 4) ** -0.5)
    dom.set_field(wp, "uw1", uw1)
    dom.set_field(wp, "tau_m", tau_m)
    dom.set_field(wp, "tau_c", 1.0 / (tau_m * 3 / DX ** 2))
    dom.refresh_fields()
    dom.assemble_x()
    dom.dt = 0.2 * DX / UM
    res = dom.update_one_step(max_iter=6, verbose=verbose)
    dom.dessemble_x()
    return res


def comsol_line(name, ref_dir=None):
    raw = np.genfromtxt(os.path.join(ref_dir or REF_DIR, name),
                        delimiter=",", skip_header=1)
    return raw


def main(argv=None) -> None:
    from metafem_torch.mesh.probe import probe_field

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mesh", help="the .mphtxt mesh (default: MESH_PATH)")
    args = ap.parse_args(argv)
    ref_dir = os.path.dirname(args.mesh) if args.mesh else REF_DIR
    dom, geo, wp = build(mesh_path=args.mesh,
                         device="cpu" if args.cpu else None)
    res = solve(dom, geo, wp, verbose=True)
    mesh = dom.workpieces[wp].mesh
    print(f"residue = {res:.3e}, n_cp = {mesh.n_cp}, "
          f"u1 range = [{mesh.fields['u1'].min():.3f}, "
          f"{mesh.fields['u1'].max():.3f}]")
    if not os.path.exists(os.path.join(ref_dir, "COMSOL_y2.csv")):
        print(f"COMSOL_y2.csv: not found in {ref_dir}; COMSOL comparison "
              f"skipped")
        return
    # COMSOL line: (u, v, w, p, mask, arc, x, y, z)
    raw = comsol_line("COMSOL_y2.csv", ref_dir)
    mask = raw[:, 4] > 0.5
    pts = raw[mask, 6:9]
    et = dom.workpieces[wp].disc.element_type
    got = probe_field(geo, mesh, et, "u1", pts)
    ok = ~np.isnan(got)
    err = np.abs(got[ok] - raw[mask, 0][ok])
    print(f"u1 vs COMSOL: {ok.sum()} pts, max |du| = {err.max():.4f}, "
          f"mean = {err.mean():.4f} (U_max = {raw[mask, 0].max():.3f})")


if __name__ == "__main__":
    main()
