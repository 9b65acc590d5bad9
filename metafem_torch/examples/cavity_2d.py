"""Lid-driven cavity (steady incompressible Navier-Stokes, SUPG/PSPG
stabilized equal-order u-p), MetaFEM.jl's mixed-field benchmark
(examples/incompressible_flow/lid_driven_cavity_flow/2D_Script.jl),
validated against the centreline data of Ghia, Ghia and Shin (1982).

Exercises two coupled internal variables, nonlinear convection
gradients, boundary weak forms with normals and products of internal
variables, and user-updated stabilization fields (tau_m and tau_c
recomputed from the current velocity between continuation steps,
2D_Script.jl:120-136).

Run as ``python -m metafem_torch.examples.cavity_2d`` (CUDA) or with
``--cpu``; ``--e-number N`` sets the N x N mesh, ``--re`` the Reynolds
numbers.
"""

import argparse
import os

import numpy as np
import torch

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.linsolve import krylov
from metafem_torch.solver.domain import FEM_Domain

#: MetaFEM.jl's Ghia_Re*.csv tables; the repository ships none, so
#: ``ghia`` reads them only where a copy has been put in this directory
GHIA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

#: the published minimum of u/U on the vertical centreline and its y
#: (Ghia, Ghia and Shin 1982, Table I)
GHIA_MIN = {100: (-0.21090, 0.4531), 1000: (-0.38289, 0.1719)}


def build(e_number=40, L_box=1.0, rho=1e3, mu=1.0, Cb=128, device=None,
          dtype=torch.float64):
    """The compiled cavity domain; returns (domain, geometry, workpiece
    id, parameters)."""
    dx = L_box / e_number
    tau_b = mu / rho * Cb / dx
    vert, conn = mf.make_square((L_box, L_box), (e_number, e_number))
    geo = mf.construct_total_mesh(vert, conn)

    dom = FEM_Domain(2, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    eps_g = dx * 0.01
    walls = mf.select_facets(
        geo, lambda c: (c[:, 0] < eps_g) | (c[:, 0] > L_box - eps_g)
        | (c[:, 1] < eps_g))
    top = mf.select_facets(geo, lambda c: c[:, 1] > L_box - eps_g)
    bg_fix = dom.add_boundary(wp, walls)
    bg_top = dom.add_boundary(wp, top)

    u = dom.internal_var("u")
    p = dom.internal_var("p")
    uw = dom.external_var("uw", "CONTROLPOINT_VAR")
    tau_m = dom.external_var("tau_m", "CONTROLPOINT_VAR")
    tau_c = dom.external_var("tau_c", "CONTROLPOINT_VAR")
    n = dom.sym("n")
    i, j, m = mf.indices("i j m")

    Rc = dom.define("Rc", [], u[m].d(m))
    Rm = dom.define("Rm", [i], u[m] * u[i].d(m) + p.d(i) / rho
                    - mu / rho * u[i].d(m, m))

    ns_base = (-rho * Bilinear(u[i].d(j), u[i] * u[j])
               - Bilinear(u[i].d(i), p) + Bilinear(p, u[i].d(i))
               + mu * Bilinear(u[i].d(j), u[i].d(j)))
    ns_supg = (tau_m * rho * Bilinear(u[i].d(j), Rm[i] * u[j])
               + tau_m * Bilinear(p.d(i), Rm[i])
               + tau_c * rho * Bilinear(u[i].d(i), Rc))
    bdy_base = (rho * Bilinear(u[i], u[i] * u[j] * n[j])
                + Bilinear(u[i], p * n[i])
                - mu * Bilinear(u[i], u[i].d(j) * n[j]))
    bdy_disp = (rho * Bilinear(u[i], (uw[i] * uw[j] - u[i] * u[j]) * n[j])
                + Bilinear(p, (uw[i] - u[i]) * n[i])
                + mu * Bilinear(u[i].d(j), (uw[i] - u[i]) * n[j])
                + tau_b * rho * Bilinear(u[i], u[i] - uw[i]))
    bdy_fix = (rho * Bilinear(u[i], -1.0 * u[i] * u[j] * n[j])
               + Bilinear(p, -1.0 * u[i] * n[i])
               + mu * Bilinear(u[i].d(j), -1.0 * u[i] * n[j])
               + tau_b * rho * Bilinear(u[i], u[i]))

    dom.assign_workpiece_weakform(wp, ns_base + ns_supg)
    dom.assign_boundary_weakform(wp, bg_fix, bdy_base + bdy_fix)
    dom.assign_boundary_weakform(wp, bg_top, bdy_base + bdy_disp)
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity")
    dom.assemble_global_variables()
    dom.compile()
    dom.converge_tol = 1e-5
    return dom, geo, wp, dict(dx=dx, rho=rho, mu=mu, L=L_box)


def run_re(dom, wp, Re, params, solver="bicgstabl", tmax=None,
           verbose=False, residuals=None):
    """Newton continuation ramping the lid velocity to u(Re) from rest,
    updating the SUPG taus from the current velocity each step
    (2D_Script.jl:111-137); returns u(Re).

    ``solver``: 'bicgstabl' (default: right-Jacobi BiCGStab(4) on the
    device, the same class of iterative solve as the reference,
    2D_Script.jl:102-105), 'cgs2' (the reference's own pick) or 'lu'
    (sparse LU on the host).  ``residuals``: a list that receives each
    continuation step's final residual."""
    dx, rho, mu, L = (params[k] for k in ("dx", "rho", "mu", "L"))
    nu = mu / rho
    dim = 2
    u_st = Re / L * nu
    mesh = dom.workpieces[wp].mesh
    if solver == "lu":
        dom.linear_solver = dom.make_direct_solver()
    elif solver == "bicgstabl":
        dom.linear_solver = dom.make_iterative_solver(
            sv_func=krylov.bicgstabl, s=4, maxiter=3000, max_pass=10)
    elif solver == "cgs2":
        dom.linear_solver = dom.make_iterative_solver(
            sv_func=krylov.cgs2, maxiter=5000, max_pass=20)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    if tmax is None:
        tmax = 10 if Re > 1000 else int(np.ceil(Re / 100))
    dom.x = dom.x * 0.0
    dom.t = 0.0
    dom.dessemble_x()
    for step in range(1, tmax + 1):
        u_top = u_st * step / tmax
        dom.dt = 0.2 * dx / u_top
        u1 = mesh.fields["u1"]
        u2 = mesh.fields["u2"]
        tau_m = (4 / dom.dt ** 2 + 9 * 16 * nu ** 2 * dim / dx ** 4
                 + (u1 ** 2 + u2 ** 2) / dx ** 2) ** (-0.5)
        dom.set_field(wp, "uw1", np.full(mesh.n_cp, u_top))
        dom.set_field(wp, "tau_m", tau_m)
        dom.set_field(wp, "tau_c", 1.0 / (tau_m * dim / dx ** 2))
        dom.refresh_fields()
        dom.assemble_x()
        res = dom.update_one_step(max_iter=6, verbose=verbose)
        dom.dessemble_x()
        if residuals is not None:
            residuals.append(res)
        if verbose:
            print(f"  continuation step {step}/{tmax}: u_top = {u_top:.4g} "
                  f"residue = {res:.3e}")
    return u_st


def centerline_u(dom, wp, u_st, params):
    """(y / L, u1 / U) along the vertical centreline, sorted by y."""
    mesh = dom.workpieces[wp].mesh
    c = mesh.cp_coords
    sel = np.abs(c[:, 0] - params["L"] / 2) < 0.25 * params["dx"]
    ys = c[sel, 1] / params["L"]
    us = mesh.fields["u1"][sel] / u_st
    order = np.argsort(ys)
    return ys[order], us[order]


def ghia(Re):
    """Ghia et al.'s centreline table from MetaFEM.jl's Ghia_Re*.csv
    under GHIA_DIR."""
    # Ghia_Re3200.csv quotes its values ("\t0.53236"); strip quotes
    # before parsing (the other files are plain CSV).
    path = os.path.join(GHIA_DIR, f"Ghia_Re{Re}.csv")
    with open(path) as f:
        lines = [ln.replace('"', "").strip() for ln in f]
    raw = np.genfromtxt(lines, delimiter=",", names=True)
    return raw["y"], raw["u"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--e-number", type=int, default=40)
    ap.add_argument("--re", type=int, nargs="+", default=[100, 1000])
    ap.add_argument("--solver", default="bicgstabl")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dom, geo, wp, params = build(e_number=args.e_number,
                                 device="cpu" if args.cpu else None)
    for Re in args.re:
        u_st = run_re(dom, wp, Re, params, solver=args.solver)
        ys, us = centerline_u(dom, wp, u_st, params)
        line = f"Re {Re}: min u/U = {us.min():.5f} at y = {ys[us.argmin()]:.4f}"
        if Re in GHIA_MIN:
            line += f" (Ghia et al. {GHIA_MIN[Re][0]} at {GHIA_MIN[Re][1]})"
        print(line)
