"""Coupled transient thermo-elasticity, MetaFEM.jl's multi-field coupling
example (examples/thermal_elasticity/themal_hypo_elasticity.jl): a
cantilever heated on one side bends away from the heat.  Temperature
diffusion (first order in time) and thermal-strain elasticity with
viscous relaxation, stepped to steady state (|u_t| < 1e-4, |T_t| < 1e-2,
themal_hypo_elasticity.jl:120-130).

The thermal strain couples the fields both ways: the displacement rows
read T, and its variation puts the elastic stress into the T rows, so the
tangent couples all 16 (T, d1, d2, d3) channel pairs.

Run as ``python -m metafem_torch.examples.thermal_elasticity_3d`` (CUDA)
or with ``--cpu``; ``--e-number N`` sets the mesh (nel = (10N/4, N, N)).
"""

import argparse

import numpy as np
import torch

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.linsolve import krylov
from metafem_torch.solver.domain import FEM_Domain

#: thermal expansion coefficient of the bar
ALPHA = 0.05e-3


def build(e_number=4, LW_ratio=10, device=None, dtype=torch.float64,
          layout_opts=None):
    """The compiled domain of a 10x1x1 bar, clamped at x=0 and cooled by
    convection on its other faces; returns (domain, workpiece id).  The
    solver is the example's own: right-Jacobi BiCGStab(4), maxiter 2000,
    20 passes, converge_tol 1e-6.  ``layout_opts`` forward to
    ``assemble_global_variables``."""
    L_box = 1.0
    size = (L_box * LW_ratio, L_box, L_box)
    nel = (int(e_number * LW_ratio / 4), e_number, e_number)
    vert, conn = mf.make_brick(size, nel)
    geo = mf.construct_total_mesh(vert, conn)

    E, nu = 210e3, 0.0
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    tau_b = 1000 * E / L_box
    rho, c_visc = 1e3, 0.01
    h, C_heat, k, alpha = 100.0, 1000.0, 100.0, ALPHA

    dom = FEM_Domain(3, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    eps_g = L_box / e_number * 0.01
    left = mf.select_facets(geo, lambda cc: cc[:, 0] < eps_g)
    others = mf.select_facets(geo, lambda cc: cc[:, 0] >= eps_g)
    bg_fix = dom.add_boundary(wp, left)
    bg_conv = dom.add_boundary(wp, others)

    d_ = dom.internal_var("d")
    T = dom.internal_var("T")
    Te = dom.external_var("Te", "CONTROLPOINT_VAR")
    delta = dom.sym("delta")
    i, j, m = mf.indices("i j m")

    eps = dom.define("eps", [i, j], (d_[i].d(j) + d_[j].d(i)) / 2.0
                     - alpha * T * delta[i, j])
    sig = dom.define("sig", [i, j],
                     lam * delta[i, j] * eps[m, m] + 2.0 * mu * eps[i, j])

    heat = C_heat * Bilinear(T, T.dt()) + k * Bilinear(T.d(i), T.d(i))
    elast = (Bilinear(eps[i, j], sig[i, j])
             + Bilinear(d_[i], rho * c_visc * d_[i].dt()))
    dom.assign_workpiece_weakform(wp, heat + elast)
    dom.assign_boundary_weakform(wp, bg_fix,
                                 tau_b * Bilinear(d_[i], d_[i]))
    dom.assign_boundary_weakform(wp, bg_conv, h * Bilinear(T, T - Te))

    dom.initialize_local_assembly()
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity")
    dom.assemble_global_variables(**(layout_opts or {}))
    dom.compile()
    dom.converge_tol = 1e-6
    dom.linear_solver = dom.make_iterative_solver(
        sv_func=krylov.bicgstabl, maxiter=2000, max_pass=20, s=4)
    return dom, wp


def heat_front(dom, wp, Te_hot=300.0):
    """Heat only the front (y = 0) face, the rest stays at Te = 0; upload
    the fields and x, and set the example's step dt = 1."""
    mesh = dom.workpieces[wp].mesh
    front = np.abs(mesh.cp_coords[:, 1]) < 1e-9
    Te = np.zeros(mesh.n_cp)
    Te[front] = Te_hot
    dom.set_field(wp, "Te", Te)
    dom.refresh_fields()
    dom.assemble_x()
    dom.dt = 1.0


def run_steps(dom, wp, n):
    """Take ``n`` time steps of the current dt through
    ``update_one_step(max_iter=3)``; returns each step's final residual."""
    res = []
    for _ in range(n):
        res.append(dom.update_one_step(max_iter=3))
        dom.dessemble_x()
    return res


def run_to_steady(dom, wp, Te_hot=300.0, max_steps=120, verbose=False):
    """Heat the front face and step until |d2_t| < 1e-4 and |T_t| < 1e-2;
    returns the number of steps taken."""
    mesh = dom.workpieces[wp].mesh
    heat_front(dom, wp, Te_hot)
    for step in range(1, max_steps + 1):
        run_steps(dom, wp, 1)
        umax = np.abs(mesh.fields["d2_t"]).max()
        Ttmax = np.abs(mesh.fields["T_t"]).max()
        if verbose and step % 10 == 0:
            print(f"step {step}: |d2_t| = {umax:.2e} |T_t| = {Ttmax:.2e} "
                  f"Tmax = {mesh.fields['T'].max():.2f} "
                  f"d2max = {np.abs(mesh.fields['d2']).max():.4f}")
        if umax < 1e-4 and Ttmax < 1e-2:
            break
    return step


def bending(dom, wp):
    """(mean tip d2, measured curvature 2 d2_tip / L^2, thermal curvature
    alpha dT / h from the through-thickness temperature difference at
    mid-length)."""
    mesh = dom.workpieces[wp].mesh
    c = mesh.cp_coords
    L = np.nanmax(c[:, 0])
    h_beam = np.nanmax(c[:, 1])
    d2_tip = float(mesh.fields["d2"][c[:, 0] > L - 1e-9].mean())
    mid = np.abs(c[:, 0] - L / 2) < 0.3
    front = mid & (np.abs(c[:, 1]) < 1e-9)
    back = mid & (np.abs(c[:, 1] - h_beam) < 1e-9)
    dT = mesh.fields["T"][front].mean() - mesh.fields["T"][back].mean()
    return d2_tip, 2 * d2_tip / L ** 2, float(ALPHA * dT / h_beam)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--e-number", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dom, wp = build(e_number=args.e_number,
                    device="cpu" if args.cpu else None)
    steps = run_to_steady(dom, wp, verbose=True)
    d2_tip, kappa, kappa_th = bending(dom, wp)
    print(f"steady after {steps} steps; tip d2 mean = {d2_tip:.4f}; "
          f"curvature {kappa:.4e} against alpha dT / h = {kappa_th:.4e}")
