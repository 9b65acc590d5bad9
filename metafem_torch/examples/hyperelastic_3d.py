"""Neo-Hookean / Mooney-Rivlin hyperelastic tension, MetaFEM.jl's
symbolic-tensor-derivative benchmark (examples/hyper_elasticity/
static_Neo_Hookean.jl, static_Mooney_Rivlin.jl): the first
Piola-Kirchhoff stress is derived symbolically as P{i,j} = d(W, F{i,j})
from the strain energy (with a Levi-Civita determinant and log(J)),
validated against the analytic homogeneous uniaxial response.

Run as ``python -m metafem_torch.examples.hyperelastic_3d`` (CUDA) or
with ``--cpu``; ``--e-number N`` sets the mesh (nel = (10N, N, N)).
"""

import argparse

import numpy as np
import torch

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.linsolve import krylov
from metafem_torch.solver.domain import FEM_Domain

#: the example's linear solver: right-Jacobi BiCGStab(4)
SOLVER_KW = dict(sv_func=krylov.bicgstabl, maxiter=3000, max_pass=10, s=4)


def build(e_number=2, LW_ratio=10, material="neo_hookean", device=None,
          dtype=torch.float64, layout_opts=None):
    """The compiled domain of a 10x1x1 bar, clamped at x=0 and pulled at
    x=L; returns (domain, workpiece id, dimensions).  ``layout_opts``
    forward to ``assemble_global_variables`` (e.g.
    ``{"dense_min_n": 0}`` forces the dense block-offset layout, G=9
    units of 117 offsets, at a small size)."""
    L_box = 1.0
    size = (L_box * LW_ratio, L_box, L_box)
    nel = (e_number * LW_ratio, e_number, e_number)
    vert, conn = mf.make_brick(size, nel)
    geo = mf.construct_total_mesh(vert, conn)

    dom = FEM_Domain(3, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    eps_g = L_box / e_number * 0.01
    left = mf.select_facets(geo, lambda c: c[:, 0] < eps_g)
    right = mf.select_facets(geo, lambda c: c[:, 0] > size[0] - eps_g)
    bg_fix = dom.add_boundary(wp, left)
    bg_load = dom.add_boundary(wp, right)

    d_ = dom.internal_var("d")
    dw = dom.external_var("dw", "CONTROLPOINT_VAR")
    Pl = dom.external_var("Pl", "CONTROLPOINT_VAR")
    mu = dom.external_var("mu", "GLOBAL_VAR")
    lam = dom.external_var("lam", "GLOBAL_VAR")
    tau_b = dom.external_var("tau_b", "GLOBAL_VAR")
    n = dom.sym("n")
    delta = dom.sym("delta")
    levi = dom.sym("eps3")
    i, j, k, m = mf.indices("i j k m")

    F = dom.define("F", [i, j], delta[i, j] + d_[i].d(j))
    J = dom.define("J", [], F[1, i] * F[2, j] * F[3, k] * levi[i, j, k])
    C = dom.define("C", [i, j], F[k, i] * F[k, j])
    if material == "neo_hookean":
        W = dom.define(
            "W", [], 0.5 * mu * (C[i, i] - 3.0 - 2.0 * mf.log(J))
            + 0.5 * lam * (J - 1.0) ** 2)
    elif material == "mooney_rivlin":
        # W = C10 (I1 - 3 - 2 log J) + C01 (I2 - 3 - 4 log J)
        #     + 0.5 lam (J-1)^2   (static_Mooney_Rivlin.jl:52)
        c10 = dom.external_var("c10", "GLOBAL_VAR")
        c01 = dom.external_var("c01", "GLOBAL_VAR")
        I1 = C[i, i]
        I2 = 0.5 * (C[i, i] * C[j, j] - C[i, j] * C[i, j])
        W = dom.define(
            "W", [], c10 * (I1 - 3.0 - 2.0 * mf.log(J))
            + c01 * (I2 - 3.0 - 4.0 * mf.log(J))
            + 0.5 * lam * (J - 1.0) ** 2)
    else:
        raise ValueError(material)
    P = dom.define("P", [i, j], mf.d(W, F[i, j]))

    dom.assign_workpiece_weakform(wp, -Bilinear(F[i, j], P[i, j]))
    dom.assign_boundary_weakform(
        wp, bg_fix, tau_b * Bilinear(d_[i], dw[i] - d_[i]))
    dom.assign_boundary_weakform(
        wp, bg_load, Bilinear(d_[1], Pl * n[1]))

    dom.initialize_local_assembly()
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity")
    dom.assemble_global_variables(**(layout_opts or {}))
    dom.compile()
    dom.converge_tol = 1e-5
    dom.linear_solver = dom.make_iterative_solver(**SOLVER_KW)
    return dom, wp, dict(L=size[0], h=L_box)


def set_material(dom, mu, lam, **extra_globals):
    """Material constants (global variables, changeable without a
    rebuild), the penalty tau_b = 1000 max(mu, lam), and the bar back at
    rest."""
    dom.global_vars.update(mu=mu, lam=lam, tau_b=1000 * max(mu, lam),
                           **extra_globals)
    dom.x = dom.x * 0.0
    dom.dessemble_x()


def load_step(dom, wp, sigma, step=None):
    """Apply the nominal stress ``sigma`` at the free end and take one
    step: ``step()`` (default ``dom.update_one_step(max_iter=7)``)
    returns the final residual.  Returns (residual, mean end
    displacement / L)."""
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "Pl", np.full(mesh.n_cp, sigma))
    dom.refresh_fields()
    res = (step or (lambda: dom.update_one_step(max_iter=7)))()
    dom.dessemble_x()
    L = np.nanmax(mesh.cp_coords[:, 0])
    right = mesh.cp_coords[:, 0] > L - 1e-9
    return res, float(mesh.fields["d1"][right].mean() / L)


def run_loading(dom, wp, mu, lam, total_steps, sigma_step, verbose=False,
                **extra_globals):
    """Incremental loading (static_Neo_Hookean.jl:99-121); returns
    (applied nominal stress, mean end displacement / L) per step.
    ``extra_globals``: further material constants (e.g. c10/c01 for
    Mooney-Rivlin)."""
    set_material(dom, mu, lam, **extra_globals)
    P1s, d1s = [], []
    for step in range(1, total_steps + 1):
        sigma = sigma_step * step
        res, d1 = load_step(
            dom, wp, sigma,
            lambda: dom.update_one_step(max_iter=7, verbose=verbose))
        P1s.append(sigma)
        d1s.append(d1)
        if verbose:
            print(f"load step {step}: P = {sigma:.3g}, "
                  f"d1/L = {d1:.4f}, residue = {res:.2e}")
    return np.array(P1s), np.array(d1s)


def analytic_uniaxial_nh(sigma, mu, lam):
    """Homogeneous uniaxial Neo-Hookean: solve P11(l1,l2)=sigma, P22=0 for
    F=diag(l1,l2,l2) with P = mu F + (lam J (J-1) - mu) F^-T."""
    from scipy.optimize import fsolve

    def eqs(v):
        l1, l2 = v
        Jd = l1 * l2 * l2
        g = lam * Jd * (Jd - 1) - mu
        return [mu * l1 + g / l1 - sigma, mu * l2 + g / l2]

    l1, l2 = fsolve(eqs, (1.0 + sigma / (3 * mu), 1.0), xtol=1e-12)
    return l1 - 1.0


def analytic_uniaxial_mr(sigma, c10, c01, lam):
    """Homogeneous uniaxial Mooney-Rivlin: F = diag(l1, l2, l2) with the
    lateral direction stress-free; solves dW/dl1 = sigma (nominal),
    dW/dl2 = 0 from the same energy as the weak form."""
    from scipy.optimize import fsolve

    def W(l1, l2):
        I1 = l1 ** 2 + 2 * l2 ** 2
        I2 = l2 ** 4 + 2 * (l1 * l2) ** 2
        J = l1 * l2 * l2
        return (c10 * (I1 - 3 - 2 * np.log(J))
                + c01 * (I2 - 3 - 4 * np.log(J))
                + 0.5 * lam * (J - 1) ** 2)

    def eqs(v):
        l1, l2 = v
        h = 1e-7
        return [(W(l1 + h, l2) - W(l1 - h, l2)) / (2 * h) - sigma,
                (W(l1, l2 + h) - W(l1, l2 - h)) / (2 * h)]

    l1, l2 = fsolve(eqs, (1.0 + sigma / (6 * (c10 + c01)), 1.0),
                    xtol=1e-12)
    return l1 - 1.0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--e-number", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dom, wp, p = build(e_number=args.e_number,
                       device="cpu" if args.cpu else None)
    mu_, lam_ = 1e6, 1e6
    P1s, d1s = run_loading(dom, wp, mu_, lam_, total_steps=args.steps,
                           sigma_step=4e5, verbose=True)
    print("BiCGStab(4) iterations per solver pass:",
          [it for it, _ in dom.solve_log])
    ana = np.array([analytic_uniaxial_nh(s, mu_, lam_) for s in P1s])
    err = np.abs(d1s - ana) / np.abs(ana)
    print("applied P:", P1s[-1], "d1/L FEM:", d1s[-1], "analytic:", ana[-1])
    print("max rel err over curve:", err.max())
