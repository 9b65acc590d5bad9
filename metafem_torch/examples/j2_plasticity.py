"""J2 hypo-elasto-plasticity under cyclic uniaxial load, MetaFEM.jl's
integration-point-callback benchmark (examples/hypo_elastic_plasticity/
J2Plasticity.jl): the plastic strain is an INTEGRATION_POINT_VAR whose
definition calls a user radial-return function over per-quadrature-point
state; the bar relaxes dynamically (second order in time, damped) to the
static solution at each load level; the elongations are held against the
analytic hardening sequences (J2Plasticity.jl:222-230).

The return map is a pure function.  The history (plastic strain ep,
backstress b, yield stress Y) lives in ``domain.user_state`` as tensors
on the domain's device, reaches the assembly through the ``user=``
callback, and is updated from the converged strains through
``evaluate_at_itg``.  The linear solves are sparse LU on the host, as in
the reference.

Run as ``python -m metafem_torch.examples.j2_plasticity`` (CUDA) or with
``--cpu``; ``--sequence`` picks the hardening model.
"""

import argparse
import math

import numpy as np
import torch

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.solver.domain import FEM_Domain
from metafem_torch.solver.time_domain import GeneralAlpha

#: Voigt order of the framework: (1,1),(2,2),(3,3),(2,3),(1,3),(1,2)
_VOIGT = [(1, 1), (2, 2), (3, 3), (2, 3), (1, 3), (1, 2)]


def radial_return(e6, ep, b, Y, mu, lam, Eb, Ep, f_res):
    """Vectorized J2 radial return with linear kinematic (Eb) and
    isotropic (Ep) hardening.  e6, ep and b are stacked Voigt tensors
    [6, ...], Y is [...]; returns (ep, b, Y) after the step."""
    e_el = e6 - ep
    tr = e_el[0] + e_el[1] + e_el[2]
    sigma = 2 * mu * e_el
    sigma = torch.cat([sigma[:3] + lam * tr, sigma[3:]])
    s = sigma - b
    skk3 = (s[0] + s[1] + s[2]) / 3.0
    s = torch.cat([s[:3] - skk3, s[3:]])
    # |s| with Voigt off-diagonals counted twice (full tensor contraction)
    s2 = (s[:3] ** 2).sum(0) + 2.0 * (s[3:] ** 2).sum(0)
    s_mag = torch.sqrt(s2)
    n_dev = s / torch.where(s_mag > 0, s_mag, torch.ones_like(s_mag))
    f = math.sqrt(1.5) * s_mag - Y
    yielded = f > f_res
    lp = torch.where(yielded, math.sqrt(1.5) * f / (3 * mu + Eb + Ep),
                     torch.zeros_like(f))
    ep_new = ep + n_dev * lp
    b_new = b + (2.0 / 3.0 * Eb) * n_dev * lp
    Y_new = Y + math.sqrt(2.0 / 3.0) * Ep * lp
    return ep_new, b_new, Y_new


def build(e_number=4, LW_ratio=10, Ey=100e3, nu=0.0, rho=1e3, c=2.0,
          f_res=1.0, device=None, dtype=torch.float64):
    """The compiled domain of a 10x1x1 bar clamped at x=0 and pulled by a
    traction at x=L, with the return map registered as
    ``strain_updater``; returns (domain, workpiece id, parameters)."""
    L_box = 1.0
    size = (L_box * LW_ratio, L_box, L_box)
    nel = (int(e_number * LW_ratio / 4), e_number, e_number)
    vert, conn = mf.make_brick(size, nel)
    geo = mf.construct_total_mesh(vert, conn)
    lam = Ey * nu / ((1 + nu) * (1 - 2 * nu))
    mu = Ey / (2 * (1 + nu))
    tau_b = 1000 * Ey / L_box ** 2

    dom = FEM_Domain(3, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    eps_g = L_box / e_number * 0.01
    left = mf.select_facets(geo, lambda cc: cc[:, 0] < eps_g)
    right = mf.select_facets(geo, lambda cc: cc[:, 0] > size[0] - eps_g)
    bg_fix = dom.add_boundary(wp, left)
    bg_load = dom.add_boundary(wp, right)

    d_ = dom.internal_var("d")
    dw = dom.external_var("dw", "CONTROLPOINT_VAR")
    sl = dom.external_var("sl", "CONTROLPOINT_VAR", "SYMMETRIC_TENSOR")
    ep_var = dom.external_var("ep", "INTEGRATION_POINT_VAR",
                              "SYMMETRIC_TENSOR")
    n = dom.sym("n")
    delta = dom.sym("delta")
    i, j, m = mf.indices("i j m")

    e = dom.define("e", [i, j], (d_[i].d(j) + d_[j].d(i)) / 2.0)
    dom.define("ep", [i, j], mf.fn(
        "strain_updater", e[1, 1], e[1, 2], e[1, 3],
        e[2, 2], e[2, 3], e[3, 3]))
    e_ev = dom.define("e_ev", [i, j], e[i, j] - ep_var[i, j])
    sig = dom.define("sig", [i, j],
                     2 * mu * e_ev[i, j] + lam * e_ev[m, m] * delta[i, j])

    dom.assign_workpiece_weakform(
        wp, Bilinear(d_[i].d(j), sig[i, j])
        + Bilinear(d_[i], rho * (c * d_[i].dt() + d_[i].dt(2))))
    dom.assign_boundary_weakform(
        wp, bg_fix, tau_b * Bilinear(d_[i], d_[i] - dw[i]))
    dom.assign_boundary_weakform(
        wp, bg_load, Bilinear(d_[i], -1.0 * sl[i, j] * n[j]))

    def strain_updater(e11, e12, e13, e22, e23, e33, *, user):
        e6 = torch.stack([e11, e22, e33, e23, e13, e12])
        ep_new, _, _ = radial_return(
            e6, user["ep"], user["b"], user["Y"], mu, lam,
            user["Eb"], user["Ep"], f_res)
        return tuple(ep_new[k] for k in range(6))

    dom.register_function("strain_updater", strain_updater)
    dom.initialize_local_assembly()
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity")
    dom.assemble_global_variables()
    dom.compile()
    dom.converge_tol = 1e-3
    dom.linear_solver = dom.make_direct_solver()
    return dom, wp, dict(mu=mu, lam=lam, f_res=f_res, L=size[0])


def reset_history(dom, wp, Y_initial, Eb, Ep):
    """Virgin material: ep = b = 0, Y = Y_initial at every quadrature
    point (the domain moves the arrays to its device once)."""
    n_el = dom.workpieces[wp].mesh.n_el
    nq = dom.workpieces[wp].disc.n_itg
    dom.user_state = {
        "ep": np.zeros((6, n_el, nq)), "b": np.zeros((6, n_el, nq)),
        "Y": np.full((n_el, nq), float(Y_initial)),
        "Eb": float(Eb), "Ep": float(Ep)}


def commit_history(dom, wp, p):
    """Re-run the return map on the converged strains and store the new
    history (the update_States! step, J2Plasticity.jl:201-208).  Runs on
    the domain's device."""
    e_sym = dom.sym("e")
    e6 = torch.stack([dom.evaluate_at_itg(wp, e_sym[a, b])
                      for (a, b) in _VOIGT])
    u = dom.user_state
    ep_new, b_new, Y_new = radial_return(
        e6, u["ep"], u["b"], u["Y"], p["mu"], p["lam"], u["Eb"], u["Ep"],
        p["f_res"])
    dom.user_state = {**u, "ep": ep_new, "b": b_new, "Y": Y_new}


def run_load_sequence(dom, wp, p, s_tests, Y_initial, Eb, Ep,
                      rate_tol=1e-4, max_relax=60, verbose=False):
    """Dynamic relaxation to steady state at each load level
    (J2Plasticity.jl:244-276); returns the mean end elongation per
    level."""
    # numerically dissipative alpha: the dynamics is only a relaxation
    # vehicle toward the static solution, so damping every mode hard is
    # preferable (the non-dissipative default rings for ~100 steps)
    dom.time_discretization = GeneralAlpha.dissipative()
    mesh = dom.workpieces[wp].mesh
    reset_history(dom, wp, Y_initial, Eb, Ep)
    dom.x = dom.x * 0.0
    dom.t = 0.0
    dom.dt = 1.0
    dom.dessemble_x()
    L = np.nanmax(mesh.cp_coords[:, 0])
    right = mesh.cp_coords[:, 0] > L - 1e-9
    d1s = []
    for s in s_tests:
        dom.set_field(wp, "sl1", np.full(mesh.n_cp, float(s)))
        dom.refresh_fields()
        for it in range(max_relax):
            dom.update_one_step(max_iter=8)
            dom.dessemble_x()
            commit_history(dom, wp, p)
            umax = np.abs(mesh.fields["d1_t"]).max()
            if umax < rate_tol:
                break
        d1s.append(mesh.fields["d1"][right].mean())
        if verbose:
            print(f"load {s}: settled after {it + 1} relaxation steps, "
                  f"d1 = {d1s[-1]:.5f}")
    return np.array(d1s)


#: the reference's cyclic tests and analytic elongations (J2Plasticity.jl)
SEQUENCES = [
    dict(Eb=0.0, Ep=50e3,
         s=[40, 80, 100, 120, 140, 180, 200, 180, 100, 0, -80, -180,
            -200, -220, -240, -200, -100],
         d1=np.array([4, 8, 10, 16, 22, 34, 40, 38, 30, 20, 12, 2, 0,
                      -6, -12, -8, 2]) * 1e-3),
    dict(Eb=25e3, Ep=25e3,
         s=[40, 80, 100, 120, 140, 180, 200, 180, 100, 0, -80, -100,
            -120, -160, -100],
         d1=np.array([4, 8, 10, 16, 22, 34, 40, 38, 30, 20, 12, 10, 4,
                      -8, -2]) * 1e-3),
    dict(Eb=50e3, Ep=0.0,
         s=[40, 80, 100, 120, 140, 180, 200, 180, 140, 100, 80, 40, 0,
            -40, -100, -80, -20],
         d1=np.array([4, 8, 10, 16, 22, 34, 40, 38, 34, 30, 28, 24, 20,
                      8, -10, -8, -2]) * 1e-3),
]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--e-number", type=int, default=2)
    ap.add_argument("--sequence", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dom, wp, p = build(e_number=args.e_number,
                       device="cpu" if args.cpu else None)
    grp = SEQUENCES[args.sequence]
    d1s = run_load_sequence(dom, wp, p, grp["s"], Y_initial=100,
                            Eb=grp["Eb"], Ep=grp["Ep"], verbose=True)
    print("max |d1 - analytic| =", np.abs(d1s - grp["d1"]).max())
