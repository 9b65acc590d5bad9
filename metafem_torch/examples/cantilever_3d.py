"""3D linear-elasticity cantilever, MetaFEM.jl's vector-DOF benchmark
(examples/linear_elasticity/cantilever/3D_Script.jl): a 10x1x1 beam fixed
at x=0 by penalty, loaded by a traction at the free end, validated
against the Euler-Bernoulli analytic deflection (3D_Script.jl:116-151).

Run as ``python -m metafem_torch.examples.cantilever_3d`` (CUDA) or with
``--cpu``.
"""

import sys

import numpy as np
import torch

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.solver.domain import FEM_Domain


def solve(e_number=4, LW_ratio=10, load_case="shear", itp_order=2,
          itp_type="Serendipity", verbose=False, device=None,
          dtype=torch.float64, layout_opts=None):
    """One Newton step of the loaded beam; returns (domain, mesh, final
    residual, parameters).  ``layout_opts`` forward to
    ``assemble_global_variables`` (e.g. ``{"dense_min_n": 0}`` forces
    dense block-offset segments at a small size)."""
    L_box = 1.0
    size = (L_box * LW_ratio, L_box, L_box)
    nel = (int(e_number * LW_ratio / 4), e_number, e_number)
    vert, conn = mf.make_brick(size, nel)
    geo = mf.construct_total_mesh(vert, conn)

    dom = FEM_Domain(3, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    eps_g = L_box / e_number * 0.01
    left = mf.select_facets(geo, lambda c: c[:, 0] < eps_g)
    right = mf.select_facets(geo, lambda c: c[:, 0] > size[0] - eps_g)
    back = mf.select_facets(geo, lambda c: c[:, 1] > L_box - eps_g)
    bg_fix = dom.add_boundary(wp, left)
    bg_right = dom.add_boundary(wp, right)
    bg_back = dom.add_boundary(wp, back)

    E, nu = 1.0, 0.001
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    tau_b = 1000 * E / L_box ** 2

    d = dom.internal_var("d")
    dw = dom.external_var("dw", "CONTROLPOINT_VAR")
    sl = dom.external_var("sl", "CONTROLPOINT_VAR", "SYMMETRIC_TENSOR")
    s2 = dom.external_var("s2", "CONTROLPOINT_VAR", "SYMMETRIC_TENSOR")
    n = dom.sym("n")
    delta = dom.sym("delta")
    i, j, m = mf.indices("i j m")

    eps = dom.define("eps", [i, j], (d[i].d(j) + d[j].d(i)) / 2.0)
    sig = dom.define("sig", [i, j],
                     lam * delta[i, j] * eps[m, m] + 2.0 * mu * eps[i, j])

    dom.assign_workpiece_weakform(wp, -Bilinear(eps[i, j], sig[i, j]))
    dom.assign_boundary_weakform(
        wp, bg_fix, tau_b * Bilinear(d[i], dw[i] - d[i]))
    dom.assign_boundary_weakform(
        wp, bg_right, Bilinear(d[i], sl[i, j] * n[j]))
    dom.assign_boundary_weakform(
        wp, bg_back, Bilinear(d[i], s2[i, j] * n[j]))

    dom.initialize_local_assembly()
    dom.mesh_classical(itp_order=itp_order, itg_order=5, itp_type=itp_type)
    dom.assemble_global_variables(**(layout_opts or {}))
    dom.compile()
    dom.converge_tol = 1e-5

    mesh = dom.workpieces[wp].mesh
    sigma_external = 1e6
    if load_case == "shear":
        # sigma_xy traction on the end face -> transverse tip load
        dom.set_field(wp, "sl6", np.full(mesh.n_cp, sigma_external))
    elif load_case == "axial":
        dom.set_field(wp, "sl1", np.full(mesh.n_cp, sigma_external))
    elif load_case == "pressure_back":
        # uniform normal load on the back face (distributed line load)
        dom.set_field(wp, "s22", np.full(mesh.n_cp, sigma_external))
    dom.refresh_fields()
    dom.assemble_x()

    res = dom.update_one_step(max_iter=4, verbose=verbose)
    dom.dessemble_x()
    return dom, mesh, res, dict(E=E, nu=nu, L=size[0], h=L_box,
                                sigma=sigma_external)


def midline(mesh, field):
    """Values of ``field`` along the beam axis (x2 = x3 = h/2)."""
    c = mesh.cp_coords
    sel = (np.abs(c[:, 1] - 0.5) < 1e-6) & (np.abs(c[:, 2] - 0.5) < 1e-6)
    xs = c[sel, 0]
    vals = mesh.fields[field][sel]
    order = np.argsort(xs)
    return xs[order], vals[order]


def shear_error(mesh, p) -> float:
    """Largest deviation of the midline deflection from Euler-Bernoulli,
    relative to the largest analytic deflection."""
    xs, d2 = midline(mesh, "d2")
    I = p["h"] ** 3 / 12.0
    ana = (p["sigma"] * p["h"] / (6 * p["E"] * I)
           * (3 * p["L"] - xs) * xs ** 2)
    return float(np.abs(d2 - ana).max() / np.abs(ana).max())


if __name__ == "__main__":
    dom, mesh, res, p = solve(verbose=True,
                              device="cpu" if "--cpu" in sys.argv else None)
    print(f"residue = {res:.3e}, max rel err vs Euler-Bernoulli = "
          f"{shear_error(mesh, p):.4f}")
