"""Steady thermal conduction on a 2D strip — MetaFEM.jl's first example
(examples/thermal_conduction/2D_Script.jl): fixed-temperature ends via
penalty + consistency weak boundary, convective + radiative top, validated
against FEATool samples along the mid line.

Run as ``python -m metafem_torch.examples.thermal_2d`` (CUDA) or with
``--cpu``.
"""

import sys

import numpy as np
import torch

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.mesh.builders import make_square, select_facets
from metafem_torch.mesh.ref_geometry import construct_total_mesh
from metafem_torch.solver.domain import FEM_Domain

T0 = 273.15
Tenv = 50.0 + T0


def build(nel=(40, 20), itp_order=2, itp_type="Serendipity", device=None,
          dtype=torch.float64):
    """The compiled domain and its mesh, T at the ambient temperature."""
    dim = 2
    L1, L2 = 0.02, 0.01
    vert, conn = make_square((L1, L2), nel)
    geo = construct_total_mesh(vert, conn)

    dom = FEM_Domain(dim, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    eps = 1e-9
    ends = select_facets(geo, lambda c: (c[:, 0] < eps)
                         | (c[:, 0] > L1 - eps))
    top = select_facets(geo, lambda c: c[:, 1] > L2 - eps)
    bg_fix = dom.add_boundary(wp, ends)
    bg_top = dom.add_boundary(wp, top)

    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    n = dom.sym("n")
    i = mf.index("i")

    k, h, Tw, h_pen = 3.0, 50.0, 900.0 + T0, 1000.0
    em, sb = 0.7, 5.669e-8

    dom.assign_workpiece_weakform(
        wp, -k * Bilinear(T.d(i), T.d(i)) + Bilinear(T, s))
    dom.assign_boundary_weakform(
        wp, bg_fix, h_pen * Bilinear(T, Tw - T)
        + k * Bilinear(T, n[i] * T.d(i)))
    dom.assign_boundary_weakform(
        wp, bg_top, h * Bilinear(T, Tenv - T)
        + em * sb * Bilinear(T, Tenv ** 4 - T ** 4))

    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=itp_order, itg_order=5, itp_type=itp_type)
    dom.assemble_global_variables()
    dom.compile()
    dom.converge_tol = 1e-6
    mesh = dom.workpieces[wp].mesh
    initial_state(dom, mesh)
    return dom, mesh


def initial_state(dom, mesh):
    """Set T to the ambient temperature everywhere and load it into x
    (the same x, bit for bit, on every call)."""
    dom.set_field(0, "T", np.full(mesh.n_cp, Tenv))
    dom.refresh_fields()
    dom.assemble_x()


def step(dom, verbose=False) -> float:
    """One Newton step (at most 6 iterations); T lands in the mesh
    fields.  Returns the final normalized residual."""
    res = dom.update_one_step(max_iter=6, verbose=verbose)
    dom.dessemble_x()
    return res


def solve(nel=(40, 20), itp_order=2, itp_type="Serendipity", verbose=False,
          device=None, dtype=torch.float64):
    dom, mesh = build(nel, itp_order, itp_type, device, dtype)
    return dom, mesh, step(dom, verbose)


# FEATool reference samples along x = L1/2 (2D_Script.jl:95-96)
FEATOOL_Y = np.array([0.0001, 0.001, 0.002, 0.003, 0.004, 0.005, 0.006,
                      0.007, 0.008, 0.009, 0.0099])
FEATOOL_T = np.array([1086.84, 1086, 1082.73, 1077.63, 1070.24, 1060.78,
                      1048.83, 1034.63, 1017.81, 998.843, 979.249])


def midline_temperature(mesh):
    x, y = mesh.cp_coords[:, 0], mesh.cp_coords[:, 1]
    sel = np.abs(x - 0.01) < 1e-7
    ys = y[sel]
    Ts = mesh.fields["T"][sel]
    order = np.argsort(ys)
    return ys[order], Ts[order]


def featool_error(mesh) -> float:
    """Largest relative deviation from the FEATool samples."""
    ys, Ts = midline_temperature(mesh)
    Ti = np.interp(FEATOOL_Y, ys, Ts)
    return float((np.abs(Ti - FEATOOL_T) / FEATOOL_T).max())


if __name__ == "__main__":
    dom, mesh, res = solve(verbose=True,
                           device="cpu" if "--cpu" in sys.argv else None)
    print(f"final residue = {res:.3e}")
    print(f"max rel deviation vs FEATool = {featool_error(mesh):.4f}")
