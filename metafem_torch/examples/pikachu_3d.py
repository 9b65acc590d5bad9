"""3D steady + transient thermal conduction on the pikachu tet mesh — the
reference's flagship example (docs/src/examples/src/pikachu/pikachu.jl,
examples/thermal_conduction/3D_Script.jl and 3D_Script_Dynamics.jl),
validated against COMSOL line data (COMSOL_a.csv / COMSOL_b.csv).

The COMSOL mesh (in centimetres) and the oracle CSVs are read from the
reference checkout (MESH_PATH, REF_DIR).  ``mesh_path=`` (or ``--mesh
FILE``) reads another .mphtxt tet mesh, e.g. the jittered brick of
``chip_smoke.write_mphtxt(path, *chip_smoke.pikachu_brick_cm(nel))``:

    python3 -m metafem_torch.examples.pikachu_3d --cpu --mesh brick.mphtxt

Without the COMSOL CSVs beside the mesh the line comparison is skipped.
"""

import argparse
import os

import numpy as np

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.solver.domain import FEM_Domain
from metafem_torch.solver.time_domain import GeneralAlpha  # noqa: F401

REF_DIR = "/root/reference/examples/thermal_conduction"
MESH_PATH = os.path.join(REF_DIR, "3D_COMSOL_Mesh.mphtxt")

K_COND, H_CONV, T_ENV, SOURCE = 0.6, 25.0, 273.15 + 20, 1600.0


def build(itp_order=2, itg_order=5, dynamic=False, C=1.0, refine=0,
          dtype=None, mesh_path=None, device=None):
    """(domain, geometry, mesh) at the ambient temperature, compiled;
    the mesh is ``mesh_path`` (default MESH_PATH), its coordinates in
    centimetres."""
    vert, conn = mf.read_mesh(mesh_path or MESH_PATH)
    vert = np.asarray(vert) / 100.0
    for _ in range(refine):        # uniform splits toward the 1M-DOF target
        vert, conn = mf.refine_simplex(vert, conn)
    geo = mf.construct_total_mesh(vert, conn)

    dom = (FEM_Domain(3, device=device) if dtype is None
           else FEM_Domain(3, dtype=dtype, device=device))
    wp = dom.add_workpiece(geo)
    bg = dom.add_boundary(wp, geo.boundary_facet_ids())

    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    i = mf.index("i")
    wf = -K_COND * Bilinear(T.d(i), T.d(i)) + Bilinear(T, s)
    if dynamic:
        wf = wf - C * Bilinear(T, T.dt())
    dom.assign_workpiece_weakform(wp, wf)
    dom.assign_boundary_weakform(wp, bg,
                                 H_CONV * Bilinear(T, T_ENV - T))
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=itp_order, itg_order=itg_order)
    dom.assemble_global_variables()
    dom.compile()
    dom.converge_tol = 1e-6

    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "T", np.full(mesh.n_cp, T_ENV))
    dom.set_field(wp, "s", np.full(mesh.n_cp, SOURCE))
    dom.refresh_fields()
    dom.assemble_x()
    return dom, geo, mesh


def comsol_lines(ref_dir=None):
    """[(arc_length, temperature, points)] for lines a and b."""
    out = []
    for name in ("COMSOL_a.csv", "COMSOL_b.csv"):
        raw = np.genfromtxt(os.path.join(ref_dir or REF_DIR, name),
                            delimiter=",", skip_header=1)
        arc, temp = raw[:, 2], raw[:, 0]
        pts = raw[:, 3:6] / 100.0          # cm -> m, matches mesh scaling
        out.append((arc, temp, pts))
    return out


def solve_static(verbose=False, **kw):
    dom, geo, mesh = build(**kw)
    res = dom.update_one_step(max_iter=4, verbose=verbose)
    dom.dessemble_x()
    return dom, geo, mesh, res


def main(argv=None) -> None:
    from metafem_torch.mesh.probe import probe_field

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mesh", help="the .mphtxt mesh (default: MESH_PATH)")
    args = ap.parse_args(argv)
    ref_dir = os.path.dirname(args.mesh) if args.mesh else REF_DIR
    dom, geo, mesh, res = solve_static(
        verbose=True, mesh_path=args.mesh,
        device="cpu" if args.cpu else None)
    print(f"residue = {res:.3e}, n_cp = {mesh.n_cp}, "
          f"T range = [{mesh.fields['T'].min():.2f}, "
          f"{mesh.fields['T'].max():.2f}]")
    if not all(os.path.exists(os.path.join(ref_dir, f"COMSOL_{x}.csv"))
               for x in "ab"):
        print(f"COMSOL_a.csv / COMSOL_b.csv: not found in {ref_dir}; "
              f"COMSOL comparison skipped")
        return
    et = dom.workpieces[0].disc.element_type
    for label, (arc, temp, pts) in zip("ab", comsol_lines(ref_dir)):
        got = probe_field(geo, mesh, et, "T", pts)
        ok = ~np.isnan(got)
        err = np.abs(got[ok] - temp[ok])
        print(f"line {label}: {ok.sum()}/{len(pts)} points inside, "
              f"max |dT| = {err.max():.3f} K, "
              f"mean |dT| = {err.mean():.3f} K")


if __name__ == "__main__":
    main()
