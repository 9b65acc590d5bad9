"""The cylinder-in-duct flow example of the PyTorch port against the
reference package, float64 on the CPU, on a mesh that the test writes
itself: the reference's COMSOL mesh is not in this repository, so
``chip_smoke.write_mphtxt`` writes ``chip_smoke.duct((12, 3, 3))`` (the
2.5 x 0.41 x 0.41 duct less a stepped cylinder, jittered), and both
examples read it (the reference's through its patched ``MESH_PATH``).

SUPG-stabilized u-p Navier-Stokes (C=4 on tets) at the reference test's
own reduced order (``itp_order=1, itg_order=3``, tests/test_cylinder.py:
33), one ``solve`` (six Newton iterations at most):

- with sparse LU in both packages: u1, u2, u3 and p each within 1e-8 *
  max|field| of the reference's;
- with the example's IDR(8) and left Jacobi: each within 10 *
  converge_tol * max|field| (two Krylov runs stop apart by about the
  tolerance times the field's scale), and the residual below the
  example's 1e-6.

Each package builds its domain once; the LU solve runs on the same
domain from zero velocity and pressure.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))
import cylinder_flow_3d as ref_cf  # noqa: E402

import chip_smoke  # noqa: E402
from metafem_torch.examples import cylinder_flow_3d as cf  # noqa: E402

torch.set_num_threads(2)

NEL = (12, 3, 3)
FIELDS = ("u1", "u2", "u3", "p")
#: the example's Newton tolerance (converge_tol)
TOL = 1e-6


def _solve_twice(example, **kw):
    """{solver: (residual, fields)}: the example's build and solve, then
    LU on the same domain from zero velocity and pressure."""
    dom, geo, wp = example.build(itp_order=1, itg_order=3, **kw)
    mesh = dom.workpieces[wp].mesh
    out = {}
    for name in ("idrs", "lu"):
        if name == "lu":
            for f in FIELDS:
                dom.set_field(wp, f, np.zeros(mesh.n_cp))
            dom.t = 0.0
            dom.linear_solver = dom.make_direct_solver()
        res = example.solve(dom, geo, wp)
        out[name] = (res, {f: np.asarray(mesh.fields[f], np.float64).copy()
                           for f in FIELDS})
    return out


@pytest.fixture(scope="module")
def mesh_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("comsol") / "duct.mphtxt")
    chip_smoke.write_mphtxt(path, *chip_smoke.duct(NEL))
    return path


@pytest.fixture(scope="module")
def solutions(mesh_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_cf, "MESH_PATH", mesh_path)
        ref = _solve_twice(ref_cf)
    return ref, _solve_twice(cf, mesh_path=mesh_path, device="cpu")


@pytest.mark.parametrize("solver,bar", [("lu", 1e-8), ("idrs", 10 * TOL)])
def test_cylinder_flow_matches_reference(solutions, solver, bar):
    ref, port = solutions
    r_res, r_fields = ref[solver]
    res, fields = port[solver]
    assert res < TOL and r_res < TOL
    for f in FIELDS:
        scale = np.abs(r_fields[f]).max()
        assert np.abs(fields[f] - r_fields[f]).max() <= bar * scale, f
    assert fields["u1"].max() > 0.5 * cf.UM
