"""The pikachu thermal example of the PyTorch port against the reference
package, float64 on the CPU, on a mesh that the test writes itself: the
reference's COMSOL mesh is not in this repository, so
``chip_smoke.write_mphtxt`` writes the jittered 5-tet brick of
``pikachu_brick`` at nel=(3, 2, 2) in centimetres, and both examples read
it (the reference's through its patched ``MESH_PATH``) and divide it by
100.

- the steady solve (``solve_static``) at refine=0 and refine=1 (order 2,
  C=1, a scalar COO tail at these sizes): T within 1e-5 *
  max|T - T_ENV| of the reference's with the example's solver
  (right-Jacobi BiCGStab, Newton tolerance 1e-6), and within 1e-9 with
  sparse LU in both packages on the same domains, from the ambient
  start;
- three transient steps (``dynamic=True``, C=4.184e3,
  ``GeneralAlpha.dissipative()``, dt=200, refine=0): T after each step
  within the same bars, with the example's solver and with LU, and the
  maxima strictly increasing as the reference test asks.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))
import pikachu_3d as ref_pk  # noqa: E402

import chip_smoke  # noqa: E402
from metafem_torch.examples import pikachu_3d as pk  # noqa: E402

torch.set_num_threads(2)

NEL = (3, 2, 2)
#: the example's Newton tolerance (converge_tol) and the bars
TOL = 1e-6
BAR = {"example": 1e-5, "lu": 1e-9}


@pytest.fixture(scope="module")
def mesh_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("comsol") / "brick.mphtxt")
    chip_smoke.write_mphtxt(path, *chip_smoke.pikachu_brick_cm(NEL))
    return path


def _t(mesh):
    return np.asarray(mesh.fields["T"], np.float64).copy()


def _lu_again(dom, x0, steps=1, max_iter=4):
    """The same domain from its start x0 with sparse LU: T after each of
    ``steps`` steps."""
    dom.x = x0
    dom.t = 0.0
    dom.linear_solver = dom.make_direct_solver()
    out = []
    for _ in range(steps):
        dom.update_one_step(max_iter=max_iter)
        dom.dessemble_x()
        out.append(_t(dom.workpieces[0].mesh))
    return out


def _static(example, refine, **kw):
    """T of ``solve_static`` (the example's solver), then T by LU."""
    dom, _, mesh = example.build(refine=refine, **kw)
    x0 = dom.x
    res = dom.update_one_step(max_iter=4)
    dom.dessemble_x()
    return res, _t(mesh), _lu_again(dom, x0)[0], mesh.n_cp


def _transient(example, **kw):
    """T after each of three transient steps, by the example's solver
    and by LU."""
    dom, _, mesh = example.build(dynamic=True, C=4.184e3, **kw)
    dom.time_discretization = example.GeneralAlpha.dissipative()
    dom.dt = 200.0
    x0 = dom.x
    temps = []
    for _ in range(3):
        dom.update_one_step(max_iter=3)
        dom.dessemble_x()
        temps.append(_t(mesh))
    dom.time_discretization = example.GeneralAlpha.dissipative()
    return temps, _lu_again(dom, x0, steps=3, max_iter=3)


@pytest.fixture(scope="module")
def reference(mesh_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_pk, "MESH_PATH", mesh_path)
        return {"static": {r: _static(ref_pk, r) for r in (0, 1)},
                "transient": _transient(ref_pk)}


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b - pk.T_ENV).max())


@pytest.mark.parametrize("refine", [0, 1])
def test_steady_matches_reference(mesh_path, reference, refine):
    res, T, T_lu, n_cp = _static(pk, refine, mesh_path=mesh_path,
                                 device="cpu")
    r_res, r_T, r_T_lu, r_n_cp = reference["static"][refine]
    assert n_cp == r_n_cp
    assert res < TOL and r_res < TOL
    assert _rel(T, r_T) <= BAR["example"]
    assert _rel(T_lu, r_T_lu) <= BAR["lu"]
    assert T.max() > pk.T_ENV + 1.0


def test_transient_matches_reference(mesh_path, reference):
    temps, temps_lu = _transient(pk, mesh_path=mesh_path, device="cpu")
    r_temps, r_temps_lu = reference["transient"]
    for T, r_T in zip(temps, r_temps):
        assert _rel(T, r_T) <= BAR["example"]
    for T, r_T in zip(temps_lu, r_temps_lu):
        assert _rel(T, r_T) <= BAR["lu"]
    maxima = [pk.T_ENV] + [T.max() for T in temps]
    assert all(b > a for a, b in zip(maxima, maxima[1:]))
