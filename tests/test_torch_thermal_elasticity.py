"""Coupled thermo-elasticity of the PyTorch port against the reference
package, float64 on the CPU (``thermal_elasticity_3d`` at e_number=1,
nel=(2,1,1)):

- the variables: (T, d1, d2, d3), first order in time;
- the first five time steps of dt=1: T, d1..d3 and their rates within
  1e-8 * max|field| of the reference after every step with sparse LU in
  both packages, and within 1e-5 * max|value| with the example's solver
  (right-Jacobi BiCGStab(4) to a normalized residual of 1e-6 in each
  package, whose iterates part at about 1e-6 * max|value|; a rate is
  held to its value's scale);
- the steady state: the bars of tests/test_thermal_elasticity.py
  (fewer than 120 steps, tip d2 above 0.01, curvature within 25% of
  alpha dT / h);
- the coupled tangent at e_number=2 on a dense layout
  (``dense_min_n=0``): one group
  of 16 units (every channel pair: the thermal strain's variation puts
  the elastic stress into the T rows), whose packed product equals the
  dense formula bitwise and scipy within 1e-12 * max|y|.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))
import thermal_elasticity_3d as ref_te  # noqa: E402

from metafem_torch.examples import thermal_elasticity_3d as te  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("T", "d1", "d2", "d3", "T_t", "d1_t", "d2_t", "d3_t")


def _heat_reference(dom, wp, Te_hot=300.0):
    """The reference's run_to_steady set-up, without its loop."""
    mesh = dom.workpieces[wp].mesh
    Te = np.zeros(mesh.n_cp)
    Te[np.abs(mesh.cp_coords[:, 1]) < 1e-9] = Te_hot
    dom.set_field(wp, "Te", Te)
    dom.refresh_fields()
    dom.assemble_x()
    dom.dt = 1.0


def test_variables_are_temperature_and_displacement():
    dom, wp = te.build(e_number=1, device="cpu")
    la = dom.workpieces[wp].local_assembly
    assert la.basic_vars == ["T", "d1", "d2", "d3"]
    assert la.max_time_level == 1
    assert dom.x.shape == (2, dom.pattern.basicfield_size)


@pytest.mark.parametrize("solver,tol", [("lu", 1e-8), ("bicgstabl", 1e-5)])
def test_first_steps_match_reference(solver, tol):
    dom_r, wp_r = ref_te.build(e_number=1)
    dom, wp = te.build(e_number=1, device="cpu")
    if solver == "lu":
        dom_r.linear_solver = dom_r.make_direct_solver()
        dom.linear_solver = dom.make_direct_solver()
    mesh_r = dom_r.workpieces[wp_r].mesh
    mesh = dom.workpieces[wp].mesh
    _heat_reference(dom_r, wp_r)
    te.heat_front(dom, wp)
    for step in range(5):
        res_r = dom_r.update_one_step(max_iter=3)
        dom_r.dessemble_x()
        (res,) = te.run_steps(dom, wp, 1)
        assert res < 1e-6 and res_r < 1e-6, (step, res, res_r)
        for name in FIELDS:
            want = np.asarray(mesh_r.fields[name])
            # iterative solves part within their residual tolerance; a
            # rate is the step's increment of its value over dt=1, so the
            # parting of the rates scales with the values
            scale = np.abs(mesh_r.fields[name if solver == "lu"
                                         else name.split("_")[0]]).max()
            np.testing.assert_allclose(
                mesh.fields[name], want, rtol=0, atol=tol * scale,
                err_msg=f"{name}, step {step + 1}")


def test_bending_toward_steady():
    dom, wp = te.build(e_number=1, device="cpu")
    steps = te.run_to_steady(dom, wp)
    assert steps < 120
    d2_tip, kappa, kappa_thermal = te.bending(dom, wp)
    # the heated (y=0) side expands, so the beam bends toward +y
    assert d2_tip > 0.01
    assert abs(kappa - kappa_thermal) < 0.25 * abs(kappa_thermal)


@pytest.fixture(scope="module")
def dense_tangent():
    """The first step's tangent at e_number=2, the smallest bar whose
    lattice (11, 5, 5) holds every one of the 117 stencil offsets."""
    dom, wp = te.build(e_number=2, device="cpu",
                       layout_opts={"dense_min_n": 0})
    te.heat_front(dom, wp)
    A, residue = dom.assemble_tangent()
    return A, residue


def test_coupled_tangent_is_one_group_of_sixteen_units(dense_tangent):
    A, _ = dense_tangent
    lo = A.layout
    assert lo.n_coo == 0
    (grp,) = lo.pallas_groups
    assert grp.n_vars == 4 and grp.n_off == 117
    assert sorted(grp.units) == [(a, b) for a in range(4) for b in range(4)]
    (plan,) = A.pack_plans()
    assert plan.maxu == 4 and plan.n_fill == 0
    assert plan.n_entries == int(A.structural_mask().sum())


def test_coupled_packed_product_matches_dense_formula_and_scipy(
        dense_tangent):
    from metafem_torch.linsolve import offset_spmv
    A, residue = dense_tangent
    (grp,) = A.layout.pallas_groups
    G, n_off, C, n_cp = len(grp.units), grp.n_off, grp.n_vars, grp.n_cp
    (plan,) = A.pack_plans()
    slab = A.vals[grp.base:grp.base + G * n_off * n_cp].view(G, n_off, n_cp)
    csr = A.to_scipy()
    rng = np.random.default_rng(23)
    for x in (rng.standard_normal(A.n), residue.numpy()):
        xt = torch.as_tensor(x)
        xw = xt.view(C, n_cp)
        y = offset_spmv.group_mv(A.packed(0), xw, plan)
        ref = offset_spmv.group_mv_plain(slab, xw, grp, torch.empty_like(y))
        assert torch.equal(y, ref)
        y_sp = csr @ x
        np.testing.assert_allclose(A.mv(xt).numpy(), y_sp, rtol=1e-12,
                                   atol=1e-12 * np.abs(y_sp).max())
