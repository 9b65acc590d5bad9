"""The first 3D vector-valued paths of the PyTorch port against the
reference package, float64 on the CPU:

- ``cantilever_3d`` at e_number=2 (linear elasticity, C=3), shear and
  axial loads: x within 1e-8 * max|x| of the reference, and the
  analytic oracles at the reference test's bars (2% Euler-Bernoulli,
  5e-3 axial);
- ``hyperelastic_3d`` at e_number=2, one Neo-Hookean load step with
  right-Jacobi BiCGStab(4): the end displacement d1/L within 1e-8
  relative of the reference, and within 2% of the analytic uniaxial
  curve (the reference test's bar);
- ``update_one_step_jit`` against the host loop and the reference's
  jitted step on tests/test_solver.py's small thermal domain;
- the jitted step with the lattice multigrid preconditioner on the
  order-1 Lagrange brick of tests/test_lattice3d.py, against the host
  loop and the reference's jitted step, and with the frozen multigrid
  state and linear tangent (``reuse_mg``, ``static_k_linear``);
- ``make_direct_solver`` in the Newton loop of both packages.

The dense-layout load step (G=9 units of 117 offsets) is in
test_torch_elastic3d_dense.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))
import cantilever_3d as ref_cantilever  # noqa: E402
import hyperelastic_3d as ref_hyper  # noqa: E402

from metafem.linsolve import krylov as ref_krylov  # noqa: E402
import metafem_torch as mf  # noqa: E402
from metafem_torch import Bilinear  # noqa: E402
from metafem_torch.examples import cantilever_3d, hyperelastic_3d  # noqa
from metafem_torch.linsolve import krylov  # noqa: E402
from metafem_torch.solver.domain import FEM_Domain  # noqa: E402

from test_lattice3d import _brick_thermal  # noqa: E402
from test_solver import _thermal_domain  # noqa: E402

torch.set_num_threads(2)


def _close(got, want, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("load_case", ["shear", "axial"])
def test_cantilever_matches_reference(load_case):
    dom_r, _, res_r, p = ref_cantilever.solve(e_number=2,
                                              load_case=load_case)
    dom, mesh, res, p_port = cantilever_3d.solve(e_number=2,
                                                 load_case=load_case,
                                                 device="cpu")
    assert p_port == p
    assert dom.pattern.offset_layout.pallas_groups[0].n_vars == 3
    assert res < 1e-5 and res_r < 1e-5, (res, res_r)
    _close(dom.x, dom_r.x, 1e-8)
    if load_case == "shear":
        assert cantilever_3d.shear_error(mesh, p) < 0.02
    else:
        xs, d1 = cantilever_3d.midline(mesh, "d1")
        ana = p["sigma"] * xs / p["E"]
        assert np.abs(d1 - ana).max() / np.abs(ana).max() < 5e-3


def hyper_load_step(ref_build, port_layout=None):
    """One Neo-Hookean load step (4e5) of the reference's example (built
    by ``ref_build``) and of the port's (with ``port_layout``); returns
    (reference d1/L, port d1/L, port residual, port domain)."""
    mu, lam, sigma = 1e6, 1e6, 4e5
    dom_r, wp_r, _ = ref_build()
    _, d_r = ref_hyper.run_loading(dom_r, wp_r, mu, lam, total_steps=1,
                                   sigma_step=sigma)
    dom, wp, _ = hyperelastic_3d.build(e_number=2, device="cpu",
                                       layout_opts=port_layout)
    hyperelastic_3d.set_material(dom, mu, lam)
    res, d1 = hyperelastic_3d.load_step(dom, wp, sigma)
    return float(d_r[0]), d1, res, dom


def check_hyper_step(d_r, d1, res):
    assert res < 1e-5, res
    assert abs(d1 - d_r) <= 1e-8 * abs(d_r), (d1, d_r)
    ana = hyperelastic_3d.analytic_uniaxial_nh(4e5, 1e6, 1e6)
    assert abs(d1 - ana) / abs(ana) < 0.02


def test_hyperelastic_load_step_matches_reference():
    d_r, d1, res, dom = hyper_load_step(
        lambda: ref_hyper.build(e_number=2))
    lo = dom.pattern.offset_layout
    assert lo.n_coo > 0         # n_cp = 1,025 < dense_min_n: COO tail
    assert all(it > 0 for it, _ in dom.solve_log)
    check_hyper_step(d_r, d1, res)


def _port_thermal(nel=(4, 3)):
    """The port's twin of test_solver._thermal_domain(with_boundary=True)."""
    L = (float(nel[0]), float(nel[1]))
    vert, conn = mf.make_square(L, nel)
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(2, device="cpu")
    wp = dom.add_workpiece(geo)
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    i = mf.index("i")
    dom.assign_workpiece_weakform(
        wp, -1.0 * Bilinear(T.d(i), T.d(i)) + Bilinear(T, s))
    n = dom.sym("n")
    bg = dom.add_boundary(wp, geo.boundary_facet_ids())
    dom.assign_boundary_weakform(
        wp, bg, 10.0 * Bilinear(T, 1.0 - T) + 1.0 * Bilinear(T, n[i] * T.d(i)))
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=1, itg_order=3, itp_type="Lagrange")
    dom.assemble_global_variables()
    dom.compile()
    return dom, wp


def test_jitted_step_matches_host_loop_and_reference():
    """tests/test_solver.py's TestJittedStep on both packages: the port's
    update_one_step_jit lands on its host loop's x and on the
    reference's jitted step's x."""
    xs = {}
    for pkg, make in (("ref", lambda: _thermal_domain(nel=(4, 3),
                                                      with_boundary=True)),
                      ("port", _port_thermal)):
        dom, wp = make()
        mesh = dom.workpieces[wp].mesh
        dom.converge_tol = 1e-10
        dom.set_field(wp, "T", np.full(mesh.n_cp, 0.5))
        dom.refresh_fields()
        dom.assemble_x()
        x0 = dom.x
        if pkg == "port":
            assert dom.update_one_step(max_iter=6) < 1e-10
            x_host = dom.x.numpy()
            dom.x = x0
            dom.t -= dom.dt
        res_jit = dom.update_one_step_jit(max_iter=6, maxiter=5000)
        assert res_jit < 1e-9
        xs[pkg] = np.asarray(dom.x)
    np.testing.assert_allclose(xs["port"], x_host, rtol=1e-7, atol=1e-9)
    _close(xs["port"], xs["ref"], 1e-8)
    assert len(dom.solve_log) > 0


def _port_brick():
    """The port's twin of test_lattice3d._brick_thermal(itp_order=1,
    itp_type='Lagrange')."""
    L = 1.0
    vert, conn = mf.make_brick((L, L, L), (8, 8, 8))
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(3, device="cpu")
    wp = dom.add_workpiece(geo)
    eps = 1e-9
    bot = mf.select_facets(geo, lambda c: c[:, 2] < eps)
    top = mf.select_facets(geo, lambda c: c[:, 2] > L - eps)
    bg_b = dom.add_boundary(wp, bot)
    bg_t = dom.add_boundary(wp, top)
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    i = mf.index("i")
    dom.assign_workpiece_weakform(
        wp, -3.0 * Bilinear(T.d(i), T.d(i)) + Bilinear(T, s))
    dom.assign_boundary_weakform(wp, bg_b,
                                 1000.0 * Bilinear(T, 800.0 - T))
    dom.assign_boundary_weakform(wp, bg_t, 50.0 * Bilinear(T, 300.0 - T))
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=1, itg_order=3, itp_type="Lagrange")
    dom.assemble_global_variables()
    dom.compile()
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "T", np.full(mesh.n_cp, 300.0))
    dom.set_field(wp, "s", np.full(mesh.n_cp, 100.0))
    dom.refresh_fields()
    dom.assemble_x()
    return dom


def test_3d_mg_jitted_step_matches_host_loop_and_reference():
    """test_lattice3d's _mg_step_roundtrip on the order-1 Lagrange brick:
    the multigrid-preconditioned jitted step converges to 1e-8, agrees
    with the host loop within 1e-6 * max|x| (the reference test's bar)
    and with the reference's jitted step within 1e-8 * max|x|."""
    kw = dict(maxiter=60, max_newton=5, max_pass=2, precond="mg")
    ref = _brick_thermal(itp_order=1, itp_type="Lagrange")
    ref.converge_tol = 1e-8
    step_r = ref.make_jitted_step(sv_func=ref_krylov.bicgstab, **kw)
    x_r, _, res_r, _ = step_r(ref._runtime_state(), ref.x,
                              jnp.float64(0.0), jnp.float64(1.0))
    dom = _port_brick()
    dom.converge_tol = 1e-8
    step = dom.make_jitted_step(sv_func=krylov.bicgstab, **kw)
    x_new, _, res, it = step(dom._runtime_state(), dom.x, 0.0, 1.0)
    assert res < 1e-8 and float(res_r) < 1e-8, (res, float(res_r))
    _close(x_new, x_r, 1e-8)
    # the multigrid state frozen by setup_mg (reuse_mg) and the linear
    # tangent frozen by freeze_linear_tangent (static_k_linear) at the
    # same x give the per-step setup's x
    dom.setup_mg(tune=False)
    dom.freeze_linear_tangent()
    step_f = dom.make_jitted_step(sv_func=krylov.bicgstab, reuse_mg=True,
                                  static_k_linear=True, **kw)
    x_f, _, res_f, _ = step_f(dom._runtime_state(), dom.x, 0.0, 1.0)
    assert res_f < 1e-8
    _close(x_f, x_new, 1e-12)
    assert dom.update_one_step(max_iter=5) < 1e-6
    _close(x_new, dom.x, 1e-6)


def test_direct_solver_step_matches_reference():
    """make_direct_solver (host LU) in the Newton loop of both packages
    on the small thermal domain, converged to 1e-10."""
    xs = {}
    for pkg, make in (("ref", lambda: _thermal_domain(nel=(4, 3),
                                                      with_boundary=True)),
                      ("port", _port_thermal)):
        dom, wp = make()
        dom.linear_solver = dom.make_direct_solver()
        dom.converge_tol = 1e-10
        dom.set_field(wp, "T", np.full(dom.workpieces[wp].mesh.n_cp, 0.5))
        dom.refresh_fields()
        dom.assemble_x()
        assert dom.update_one_step(max_iter=6) < 1e-10
        xs[pkg] = np.asarray(dom.x)
    _close(xs["port"], xs["ref"], 1e-10)


def test_unported_options_raise():
    """rowshard_mesh takes a DeviceMesh and refuses anything else; on a
    one-rank gloo group (a HashStore, no ranks spawned) the row-sharded
    refined multigrid step is bitwise the unsharded one, since every
    collective is an identity.  The auxiliary-space solver refuses to
    solve before setup_auxmg."""
    import torch.distributed as dist
    from metafem_torch.parallel import shard_domain_state
    from metafem_torch.parallel.dataparallel import make_mesh
    dom, wp = _port_thermal(nel=(12, 8))
    with pytest.raises(TypeError, match="DeviceMesh"):
        dom.make_jitted_step(rowshard_mesh=object())
    solve = dom.make_iterative_solver(precond="auxmg")
    A, residue = dom.assemble_tangent()
    with pytest.raises(RuntimeError, match="setup_auxmg"):
        solve(A, residue)
    dom.set_field(wp, "s", np.linspace(0.5, 2.0, dom.workpieces[wp].mesh.n_cp))
    dom.refresh_fields()
    dom.converge_tol = 1e-10
    dom.freeze_linear_tangent()
    dom.setup_mg(tune=False)
    dom.freeze_refined_residual()
    kw = dict(sv_func=krylov.bicgstab, maxiter=60, max_refine=10,
              precond="mg")
    state = dom._runtime_state()
    x0, _, res0, it0 = dom.make_refined_step(**kw)(state, dom.x, 0.0, 1.0)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        step = dom.make_refined_step(rowshard_mesh=mesh, **kw)
        x1, _, res1, it1 = step(shard_domain_state(state, mesh), dom.x,
                                0.0, 1.0)
    finally:
        dist.destroy_process_group()
    assert res0 < 1e-10 and it1 == it0 and res1 == res0
    assert torch.equal(x1, x0)
