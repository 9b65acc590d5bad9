"""The refined step's two-float (``df32``) residual mode of the PyTorch
port on the reference's nonlinear physics: tests/test_refined.py's
test_refined_step_df32_cavity and
test_refined_step_df32_j2_plasticity_smoke on the port's float32 twins,
with the reference's bars, beside the reference's df32 step on its own
float32 twin (see test_torch_refined_df32.py for the tolerances).

- the cavity at e_number=8 after the reference's float64 Re 100
  continuation: residual below 1e-9, the float64 domain's own residual
  of the df32 root below 5e-9 (the claim of the df32 path), and the
  reference's df32 root within 1e-6 * max|x| (the pressure modulo its
  mean: the enclosed flow leaves its constant free);
- J2 at e_number=1, one relaxation step past first yield: residual
  below 2e-5, x within 2e-4 * max|x| of the float64 direct-solve root
  and within 1e-6 * max|x| of the reference's df32 x.  Most of this
  test's time is the reference's: its df32 step compiles with XLA's
  fusion pass off (the reference's ``_df_jit`` on the CPU).

Refines equal within 1 in both.
"""

import os
import sys

import numpy as np
import torch

import jax.numpy as jnp

from metafem.linsolve import krylov as ref_krylov
from metafem_torch.linsolve import krylov

from test_torch_refined_df32 import _close

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))

torch.set_num_threads(2)


def _cavity_fields():
    """The reference's float64 Re 100 continuation at e_number=8: the
    fields (the taus included) both float32 twins start from."""
    import cavity_2d as ref_cavity
    dom64, _, wp64, params = ref_cavity.build(e_number=8)
    ref_cavity.run_re(dom64, wp64, 100, params)
    mesh = dom64.workpieces[wp64].mesh
    return {k: np.asarray(v) for k, v in mesh.fields.items()}


def _cavity_twin(build, fields, **kw):
    dom, _, wp, _ = build(e_number=8, **kw)
    for name, col in fields.items():
        dom.set_field(wp, name, col)
    dom.refresh_fields()
    dom.assemble_x()
    return dom, wp


CAVITY_STEP = dict(maxiter=1500, max_refine=20, max_pass=3,
                   precond="jacobi", residual_mode="df32")


def test_refined_step_df32_cavity():
    """test_refined_step_df32_cavity on the port: convection under
    SUPG/PSPG in two-float arithmetic over the frozen DF tables."""
    import cavity_2d as ref_cavity
    from metafem_torch.examples import cavity_2d
    fields = _cavity_fields()
    ref, _ = _cavity_twin(ref_cavity.build, fields, dtype=jnp.float32)
    dom, wp = _cavity_twin(cavity_2d.build, fields, device="cpu",
                           dtype=torch.float32)
    for d in (ref, dom):
        d.converge_tol = 1e-9
        d.freeze_linear_tangent()
        d.freeze_refined_residual()
    assert dom._refined["wp_df"] is not None
    x_r, _, res_r, it_r = ref.make_refined_step(
        sv_func=ref_krylov.bicgstabl, s=4, **CAVITY_STEP)(
            ref._runtime_state(), jnp.asarray(ref.x, jnp.float64),
            jnp.float64(0.0), jnp.float64(1.0))
    x, _, res, it = dom.make_refined_step(
        sv_func=krylov.bicgstabl, s=4, **CAVITY_STEP)(
            dom._runtime_state(), dom.x.to(torch.float64), 0.0, 1.0)
    assert res < 1e-9, res
    assert float(res_r) < 1e-9
    assert abs(it - int(it_r)) <= 1, (it, int(it_r))

    # the claim of the df32 path: its root is a float64-quality root of
    # the float64 domain's own residual
    dom64, _ = _cavity_twin(cavity_2d.build, fields, device="cpu")
    dom64.time_discretization.update_time(1.0, dom64.pattern.max_time_level)
    st = dom64._runtime_state()
    st["x_star"] = x
    st["K_linear"] = dom64._k_linear(st)
    r_cross, _ = dom64._res_k(st)
    res_cross = float(torch.linalg.norm(r_cross)) / np.sqrt(
        dom64.pattern.basicfield_size)
    assert res_cross < 5e-9, res_cross

    # against the reference's df32 root: velocity within 1e-6 * max|x|,
    # the pressure modulo its mean over the occupied control points
    occ = torch.as_tensor(np.asarray(
        dom.workpieces[wp].mesh.is_occupied, bool))
    info = dom.pattern.wp_infos[wp]
    la = dom.workpieces[wp].local_assembly
    x_r = torch.as_tensor(np.asarray(x_r))
    scale = float(x_r.abs().max())
    for pos, name in enumerate(la.basic_vars):
        sl = slice(info.dof_offset + pos * info.n_cp,
                   info.dof_offset + (pos + 1) * info.n_cp)
        a, b = x[0, sl][occ], x_r[0, sl][occ]
        if name == "p":
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= 1e-6 * scale, name



def _j2_prep(dom, wp, j2):
    from metafem_torch.solver.time_domain import GeneralAlpha
    dom.time_discretization = GeneralAlpha.dissipative()
    j2.reset_history(dom, wp, Y_initial=100, Eb=25e3, Ep=25e3)
    dom.x = dom.x * 0.0
    dom.t = 0.0
    dom.dt = 1.0
    dom.dessemble_x()
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "sl1", np.full(mesh.n_cp, 140.0))
    dom.refresh_fields()
    dom.assemble_x()


J2_STEP = dict(s=2, maxiter=200, max_refine=40, max_pass=1,
               precond="jacobi", residual_mode="df32", forcing=1e-2,
               stall_ratio=0.97)


def test_refined_step_df32_j2_plasticity_smoke():
    """test_refined_step_df32_j2_plasticity_smoke on the port: the
    radial-return user callback (``user=``) under the two-float lowering,
    in float64 on the quadrature-point arrays."""
    import j2_plasticity as ref_j2
    from metafem.solver.time_domain import GeneralAlpha as RefAlpha
    from metafem_torch.examples import j2_plasticity as j2

    dom64, wp64, _ = j2.build(e_number=1, device="cpu")
    _j2_prep(dom64, wp64, j2)
    dom64.converge_tol = 1e-5
    dom64.linear_solver = dom64.make_direct_solver()
    domf, wpf, _ = j2.build(e_number=1, device="cpu", dtype=torch.float32)
    _j2_prep(domf, wpf, j2)
    domf.converge_tol = 1e-5
    domf.freeze_linear_tangent()
    domf.freeze_refined_residual()
    assert domf._refined["wp_df"] is not None
    res64 = dom64.update_one_step(max_iter=40)
    assert res64 < 1e-5, res64
    x32, _, res32, it = domf.make_refined_step(
        sv_func=krylov.bicgstabl, **J2_STEP)(
            domf._runtime_state(), domf.x.to(torch.float64), 1.0, 1.0)
    assert res32 < 2e-5, res32
    _close(x32, dom64.x.numpy(), 2e-4)

    # the reference's df32 step on its float32 twin
    ref, wpr, _ = ref_j2.build(e_number=1, dtype=jnp.float32)
    ref.time_discretization = RefAlpha.dissipative()
    ref_j2.reset_history(ref, wpr, Y_initial=100, Eb=25e3, Ep=25e3)
    ref.x = ref.x * 0.0
    ref.t, ref.dt = 0.0, 1.0
    ref.dessemble_x()
    ref.set_field(wpr, "sl1", np.full(ref.workpieces[wpr].mesh.n_cp, 140.0))
    ref.refresh_fields()
    ref.assemble_x()
    ref.converge_tol = 1e-5
    ref.freeze_linear_tangent()
    ref.freeze_refined_residual()
    x_r, _, res_r, it_r = ref.make_refined_step(
        sv_func=ref_krylov.bicgstabl, **J2_STEP)(
            ref._runtime_state(), jnp.asarray(ref.x, jnp.float64),
            jnp.float64(1.0), jnp.float64(1.0))
    assert float(res_r) < 2e-5
    _close(x32, np.asarray(x_r), 1e-6)
    assert abs(it - int(it_r)) <= 1, (it, int(it_r))
