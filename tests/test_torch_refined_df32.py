"""The refined step's two-float (``df32``) residual mode of the PyTorch
port against the reference package on the strip of tests/test_refined.py
(``_radiating_thermal``, nel=(16, 8)): its default-tier df32 tests
test_refined_step_df32_mode and test_refined_step_df32_volume_nonlinear
on the port's float32 twins, with the reference's own bars, beside the
reference's df32 step on its own float32 twin.  The cavity and J2 df32
tests are in test_torch_refined_df32_physics.py.

Bars (the reference's): residual below 1e-8, x within 2e-5 * max|x| of
the float64-mode step on a float64 twin.

Added here:
- the port's df32 x against the reference's df32 x on the same float32
  twin within 1e-6 * max|x| (both converge that far below the bar that
  the two float32 tangents and solves leave), with refines equal within
  1;
- with the reference's freezes loaded (``interop.load_reference_freezes``:
  K_linear_td, the A_td/b pairs themselves, bnd_dofs or wp_df, the
  multigrid state) the port's step lands on the reference's x after the
  same number of refines, within 1e-9 * max|x|: the residuals agree to
  their two-float rounding, but the float32 tangents and BiCGStab's
  float32 iterates differ at float32 rounding (the port's dots sum their
  blocks in float64), so each refine's correction differs at ~1e-7 of
  itself, and the converged x keeps ~1e-9 of that;
- a DF in gives a DF out, with the bits of the float64-in call.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metafem.linsolve import krylov as ref_krylov
from metafem.linsolve import twofloat as rtf
from metafem_torch import interop
from metafem_torch.linsolve import krylov
from metafem_torch.linsolve import twofloat as tf

from test_refined import _radiating_thermal
from test_torch_refined import _port_radiating

torch.set_num_threads(2)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = (got.double().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float64))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _freeze(d, mg=True):
    d.freeze_linear_tangent()
    if mg:
        d.setup_mg()
    d.freeze_refined_residual()


@functools.lru_cache(maxsize=None)
def _strip_steps(nonlinear_volume):
    """(port f32 df32 x, its refines, reference f32 df32 x, its refines,
    port f64-mode x on the f64 twin, the port's f32 domain and step)."""
    max_refine = 16 if nonlinear_volume else 14
    ref = _radiating_thermal(dtype=jnp.float32,
                             nonlinear_volume=nonlinear_volume)
    dom = _port_radiating(dtype=torch.float32,
                          nonlinear_volume=nonlinear_volume)
    for d in (ref, dom):
        d.converge_tol = 1e-8
        _freeze(d)
    assert (dom._refined["wp_df"] is not None) == nonlinear_volume
    step_r = ref.make_refined_step(sv_func=ref_krylov.bicgstab, maxiter=60,
                                   max_refine=max_refine,
                                   residual_mode="df32")
    x_r, _, res_r, it_r = step_r(ref._runtime_state(),
                                 ref.x.astype(jnp.float64),
                                 jnp.float64(0.0), jnp.float64(1.0))
    assert float(res_r) < 1e-8
    step = dom.make_refined_step(sv_func=krylov.bicgstab, maxiter=60,
                                 max_refine=max_refine, residual_mode="df32")
    x, _, res, it = step(dom._runtime_state(), dom.x.to(torch.float64),
                         0.0, 1.0)
    dom64 = _port_radiating(nonlinear_volume=nonlinear_volume)
    dom64.converge_tol = 1e-11
    _freeze(dom64)
    x64, _, res64, _ = dom64.make_refined_step(
        sv_func=krylov.bicgstab, maxiter=60, max_refine=max_refine)(
            dom64._runtime_state(), dom64.x, 0.0, 1.0)
    assert res64 < 1e-11, res64
    return (x, it, res, np.asarray(x_r), int(it_r), x64, dom, step)


@pytest.mark.parametrize("nonlinear_volume", [False, True],
                         ids=["df32_mode", "df32_volume_nonlinear"])
def test_refined_step_df32_matches_f64_mode_and_reference(nonlinear_volume):
    """test_refined_step_df32_mode and
    test_refined_step_df32_volume_nonlinear on the port."""
    x, it, res, x_r, it_r, x64, _, _ = _strip_steps(nonlinear_volume)
    assert x.dtype == torch.float64
    assert res < 1e-8, res
    _close(x, x64, 2e-5)
    _close(x, x_r, 1e-6)
    assert abs(it - it_r) <= 1, (it, it_r)


def test_refined_step_df32_pair_in_pair_out():
    x, it, res, _, _, _, dom, step = _strip_steps(False)
    x0 = tf.df_from_f64(dom.x.to(torch.float64))
    xd, dx, res_d, it_d = step(dom._runtime_state(), x0, 0.0, 1.0)
    assert isinstance(xd, tf.DF) and isinstance(dx, tf.DF)
    assert xd.hi.dtype == xd.lo.dtype == torch.float32
    assert (res_d, it_d) == (res, it)
    assert torch.equal(tf.df_to_f64(xd), x)


@pytest.mark.parametrize("nonlinear_volume", [False, True],
                         ids=["boundary_nonaffine", "volume_nonaffine"])
def test_refined_step_df32_with_reference_freezes(nonlinear_volume):
    """The reference's freezes loaded into the port's float32 domain: the
    port's df32 step repeats the reference's, stage for stage."""
    ref = _radiating_thermal(dtype=jnp.float32,
                             nonlinear_volume=nonlinear_volume)
    ref.converge_tol = 1e-8
    _freeze(ref)
    port = _port_radiating(dtype=torch.float32,
                           nonlinear_volume=nonlinear_volume)
    port.converge_tol = 1e-8
    keys = ("A_hi", "A_lo", "b_hi", "b_lo", "bnd_dofs", "wp_df")
    interop.load_reference_freezes(
        port, k_linear_td=np.asarray(ref._k_linear_td),
        refined=jax.tree_util.tree_map(
            np.asarray, {k: ref._refined[k] for k in keys}),
        mg_frozen=jax.tree_util.tree_map(np.asarray, ref._mg_frozen),
        mg_hier=ref._mg_hier)
    assert torch.equal(port._refined["A_hi"],
                       torch.as_tensor(np.array(ref._refined["A_hi"])))
    if nonlinear_volume:
        assert isinstance(port._refined["wp_df"][0]["el"]["weights"], tf.DF)
    else:
        assert torch.equal(port._refined["bnd_dofs"], torch.as_tensor(
            np.asarray(ref._refined["bnd_dofs"]).astype(np.int64)))
    x0 = np.asarray(ref.x, np.float64) * 1.0005
    step_r = ref.make_refined_step(sv_func=ref_krylov.bicgstab, maxiter=60,
                                   max_refine=16, residual_mode="df32")
    x_r, _, res_r, it_r = step_r(ref._runtime_state(),
                                 rtf.df_from_f64(x0), jnp.float64(0.0),
                                 jnp.float64(1.0))
    step = port.make_refined_step(sv_func=krylov.bicgstab, maxiter=60,
                                  max_refine=16, residual_mode="df32")
    x_p, _, res_p, it_p = step(port._runtime_state(),
                               tf.df_from_f64(torch.as_tensor(x0)), 0.0,
                               1.0)
    assert float(res_r) < 1e-8 and res_p < 1e-8, (float(res_r), res_p)
    assert int(it_r) == it_p
    x_r64 = (np.asarray(x_r.hi, np.float64) + np.asarray(x_r.lo, np.float64))
    _close(tf.df_to_f64(x_p), x_r64, 1e-9)


def test_refined_step_df32_boundary_remainder_without_compact_map():
    """On a strip one element high the radiating top touches over a fifth
    of the rows, so the nonaffine residues reduce through a full-size
    map (no ``r_touched``).  The port's df32 step then evaluates the
    boundary remainder in float64 over the whole vector (the reference's
    step has no branch for this case and leaves the remainder out) and
    lands on the float64-mode root."""
    dom = _port_radiating(nel=(8, 1), dtype=torch.float32)
    dom.converge_tol = 1e-8
    _freeze(dom, mg=False)
    kw = dict(sv_func=krylov.bicgstabl, s=2, maxiter=400, max_refine=12,
              max_pass=2, precond="jacobi")
    step = dom.make_refined_step(residual_mode="df32", **kw)
    maps = dom._device_maps["nonaff_res"]
    assert "r" in maps and "r_touched" not in maps
    x, _, res, _ = step(dom._runtime_state(), dom.x.to(torch.float64), 0.0,
                        1.0)
    assert res < 1e-8, res
    dom64 = _port_radiating(nel=(8, 1))
    dom64.converge_tol = 1e-11
    _freeze(dom64, mg=False)
    x64, _, res64, _ = dom64.make_refined_step(**kw)(
        dom64._runtime_state(), dom64.x, 0.0, 1.0)
    assert res64 < 1e-11, res64
    _close(x, x64, 2e-5)
