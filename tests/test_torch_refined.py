"""The refined Newton step of the PyTorch port against the reference.

tests/test_refined.py's ``_radiating_thermal`` strip at nel=(16,8)
(conduction, fixed-temperature ends, convection and T^4 radiation on the
top: affine volume, nonaffine boundary) on the reference side, and the
port's twin of it built from the same literals.  Tolerances:

- the freezes (``K_linear_td``, A_td and b) and the refined phases
  (``aff_res``, ``nonaff_nl``) agree to 1e-12 of each vector's largest
  entry: the same float64 element arithmetic, summed in another order;
- float64-domain refined steps (BiCGStab and Chebyshev inner solves)
  reach ``converge_tol=1e-11`` and their x agrees with the reference's
  refined step within 1e-10 * max|x| (both are converged that far; the
  reference's own test_refined.py holds two of its paths to the same
  bar);
- a float32-domain step (the flagship's precision: float32 tangent and
  multigrid, float64 residuals) reaches 1e-8 and its x agrees with the
  reference's float32 domain in float64 residual mode within
  1e-6 * max|x|;
- with the reference's freezes loaded (interop.load_reference_freezes)
  the port's step repeats the reference's stage for stage: x within
  1e-12 * max|x| after the same number of refines.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metafem.linsolve import krylov as ref_krylov
import metafem_torch as mf
from metafem_torch import Bilinear, interop
from metafem_torch.linsolve import krylov
from metafem_torch.solver.domain import FEM_Domain

from test_refined import _radiating_thermal

torch.set_num_threads(2)


def _port_radiating(nel=(16, 8), transient=False, dtype=torch.float64):
    """The port's twin of test_refined._radiating_thermal."""
    L1, L2 = 0.02, 0.01
    vert, conn = mf.make_square((L1, L2), nel)
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(2, dtype=dtype, device="cpu")
    wp = dom.add_workpiece(geo)
    eps = 1e-9
    ends = mf.select_facets(geo, lambda c: (c[:, 0] < eps)
                            | (c[:, 0] > L1 - eps))
    top = mf.select_facets(geo, lambda c: c[:, 1] > L2 - eps)
    bg_fix = dom.add_boundary(wp, ends)
    bg_top = dom.add_boundary(wp, top)
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    n = dom.sym("n")
    i = mf.index("i")
    vol = -3.0 * Bilinear(T.d(i), T.d(i)) + Bilinear(T, s)
    if transient:
        vol = vol - 1.0e5 * Bilinear(T, T.dt())
    dom.assign_workpiece_weakform(wp, vol)
    dom.assign_boundary_weakform(
        wp, bg_fix, 1000.0 * Bilinear(T, 1173.15 - T)
        + 3.0 * Bilinear(T, n[i] * T.d(i)))
    dom.assign_boundary_weakform(
        wp, bg_top, 50.0 * Bilinear(T, 323.15 - T)
        + 0.7 * 5.669e-8 * Bilinear(T, 323.15 ** 4 - T ** 4))
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity")
    dom.assemble_global_variables()
    dom.compile()
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "T", np.full(mesh.n_cp, 323.15))
    dom.refresh_fields()
    dom.assemble_x()
    return dom


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = (got.double().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float64))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _ref_f64(ref, key):
    return (np.asarray(ref[key + "_hi"], np.float64)
            + np.asarray(ref[key + "_lo"], np.float64))


@functools.lru_cache(maxsize=None)
def _frozen_pair(transient):
    ref = _radiating_thermal(transient=transient)
    dom = _port_radiating(transient=transient)
    if transient:
        for d in (ref, dom):
            d.time_discretization.update_time(0.5,
                                              d.pattern.max_time_level)
    for d in (ref, dom):
        d.freeze_linear_tangent()
        d.freeze_refined_residual()
    return ref, dom


@pytest.mark.parametrize("transient", [False, True])
def test_freezes_match_reference(transient):
    ref, dom = _frozen_pair(transient)
    assert dom._k_linear_td.shape[0] == (2 if transient else 1)
    _close(dom._k_linear_td, ref._k_linear_td, 1e-12)
    _close(dom._refined["A"], _ref_f64(ref._refined, "A"), 1e-12)
    _close(dom._refined["b"], _ref_f64(ref._refined, "b"), 1e-12)
    assert dom._refined["A"].dtype == torch.float64
    # the float64 volume tables are freed: the volume is affine
    assert dom._refined["wp"][0]["el"] is dom.state["wp"][0]["el"]


@pytest.mark.parametrize("transient", [False, True])
def test_refined_phases_match_reference(transient):
    """aff_res and nonaff_nl at a random x*, and the port's refined
    residual identity sum A_td x*[td] + b + R_nonaffine == res_k."""
    ref, dom = _frozen_pair(transient)
    rng = np.random.default_rng(0)
    xs = np.asarray(ref.x) + rng.normal(0.0, 50.0, ref.x.shape)
    ref._ensure_device_maps("aff_res")
    st_r = ref._runtime_state()
    st_r["x_star"] = jnp.asarray(xs)
    st_p = dom._runtime_state()
    st_p["x_star"] = torch.tensor(xs)
    for phase in ("aff_res", "nonaff_nl"):
        r_r, K_r = ref._run_phase(st_r, phase)
        r_p, K_p = dom._run_phase(st_p, phase)
        _close(r_p, r_r, 1e-12)
        if phase == "nonaff_nl":
            _close(K_p, K_r, 1e-12)
    # the exact decomposition against the direct residual, port only
    st_p["K_linear"] = dom._k_linear(st_p)
    r_direct, _ = dom._res_k(st_p)
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    lo = dom.pattern.offset_layout
    r = dom._refined["b"]
    for td in range(dom.pattern.max_time_level + 1):
        r = r + OffsetMatrix.from_values(dom._refined["A"][td], lo).mv(
            st_p["x_star"][td])
    st64 = {**st_p, "wp": dom._refined["wp"]}
    r = r + dom._run_phase(st64, "nonaff_nl")[0]
    _close(r, r_direct.numpy(), 1e-12)


def _prepare(d):
    d.converge_tol = 1e-11
    d.freeze_linear_tangent()
    d.setup_mg()
    d.freeze_refined_residual()


@functools.lru_cache(maxsize=None)
def _converged_pair():
    """Both f64 domains after the BiCGStab refined step of
    test_refined_step_converges_below_f32_floor."""
    ref, dom = _radiating_thermal(), _port_radiating()
    _prepare(ref)
    _prepare(dom)
    step_r = ref.make_refined_step(sv_func=ref_krylov.bicgstab, maxiter=60,
                                   max_refine=12)
    x_r, _, res_r, _ = step_r(ref._runtime_state(), ref.x,
                              jnp.float64(0.0), jnp.float64(1.0))
    step_p = dom.make_refined_step(sv_func=krylov.bicgstab, maxiter=60,
                                   max_refine=12)
    x_p, _, res_p, it_p = step_p(dom._runtime_state(), dom.x, 0.0, 1.0)
    return ref, dom, np.asarray(x_r), float(res_r), x_p, res_p, it_p


def test_refined_step_bicgstab_matches_reference():
    _, _, x_r, res_r, x_p, res_p, it_p = _converged_pair()
    assert res_r < 1e-11 and res_p < 1e-11, (res_r, res_p)
    assert it_p >= 2
    _close(x_p, x_r, 1e-10)


def test_refined_step_chebyshev_matches_reference():
    """test_refined_step_chebyshev's production pattern: re-tune at the
    converged state, then Chebyshev-step from x_c * 1.001."""
    ref, dom, x_r, _, x_p, _, _ = _converged_pair()
    ref.x = jnp.asarray(x_r)
    ref.setup_mg()
    dom.x = x_p
    dom.setup_mg()
    lo, hi = dom._mg_spectrum
    assert 0 < lo < hi
    assert dom._mg_cheb is not None
    step_r = ref.make_refined_step(sv_func=ref_krylov.chebyshev,
                                   maxiter=40, max_refine=14)
    xc_r, _, res_r, _ = step_r(ref._runtime_state(),
                               jnp.asarray(x_r) * 1.001,
                               jnp.float64(0.0), jnp.float64(1.0))
    step_p = dom.make_refined_step(sv_func=krylov.chebyshev, maxiter=40,
                                   max_refine=14)
    xc_p, _, res_p, _ = step_p(dom._runtime_state(), x_p * 1.001, 0.0, 1.0)
    assert float(res_r) < 1e-11 and res_p < 1e-11, (float(res_r), res_p)
    _close(xc_p, xc_r, 1e-10)


def test_refined_step_with_reference_freezes_is_stage_exact():
    """The reference's K_linear_td, A_td/b and multigrid state loaded
    into the port: one BiCGStab refined step lands on the reference's x
    after the same number of refines."""
    ref, dom, _, _, _, _, _ = _converged_pair()
    port = _port_radiating()
    port.converge_tol = 1e-11
    interop.load_reference_freezes(
        port, k_linear_td=np.asarray(ref._k_linear_td),
        refined={k: np.asarray(v) for k, v in ref._refined.items()
                 if k in ("A_hi", "A_lo", "b_hi", "b_lo")},
        mg_frozen=jax.tree_util.tree_map(np.asarray, ref._mg_frozen),
        mg_hier=ref._mg_hier)
    assert port._mg_hier.shapes == ref._mg_hier.shapes
    x0 = np.asarray(ref.x) * 1.0005
    step_r = ref.make_refined_step(sv_func=ref_krylov.bicgstab, maxiter=60,
                                   max_refine=12)
    x_r, _, res_r, it_r = step_r(ref._runtime_state(), jnp.asarray(x0),
                                 jnp.float64(0.0), jnp.float64(1.0))
    step_p = port.make_refined_step(sv_func=krylov.bicgstab, maxiter=60,
                                    max_refine=12)
    x_p, _, res_p, it_p = step_p(port._runtime_state(), torch.tensor(x0),
                                 0.0, 1.0)
    assert int(it_r) == it_p
    _close(x_p, x_r, 1e-12)


def test_float32_domain_step_matches_reference():
    """The flagship's precision: float32 geometry, tangent and multigrid,
    float64 frozen operator and residuals."""
    ref = _radiating_thermal(dtype=jnp.float32)
    dom = _port_radiating(dtype=torch.float32)
    for d in (ref, dom):
        d.converge_tol = 1e-8
        d.freeze_linear_tangent()
        d.setup_mg()
        d.freeze_refined_residual()
    assert dom._mg_frozen[1]["coefs"].dtype == torch.float32
    step_r = ref.make_refined_step(sv_func=ref_krylov.bicgstab, maxiter=60,
                                   max_refine=14, residual_mode="f64")
    x_r, _, res_r, _ = step_r(ref._runtime_state(),
                              ref.x.astype(jnp.float64),
                              jnp.float64(0.0), jnp.float64(1.0))
    step_p = dom.make_refined_step(sv_func=krylov.bicgstab, maxiter=60,
                                   max_refine=14)
    x_p, _, res_p, _ = step_p(dom._runtime_state(), dom.x, 0.0, 1.0)
    assert x_p.dtype == torch.float64
    assert float(res_r) < 1e-8 and res_p < 1e-8, (float(res_r), res_p)
    _close(x_p, x_r, 1e-6)


def test_unported_options_raise():
    _, dom = _frozen_pair(False)
    for kw in ({"residual_mode": "df32"}, {"precond": "auxmg"},
               {"inner_operator": "sparse"}, {"rowshard_mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dom.make_refined_step(**{"precond": "jacobi", **kw})
