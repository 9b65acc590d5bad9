"""Lattice multigrid of the PyTorch port against the reference package.

Same operators on both sides: the tangents of tests/test_multigrid.py's
``_thermal_domain`` (C=1, serendipity, so the ghost-slot mask is live)
and ``_elastic_domain_2d`` (C=2, block smoothing), carried across as
numpy.  The reference draws its start vectors from ``jax.random``; the
port takes them as arguments, so both start alike.  Tolerances:

- transfers agree with the reference and are adjoint to 1e-14 (the
  same arithmetic; the two dots of the adjoint test sum in other
  orders);
- probed coarse stencils, damping factors, the coarsest inverse and a
  V-cycle agree to 1e-12 of each quantity's largest entry (float64;
  only the order of the stencil sums and of the LAPACK inverse differ);
- the spectrum estimate and the Chebyshev tune agree to 1e-10 (24 and
  16 preconditioned applies, each adding ~1e-15 of drift).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metafem.linsolve import multigrid as ref_mg
from metafem_torch import interop
from metafem_torch.examples import thermal_2d
from metafem_torch.linsolve import multigrid

from test_multigrid import _elastic_domain_2d, _tangent, _thermal_domain

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("shape", [(7,), (8,), (9, 6), (5, 4, 7)])
def test_transfers_match_reference_and_are_adjoint(shape):
    rng = np.random.default_rng(0)
    coarse = tuple((s + 1) // 2 for s in shape)
    xc = rng.standard_normal((2,) + coarse)
    yf = rng.standard_normal((2,) + shape)
    p = multigrid.prolong(_t(xc), shape)
    r = multigrid.restrict(_t(yf))
    _close(p, ref_mg.prolong(jnp.asarray(xc), shape), 1e-14)
    _close(r, ref_mg.restrict(jnp.asarray(yf)), 1e-14)
    lhs = float(torch.vdot(p.reshape(-1), _t(yf).reshape(-1)))
    rhs = float(torch.vdot(_t(xc).reshape(-1), r.reshape(-1)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-14)


@functools.lru_cache(maxsize=None)
def _ref_thermal():
    return _thermal_domain(nel=(16, 8))


def test_hierarchy_and_mask_match_reference():
    """hierarchy_for_domain and mask_for_domain of the port's own domain
    (examples/thermal_2d.py, the same strip) equal the reference's."""
    ref = _ref_thermal()
    dom, _ = thermal_2d.build((16, 8), device="cpu")
    h_ref = ref_mg.hierarchy_for_domain(ref, max_coarse=16)
    h = multigrid.hierarchy_for_domain(dom, max_coarse=16)
    assert dataclasses.asdict(h) == dataclasses.asdict(h_ref)
    assert h.n_levels == 4
    m_ref = np.asarray(ref_mg.mask_for_domain(ref))
    m = multigrid.mask_for_domain(dom)
    assert m is not None and 0 < m_ref.sum() < m_ref.size
    np.testing.assert_array_equal(m.numpy(), m_ref)
    assert dom._mg_mask is not None
    np.testing.assert_array_equal(dom._mg_mask.numpy(), m_ref)


def _hier(h_ref):
    return multigrid.MGHierarchy(**dataclasses.asdict(h_ref))


def _ref_starts(h_ref, dtype=jnp.float64):
    """The reference's calibration start vectors (PRNGKey(3 + level))."""
    return [np.asarray(jax.random.normal(
        jax.random.PRNGKey(3 + lvl), (h_ref.channels,) + h_ref.shapes[lvl],
        dtype)) for lvl in range(h_ref.n_levels - 1)]


@functools.lru_cache(maxsize=None)
def _setups(name):
    """(reference hierarchy, state, A, residue; port hierarchy, state)."""
    if name == "thermal":
        ref = _ref_thermal()
        h_ref = ref_mg.hierarchy_for_domain(ref, max_coarse=16)
    else:
        ref = _elastic_domain_2d(nel=(12, 4))
        h_ref = ref_mg.hierarchy_for_domain(ref, max_coarse=16,
                                            block_smooth=True)
    A, residue = _tangent(ref)
    mask = ref_mg.mask_for_domain(ref)
    # jitted as the reference's own setup_mg runs it (eager JAX
    # dispatches op by op and takes several times longer)
    st_ref = jax.jit(lambda A, m: ref_mg.mg_setup(h_ref, A, m))(A, mask)
    h = _hier(h_ref)
    At = interop.offset_matrix_from_numpy(np.asarray(A.vals), A.layout,
                                          device="cpu")
    st = multigrid.mg_setup(h, At, None if mask is None else _t(mask),
                            starts=_ref_starts(h_ref))
    return h_ref, st_ref, A, np.array(residue), h, st, At


@pytest.mark.parametrize("name", ["thermal", "elastic"])
def test_mg_setup_and_vcycle_match_reference(name):
    h_ref, st_ref, _, b, h, st, _ = _setups(name)
    assert h.n_levels >= 3
    if name == "elastic":
        assert h.channels == 2 and h.block_smooth
        _close(st[0]["inv_diag_blk"], st_ref[0]["inv_diag_blk"], 1e-12)
    for lvl in range(1, h.n_levels):
        _close(st[lvl]["coefs"], st_ref[lvl]["coefs"], 1e-12)
        _close(st[lvl]["inv_diag"], st_ref[lvl]["inv_diag"], 1e-12)
    for lvl in range(h.n_levels - 1):
        np.testing.assert_allclose(float(st[lvl]["omega"]),
                                   float(st_ref[lvl]["omega"]), rtol=1e-12)
    _close(st[-1]["inv"], st_ref[-1]["inv"], 1e-12)
    y_ref = jax.jit(lambda s, v: ref_mg.vcycle(h_ref, s, v))(
        st_ref, jnp.asarray(b))
    _close(multigrid.vcycle(h, st, _t(b)), y_ref, 1e-12)


def test_stencil_apply_and_dense_match_reference():
    """The port's strided-window stencil apply and the dense coarsest
    matrix against the reference's per-offset loop, on random
    coefficients of a C=2 level."""
    h_ref = ref_mg.build_hierarchy((9, 7), 2, 2)
    rng = np.random.default_rng(5)
    coefs = rng.standard_normal((len(h_ref.offsets), 2, 2, 9, 7))
    x = rng.standard_normal((2, 9, 7))
    want = ref_mg._stencil_mv(jnp.asarray(coefs), jnp.asarray(x),
                              h_ref.offsets, h_ref.radius)
    got = multigrid._stencil_mv(_t(coefs), _t(x), h_ref.offsets,
                                h_ref.radius)
    _close(got, want, 1e-14)
    want = ref_mg._stencil_to_dense(jnp.asarray(coefs), (9, 7),
                                    list(h_ref.offsets), 2)
    got = multigrid._stencil_to_dense(_t(coefs), (9, 7), h_ref.offsets, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spectrum_and_chebyshev_tune_match_reference():
    h_ref, st_ref, A, _, h, st, At = _setups("thermal")
    n = A.n
    op_ref = ref_mg.MGOperator(A, st_ref, h_ref)
    op = multigrid.MGOperator(At, st, h)
    spec_ref = ref_mg.estimate_spectrum(op_ref, n, jnp.float64)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (n,),
                                      jnp.float64))
    spec = multigrid.estimate_spectrum(op, n, torch.float64, v0=v0)
    np.testing.assert_allclose(spec, spec_ref, rtol=1e-10)
    assert 0 < spec[0] < spec[1]
    tuned_ref = ref_mg.tune_chebyshev(op_ref, n, jnp.float64, spec_ref)
    b0 = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (n,),
                                      jnp.float64))
    tuned = multigrid.tune_chebyshev(op, n, torch.float64, spec, b0=b0)
    assert tuned is not None and tuned_ref is not None
    np.testing.assert_allclose(tuned[0], tuned_ref[0], rtol=1e-10)
    np.testing.assert_allclose(tuned[1], tuned_ref[1], rtol=1e-10)


def test_default_start_vectors_repeat():
    """Without start vectors the port seeds a CPU generator as the
    reference seeds its keys: two setups agree bitwise."""
    _, _, _, _, h, _, At = _setups("thermal")
    a = multigrid.mg_setup(h, At)
    b = multigrid.mg_setup(h, At)
    for lvl in range(h.n_levels - 1):
        assert torch.equal(a[lvl]["omega"], b[lvl]["omega"])
    assert torch.equal(a[-1]["inv"], b[-1]["inv"])
