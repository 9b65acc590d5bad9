"""Krylov solves of the PyTorch port against the reference package.

Same operator (the reference's thermal tangent at nel=(12,6)) and
right-hand side (its residual) on both sides, solved to tol 1e-10:
``bicgstab`` on the right-Jacobi scaled operator, and ``iterative_solve``
(which scales itself) on the raw one.  x agrees within 1e-8 * max|x| and
the BiCGStab iteration counts within 1: the port runs the reference's
arithmetic in the reference's order, and the SpMV forms differ only in
the last bits.
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metafem.linsolve import driver as ref_driver
from metafem.linsolve import krylov as ref_krylov
from metafem.linsolve.precond import pr_jacobi as ref_pr_jacobi
from metafem_torch import interop
from metafem_torch.linsolve import krylov
from metafem_torch.linsolve.driver import iterative_solve
from metafem_torch.linsolve.precond import pr_jacobi

from test_multigrid import _thermal_domain, _tangent

torch.set_num_threads(2)

TOL = 1e-10


@functools.lru_cache(maxsize=None)
def _operators():
    A, residue = _tangent(_thermal_domain(nel=(12, 6)))
    At = interop.offset_matrix_from_numpy(np.asarray(A.vals), A.layout,
                                          device="cpu")
    return A, At, np.array(residue)


def test_bicgstab_and_iterative_solve_match_reference(capsys):
    A, At, b = _operators()

    As, _ = ref_pr_jacobi(A, None)
    x_r, it_r, _ = ref_krylov.bicgstab(As, jnp.asarray(b), tol=TOL,
                                       maxiter=2000)
    Ats, _ = pr_jacobi(At)
    x_p, it_p, nn_p = krylov.bicgstab(Ats, torch.as_tensor(b), tol=TOL,
                                      maxiter=2000)
    x_r = np.asarray(x_r)
    assert float(nn_p) <= TOL
    assert abs(int(it_r) - it_p) <= 1, (int(it_r), it_p)
    np.testing.assert_allclose(x_p.numpy(), x_r, rtol=0,
                               atol=1e-8 * np.abs(x_r).max())

    capsys.readouterr()
    y_r = np.asarray(ref_driver.iterative_solve(
        A, jnp.asarray(b), None, converge_tol=TOL,
        sv_func=ref_krylov.bicgstab, max_pass=10, verbose=True))
    iters_r = [int(m) for m in re.findall(r"iters = (\d+)",
                                          capsys.readouterr().out)]
    log = []
    y_p = iterative_solve(At, torch.as_tensor(b), converge_tol=TOL,
                          sv_func=krylov.bicgstab, max_pass=10, log=log)
    assert len(log) == len(iters_r)
    assert all(abs(a - b) <= 1 for (a, _), b in zip(log, iters_r)), \
        (log, iters_r)
    assert log[-1][1] < TOL
    np.testing.assert_allclose(y_p.numpy(), y_r, rtol=0,
                               atol=1e-8 * np.abs(y_r).max())


def test_float32_is_refused():
    """float32 solves run through the compensated dot now
    (test_float32_bicgstab_matches_reference); what stays refused is a
    type the port's dots do not take: a float16 solve raises instead of
    running an uncompensated dot."""
    _, At, b = _operators()
    At16 = interop.offset_matrix_from_numpy(
        At.vals.numpy().astype(np.float16), At.layout, device="cpu")
    with pytest.raises(NotImplementedError, match="float32 or float64"):
        krylov.bicgstab(At16, torch.as_tensor(b, dtype=torch.float16))


def _cancelling(kind, n=1 << 16, seed=7):
    """float32 vectors (a, b) whose dot cancels: ``halves`` pairs the
    first half's products with nearly opposite ones in the second half
    (cancellation across summation blocks), ``neighbours`` pairs
    neighbouring products (within blocks).  Returns (a, b, the exact
    dot: float32 products are exact in float64)."""
    rng = np.random.default_rng(seed)
    m = n // 2
    u = rng.standard_normal(m).astype(np.float32)
    v = rng.standard_normal(m).astype(np.float32)
    w = (-v + 1e-3 * rng.standard_normal(m)).astype(np.float32)
    if kind == "halves":
        a, b = np.concatenate([u, u]), np.concatenate([v, w])
    else:
        a = np.stack([u, u], axis=1).reshape(-1)
        b = np.stack([v, w], axis=1).reshape(-1)
    exact = float(np.sum(a.astype(np.float64) * b.astype(np.float64)))
    return a, b, exact


@pytest.mark.parametrize("kind", ["halves", "neighbours"])
def test_float32_dot_is_compensated(kind):
    """The compensated float32 dot on cancelling vectors: its products
    are error-free (p + err == a*b exactly: no FMA contraction), and it
    lands within one float32 ulp of the exact (float64) dot, where a
    plain float32 sum is off by more than 100 ulp.  The reference's _dot
    (float32 block sums) is within its own summation error of exact;
    the port stays within that error plus one ulp of it."""
    a, b, exact = _cancelling(kind)
    at, bt = torch.tensor(a), torch.tensor(b)
    p, err = krylov._two_prod(at, bt)
    assert np.array_equal(p.double().numpy() + err.double().numpy(),
                          a.astype(np.float64) * b.astype(np.float64))
    ulp = float(np.spacing(np.float32(abs(exact))))
    got = krylov._dot(at, bt)
    assert got.dtype == torch.float32
    assert abs(float(got) - exact) <= ulp, (float(got), exact, ulp)
    plain = float((at * bt).sum())
    assert abs(plain - exact) > 100 * ulp, (plain, exact)
    ref = float(ref_krylov._dot(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(got) - ref) <= abs(ref - exact) + ulp, \
        (float(got), ref, exact)
    d64 = krylov._dot(at.double(), bt.double())
    assert d64.dtype == torch.float64
    # float64 dots round at ~1e-16 of sum |a_i b_i|
    S = float(np.sum(np.abs(a.astype(np.float64) * b)))
    np.testing.assert_allclose(float(d64), exact, rtol=0, atol=1e-14 * S)


def test_chebyshev_matches_reference():
    """Chebyshev on the right-Jacobi scaled tangent (spectrum inside
    (0, 2)) with the same enclosure, trip count and right-hand side:
    x within 1e-12 * max|x| (the same recurrence; the SpMV forms sum in
    another order)."""
    A, At, b = _operators()
    As, _ = ref_pr_jacobi(A, None)
    Ats, _ = pr_jacobi(At)
    iv = (0.05, 1.95)
    x_r, it_r, nn_r = ref_krylov.chebyshev(As, jnp.asarray(b), maxiter=30,
                                           interval=iv)
    x_p, it_p, nn_p = krylov.chebyshev(Ats, torch.as_tensor(b), maxiter=30,
                                       interval=iv)
    assert it_p == int(it_r) == 30
    x_r = np.asarray(x_r)
    np.testing.assert_allclose(x_p.numpy(), x_r, rtol=0,
                               atol=1e-12 * np.abs(x_r).max())
    np.testing.assert_allclose(float(nn_p), float(nn_r), rtol=1e-10)
    # resumable: two chunks of steps are the one long solve
    carry = krylov.chebyshev_init(Ats, torch.as_tensor(b), interval=iv)
    carry = krylov.chebyshev_steps(Ats, carry, 12, iv)
    carry = krylov.chebyshev_steps(Ats, carry, 18, iv)
    assert torch.equal(carry[0], x_p)


def test_float32_bicgstab_matches_reference():
    """float32 BiCGStab with compensated dots on the float32 scaled
    tangent, against the reference's float32 solve: both reach the
    tolerance, the iteration counts agree within 25% and x within
    1e-4 * max|x| (float32 trajectories part at the ulp level)."""
    A, At, b = _operators()
    As, _ = ref_pr_jacobi(A, None)
    As32 = type(As)(As.vals.astype(jnp.float32), As.coo_rows, As.coo_cols,
                    As.layout)
    Ats, _ = pr_jacobi(At)
    Ats32 = interop.offset_matrix_from_numpy(
        Ats.vals.numpy().astype(np.float32), At.layout, device="cpu")
    b32 = b.astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b32)) / np.sqrt(b32.size)
    x_r, it_r, _ = ref_krylov.bicgstab(As32, jnp.asarray(b32), tol=tol,
                                       maxiter=2000)
    x_p, it_p, nn_p = krylov.bicgstab(Ats32, torch.tensor(b32), tol=tol,
                                      maxiter=2000)
    assert x_p.dtype == torch.float32
    assert float(nn_p) <= tol
    assert abs(int(it_r) - it_p) <= max(2, 0.25 * int(it_r)), \
        (int(it_r), it_p)
    x_r = np.asarray(x_r)
    np.testing.assert_allclose(x_p.numpy(), x_r, rtol=0,
                               atol=1e-4 * np.abs(x_r).max())
