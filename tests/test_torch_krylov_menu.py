"""The Krylov menu, the preconditioners and the direct solvers of the
PyTorch port against the reference package.

Same inputs on both sides, float64 on the CPU:

- the cases of tests/test_linsolve.py (every solver on the 1D Laplacian
  at n=64 and on the nonsymmetric matrix), BiCGStab(l), IDR(s) and GMRES
  on the reference's thermal tangent at nel=(12,6), and the left-Jacobi
  and Neumann paths of ``iterative_solve``: x within 1e-8 * max|x| of
  the reference's x and the iteration counts within 1.  The random
  shadow spaces of IDR(s), CGS2 and TFQMR are the reference's own,
  drawn here from its keys and passed in.  Where a solver's recurrence
  amplifies last-bit differences of the dots (named in ``AMPLIFIES``)
  its count may differ by more, and x is held to the reference test's
  own bar against the true solution (atol 1e-6 SPD, 1e-5 nonsymmetric);
- ``SparseMatrix.mv``/``tmv`` and ``OffsetMatrix.tmv`` (dense groups
  with C=1 and C=2, and a COO tail) against scipy at 1e-12 of max|y|;
- ``solver_lu`` and ``solver_qr`` against the reference at 1e-10.
"""

import functools
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from metafem.linsolve import SparseMatrix as RefSparse
from metafem.linsolve import driver as ref_driver
from metafem.linsolve import krylov as ref_krylov
from metafem.linsolve.poly import NeumannOperator as RefNeumann
from metafem.linsolve.precond import pl_jacobi as ref_pl_jacobi
from metafem.linsolve.precond import pr_jacobi as ref_pr_jacobi
from metafem_torch import interop
from metafem_torch.linsolve import driver, krylov
from metafem_torch.linsolve.poly import NeumannOperator
from metafem_torch.linsolve.precond import pl_jacobi, pr_jacobi

from test_torch_krylov import _operators

torch.set_num_threads(2)

NAMES_SPD = ["cg", "bicgstab", "bicgstabl", "bicgstabl_gs", "idrs",
             "idrs_original", "gmres", "lsqr", "cgs", "cgs2", "tfqmr"]
NAMES_NONSYM = NAMES_SPD[1:]
#: (solver, case) pairs whose recurrence amplifies the last-bit
#: differences between the two packages' dot products.  On the 1D
#: Laplacian (condition ~1.7e3) BiCGStab(2) reaches its exact
#: termination at iteration 64 with a residual of 1.2e-10 in the
#: reference and 3.5e-11 here, against tol 1e-10, so the reference runs
#: one more cycle (66 against 64); the residuals of the two packages
#: already differ by 1e-4 relative at iteration 60.  LSQR works on the
#: squared condition number: after 100 iterations the two x differ by
#: 2.6e-5, and the counts end at 155 and 157.
AMPLIFIES = {("bicgstabl", "spd"), ("bicgstabl_gs", "spd"),
             ("lsqr", "spd")}


def _laplace_1d(n):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()


def _nonsym(n, seed=0):
    rng = np.random.default_rng(seed)
    A = _laplace_1d(n).tolil()
    for i in range(n - 1):
        A[i, i + 1] += 0.5
    A += sp.diags(rng.uniform(0.1, 0.5, n))
    return A.tocsr()


def _pair(A: sp.spmatrix):
    """(reference SparseMatrix, the port's) of the same CSR-ordered
    COO arrays."""
    coo = A.tocoo()
    order = np.lexsort((coo.col, coo.row))
    vals, rows, cols = coo.data[order], coo.row[order], coo.col[order]
    ref = RefSparse(jnp.asarray(vals), jnp.asarray(rows.astype(np.int32)),
                    jnp.asarray(cols.astype(np.int32)), A.shape[0])
    port = interop.sparse_matrix_from_numpy(vals, rows, cols, A.shape[0],
                                            device="cpu")
    return ref, port


def _shadows(name, n):
    """The reference's random arrays for solver ``name`` at size n, as
    keyword arguments of the port's solver."""
    if name in ("idrs", "idrs_original"):
        return {"P": np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (4, n), dtype=jnp.float64))}
    if name == "cgs2":
        return {"s0": np.asarray(jax.random.normal(
            jax.random.PRNGKey(1), (n,), jnp.float64))}
    if name == "tfqmr":
        return {"jitter": np.asarray(jax.random.normal(
            jax.random.PRNGKey(2), (n,), jnp.float64))}
    return {}


def _both(name, A_ref, A_port, b, **kw):
    """Run the solver of both packages on the same system; returns
    (x_ref, iters_ref, x_port, iters_port)."""
    n = b.shape[0]
    x_r, it_r, _ = getattr(ref_krylov, name)(A_ref, jnp.asarray(b), **kw)
    x_p, it_p, _ = getattr(krylov, name)(A_port, torch.as_tensor(b), **kw,
                                         **_shadows(name, n))
    return np.asarray(x_r), int(it_r), x_p.numpy(), int(it_p)


def _check(name, case, x_r, it_r, x_p, it_p, x_true, atol_true):
    if (name, case) in AMPLIFIES:
        np.testing.assert_allclose(x_p, x_true, rtol=0, atol=atol_true)
        np.testing.assert_allclose(x_r, x_true, rtol=0, atol=atol_true)
        return
    assert abs(it_r - it_p) <= 1, (it_r, it_p)
    np.testing.assert_allclose(x_p, x_r, rtol=0,
                               atol=1e-8 * np.abs(x_r).max())


@pytest.mark.parametrize("name", NAMES_SPD)
def test_spd_matches_reference(name):
    n = 64
    A = _laplace_1d(n)
    x_true = np.sin(np.linspace(0, 3, n))
    A_r, A_p = _pair(A)
    x_r, it_r, x_p, it_p = _both(name, A_r, A_p, A @ x_true, tol=1e-10,
                                 maxiter=5000)
    _check(name, "spd", x_r, it_r, x_p, it_p, x_true, 1e-6)


@pytest.mark.parametrize("name", NAMES_NONSYM)
def test_nonsymmetric_matches_reference(name):
    n = 64
    A = _nonsym(n)
    x_true = np.cos(np.linspace(0, 5, n))
    A_r, A_p = _pair(A)
    x_r, it_r, x_p, it_p = _both(name, A_r, A_p, A @ x_true, tol=1e-10,
                                 maxiter=5000)
    _check(name, "nonsym", x_r, it_r, x_p, it_p, x_true, 1e-5)


@pytest.mark.parametrize("name,kw", [("bicgstabl", {"s": 4}),
                                     ("bicgstabl_gs", {"s": 4}),
                                     ("idrs", {}), ("gmres", {"s": 30})])
def test_thermal_tangent_matches_reference(name, kw):
    """The right-Jacobi scaled thermal tangent (block-offset storage,
    COO tail) at nel=(12,6), solved to 1e-10."""
    A, At, b = _operators()
    As, _ = ref_pr_jacobi(A, None)
    Ats, _ = pr_jacobi(At)
    x_r, it_r, x_p, it_p = _both(name, As, Ats, b, tol=1e-10, maxiter=4000,
                                 **kw)
    assert abs(it_r - it_p) <= 1, (it_r, it_p)
    np.testing.assert_allclose(x_p, x_r, rtol=0,
                               atol=1e-8 * np.abs(x_r).max())


def _diag_pos(A_r):
    rows, cols = np.asarray(A_r.rows), np.asarray(A_r.cols)
    pos = np.full(A_r.n, -1, np.int64)
    hits = rows == cols
    pos[rows[hits]] = np.nonzero(hits)[0]
    return pos


def _iters(capsys):
    return [int(m) for m in re.findall(r"iters = (\d+)",
                                       capsys.readouterr().out)]


@pytest.mark.parametrize("option", [{"use_pl_jacobi": True},
                                    {"neumann_order": 3}])
def test_iterative_solve_options_match_reference(option, capsys):
    """Left Jacobi (with the tol_factor pass logic) and the Neumann
    polynomial, on a badly column-scaled nonsymmetric system."""
    n = 128
    A = (_nonsym(n) @ sp.diags(np.logspace(0, 3, n))).tocsr()
    x_true = np.random.default_rng(2).normal(size=n)
    b = A @ x_true
    A_r, A_p = _pair(A)
    kw = dict(converge_tol=1e-10, max_pass=10, maxiter=5000, **option)
    capsys.readouterr()
    x_r = np.asarray(ref_driver.iterative_solve(
        A_r, jnp.asarray(b), _diag_pos(A_r), sv_func=ref_krylov.bicgstab,
        verbose=True, **kw))
    it_r = _iters(capsys)
    log = []
    x_p = driver.iterative_solve(A_p, torch.as_tensor(b), None,
                                 sv_func=krylov.bicgstab, log=log,
                                 **kw).numpy()
    assert len(log) == len(it_r)
    assert all(abs(a - c) <= 1 for (a, _), c in zip(log, it_r)), (log, it_r)
    np.testing.assert_allclose(x_p, x_r, rtol=0,
                               atol=1e-8 * np.abs(x_r).max())
    np.testing.assert_allclose(x_p, x_true, rtol=1e-6)


def test_preconditioners_match_reference():
    """pr_jacobi's column-norm and pl_jacobi's row-norm fallbacks on a
    matrix with zero diagonals, and the Neumann operator's mv/tmv."""
    A = _nonsym(40).tolil()
    A[3, 3] = 0.0
    A[17, 17] = 0.0
    A = A.tocsr()
    A.eliminate_zeros()
    A_r, A_p = _pair(A)
    pos = _diag_pos(A_r)
    As_r, _ = ref_pr_jacobi(A_r, pos)
    As_p, unscale = pr_jacobi(A_p, pos)
    np.testing.assert_allclose(As_p.vals.numpy(), np.asarray(As_r.vals),
                               rtol=1e-14)
    pl_r = np.asarray(ref_pl_jacobi(A_r, pos))
    np.testing.assert_allclose(pl_jacobi(A_p, None).numpy(), pl_r,
                               rtol=1e-14)
    x = np.random.default_rng(5).normal(size=40)
    N_r = RefNeumann(A_r, jnp.asarray(pl_r), 3)
    N_p = NeumannOperator(A_p, torch.as_tensor(pl_r), 3)
    for op in ("mv", "tmv", "pinv"):
        y_r = np.asarray(getattr(N_r, op)(jnp.asarray(x)))
        y_p = getattr(N_p, op)(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(y_p, y_r, rtol=0,
                                   atol=1e-13 * np.abs(y_r).max())


def test_sparse_matrix_products_against_scipy():
    A = _nonsym(50)
    _, A_p = _pair(A)
    x = np.random.default_rng(1).normal(size=50)
    xt = torch.as_tensor(x)
    for got, want in ((A_p.mv(xt), A @ x), (A_p.tmv(xt), A.T @ x),
                      (A_p.scale_cols(xt).mv(xt), A @ (x * x)),
                      (A_p.scale_rows(xt).mv(xt), x * (A @ x))):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    assert (A_p.to_scipy() != A).nnz == 0


@functools.lru_cache(maxsize=None)
def _offset_operators():
    """Block-offset tangents of the port: the reference's thermal
    tangent at nel=(12,6) (COO tail and a dense diagonal), the thermal
    strip at nel=(64,32) (one dense group, C=1) and the C=2 plane-strain
    operator of chip_smoke.py at (64,32) (G=4 dense units)."""
    import chip_smoke
    from metafem_torch.examples import thermal_2d
    _, At, _ = _operators()
    dom, _ = thermal_2d.build((64, 32), device="cpu")
    A1, _ = dom.assemble_tangent()
    A2, _ = chip_smoke.elastic_domain((64, 32), "cpu").assemble_tangent()
    return At, A1, A2


@pytest.mark.parametrize("which", ["coo_tail", "dense_c1", "dense_c2"])
def test_offset_matrix_tmv_against_scipy(which):
    A = dict(zip(("coo_tail", "dense_c1", "dense_c2"),
                 _offset_operators()))[which]
    lo = A.layout
    if which == "coo_tail":
        assert lo.n_coo > 0
    else:
        assert lo.n_coo == 0 and lo.pallas_groups[0].n_vars == \
            {"dense_c1": 1, "dense_c2": 2}[which]
    x = np.random.default_rng(3).normal(size=A.n)
    S = A.to_scipy()
    for got, want in ((A.tmv(torch.as_tensor(x)), S.T @ x),
                      (A.mv(torch.as_tensor(x)), S @ x)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(A.diag(None).numpy(), S.diagonal())


def test_direct_solvers_match_reference():
    n = 60
    A = _nonsym(n)
    x_true = np.random.default_rng(4).normal(size=n)
    b = A @ x_true
    A_r, A_p = _pair(A)
    for ref_fn, fn in ((ref_driver.solver_lu, driver.solver_lu),
                       (ref_driver.solver_qr, driver.solver_qr)):
        x_r = np.asarray(ref_fn(A_r, jnp.asarray(b)))
        x_p = fn(A_p, torch.as_tensor(b))
        assert x_p.dtype == torch.float64
        np.testing.assert_allclose(x_p.numpy(), x_r, rtol=1e-10)
        np.testing.assert_allclose(x_p.numpy(), x_true, rtol=1e-8)
    with pytest.raises(ValueError, match="max_dense_n"):
        driver.solver_qr(A_p, torch.as_tensor(b), max_dense_n=10)
