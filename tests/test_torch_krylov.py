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
                          max_pass=10, log=log)
    assert len(log) == len(iters_r)
    assert all(abs(a - b) <= 1 for (a, _), b in zip(log, iters_r)), \
        (log, iters_r)
    assert log[-1][1] < TOL
    np.testing.assert_allclose(y_p.numpy(), y_r, rtol=0,
                               atol=1e-8 * np.abs(y_r).max())


def test_float32_is_refused():
    """Only the float64 Krylov path is ported: a float32 solve raises
    instead of running an uncompensated dot."""
    _, At, b = _operators()
    At32 = interop.offset_matrix_from_numpy(
        At.vals.numpy().astype(np.float32), At.layout, device="cpu")
    with pytest.raises(NotImplementedError, match="float64"):
        krylov.bicgstab(At32, torch.as_tensor(b, dtype=torch.float32))
