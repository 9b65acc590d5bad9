"""Solver driver: restart passes with true-residual recomputation, and
the direct solvers.

The port of ``metafem/linsolve/driver.py`` (the analog of MetaFEM.jl's
iterative_Solve!, 02_Preconditioner.jl:30-78): right-Jacobi scale once,
optionally left-Jacobi or Neumann-polynomial precondition, run at most
``max_pass`` batches of the chosen Krylov solver with the true residual
recomputed between passes, and un-scale x at exit.  The direct solvers
are a host scipy LU (solver_LU_CPU, 01_Direct_Solver.jl:10-24) and a
dense QR on the operator's device (solver_QR_GPU, :55-66).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from . import krylov
from .precond import pl_jacobi, pr_jacobi


def solver_lu(A, b: torch.Tensor) -> torch.Tensor:
    """Direct sparse LU on the host (01_Direct_Solver.jl:10-24); x comes
    back on b's device in b's type."""
    from scipy.sparse.linalg import splu
    lu = splu(A.to_scipy().tocsc())
    x = lu.solve(b.detach().cpu().numpy().astype(np.float64))
    return torch.as_tensor(x, dtype=b.dtype).to(b.device)


def solver_qr(A, b: torch.Tensor, max_dense_n: int = 32768) -> torch.Tensor:
    """Direct QR solve on the operator's device (solver_QR_GPU,
    01_Direct_Solver.jl:55-66): the matrix is densified and factored by
    ``torch.linalg.qr``, exact for singular-pattern-free systems and
    robust on rank-marginal penalty rows where LU pivoting struggles.
    Densifying takes O(n^2) memory, so it is refused above
    ``max_dense_n`` (8.6 GB in float64 at the default); LSQR
    (krylov.lsqr) is the menu's large least-squares path."""
    n = A.n
    if n > max_dense_n:
        raise ValueError(
            f"solver_qr densifies ({n} > max_dense_n={max_dense_n}); "
            "use krylov.lsqr for large least-squares-style solves")
    Ad = torch.as_tensor(A.to_scipy().toarray(), dtype=b.dtype).to(b.device)
    q, r = torch.linalg.qr(Ad)
    return torch.linalg.solve_triangular(r, (q.T @ b)[:, None],
                                         upper=True)[:, 0]


def iterative_solve(A, b: torch.Tensor, diag_pos: np.ndarray = None,
                    converge_tol: float = 1e-8,
                    sv_func: Callable = krylov.idrs,
                    use_pr_jacobi: bool = True,
                    use_pl_jacobi: bool = False,
                    neumann_order: int = 0,
                    max_pass: int = 4,
                    maxiter: int = 2000,
                    verbose: bool = False,
                    log: Optional[list] = None,
                    **kwargs) -> torch.Tensor:
    """Preconditioned restarted Krylov solve of A x = b.

    ``diag_pos``: CSR positions of the diagonal of a ``SparseMatrix``
    (None: found from its rows and columns; block-offset matrices know
    theirs).  ``neumann_order > 0`` enables the polynomial left
    preconditioner (poly.py); it composes with the right Jacobi scaling
    and rescales b once.  ``log``, when given, receives one (Krylov
    iterations, true residual) pair per pass."""
    unscale: Optional[Callable] = None
    if use_pr_jacobi:
        A, unscale = pr_jacobi(A, diag_pos)
    pl = pl_jacobi(A, diag_pos) if use_pl_jacobi else None
    if neumann_order > 0:
        from .poly import NeumannOperator
        dinv = pl_jacobi(A, diag_pos)
        A = NeumannOperator(A, dinv, neumann_order)
        b = A.pinv(b)
        pl = None

    n = b.shape[0]
    x = torch.zeros_like(b)
    tol_factor = 1.0
    for pass_number in range(1, max_pass + 1):
        x, iters, _ = sv_func(A, b, x0=x, tol=tol_factor * converge_tol,
                              maxiter=maxiter, pl=pl, **kwargs)
        # true residual (Krylov updates r incrementally and drifts)
        r = b - A.mv(x)
        res = float(torch.linalg.norm(r)) / math.sqrt(n)
        if pl is not None:
            pres = float(torch.linalg.norm(pl * r)) / math.sqrt(n)
            tol_factor = min(pres / res, 1.0) if res > 0 else 1.0
        if log is not None:
            log.append((int(iters), res))
        if verbose:
            print(f"  pass {pass_number}: res = {res:.3e} "
                  f"iters = {int(iters)}")
        if res < converge_tol:
            break
    return unscale(x) if unscale is not None else x
