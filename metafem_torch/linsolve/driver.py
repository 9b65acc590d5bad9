"""Solver driver: restart passes with true-residual recomputation.

The port of ``iterative_solve`` (reference: ``metafem/linsolve/driver.py``,
the analog of MetaFEM.jl's iterative_Solve!, 02_Preconditioner.jl:30-78):
right-Jacobi scale once, run at most ``max_pass`` batches of the chosen
Krylov solver with the true residual recomputed between passes, and
un-scale x at exit.  The Neumann and left-Jacobi options of the reference
are not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from . import krylov
from .precond import pr_jacobi


def iterative_solve(A, b: torch.Tensor, converge_tol: float = 1e-8,
                    sv_func: Callable = krylov.bicgstab,
                    use_pr_jacobi: bool = True,
                    max_pass: int = 4,
                    maxiter: int = 2000,
                    verbose: bool = False,
                    log: Optional[list] = None,
                    **kwargs) -> torch.Tensor:
    """Preconditioned restarted Krylov solve of A x = b.  ``log``, when
    given, receives one (Krylov iterations, true residual) pair per
    pass."""
    unscale: Optional[Callable] = None
    if use_pr_jacobi:
        A, unscale = pr_jacobi(A)
    n = b.shape[0]
    x = torch.zeros_like(b)
    for pass_number in range(1, max_pass + 1):
        x, iters, _ = sv_func(A, b, x0=x, tol=converge_tol,
                              maxiter=maxiter, **kwargs)
        # true residual (Krylov updates r incrementally and drifts)
        r = b - A.mv(x)
        res = float(torch.linalg.norm(r)) / math.sqrt(n)
        if log is not None:
            log.append((int(iters), res))
        if verbose:
            print(f"  pass {pass_number}: res = {res:.3e} "
                  f"iters = {int(iters)}")
        if res < converge_tol:
            break
    return unscale(x) if unscale is not None else x
