"""Jacobi preconditioners (the reference's Pr_Jacobi! and its left
counterpart, 02_Preconditioner.jl:103-148), port of
``metafem/linsolve/precond.py``.

Right Jacobi scales the columns once by the diagonal (falling back to
the column norm of a ``SparseMatrix`` where a diagonal entry vanishes)
and un-scales x at exit; left Jacobi returns the row scaling as the
vector the Krylov solvers take as ``pl``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch


def _col_norms(A) -> torch.Tensor:
    return torch.sqrt(A.col_sumsq())


def _row_norms(A) -> torch.Tensor:
    return torch.sqrt(A.row_sumsq())


def _with_fallback(d: torch.Tensor, fallback) -> torch.Tensor:
    one = torch.ones_like(d)
    if fallback is None:
        return torch.where(d != 0, d, one)
    return torch.where(d != 0, d, torch.where(fallback > 0, fallback, one))


def pr_jacobi(A, diag_pos: np.ndarray = None) -> Tuple[object, Callable]:
    """Right Jacobi: returns (scaled A, unscale) with A' = A diag(s),
    x = diag(s) x'.  Scales by the SIGNED diagonal (column norm, then
    1.0, for zero diagonals), so the scaled diagonal is exactly +1 and
    sign-mixed diagonals (-k-Laplacian rows next to +1 ghost rows) keep
    the scaled system definite."""
    d = A.diag(diag_pos)
    d = _with_fallback(d, _col_norms(A) if hasattr(A, "cols") else None)
    s = 1.0 / d
    return A.scale_cols(s), lambda x: s * x


def pl_jacobi(A, diag_pos: np.ndarray = None) -> torch.Tensor:
    """Left Jacobi diagonal: M^-1 v = s * v (row-norm fallback for zero
    diagonals), returned as the vector s that the solvers take as
    ``pl``."""
    d = A.diag(diag_pos)
    d = _with_fallback(d, _row_norms(A) if hasattr(A, "rows") else None)
    return 1.0 / d


@dataclasses.dataclass(frozen=True)
class Identity:
    def __call__(self, v):
        return v
