"""Right-Jacobi preconditioning (the reference's Pr_Jacobi!,
02_Preconditioner.jl:103-148), port of ``metafem/linsolve/precond.py``'s
``pr_jacobi`` for block-offset matrices."""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def pr_jacobi(A) -> Tuple[object, Callable]:
    """Right Jacobi: returns (scaled A, unscale) with A' = A diag(s),
    x = diag(s) x'.  Scales by the SIGNED diagonal (1.0 for zero
    diagonals), so the scaled diagonal is exactly +1 and sign-mixed
    diagonals (-k-Laplacian rows next to +1 ghost rows) keep the scaled
    system definite."""
    d = A.diag()
    d = torch.where(d != 0, d, torch.ones_like(d))
    s = 1.0 / d
    return A.scale_cols(s), lambda x: s * x
