"""Polynomial (truncated Neumann) left preconditioning, port of
``metafem/linsolve/poly.py``.

The reference package substitutes a matrix polynomial from the Jacobi
splitting for MetaFEM.jl's ILU(0) left preconditioner (Pl_ILU,
02_Preconditioner.jl:179-193), whose sequential triangular solves suit
neither a TPU nor a GPU:

    M^-1 = sum_{k=0..p} (I - D^-1 A)^k D^-1      (truncated Neumann)

Each application costs p SpMVs.  The solvers see M^-1 A as an operator
with ``mv``/``tmv``, so every Krylov method works on it unchanged.
"""

from __future__ import annotations

import torch


class NeumannOperator:
    """Operator M^-1 A with M^-1 the order-p Neumann polynomial."""

    def __init__(self, A, dinv: torch.Tensor, order: int):
        self.A = A
        self.dinv = dinv
        self.order = int(order)

    @property
    def n(self) -> int:
        return self.A.n

    def pinv(self, v: torch.Tensor) -> torch.Tensor:
        """M^-1 v."""
        y = self.dinv * v
        acc = y
        for _ in range(self.order):
            y = y - self.dinv * self.A.mv(y)
            acc = acc + y
        return acc

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.pinv(self.A.mv(x))

    def tmv(self, x: torch.Tensor) -> torch.Tensor:
        # (M^-1 A)^T = A^T M^-T; M is symmetric only for symmetric A, as
        # in the reference (LSQR on symmetric problems)
        y = x
        acc = y
        for _ in range(self.order):
            y = y - self.A.tmv(self.dinv * y)
            acc = acc + y
        return self.A.tmv(self.dinv * acc)
