"""Sorted-COO sparse matrix with deterministic products.

Port of ``metafem/linsolve/spmv.py``'s ``SparseMatrix``: the values are
kept in CSR (row-sorted) order, so ``mv`` is a sorted segment sum over
the rows; ``tmv`` sums the same products over the columns in the order
of a stable sort of the columns, computed once (block_offset's
``sorted_segment_plan``).  Neither product uses
``index_add_``/``scatter_add_``, which are atomic on CUDA: both repeat
bit for bit, as the reference's segment sums do.  Indices are int64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .block_offset import sorted_segment_plan, sorted_segment_sum


@dataclasses.dataclass
class SparseMatrix:
    """Square sparse matrix in sorted-COO (= CSR order) form."""
    vals: torch.Tensor          # [nnz] CSR-ordered values
    rows: torch.Tensor          # [nnz] int64, sorted
    cols: torch.Tensor          # [nnz] int64
    n: int
    #: segment plans of mv and tmv (tensors on the matrix's device),
    #: built at first use and shared by the scaled copies (same rows and
    #: cols)
    _plans: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def _sum(self, data: torch.Tensor, key: str) -> torch.Tensor:
        """Segment sum of ``data`` over the rows or the columns, in the
        fixed order of a plan built at first use on the matrix's
        device."""
        plan = self._plans.get(key)
        if plan is None:
            seg = self.rows if key == "rows" else self.cols
            plan = self._plans[key] = sorted_segment_plan(
                seg.cpu().numpy(), seg.device)
        return sorted_segment_sum(data, plan, self.n)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x."""
        return self._sum(self.vals * x[self.cols], "rows")

    def tmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A.T @ x (needed by LSQR)."""
        return self._sum(self.vals * x[self.rows], "cols")

    def diag(self, diag_pos: Optional[np.ndarray] = None) -> torch.Tensor:
        """Diagonal entries given their CSR positions (-1: no stored
        diagonal, read as 0); ``None`` finds them from rows == cols."""
        if diag_pos is None:
            hits = torch.nonzero(self.rows == self.cols).reshape(-1)
            pos = torch.full((self.n,), -1, dtype=torch.int64,
                             device=self.vals.device)
            pos[self.rows[hits]] = hits
        else:
            pos = torch.as_tensor(np.asarray(diag_pos, np.int64),
                                  device=self.vals.device)
        d = self.vals[pos.clamp(min=0)]
        return torch.where(pos < 0, torch.zeros_like(d), d)

    def _with_vals(self, vals: torch.Tensor) -> "SparseMatrix":
        return SparseMatrix(vals, self.rows, self.cols, self.n, self._plans)

    def scale_cols(self, s: torch.Tensor) -> "SparseMatrix":
        return self._with_vals(self.vals * s[self.cols])

    def scale_rows(self, s: torch.Tensor) -> "SparseMatrix":
        return self._with_vals(self.vals * s[self.rows])

    def col_sumsq(self) -> torch.Tensor:
        """sum over each column of the squared values."""
        return self._sum(self.vals * self.vals, "cols")

    def row_sumsq(self) -> torch.Tensor:
        """sum over each row of the squared values."""
        return self._sum(self.vals * self.vals, "rows")

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix(
            (self.vals.detach().cpu().numpy(),
             (self.rows.cpu().numpy(), self.cols.cpu().numpy())),
            shape=(self.n, self.n))
