"""Linear solvers of the port: block-offset storage with its CUDA SpMV,
sorted-COO matrices, the Krylov menu, Jacobi and Neumann-polynomial
preconditioning, the restart driver, direct solvers and lattice
multigrid."""

from .block_offset import OffsetMatrix, build_offset_layout  # noqa: F401
from .spmv import SparseMatrix  # noqa: F401
from .driver import iterative_solve, solver_lu, solver_qr  # noqa: F401
from .krylov import (bicgstab, bicgstabl, cg, cgs, cgs2, gmres,  # noqa: F401
                     idrs, idrs_original, lsqr, tfqmr)
