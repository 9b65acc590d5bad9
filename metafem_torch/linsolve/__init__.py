"""Linear solvers of the port: block-offset storage with its CUDA SpMV,
BiCGStab, right-Jacobi preconditioning and the restart driver."""

from .block_offset import OffsetMatrix, build_offset_layout  # noqa: F401
from .driver import iterative_solve  # noqa: F401
from .krylov import bicgstab  # noqa: F401
