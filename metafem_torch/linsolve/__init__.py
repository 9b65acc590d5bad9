"""Linear solvers of the port: block-offset storage with its CUDA SpMV,
BiCGStab and Chebyshev, right-Jacobi preconditioning, the restart driver
and lattice multigrid."""

from .block_offset import OffsetMatrix, build_offset_layout  # noqa: F401
from .driver import iterative_solve  # noqa: F401
from .krylov import bicgstab  # noqa: F401
