"""metafem_torch: the PyTorch/CUDA port of metafem, the generic FEM
framework.

PDE weak forms written as tensor-index meta-expressions are symbolically
differentiated and evaluated as batched element tensors; sparse systems
are assembled into block-offset storage through precomputed maps and
solved by preconditioned Krylov methods inside a generalized-alpha /
Newton time loop.  The SpMV of every Krylov iteration is a hand-written
CUDA kernel (linsolve/offset_spmv.py).  Entry points run on CUDA unless
the caller passes ``device="cpu"``.
"""

from . import config  # noqa: F401  (TF32 off before any tensor is made)
from .symbolics import (Bilinear, Expr, SymRef, index, indices, fn, log,
                        ifelse, d, visualize, register_rule,
                        unregister_rule, registered_rules,
                        register_diff_rule)
from .solver import FEM_Domain
from .mesh.builders import (make_square, make_brick, refine_simplex,
                            select_facets)
from .mesh.ref_geometry import construct_total_mesh, get_boundary_mesh
from .mesh.readers import read_mesh

__version__ = "0.1.0"
