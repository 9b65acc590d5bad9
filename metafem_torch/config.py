"""Numeric and device configuration of the PyTorch port.

The working precision defaults to float64, as in the reference package
(its MetaFEM.jl model pins Float64, misc/02_Global_Macros.jl:123-124).
Entry points run on CUDA unless the caller asks for the CPU; there is no
silent fall back to the CPU when CUDA is missing.

float32 matrix products must stay full precision: FEM jacobians and
gradients are differences of nearly equal coordinates and field values,
and TF32's 10-bit mantissa would cancel element-scale geometry.  Both
TF32 switches are turned off and the matmul precision is pinned to
"highest" when this module is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: default floating type of geometry tables, assembly and Krylov solves
DEFAULT_DTYPE = torch.float64
#: index type of every gather map and storage offset
INDEX_DTYPE = torch.int64


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
