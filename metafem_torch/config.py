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

import functools

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


def device_constant(values, dtype, device) -> torch.Tensor:
    """A tensor of ``values`` (a number, or a sequence of numbers) in
    ``dtype`` on ``device``, copied from the host once per (values,
    dtype, device) and shared afterwards: the time-integration
    parameters and weak-form constants that every step reads.  A copy
    from pageable host memory blocks the host, and a CUDA graph cannot
    replay it.  The values are keyed by their bits (``float.hex``), so
    -0.0 and 0.0 stay apart.  Callers must not write into the tensor."""
    key = (float(values).hex() if isinstance(values, (int, float))
           else tuple(float(v).hex() for v in values))
    return _cached_constant(key, dtype, torch.device(device))


@functools.lru_cache(maxsize=1024)
def _cached_constant(key, dtype, device) -> torch.Tensor:
    values = (float.fromhex(key) if isinstance(key, str)
              else [float.fromhex(h) for h in key])
    return torch.tensor(values, dtype=dtype, device=device,
                        requires_grad=False)
