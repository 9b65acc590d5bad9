"""Dense-group SpMV of the block-offset storage: the hand-written CUDA
kernel and its plain PyTorch version.

For one workpiece group (block_offset.PallasGroup) with G units (pd, pb),
n_off sorted offsets d_k and C channels of n_cp rows:

    y[pd, r] = sum_g sum_k vals[g, k, r] * x[pb_g, r + d_k]

with x zero outside [0, n_cp).  This replaces the TPU kernel
``metafem/linsolve/pallas_spmv.py:_group_kernel`` (its wrapper
``group_mv``).  On CUDA it is the default SpMV of every Krylov solve.

Kernel (``csrc/offset_spmv.cu``): one thread per output row and channel
walks the units and offsets in the reference's order, reads the values
and x coalesced with a bounds test on x, and writes y once.  Its bound is
memory: the least traffic is (G*n_off + 2*C)*n_cp*sizeof(T) bytes, e.g.
27 * 321,201 * 8 B = 69.4 MB per product for the thermal strip at
nel=(400,200) in f64, about 21 us at the 3.35 TB/s of an H100 SXM.  The
TPU kernel's halo'd x window staged in fast memory is not carried over:
its 3D radius (~2.6e4 rows) would not fit a block's 227 KB of shared
memory, and the offsets cluster on a few lattice rows that L1 and L2
keep.

The kernel is built with nvcc for sm_90a into a plain-C shared library
(metafem_torch/_build/) at first use and called through ctypes on the
current CUDA stream.  On a CPU tensor ``group_mv`` runs the plain version;
on a CUDA tensor it launches the kernel or raises.  ``group_mv.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..buildlib import build_cuda

_LIB: Optional[ctypes.CDLL] = None
#: per (group, device): the unit table [G, 2] and offsets [n_off], int64
_TABLES: dict = {}


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_cuda("offset_spmv"))
        for name in ("offset_spmv_f64", "offset_spmv_f32"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def shifted_stack(xw: torch.Tensor, offsets) -> torch.Tensor:
    """[n_off, C, n_cp] stack of xw [C, n_cp] shifted by each offset d:
    entry r holds xw[:, r + d], zero outside [0, n_cp)."""
    n_cp = xw.shape[1]
    R = int(max(abs(d) for d in offsets))
    xp = torch.nn.functional.pad(xw, (R, R))
    return torch.stack([xp[:, R + d:R + d + n_cp] for d in offsets])


def group_mv_plain(slab: torch.Tensor, xw: torch.Tensor, group,
                   out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the shifted multiply-adds in
    the kernel's order (units, then offsets).  ``slab`` [G, n_off, n_cp]."""
    shifted = shifted_stack(xw, group.offsets)
    acc = [None] * group.n_vars
    for g, (pd, pb) in enumerate(group.units):
        for k in range(group.n_off):
            c = slab[g, k] * shifted[k, pb]
            acc[pd] = c if acc[pd] is None else acc[pd] + c
    for pd, a in enumerate(acc):
        if a is None:
            out[pd].zero_()
        else:
            out[pd].copy_(a)
    return out


def _tables(group, device):
    key = (group, device)
    got = _TABLES.get(key)
    if got is None:
        units = torch.tensor(group.units, dtype=torch.int64,
                             device=device).reshape(-1, 2)
        offs = torch.tensor(group.offsets, dtype=torch.int64, device=device)
        got = _TABLES[key] = (units, offs)
    return got


def group_mv(vals: torch.Tensor, xw: torch.Tensor, group,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y [C, n_cp] for one dense group.  ``vals``: the whole storage
    vector [n_storage]; ``xw``: the group's slice of x as [C, n_cp];
    ``out``: optional contiguous [C, n_cp] destination (not aliasing
    xw or vals)."""
    C, n_cp, n_off = group.n_vars, group.n_cp, group.n_off
    G = len(group.units)
    n_slab = G * n_off * n_cp
    if vals.dim() != 1 or vals.shape[0] < group.base + n_slab:
        raise ValueError(f"vals {tuple(vals.shape)} does not hold the "
                         f"group's {n_slab} values at {group.base}")
    if tuple(xw.shape) != (C, n_cp):
        raise ValueError(f"x window {tuple(xw.shape)} != {(C, n_cp)}")
    if out is None:
        out = torch.empty((C, n_cp), dtype=xw.dtype, device=xw.device)
    elif tuple(out.shape) != (C, n_cp):
        raise ValueError(f"out {tuple(out.shape)} != {(C, n_cp)}")
    if not (vals.dtype == xw.dtype == out.dtype):
        raise TypeError(f"dtype mismatch: vals {vals.dtype}, x {xw.dtype}, "
                        f"out {out.dtype}")
    if not (vals.device == xw.device == out.device):
        raise ValueError("vals, x and out must lie on one device")
    if not (vals.is_contiguous() and xw.is_contiguous()
            and out.is_contiguous()):
        raise ValueError("group_mv needs contiguous tensors")
    slab = vals[group.base:group.base + n_slab]
    if xw.device.type == "cpu":
        return group_mv_plain(slab.view(G, n_off, n_cp), xw, group, out)
    if xw.device.type != "cuda":
        raise ValueError(f"group_mv runs on cuda or cpu, not {xw.device}")
    if xw.dtype == torch.float64:
        fn = load_library().offset_spmv_f64
    elif xw.dtype == torch.float32:
        fn = load_library().offset_spmv_f32
    else:
        raise TypeError(f"group_mv supports float32/float64, not {xw.dtype}")
    units, offs = _tables(group, xw.device)
    with torch.cuda.device(xw.device):
        # the launch runs in the current device's context
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(slab.data_ptr(), xw.data_ptr(), out.data_ptr(),
                 units.data_ptr(), offs.data_ptr(), G, n_off, C, n_cp,
                 stream)
    if err != 0:
        raise RuntimeError(f"offset_spmv kernel launch failed: CUDA error "
                           f"{err}")
    group_mv.launches += 1
    group_mv.launches_by_dtype[xw.dtype] += 1
    return out


#: kernel launches, in all and per float type
group_mv.launches = 0
group_mv.launches_by_dtype = {torch.float32: 0, torch.float64: 0}


def reset_launches() -> None:
    group_mv.launches = 0
    for k in group_mv.launches_by_dtype:
        group_mv.launches_by_dtype[k] = 0
