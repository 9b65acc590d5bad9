"""SpMV of the BSR tail of the block-offset storage: the hand-written
CUDA kernel and its plain PyTorch version.

Unstructured meshes spill the rare offsets of their tangent into a tail
of dense ``b x b`` blocks (``block_offset.OffsetLayout.blk_b``, b = 8).
The tail's storage is component-major: entry (i, j) of block k lies at
``(i*b + j)*nb + k`` of the tail's values, and the blocks are sorted by
block row.  Its product adds into y:

    y[R*b + i] += sum_k sum_j vals[(i*b + j)*nb + k] * x[cols[k]*b + j]

over the blocks k of block row R.  The reference computes it outside
Pallas (``metafem/linsolve/block_offset.py:_blk_tail_mv``, XLA on the
TPU); in the port it runs as ``csrc/bsr_tail.cu`` on the card, one warp
per run of blocks of one block row (see the source's note).

``tail_mv`` launches the kernel on a CUDA tensor and runs
``bsr_tail_mv_plain`` on a CPU tensor; on any other device it raises,
and on a CUDA tensor a failed build or launch raises too.  The run plan
(``run_start``, ``run_row``) comes from ``block_offset.tail_runs``, kept
on the layout's device tables.  ``tail_mv.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..buildlib import build_cuda

_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_cuda("bsr_tail"))
        for name in ("bsr_tail_mv_f64", "bsr_tail_mv_f32"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def blocked(v: torch.Tensor, b: int) -> torch.Tensor:
    """v [n] zero-padded to whole blocks, as [ceil(n / b), b]."""
    n = v.shape[0]
    vp = torch.zeros(-(-n // b) * b, dtype=v.dtype, device=v.device)
    vp[:n] = v
    return vp.view(-1, b)


def bsr_tail_mv_plain(tail: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      cols: torch.Tensor, run_start: torch.Tensor,
                      run_row: torch.Tensor, b: int) -> torch.Tensor:
    """The tail's product added into y, in plain PyTorch: per block the
    products of each row i summed over j = 0..b-1, then each run's block
    sums added in the run's order (``torch.segment_reduce`` over the
    sorted blocks), and each run's row written once.  The kernel sums a
    run's blocks in another order (lane sums, then a shuffle tree), so
    the two agree to rounding, not bitwise."""
    n = y.shape[0]
    nb = cols.shape[0]
    if nb == 0:
        return y
    xg = blocked(x, b)[cols]                                # [nb, b]
    B = tail.view(b, b, nb)
    contrib = B[:, 0, :] * xg[:, 0]                          # [b, nb]
    for j in range(1, b):
        contrib = contrib + B[:, j, :] * xg[:, j]
    lengths = run_start[1:] - run_start[:-1]
    sums = torch.segment_reduce(contrib.t(), "sum", lengths=lengths)
    rows = (run_row[:, None] * b
            + torch.arange(b, device=y.device)).reshape(-1)
    keep = rows < n
    y[rows[keep]] += sums.reshape(-1)[keep]
    return y


def tail_mv(tail: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            cols: torch.Tensor, run_start: torch.Tensor,
            run_row: torch.Tensor, b: int) -> torch.Tensor:
    """y += (BSR tail) x, in place.  ``tail``: the tail's values
    [b*b*nb] (component-major); ``x``, ``y``: [n]; ``cols``: int64 block
    column of each block; ``run_start``: int64 [n_runs + 1], the first
    block of each run and nb at the end; ``run_row``: int64 [n_runs], the
    run's block row.  On CUDA tensors the kernel (b = 8 only) or an
    error; on CPU tensors the plain version."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tail_mv runs on cuda or cpu, not {dev}")
    nb = cols.shape[0]
    n_runs = run_row.shape[0]
    if tail.shape != (b * b * nb,):
        raise ValueError(f"tail {tuple(tail.shape)} != ({b * b * nb},)")
    if x.shape != y.shape or x.dim() != 1:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         f"be equal 1-D shapes")
    if run_start.shape != (n_runs + 1,):
        raise ValueError(f"run_start {tuple(run_start.shape)} != "
                         f"({n_runs + 1},)")
    if len({tail.dtype, x.dtype, y.dtype}) != 1:
        raise TypeError(f"dtype mismatch: tail {tail.dtype}, x {x.dtype}, "
                        f"y {y.dtype}")
    if any(t.dtype != torch.int64 for t in (cols, run_start, run_row)):
        raise TypeError("cols, run_start and run_row must be int64")
    if any(t.device != dev for t in (tail, y, cols, run_start, run_row)):
        raise ValueError("tail, x, y and the run plan must lie on one "
                         "device")
    if not all(t.is_contiguous()
               for t in (tail, x, y, cols, run_start, run_row)):
        raise ValueError("tail_mv needs contiguous tensors")
    if dev.type == "cpu":
        return bsr_tail_mv_plain(tail, x, y, cols, run_start, run_row, b)
    if b != 8:
        raise NotImplementedError(f"the BSR-tail kernel takes b = 8, not "
                                  f"{b}")
    if x.dtype == torch.float64:
        fn = load_library().bsr_tail_mv_f64
    elif x.dtype == torch.float32:
        fn = load_library().bsr_tail_mv_f32
    else:
        raise TypeError(f"tail_mv supports float32/float64, not {x.dtype}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tail.data_ptr(), x.data_ptr(), y.data_ptr(),
                 cols.data_ptr(), run_start.data_ptr(), run_row.data_ptr(),
                 n_runs, nb, y.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"bsr_tail kernel launch failed: CUDA error "
                           f"{err}")
    tail_mv.launches += 1
    tail_mv.launches_by_dtype[x.dtype] += 1
    return y


#: kernel launches, in all and per float type
tail_mv.launches = 0
tail_mv.launches_by_dtype = {torch.float32: 0, torch.float64: 0}


def reset_launches() -> None:
    tail_mv.launches = 0
    for k in tail_mv.launches_by_dtype:
        tail_mv.launches_by_dtype[k] = 0
