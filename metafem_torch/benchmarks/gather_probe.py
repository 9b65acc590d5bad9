"""Random-gather probe: how fast are random reads from device memory and
from a window staged in shared memory on the card?

    python3 -m metafem_torch.benchmarks.gather_probe

The counterpart of ``benchmarks/pallas_gather_probe.py`` (the TPU
package's VMEM gather probe, whose answer shaped its SpMV design).  The
kernel (``csrc/gather_probe.cu``) computes ``out[i] = x[idx[i]]`` for
float32 x and int32 idx in two variants:

- ``"window"``: every block stages all of x in shared memory, then
  gathers from it (the TPU kernel's design).  x must fit a block's
  opt-in shared memory (227 KB on an H100, 58,112 float32 values);
  larger windows raise ``ValueError``, there is no quiet switch to the
  other variant;
- ``"global"``: one thread per output reads x through the read-only
  cache, any size.

The plain version is ``torch.take(x, idx.long())``; on a CPU tensor
``gather`` runs it, on a CUDA tensor it launches the kernel or raises.
The gather is exact, so the kernel and the plain version agree bitwise.
``gather.launches`` counts kernel launches.  The probe runs the TPU
probe's two sizes, (n_win, n_idx) = (16384, 131072) and (65536, 524288),
and prints each variant's device time per launch (CUDA-graph replay of
back-to-back launches; the eager per-call time beside it) and M
gathers/s, beside the plain version, ``torch.index_select`` and the
memory bound (which, at under 5 MB moved, is below a microsecond: the
probe measures launch latency as much as gathers).
"""

from __future__ import annotations

import argparse
import ctypes
import json
from typing import Optional

import numpy as np
import torch

from ..buildlib import build_cuda

#: the TPU probe's sizes (benchmarks/pallas_gather_probe.py:58)
SIZES = ((16384, 131072), (65536, 524288))
VARIANTS = ("window", "global")
#: an H100's opt-in shared memory per block (232,448 bytes), the window
#: limit checked for tensors off the card (on the card the device's own
#: attribute is read)
H100_WINDOW_LIMIT_BYTES = 232448
#: H100 SXM device memory bandwidth, bytes/s (data sheet)
PEAK_BYTES_PER_S = 3.35e12

_LIB: Optional[ctypes.CDLL] = None
#: device index -> the window limit in bytes, read (and granted to the
#: window kernel) at the first use on that device, so no CUDA call is
#: made while launches are being captured into a graph
_WINDOW_LIMIT: dict = {}


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_cuda("gather_probe"))
        for name in ("gather_window_f32", "gather_global_f32"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        for name in ("gather_window_limit_bytes", "gather_window_allow"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def window_limit_bytes(device: torch.device) -> int:
    """Shared memory a block may opt in to on ``device``
    (cudaDevAttrMaxSharedMemoryPerBlockOptin); the H100's for the CPU."""
    if device.type != "cuda":
        return H100_WINDOW_LIMIT_BYTES
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _WINDOW_LIMIT:
        lib = load_library()
        v = lib.gather_window_limit_bytes(index)
        if v <= 0:
            raise RuntimeError("could not read the shared-memory limit")
        with torch.cuda.device(index):
            err = lib.gather_window_allow(v)
        if err != 0:
            raise RuntimeError(f"cudaFuncSetAttribute failed: CUDA error "
                               f"{err}")
        _WINDOW_LIMIT[index] = v
    return _WINDOW_LIMIT[index]


def gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out[i] = x[idx[i]]."""
    return torch.take(x, idx.long())


def gather(x: torch.Tensor, idx: torch.Tensor, variant: str = "global",
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = x[idx[i]] with float32 ``x`` [n_win] and int32 ``idx``
    [n_idx] in [0, n_win), by the ``variant`` kernel ("window" or
    "global")."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.dim() != 1 or idx.dim() != 1:
        raise ValueError("x and idx must be 1-D")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather takes float32 x and int32 idx, not "
                        f"{x.dtype} and {idx.dtype}")
    if x.device != idx.device:
        raise ValueError("x and idx must lie on one device")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather needs contiguous tensors")
    if variant == "window":
        limit = window_limit_bytes(x.device)
        need = x.numel() * x.element_size()
        if need > limit:
            raise ValueError(
                f"shared-window gather: the window of {x.numel()} float32 "
                f"values needs {need} bytes of shared memory, above the "
                f"{limit} bytes a block may use on this device")
    if out is None:
        out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    elif out.shape != idx.shape or out.dtype != x.dtype or \
            out.device != x.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous float32 tensor shaped "
                         "like idx on x's device")
    if x.device.type == "cpu":
        return out.copy_(gather_plain(x, idx))
    if x.device.type != "cuda":
        raise ValueError(f"gather runs on cuda or cpu, not {x.device}")
    lib = load_library()
    fn = lib.gather_window_f32 if variant == "window" else \
        lib.gather_global_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.numel(),
                 idx.numel(), stream)
    if err != 0:
        raise RuntimeError(f"gather_probe kernel launch failed: CUDA error "
                           f"{err}")
    gather.launches += 1
    return out


gather.launches = 0


def probe_inputs(n_win: int, n_idx: int, device, seed: int = 0):
    """(x, idx) of the TPU probe: x uniform in [0, 1), idx uniform in
    [0, n_win), from a numpy generator."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random(n_win, dtype=np.float32),
                     dtype=torch.float32, device=device)
    idx = torch.tensor(rng.integers(0, n_win, n_idx), dtype=torch.int32,
                       device=device)
    return x, idx


def bound_ms(n_win: int, n_idx: int) -> float:
    """Least time of one gather on the card: idx read, out written and x
    read once each, at the device memory rate."""
    return (4 * n_idx * 2 + 4 * n_win) / PEAK_BYTES_PER_S * 1e3


def run(device=None, reps: int = 50) -> list:
    """Time both variants at both sizes on the card, each checked bitwise
    against the plain version.  Returns one dict per (size, variant); a
    window that does not fit gets ``"error"`` instead of times."""
    from .timing import cuda_time_ms
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise RuntimeError("the gather probe measures the card; CUDA is "
                           "required")
    rows = []
    for n_win, n_idx in SIZES:
        x, idx = probe_inputs(n_win, n_idx, device)
        ref = gather_plain(x, idx)
        # each call is shorter than its host dispatch: replay the calls
        # from a CUDA graph to time the device alone
        plain_ms = cuda_time_ms(lambda: gather_plain(x, idx), reps=reps,
                                graph=True)
        lib_ms = cuda_time_ms(lambda: torch.index_select(x, 0, idx),
                              reps=reps, graph=True)
        for variant in VARIANTS:
            row = {"n_win": n_win, "n_idx": n_idx, "variant": variant,
                   "bound_ms": bound_ms(n_win, n_idx), "plain_ms": plain_ms,
                   "library_ms": lib_ms}
            try:
                out = gather(x, idx, variant)
            except ValueError as e:
                row["error"] = str(e)
                print(f"[gather_probe] {variant} {n_idx} from {n_win}: "
                      f"{e}", flush=True)
                rows.append(row)
                continue
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"gather {variant} differs from the "
                                     f"plain version at {n_win, n_idx}")
            ms = cuda_time_ms(lambda: gather(x, idx, variant, out=out),
                              reps=reps, graph=True)
            host_ms = cuda_time_ms(lambda: gather(x, idx, variant, out=out),
                                   reps=reps)
            row.update(ms=ms, host_ms=host_ms,
                       m_per_s=n_idx / (ms * 1e-3) / 1e6,
                       max_abs_err=float((out - ref).abs().max()))
            print(f"[gather_probe] {variant} {n_idx} from {n_win}: "
                  f"{ms:.4f} ms ({row['m_per_s']:.0f} M/s; graph replay), "
                  f"{host_ms:.4f} ms per eager call; plain {plain_ms:.4f} "
                  f"ms, index_select {lib_ms:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms: launch-bound, bitwise equal",
                  flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    rows = run(reps=ap.parse_args(argv).reps)
    print(json.dumps({"gather_probe": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
