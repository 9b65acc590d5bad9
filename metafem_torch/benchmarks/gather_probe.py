"""Random-gather probe: how fast are random reads from device memory and
from a window staged in the shared memory of a thread-block cluster?

    python3 -m metafem_torch.benchmarks.gather_probe

The counterpart of ``benchmarks/pallas_gather_probe.py`` (the TPU
package's VMEM gather probe, whose answer shaped its SpMV design).  The
kernels (``csrc/gather_probe.cu``) compute ``out[i] = x[idx[i]]`` for
float32 x and int32 idx in two variants, both persistent and
grid-striding with 4 outputs per thread and step:

- ``"window"``: a cluster of k blocks holds x in its shared memory, block
  r the r-th slice of ``slice_len(n_win, k)`` values, and every block
  reads any slice through distributed shared memory (``window_slices``
  gives the (rank, offset) the kernel computes for each index).  A block
  holds at most its opt-in shared memory (227 KB on an H100, 58,112
  float32 values) and a cluster at most ``max_cluster`` blocks (16 on an
  H100), so the window holds at most their product; larger windows raise
  ``ValueError``, there is no quiet switch to the other variant.  k
  defaults to the smallest cluster that holds the window;
- ``"global"``: x read through the read-only cache, any size.

The plain version is ``torch.take(x, idx.long())``; on a CPU tensor
``gather`` runs it, on a CUDA tensor it launches the kernel or raises.
The gather is exact, so the kernel and the plain version agree bitwise.
``gather.launches`` counts kernel launches.  The probe runs the TPU
probe's two sizes, (n_win, n_idx) = (16384, 131072) and (65536, 524288),
and the main path's counts with the same uniform random indices: x of
the 3D Neo-Hookean bar (541,059 values) and as many reads as one product
with its tangent makes (89,057,289 structural entries).  The tangent's
own read stream, with its locality, comes from its pack plan
(``spmv_stream``) and runs through ``probe_rows`` where the plan is
built (``chip_smoke.py``'s 3D phase).  Each row gives a variant's device
time per launch (CUDA-graph replay of back-to-back launches; the eager
per-call time beside it), M gathers/s, its share of the bytes bound and
its time over the launch floor (an empty kernel of the same library,
timed the same way), beside the plain version and
``torch.index_select``; the window runs at every cluster size it is
tried at (``cluster_sizes``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time
from typing import Optional

import numpy as np
import torch

from ..buildlib import build_cuda

#: the TPU probe's sizes (benchmarks/pallas_gather_probe.py:58)
TPU_SIZES = ((16384, 131072), (65536, 524288))
#: the main path's counts, with uniform random indices: x of
#: hyperelastic_3d at nel=(160,16,16) (541,059 DOF) and one read per
#: structural entry of its tangent (89,057,289); ``spmv_stream`` gives
#: the tangent's own read stream
MAIN_PATH_SIZE = (541059, 89057289)
SIZES = TPU_SIZES + (MAIN_PATH_SIZE,)
VARIANTS = ("window", "global")
#: an H100's opt-in shared memory per block (232,448 bytes), the window
#: limit checked for tensors off the card (on the card the device's own
#: is read)
H100_WINDOW_LIMIT_BYTES = 232448
#: the largest thread-block cluster on Hopper (8 is portable, 9-16 need
#: cudaFuncAttributeNonPortableClusterSizeAllowed); off the card the
#: window limit assumes it, on the card the largest the device launches
#: is read
MAX_CLUSTER = 16
#: H100 SXM device memory bandwidth, bytes/s (data sheet)
PEAK_BYTES_PER_S = 3.35e12

_LIB: Optional[ctypes.CDLL] = None
#: device index -> (the per-block window limit in bytes, the largest
#: cluster the device launches at that limit), read at the first use on
#: that device, before any graph capture
_DEVICE: dict = {}


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_cuda("gather_probe"))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        sigs = {
            "gather_cluster_f32": ([vp] * 3 + [i64] * 2 + [i32, i64, vp],
                                   i32),
            "gather_global_f32": ([vp] * 3 + [i64] * 2 + [vp], i32),
            "gather_empty": ([vp], i32),
            "gather_window_limit_bytes": ([i32], i32),
            "gather_cluster_setup": ([i32], i32),
            "gather_global_blocks": ([i64], i64),
            "gather_cluster_blocks": ([i64, i32, i64], i64),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _LIB = lib
    return _LIB


def _device_limits(device: torch.device) -> tuple:
    """(window limit bytes per block, largest cluster) of ``device``
    (``_DEVICE``), read and granted to the cluster kernel once per
    device."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _DEVICE:
        lib = load_library()
        v = lib.gather_window_limit_bytes(index)
        if v <= 0:
            raise RuntimeError("could not read the shared-memory limit")
        with torch.cuda.device(index):
            k_max = lib.gather_cluster_setup(v)
        if k_max < 0:
            raise RuntimeError(f"cluster kernel setup failed: CUDA error "
                               f"{-k_max}")
        if k_max == 0:
            raise RuntimeError("the card launches no cluster with a full "
                               "block of shared memory")
        _DEVICE[index] = (v, k_max)
    return _DEVICE[index]


def window_limit_bytes(device: torch.device) -> int:
    """Shared memory a block may opt in to on ``device``
    (cudaDevAttrMaxSharedMemoryPerBlockOptin); the H100's for the CPU."""
    if device.type != "cuda":
        return H100_WINDOW_LIMIT_BYTES
    return _device_limits(device)[0]


def max_cluster(device: torch.device) -> int:
    """The largest cluster ``device`` launches with a full block of shared
    memory each (cudaOccupancyMaxActiveClusters above 0); Hopper's for
    the CPU."""
    if device.type != "cuda":
        return MAX_CLUSTER
    return _device_limits(device)[1]


def slice_len(n_win: int, k: int) -> int:
    """Values of x each block of a k-block cluster holds: ceil(n_win/k)
    rounded up to a multiple of 4 (16-byte loads); the last block holds
    the rest."""
    per_block = -(-n_win // k)
    return -(-per_block // 4) * 4


def min_cluster(n_win: int, limit_bytes: int) -> int:
    """The smallest cluster whose blocks each hold their slice of an
    ``n_win`` window within ``limit_bytes``: slice_len(n_win, k) is at
    most the largest multiple of 4 values that fits, m, exactly when
    k * m >= n_win."""
    m = limit_bytes // 16 * 4
    return max(1, -(-n_win // m))


def window_slices(n_win: int, k: int):
    """(rank, offset) of every index in [0, n_win) in a k-block cluster,
    computed as the kernel computes them: the float32 product of the index
    and the rounded reciprocal of the slice length, truncated, then
    corrected by one step; equal to (j // slice, j % slice)."""
    s = slice_len(n_win, k)
    j = torch.arange(n_win, dtype=torch.int64)
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        float(s), dtype=torch.float32)
    r = (j.to(torch.float32) * inv).to(torch.int64)
    o = j - r * s
    low = (o < 0).to(torch.int64)
    r, o = r - low, o + low * s
    high = (o >= s).to(torch.int64)
    return r + high, o - high * s


def cluster_sizes(n_win: int, limit_bytes: int, k_max: int) -> list:
    """The cluster sizes the probe tries for an ``n_win`` window: the
    smallest that holds it, then each power of two above it up to
    ``k_max``."""
    k0 = min_cluster(n_win, limit_bytes)
    return [k0] + [k for k in (2, 4, 8, 16) if k0 < k <= k_max]


def gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out[i] = x[idx[i]]."""
    return torch.take(x, idx.long())


def _window_cluster(x: torch.Tensor, cluster: Optional[int]) -> tuple:
    """(k, slice length) of a window gather of ``x``, or ``ValueError``
    when no cluster on x's device holds it."""
    n_win = x.numel()
    limit = window_limit_bytes(x.device)
    k_max = max_cluster(x.device)
    if n_win > k_max * (limit // 16 * 4):
        raise ValueError(
            f"shared-window gather: the window of {n_win} float32 values "
            f"needs {4 * n_win} bytes of shared memory, above the {k_max} "
            f"x {limit} bytes a cluster of {k_max} blocks may hold on this "
            f"device")
    k = min_cluster(n_win, limit) if cluster is None else int(cluster)
    if not 1 <= k <= k_max:
        raise ValueError(f"shared-window gather: a cluster holds 1 to "
                         f"{k_max} blocks on this device, not {k}")
    s = slice_len(n_win, k)
    if 4 * s > limit:
        raise ValueError(
            f"shared-window gather: a cluster of {k} blocks cannot hold "
            f"the window of {n_win} float32 values ({4 * s} bytes per "
            f"block, above the {limit} bytes a block may use)")
    return k, s


def _no_cluster(k: int, s: int) -> ValueError:
    return ValueError(
        f"shared-window gather: the card schedules no cluster of {k} "
        f"blocks with {4 * s} bytes of shared memory each "
        f"(cudaOccupancyMaxActiveClusters is 0)")


def launch_blocks(x: torch.Tensor, n_idx: int, variant: str,
                  cluster: Optional[int] = None) -> int:
    """Blocks the ``variant`` kernel launches on x's card for ``n_idx``
    gathers from ``x``, as the kernel library sizes its grid."""
    lib = load_library()
    with torch.cuda.device(x.device):
        if variant == "global":
            n = lib.gather_global_blocks(n_idx)
        else:
            k, s = _window_cluster(x, cluster)
            n = lib.gather_cluster_blocks(n_idx, k, s)
            if n == 0:
                raise _no_cluster(k, s)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def gather(x: torch.Tensor, idx: torch.Tensor, variant: str = "global",
           out: Optional[torch.Tensor] = None,
           cluster: Optional[int] = None) -> torch.Tensor:
    """out[i] = x[idx[i]] with float32 ``x`` [n_win] and int32 ``idx``
    [n_idx] in [0, n_win), by the ``variant`` kernel ("window" or
    "global").  ``cluster`` is the window's cluster size (default: the
    smallest that holds it)."""
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather runs on cuda or cpu, not {x.device}")
    if variant == "window":
        k, s = _window_cluster(x, cluster)
    elif cluster is not None:
        raise ValueError("only the window variant takes a cluster size")
    if out is None:
        out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    elif out.shape != idx.shape or out.dtype != x.dtype or \
            out.device != x.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous float32 tensor shaped "
                         "like idx on x's device")
    if x.device.type == "cpu":
        return out.copy_(gather_plain(x, idx))
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "window":
            err = lib.gather_cluster_f32(
                x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.numel(),
                idx.numel(), k, s, stream)
            if err == -1:
                raise _no_cluster(k, s)
        else:
            err = lib.gather_global_f32(
                x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.numel(),
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


def launch_floor_ms(device, reps: int = 50) -> float:
    """Device time per launch of an empty kernel of the probe's library,
    timed as the kernels are (``reps`` launches in one CUDA graph)."""
    from .timing import cuda_time_ms
    lib = load_library()

    def empty():
        err = lib.gather_empty(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error "
                               f"{err}")
    with torch.cuda.device(device):
        return cuda_time_ms(empty, reps=reps, graph=True)


def spmv_stream(plan, occupied: torch.Tensor) -> tuple:
    """(n_win, idx) of the x reads one packed SpMV over ``plan`` makes
    (``offset_spmv.PackPlan``), in the order of its packed values: a
    row's slot group, then the next row's, as a warp of the kernel reads
    them.  Only reads of occupied control points' values count (a ghost
    point's row holds only its diagonal, a read a mesh off the lattice
    does not make), renumbered to a compact x of n_win = C x occupied
    values; ``occupied`` is the bool mask over the plan's control
    points."""
    from ..linsolve.offset_spmv import packed_columns
    if occupied.shape != (plan.group.n_cp,):
        raise ValueError(f"occupied must be a mask over the plan's "
                         f"{plan.group.n_cp} control points")
    kept = plan.columns is not None
    cols = packed_columns(plan)
    if not kept:
        plan.columns = None
    real = torch.ones(plan.n_packed, dtype=torch.bool, device=cols.device)
    real[plan.pad] = False
    cols = cols[real]
    occ = occupied.to(cols.device, torch.bool).repeat(plan.group.n_vars)
    cols = cols[occ[cols]]
    rank = torch.cumsum(occ, 0) - 1
    return int(occ.sum()), rank[cols].to(torch.int32)


def probe_rows(x: torch.Tensor, idx: torch.Tensor, floor: float,
               reps: int = 50, indices: str = "uniform") -> list:
    """Time both variants on the card for one (x, idx), the window at
    each of ``cluster_sizes``, each checked bitwise against the plain
    version: one dict per (variant, cluster size), tagged ``indices``.  A
    window the card refuses gets ``"error"`` instead of times; the
    fastest window is marked ``"chosen"``.  ``floor``: the launch floor
    (``launch_floor_ms``)."""
    from .timing import cuda_time_ms
    n_win, n_idx = x.numel(), idx.numel()
    limit, k_max = _device_limits(x.device)
    ref = gather_plain(x, idx)
    out = torch.empty_like(ref)
    # each call at the TPU probe's sizes is shorter than its host
    # dispatch: replay the calls from a CUDA graph to time the device;
    # fewer of them at the main path's size (~1 ms each)
    n = max(5, min(reps, (1 << 30) // n_idx))
    plain_ms = cuda_time_ms(lambda: gather_plain(x, idx), reps=n, graph=True)
    lib_ms = cuda_time_ms(lambda: torch.index_select(x, 0, idx), reps=n,
                          graph=True)
    bound = bound_ms(n_win, n_idx)
    size = f"{n_idx} from {n_win} ({indices})"
    print(f"[gather_probe] {size}: bound {bound * 1e3:.3f} us, plain "
          f"{plain_ms * 1e3:.3f} us, index_select {lib_ms * 1e3:.3f} us",
          flush=True)
    runs = [("global", None)] + [
        ("window", k) for k in cluster_sizes(n_win, limit, k_max)]
    rows = []
    for variant, k in runs:
        row = {"n_win": n_win, "n_idx": n_idx, "indices": indices,
               "variant": variant, "cluster": k, "bound_ms": bound,
               "floor_ms": floor, "plain_ms": plain_ms,
               "library_ms": lib_ms}
        tag = f"{variant}" + (f" k={k}" if k else "")
        try:
            gather(x, idx, variant, out=out, cluster=k)
        except ValueError as e:
            row["error"] = str(e)
            print(f"[gather_probe] {tag} {size}: refused: {e}", flush=True)
            rows.append(row)
            continue
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"gather {tag} differs from the plain "
                                 f"version at {size}")
        row["blocks"] = launch_blocks(x, n_idx, variant, k)
        ms = cuda_time_ms(lambda: gather(x, idx, variant, out=out,
                                         cluster=k), reps=n, graph=True)
        host_ms = cuda_time_ms(lambda: gather(x, idx, variant, out=out,
                                              cluster=k), reps=n)
        row.update(ms=ms, host_ms=host_ms, bound_share=bound / ms,
                   over_floor=ms / floor,
                   m_per_s=n_idx / (ms * 1e-3) / 1e6,
                   max_abs_err=float((out - ref).abs().max()))
        print(f"[gather_probe] {tag} {size}, {row['blocks']} blocks: "
              f"{ms * 1e3:.3f} us ({row['m_per_s']:.0f} M/s; graph "
              f"replay), {100 * row['bound_share']:.1f}% of the bytes "
              f"bound, {row['over_floor']:.2f}x the floor; "
              f"{host_ms * 1e3:.3f} us per eager call; plain "
              f"{plain_ms * 1e3:.3f} us, index_select {lib_ms * 1e3:.3f} "
              f"us; bitwise equal", flush=True)
        rows.append(row)
    windows = [r for r in rows if r["variant"] == "window" and "ms" in r]
    if windows:
        best = min(windows, key=lambda r: r["ms"])
        best["chosen"] = True
        print(f"[gather_probe] {size}: fastest window k={best['cluster']}",
              flush=True)
    return rows


def run(device=None, reps: int = 50) -> list:
    """``probe_rows`` at every size of ``SIZES`` on the card, with the
    probe's uniform random indices (``probe_inputs``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise RuntimeError("the gather probe measures the card; CUDA is "
                           "required")
    floor = launch_floor_ms(device, reps)
    limit, k_max = _device_limits(device)
    print(f"[gather_probe] launch floor {floor * 1e3:.3f} us (empty kernel, "
          f"graph replay); window limit {limit} bytes per block, clusters "
          f"of up to {k_max} blocks", flush=True)
    rows = []
    for n_win, n_idx in SIZES:
        t0 = time.perf_counter()
        x, idx = probe_inputs(n_win, n_idx, device)
        torch.cuda.synchronize()
        print(f"[gather_probe] {n_idx} from {n_win}: inputs "
              f"{time.perf_counter() - t0:.2f} s (numpy, host copy)",
              flush=True)
        rows += probe_rows(x, idx, floor, reps)
        # the main path's size holds ~1 GB on the card: free it before the
        # next size and the next phase
        del x, idx
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    rows = run(reps=ap.parse_args(argv).reps)
    print(json.dumps({"gather_probe": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
