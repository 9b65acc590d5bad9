"""Profiling hooks and the device-memory ledger.

The counterpart of the reference package's ``utils/profiling.py`` for
the port.  MetaFEM.jl's observability is @time wrappers and a recursive
report_memory byte counter (misc/02_Global_Macros.jl:140-172).  Here: a
phase timer that waits for the devices of the tensors its caller hands
it (so asynchronous launches don't fake the number), a
``torch.profiler`` trace exported as a Chrome trace, and a ledger of the
runtime state's bytes per subsystem.

    with phase_timer("step", results=times) as out:
        x, _, res, _ = step(state, x, 0.0, 1.0)
        out.append(x)                      # waits for x's device
    with trace_profile("traces/") as prof:  # traces/trace_<pid>.json
        step(state, x, 0.0, 1.0)
    memory_report(dom, "MB")               # {"wp0.geometry": ..., ...}
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

_UNITS = {"B": 1.0, "KB": 2 ** 10, "MB": 2 ** 20, "GB": 2 ** 30}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _sync(tensors) -> None:
    """Wait for every CUDA device that holds one of ``tensors``."""
    devices = {t.device for t in _leaves(tensors)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def phase_timer(label: str, results: Dict[str, float] | None = None,
                verbose: bool = True):
    """Wall-time a phase on the host clock.  The caller may append
    tensors to the yielded list: at exit the timer waits for the CUDA
    devices that hold them before it reads the clock."""
    t0 = time.perf_counter()
    out: list = []
    yield out
    _sync(out)
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = results.get(label, 0.0) + dt
    if verbose:
        print(f"[metafem_torch] {label}: {dt * 1e3:.2f} ms")


@contextlib.contextmanager
def trace_profile(logdir: str):
    """A ``torch.profiler`` trace of the block, CPU activity and, where
    CUDA is available, the card's kernels and copies; at exit it is
    exported as a Chrome trace to ``logdir/trace_<pid>.json`` (the path
    is the profiler's ``trace_path`` attribute).  Yields the profiler,
    whose ``key_averages()`` and ``events()`` stay readable."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(prof.trace_path)


def _nbytes(tree) -> int:
    """Bytes of the tensors and arrays of ``tree``; 8 per Python
    number, as the reference counts them."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        elif isinstance(leaf, (int, float)):
            total += 8
    return total


def memory_report(domain, unit: str = "MB") -> Dict[str, float]:
    """Bytes of the domain's state per subsystem (the reference's
    ledger, the analog of MetaFEM.jl's report_memory), with the
    reference's keys and arithmetic: the geometry tables and fields of
    each workpiece, x and dx, two K buffers of the pattern's nnz entries
    (linear and total) and its CSR index arrays, the user state, and
    their sum.  It does not see the freezes, the multigrid levels, pack
    plans or gather maps."""
    div = _UNITS[unit]
    rep: Dict[str, float] = {}
    if domain.state is not None:
        for i, wps in enumerate(domain.state["wp"]):
            rep[f"wp{i}.geometry"] = (_nbytes(wps["el"])
                                      + _nbytes(wps["bdy"])) / div
            rep[f"wp{i}.fields"] = _nbytes(wps["fields"]) / div
    if domain.x is not None:
        rep["globalfield.x/dx"] = (_nbytes(domain.x)
                                   + _nbytes(domain.dx)) / div
    if domain.pattern is not None:
        p = domain.pattern
        itemsize = 8 if domain.dtype == torch.float64 else 4
        rep["sparse.K(linear+total)"] = 2 * p.nnz * itemsize / div
        # the CSR view's arrays (csr_perm int32, rows_sorted and
        # cols_sorted of the COO dtypes), counted without building it
        rep["sparse.indices"] = p.nnz * (
            4 + p.coo_rows.itemsize + p.coo_cols.itemsize) / div
    rep["user_state"] = _nbytes(domain.user_state) / div
    rep[f"TOTAL ({unit})"] = sum(v for k, v in rep.items()
                                 if not k.startswith("TOTAL"))
    return rep
