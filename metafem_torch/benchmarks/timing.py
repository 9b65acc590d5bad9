"""Device timing of a call with CUDA events."""

from __future__ import annotations

import numpy as np
import torch


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3, batches: int = 5,
                 graph: bool = False) -> float:
    """Device time in ms of one call of ``fn``: CUDA events around
    ``reps`` back-to-back calls, divided by ``reps``; the median over
    ``batches`` such runs, after ``warmup`` calls.

    Back-to-back calls keep the queue full when a call takes longer on
    the device than on the host.  For calls shorter than their host
    dispatch (a few microseconds), ``graph=True`` captures the ``reps``
    calls in one CUDA graph and times its replays, which measures the
    device alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                             # warm on the capture stream
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if graph:
            run()
        else:
            for _ in range(reps):
                run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))
