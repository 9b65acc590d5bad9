"""The collectives of the port's multi-device layer
(``metafem_torch/parallel/comm.py``) on two gloo ranks on the CPU.

Every sum is taken on the tensors' own device, in rank order: the
transports only move bytes.  Each rank runs with the reducing
collectives of ``torch.distributed`` (all_reduce, reduce_scatter and
their tensor forms) replaced by functions that raise, and holds
``comm.reduce_scatter`` and ``comm.all_reduce`` (small and large) bitwise
to the rank-order sum of every rank's input, rebuilt from the seeds.
"""

import os

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANKS = 2


def _inputs(rank, n, dtype):
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randn(n, generator=g, dtype=torch.float64).to(dtype)


def _rank_sum(n, dtype):
    acc = _inputs(0, n, dtype).clone()
    for r in range(1, RANKS):
        acc += _inputs(r, n, dtype)
    return acc


def _worker(rank, store_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=RANKS)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from metafem_torch.parallel import comm

        def refused(*a, **kw):
            raise AssertionError("a collective that adds was called")
        for name in ("all_reduce", "reduce_scatter", "reduce_scatter_tensor",
                     "reduce_scatter_single", "reduce"):
            if hasattr(dist, name):
                setattr(dist, name, refused)
        mesh = init_device_mesh("cpu", (RANKS,), mesh_dim_names=("el",))
        comm.reset_counts()
        results = []
        for dtype in (torch.float64, torch.float32):
            for n in (3, comm.SMALL + 5, 6 * comm.SMALL):
                t = _inputs(rank, n, dtype)
                got = comm.all_reduce(t, mesh)
                results.append(("all_reduce", str(dtype), n,
                                bool(torch.equal(got, _rank_sum(n, dtype)))))
            n = 4 * comm.SMALL
            got = comm.reduce_scatter(_inputs(rank, n, dtype), mesh)
            m = n // RANKS
            want = _rank_sum(n, dtype)[rank * m:(rank + 1) * m]
            results.append(("reduce_scatter", str(dtype), n,
                            bool(torch.equal(got, want))))
        counts = comm.counts()
        torch.save({"results": results, "counts": counts},
                   f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_sums_are_taken_on_the_device_in_rank_order(tmp_path):
    out = str(tmp_path / "out")
    mp.start_processes(_worker, args=(str(tmp_path / "store"), out),
                       nprocs=RANKS, start_method="spawn")
    for rank in range(RANKS):
        rec = torch.load(f"{out}.{rank}")
        bad = [r for r in rec["results"] if not r[-1]]
        assert not bad, bad
        assert len(rec["results"]) == 8
        c = rec["counts"]
        assert c["reduce_scatter_calls"] == 2 and c["reduce_scatter"] > 0
        assert c["all_reduce_calls"] == 6 and c["all_reduce"] > 0
        assert c["staged"] == 0             # CPU tensors: nothing staged
