"""Element-axis data parallelism over a DeviceMesh (explicit SPMD).

Port of ``metafem/parallel/dataparallel.py``.  The FEM "sequence" is the
element list, embarrassingly parallel for the gather, coefficient and
contraction stages: each rank keeps a contiguous block of every volume
element table and assembles it into partial sums, which one collective
combines (``assembly._run_sharded``): an all-reduce, so that the tangent
stays whole on every rank (the reference's default layout), or with a
row-sharded step (``make_jitted_step(rowshard_mesh=mesh)``) a
reduce-scatter onto the ranks' row windows (rowshard.py).  Boundary
batches stay whole on every rank and are added once, after the
collective.

The reference pads the element count with zero-weight elements because
GSPMD needs even splits; a rank's block here is elements
[E*rank//N, E*(rank+1)//N), so nothing is padded.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from . import comm
from .rowshard import (Sharding, put_divisible, rowblock_sharding,
                       row_window, shard_mg_state)


def element_sharding(mesh) -> Sharding:
    """A contiguous block of the leading element axis per rank."""
    return Sharding("elements", mesh)


def replicated_sharding(mesh) -> Sharding:
    return Sharding("replicated", mesh)


def make_mesh(n_devices: Optional[int] = None, device=None):
    """A 1-D ("el",) DeviceMesh over the first ``n_devices`` ranks of the
    initialized default group (all by default), on the device type of
    ``device`` (default: CUDA when the group's backend is NCCL, else the
    CPU).  Raises when torch.distributed is not initialized."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized "
                           "(init_process_group first)")
    n = n_devices or dist.get_world_size()
    if device is None:
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    else:
        kind = torch.device(device).type
    return DeviceMesh(kind, torch.arange(n), mesh_dim_names=("el",))


def element_range(n_el: int, mesh) -> tuple:
    """The rank's block [e0, e1) of n_el elements over the mesh's row
    axes."""
    _, rank, size = comm.row_group(mesh)
    return n_el * rank // size, n_el * (rank + 1) // size


def shard_domain_state(state: dict, mesh) -> dict:
    """A FEM_Domain runtime state (``_runtime_state``) for this rank of
    the mesh: a contiguous block of every volume element table, the
    frozen row-shaped caches cut to the rank's row window (``K_linear_td``,
    the refined A_td/b, the multigrid fine level), everything else
    whole."""
    out = dict(state)
    ranges = []
    wps = []
    for wp_state in state["wp"]:
        el = wp_state["el"]
        if el is None or el.get("itg_vals") is None \
                or el.get("weights") is None:
            raise RuntimeError(
                "shard_domain_state: the volume element tables were "
                "released by free_volume_tables(); call update_mesh() "
                "to rebuild them before sharding")
        e0, e1 = element_range(el["weights"].shape[0], mesh)
        ranges.append((e0, e1))
        wps.append({"el": {k: v[e0:e1] for k, v in el.items()},
                    "bdy": wp_state["bdy"], "fields": wp_state["fields"],
                    "el_range": (e0, e1)})
    out["wp"] = wps
    # the rank's block rebuilds its reduction maps and node reads at its
    # first assembly (assembly._shard_maps), kept here
    out["el_shard"] = {"mesh": mesh, "ranges": ranges, "maps": {}}
    # the refined step's nonaffine phases run on the frozen whole tables
    # of state["refined"], with the domain's maps
    rows = row_window(state["layout"], mesh)
    rb = rowblock_sharding(rows, 1)
    sb = rowblock_sharding(rows, 1, storage=True)
    # where the windows divide, the row-shaped caches are cut here and
    # the records say so (``rowshard.held``); else they stay whole
    cut_to = rows if rows.even else None
    out["cut_to"] = cut_to
    # a whole step gathers the cut caches back once and keeps them here
    # (``rowshard.uncut``; shared by the step's shallow copies)
    out["uncut"] = {}
    if state.get("mg_frozen") is not None:
        out["mg_frozen"] = shard_mg_state(state["mg_frozen"], rows)
    if state.get("K_linear_td") is not None:
        out["K_linear_td"] = put_divisible(state["K_linear_td"], sb, mesh)
    if state.get("refined") is not None:
        # the matrices that steps built from the whole record, and what
        # they gathered, belong to its layout
        ref = {k: v for k, v in state["refined"].items()
               if k not in ("A_mats", "A_packed", "uncut", "windows")}
        for k in ("A", "A_hi", "A_lo", "b", "b_hi", "b_lo"):
            if ref.get(k) is not None:
                ref[k] = put_divisible(ref[k], sb if k[0] == "A" else rb,
                                       mesh)
        ref["cut_to"] = cut_to
        ref["uncut"] = {}
        out["refined"] = ref
    return out
