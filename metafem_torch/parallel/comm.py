"""The collectives of the multi-device layer, over a DeviceMesh's row
axes.

The reference declares layouts and lets XLA insert every collective
(``metafem/parallel/rowshard.py``); PyTorch has no such compiler for
this code, so the port calls them by name, from these functions only:

* ``all_gather(t, mesh)``: [N, *t.shape], rank by rank;
* ``reduce_scatter(t, mesh)``: the sum over ranks of block r of t (t
  holds N equal blocks) on rank r: one all-to-all brings every rank's
  block r to rank r, which adds the N blocks in rank order;
* ``all_reduce(t, mesh)``: the sum over ranks, the same bits on every
  rank.  A small tensor (a Krylov dot, a norm) is all-gathered and summed
  in rank order; a large one is reduce-scattered and all-gathered.
  Either way each element is summed once, by one rank, and every rank
  receives those bits, so every rank takes the same branch of a solver.

The transports only move bytes: every sum is taken here, on the
tensors' own device, in rank order (``_sum_ranks``); no collective that
adds is called.

With more than one mesh axis the axes are flattened into one group of
ranks, rank-major in the mesh's order (``row_group``; the reference's
``_row_axes``).  On an NCCL group the tensors stay on the card.  Gloo is
a host transport: on a gloo group a CUDA tensor is copied to pinned host
memory and back, always, and ``counts()["staged"]`` says how many bytes
were copied; no arithmetic moves to the host, since the transports do
none.

``counts()`` also keeps the calls and the bytes each rank sends per
collective: all-gather (N-1)·B of its B input bytes, reduce-scatter
(N-1)/N·B (the blocks the all-to-all sends away), all-reduce the sum of
its two halves.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

#: numel up to which all_reduce gathers and sums in rank order
SMALL = 4096

_COUNTS: Dict[str, int] = {}
_GROUPS: dict = {}
_PINNED: dict = {}


def reset_counts() -> None:
    for k in ("all_gather", "reduce_scatter", "all_reduce"):
        _COUNTS[k] = 0
        _COUNTS[k + "_calls"] = 0
    _COUNTS["staged"] = 0


reset_counts()


def counts() -> dict:
    """Calls and bytes sent per collective since ``reset_counts``, and
    the bytes staged through pinned host memory."""
    return dict(_COUNTS)


def row_group(mesh) -> Tuple[object, int, int]:
    """(process group, rank, size) of the mesh's row axes: the mesh's
    one group, or with several axes one group over all of them, ranks in
    the mesh's row-major order (which must be ascending)."""
    key = id(mesh)
    hit = _GROUPS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    if mesh.ndim == 1:
        group = mesh.get_group(0)
    else:
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        if ranks != sorted(ranks):
            raise ValueError(f"the mesh's ranks {ranks} are not in "
                             f"ascending row-major order")
        if ranks == list(range(dist.get_world_size())):
            group = dist.group.WORLD
        else:
            group = dist.new_group(ranks)
    out = (group, dist.get_rank(group), dist.get_world_size(group))
    _GROUPS[key] = (mesh, out)
    return out


def _pinned(tag: str, like: torch.Tensor, shape) -> torch.Tensor:
    """A pinned host buffer of ``shape`` in like's dtype, kept per
    (tag, shape, dtype): every copy into or out of it is synchronous, so
    it is free again when the call that used it returns."""
    key = (tag, tuple(shape), like.dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = torch.empty(shape, dtype=like.dtype, pin_memory=True)
        _PINNED[key] = buf
    return buf


def _call(name: str, fn, out: torch.Tensor, inp: torch.Tensor, group,
          sent: int) -> torch.Tensor:
    """Run fn(out, inp, group) on the group's transport: staged through
    pinned host memory for a CUDA tensor on a gloo group.  The bytes go
    to ``name``'s counter (an all-reduce counts its pieces as one
    call)."""
    _COUNTS[name] += sent
    if name != "all_reduce":
        _COUNTS[name + "_calls"] += 1
    if inp.device.type == "cuda" and dist.get_backend(group) == "gloo":
        h_in = _pinned("in", inp, inp.shape)
        h_out = _pinned("out", out, out.shape)
        h_in.copy_(inp)
        fn(h_out, h_in, group=group)
        out.copy_(h_out)
        _COUNTS["staged"] += (inp.numel() + out.numel()) * inp.element_size()
        return out
    fn(out, inp, group=group)
    return out


def _gather_fn():
    return getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor


def _sum_ranks(blocks: torch.Tensor) -> torch.Tensor:
    """blocks [N, ...] -> their sum, added in rank order on blocks'
    device."""
    acc = blocks[0].clone()
    for r in range(1, blocks.shape[0]):
        acc += blocks[r]
    return acc


def all_gather(t: torch.Tensor, mesh, name: str = "all_gather"
               ) -> torch.Tensor:
    """[N, *t.shape]: every rank's t, in rank order (t has the same shape
    on every rank).  ``name``: the counter its bytes go to."""
    group, _, n = row_group(mesh)
    if n == 1:
        return t.unsqueeze(0).clone()
    flat = t.reshape(-1).contiguous()
    out = torch.empty(n * flat.numel(), dtype=t.dtype, device=t.device)
    _call(name, _gather_fn(), out, flat, group,
          (n - 1) * flat.numel() * t.element_size())
    return out.view((n,) + tuple(t.shape))


def reduce_scatter(t: torch.Tensor, mesh, name: str = "reduce_scatter"
                   ) -> torch.Tensor:
    """t [N*m, ...] (the same shape on every rank) -> the sum over ranks
    of rows [r*m, (r+1)*m) on rank r: an all-to-all moves each block to
    its rank, which adds the N blocks in rank order.  ``name``: the
    counter its bytes go to."""
    group, _, n = row_group(mesh)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: {t.shape[0]} rows do not split "
                         f"over {n} ranks")
    if n == 1:
        return t.clone()
    flat = t.reshape(-1).contiguous()
    got = torch.empty_like(flat)
    _call(name, dist.all_to_all_single, got, flat, group,
          (n - 1) * (flat.numel() // n) * t.element_size())
    return _sum_ranks(got.view(n, -1)).view(
        (t.shape[0] // n,) + tuple(t.shape[1:]))


def all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of t over ranks, the same bits on every rank (see the
    module docstring).  With one rank t itself."""
    _, _, n = row_group(mesh)
    if n == 1:
        return t
    _COUNTS["all_reduce_calls"] += 1
    if t.numel() <= SMALL:
        return _sum_ranks(all_gather(t, mesh, "all_reduce"))
    flat = t.reshape(-1)
    m = -(-flat.numel() // n)
    pad = torch.nn.functional.pad(flat, (0, m * n - flat.numel()))
    part = reduce_scatter(pad, mesh, "all_reduce")
    return all_gather(part, mesh, "all_reduce").reshape(-1)[
        :flat.numel()].view(t.shape)
