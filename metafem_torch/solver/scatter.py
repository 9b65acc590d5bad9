"""Scatter-free reduction: precomputed padded gather maps.

Port of ``metafem/solver/scatter.py``.  The assembly's "scatter
contributions into slots" step is inverted at setup time: for every output
slot the (padded, capped) list of contribution indices is precomputed on
the host, and the runtime reduction becomes

    out[s] = sum_k data_padded[gmap[s, k]]

— gathers and a small dense sum.  Slots with more than ``cap``
contributions spill into a small overflow reduced by a sorted segment
sum.  The summation order is fixed, so results repeat bitwise: on CUDA
``index_add_``/``scatter_add_`` would use atomics and change the order
from run to run, so neither is used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..linsolve import twofloat as tf
from ..linsolve.block_offset import sorted_segment_plan, sorted_segment_sum


@dataclasses.dataclass
class GatherReduce:
    """HOST (numpy) index maps; maps_to_device uploads them."""
    num: int                      # number of output slots
    n_data: int                   # contribution count (sentinel index)
    gmap: np.ndarray              # [num, cap] int32, sentinel = n_data
    overflow_src: Optional[np.ndarray]   # [n_of] int32 into data
    overflow_dst: Optional[np.ndarray]   # [n_of] int32 slot ids


def build_gather_reduce(slots: np.ndarray, num: int,
                        cap: int = 8) -> GatherReduce:
    """Invert a contribution->slot map.  ``slots``: [N] target slot per
    contribution (all in [0, num))."""
    from ..native import invert_map
    slots = np.asarray(slots)
    gmap, of_src, of_dst, _k = invert_map(slots, num, cap)
    return GatherReduce(num=num, n_data=slots.size, gmap=gmap,
                        overflow_src=of_src, overflow_dst=of_dst)


def build_compact_gather_reduce(slots: np.ndarray, num: int,
                                cap: int = 8,
                                compact_threshold: float = 0.2):
    """Like build_gather_reduce, but when the touched slots are a small
    fraction of ``num`` (e.g. boundary-only nonlinear tangent blocks), the
    reduction runs over the compact touched set and is expanded to full
    size by one tiny scatter — instead of iterating every output slot.

    Returns (GatherReduce over compact slots, touched np.ndarray | None).
    ``touched is None`` means the map is full-size."""
    slots = np.asarray(slots)
    # O(N) touched-set detection (np.unique would sort 1e8+ entries),
    # and each slot's rank in the touched set through a num-long table:
    # one scatter and one gather, where a searchsorted of every slot in
    # the touched list costs O(N log n_touched) random reads (the
    # unstructured tangent's BSR-tail storage is ~90% stored zeros, so
    # its K streams take this compact path with N ~ 1e8)
    counts = np.bincount(slots, minlength=num)
    touched = np.flatnonzero(counts)
    n_touched = touched.size
    del counts
    if n_touched > compact_threshold * num:
        return build_gather_reduce(slots, num, cap), None
    rank = np.empty(num, np.int64 if n_touched >= 2 ** 31 else np.int32)
    rank[touched] = np.arange(n_touched, dtype=rank.dtype)
    compact = rank[slots]
    del rank
    return build_gather_reduce(compact, n_touched, cap), touched


def maps_to_device(gr: Optional[GatherReduce], device) -> Optional[dict]:
    """Upload a GatherReduce's index arrays once, as int64 tensors.  The
    map is stored flat and column-major ([cap * num]) so each of the cap
    passes is one contiguous 1-D index; the overflow carries its sorted
    segment-sum plan."""
    if gr is None:
        return None
    out = {"gmap_flat": torch.as_tensor(
        np.ascontiguousarray(gr.gmap.T).reshape(-1).astype(np.int64),
        device=device)}
    if gr.overflow_src is not None:
        out["of_src"] = torch.as_tensor(gr.overflow_src.astype(np.int64),
                                        device=device)
        out["of_plan"] = sorted_segment_plan(gr.overflow_dst, device)
    return out


def apply_device_maps(maps: Optional[dict], data: torch.Tensor,
                      num: int) -> torch.Tensor:
    if maps is None:
        return torch.zeros(num, dtype=data.dtype, device=data.device)
    padded = torch.cat([data, torch.zeros(1, dtype=data.dtype,
                                           device=data.device)])
    gmap_flat = maps["gmap_flat"]
    n = num
    cap = gmap_flat.shape[0] // n
    out = padded[gmap_flat[0:n]]
    for k in range(1, cap):
        out = out + padded[gmap_flat[k * n:(k + 1) * n]]
    if "of_src" in maps:
        out = out + sorted_segment_sum(data[maps["of_src"]],
                                       maps["of_plan"], num)
    return out


def apply_device_maps_df(maps: Optional[dict], data, num: int):
    """Two-float ``apply_device_maps``: ``data`` is a DF pair of
    contribution values, and each slot's cap-term sum is
    two_sum-compensated (a slot's contributions may cancel, and a plain
    float32 sum would bring back the float32 assembly floor that the
    two-float mode removes).  The overflow reduces through one float64
    sorted segment sum, split back and df_added.  Same fixed order as
    ``apply_device_maps``: no atomics."""
    dev = data.hi.device
    if maps is None:
        z = torch.zeros(num, dtype=torch.float32, device=dev)
        return tf.DF(z, z.clone())
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    pad_hi = torch.cat([data.hi, zero])
    pad_lo = torch.cat([data.lo, zero])
    gmap_flat = maps["gmap_flat"]
    n = num
    cap = gmap_flat.shape[0] // n
    idx = gmap_flat[0:n]
    s, c = pad_hi[idx], pad_lo[idx]
    for k in range(1, cap):
        idx = gmap_flat[k * n:(k + 1) * n]
        s, e = tf.two_sum(s, pad_hi[idx])
        c = c + (e + pad_lo[idx])
    out = tf.df_normalize(s, c)
    if "of_src" in maps:
        v64 = tf.df_to_f64(tf.DF(data.hi[maps["of_src"]],
                                 data.lo[maps["of_src"]]))
        t64 = sorted_segment_sum(v64, maps["of_plan"], num)
        out = tf.df_add(out, tf.df_from_f64(t64))
    return out
