"""Lattice fast path for the assembly reduction — strided in-place adds.

Port of ``metafem/solver/lattice_reduce.py``.  On structured meshes with
lattice control-point numbering (mesh/fem_mesh.py) every volume
contribution stream is *affine*: for a fixed local pair (a, b),
element (e_1..e_d) contributes to storage slot

    base + ravel_lattice(p * e + k0)        (p = itp order per axis)

i.e. contributions tile a stride-p sub-lattice of one dense diagonal
segment (and likewise residual streams tile the DOF lattice).  The
reduction is then one strided in-place add per column,

    target[base:base + n_cp].view(lattice)[k0::p, ...] += column,

which is exact (each target entry receives one value per column) and
deterministic (columns are added in list order).  The reference's TPU
form (0/1 selection matmuls and a ``lax.scan``) places the same values in
the same order.  Streams that fail the exact host-side verification
(boundary parts, unstructured meshes, COO spill) go through the gather
maps of scatter.py.  ``scan_apply_group_df`` is the two-float form
(the refined step's ``df32`` residual): placement is exact, so hi and lo
are placed apart and only the accumulation is a df_add.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..linsolve import twofloat as tf


@dataclasses.dataclass(frozen=True)
class FastStream:
    """One affine contribution column: add vals[:, col] (el-major) into
    ``target[base : base + prod(lattice)]`` at sub-lattice ``p*e + k0``."""
    col: int                      # flat column index within the stream
    base: int                     # storage/dof offset of the lattice block
    k0: Tuple[int, ...]           # per-axis start within the lattice
    p: int                        # per-axis stride (itp order)
    el_grid: Tuple[int, ...]      # element grid (row-major = el order)
    lattice: Tuple[int, ...]      # cp lattice shape of the block


def fit_stream_columns(slots: np.ndarray, lattice: Tuple[int, ...],
                       block_of: "callable"):
    """Try to express the columns of ``slots`` [E, n_cols] as affine
    sub-lattice maps.  ``block_of(slot)`` -> base of the lattice block
    containing the slot (dense-segment start for K, dof-block start for
    residuals), or None.  Returns (fast_list, rest_cols): FastStream per
    fitting column + the indices of columns that must use the generic
    gather path (e.g. pairs whose offset spilled to the COO tail).
    Returns (None, all columns) when the element grid itself does not
    factor (unstructured mesh / reordered elements)."""
    E, n_cols = slots.shape
    all_cols = np.arange(n_cols)
    n_cp = int(np.prod(lattice))

    # infer the element grid: common stride p with (L-1) % p == 0
    el_grid = None
    for p in (1, 2, 3, 4):
        if all((L - 1) % p == 0 and (L - 1) // p > 0 for L in lattice):
            cand = tuple((L - 1) // p for L in lattice)
            if int(np.prod(cand)) == E:
                el_grid = cand
                p_fit = p
                break
    if el_grid is None:
        return None, all_cols

    grids = np.meshgrid(*[np.arange(g) for g in el_grid], indexing="ij")
    strides = np.cumprod((1,) + lattice[:0:-1])[::-1]

    out: List[FastStream] = []
    rest: List[int] = []
    for c in range(n_cols):
        col = slots[:, c]
        base = block_of(int(col[0]))
        ok = base is not None
        if ok:
            rel0 = int(col[0]) - base
            ok = 0 <= rel0 < n_cp
        if ok:
            k0 = np.unravel_index(rel0, lattice)
            ok = (all(int(k) <= p_fit for k in k0)      # k0 in [0, p]
                  and all(int(k) + p_fit * (g - 1) < L
                          for k, g, L in zip(k0, el_grid, lattice)))
        if ok:
            expect = base + sum(
                (p_fit * g.reshape(-1) + int(k)) * s
                for g, k, s in zip(grids, k0, strides))
            ok = np.array_equal(expect, col)
        if ok:
            out.append(FastStream(col=c, base=base,
                                  k0=tuple(int(k) for k in k0), p=p_fit,
                                  el_grid=el_grid, lattice=lattice))
        else:
            rest.append(c)
    return out, np.asarray(rest, dtype=np.int64)


def _sub_lattice(fs: FastStream):
    return tuple(slice(k, k + fs.p * (g - 1) + 1, fs.p)
                 for k, g in zip(fs.k0, fs.el_grid))


def gather_lattice_nodes(block_vals: torch.Tensor,
                         fs_list: List[FastStream]) -> torch.Tensor:
    """Inverse-direction fast path: read the element-node values
    ``out[e, a] = block_vals[ravel(p*e + k0_a)]`` as per-node strided
    lattice slices instead of a [E, na] gather."""
    lat = block_vals.view(fs_list[0].lattice)
    return torch.stack([lat[_sub_lattice(fs)].reshape(-1)
                        for fs in fs_list], dim=1)          # [E, na]


def apply_fast_stream(target: torch.Tensor, vals_col: torch.Tensor,
                      fs: FastStream) -> None:
    """In place: target[base : base+n_cp] += interleave(vals_col), as one
    strided add onto the stream's sub-lattice."""
    n_cp = int(np.prod(fs.lattice))
    block = target[fs.base:fs.base + n_cp].view(fs.lattice)
    block[_sub_lattice(fs)] += vals_col.reshape(fs.el_grid)


def scan_apply_group(target: torch.Tensor,
                     pairs: List[Tuple[torch.Tensor, FastStream]]
                     ) -> torch.Tensor:
    """Accumulate every (vals_col, FastStream) pair into the flat
    ``target`` in list order (the reference's ``lax.scan`` order), in
    place; returns ``target``."""
    for col, fs in pairs:
        apply_fast_stream(target, col, fs)
    return target


def scan_apply_group_df(target, pairs):
    """Two-float ``scan_apply_group``: ``target`` (flat) and the value
    columns are DF pairs.  Placing a column on its sub-lattice moves
    values without rounding, so hi and lo are placed independently; only
    the accumulation into the target, column after column in list order,
    is a df_add.  Returns the new target pair."""
    hi, lo = target.hi.clone(), target.lo.clone()
    for col, fs in pairs:
        n_cp = int(np.prod(fs.lattice))
        sub = _sub_lattice(fs)
        blk_hi = hi[fs.base:fs.base + n_cp].view(fs.lattice)
        blk_lo = lo[fs.base:fs.base + n_cp].view(fs.lattice)
        new = tf.df_add(tf.DF(blk_hi[sub], blk_lo[sub]),
                        tf.DF(col.hi.reshape(fs.el_grid),
                              col.lo.reshape(fs.el_grid)))
        blk_hi[sub] = new.hi
        blk_lo[sub] = new.lo
    return tf.DF(hi, lo)
