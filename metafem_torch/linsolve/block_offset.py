"""Block-offset ("generalized stencil") sparse storage and its SpMV.

FEM matrices in a lexicographic control-point numbering concentrate their
entries on a small set of *column-minus-row offsets* per variable-pair
block (exactly a stencil on structured meshes, approximately on
unstructured ones).

Storage: for every workpiece, variable pair (pd, pb) and popular offset
d, a DENSE diagonal segment of length n_cp (absent entries are stored
zeros and never touched by assembly).  Rare offsets spill to a small COO
tail.  SpMV becomes

    y[pd, r] = sum_g sum_k vals[g, k, r] * x[pb_g, r + d_k]
               + a small COO segment sum for the tail

and the assembly's reduction maps target this storage directly, so the
Newton path never materializes CSR at all.

The host half (``Segment``, ``PallasGroup``, ``OffsetLayout``,
``build_offset_layout``) is numpy only and is a copy of the reference
package's layout builder, so both packages agree on the storage order.
The device half is ``OffsetMatrix``: ``mv`` packs each dense group's
structural values once (``offset_spmv.PackPlan``) and, on a CUDA tensor,
launches the hand-written kernel of ``offset_spmv.py`` once per dense
group, then, where the layout has a BSR tail (unstructured meshes), the
tail kernel of ``bsr_tail.py`` over the tail's packed structural values
(``bsr_tail.TailPlan``), which adds into the same y; on a CPU tensor it
runs those kernels' plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from . import bsr_tail, offset_spmv

#: dense segment: (row0, col0, n_cp, offset d, storage base)
Segment = Tuple[int, int, int, int, int]


@dataclasses.dataclass(frozen=True)
class PallasGroup:
    """Static description of one workpiece's dense region for the fused
    SpMV kernel (offset_spmv.py; the name is the reference's, whose
    kernel was written in Pallas): storage rows are unit-major,
    offset-minor (offsets sorted) over ``[len(units), n_off, n_cp]``."""
    dof_offset: int
    n_cp: int
    n_vars: int
    n_off: int
    offsets: Tuple[int, ...]            # sorted dense offsets
    units: Tuple[Tuple[int, int], ...]  # (dual_pos, base_pos) in unit order
    base: int                           # start of this region in storage


@dataclasses.dataclass(eq=False)  # id-hash: used as static jit aux data
class OffsetLayout:
    """Static (host) description of the block-offset storage.

    ``blk_b > 0``: the tail is stored as dense ``blk_b x blk_b`` BSR
    blocks instead of scalar COO entries, and ``coo_rows``/``coo_cols``
    hold BLOCK row/col ids (length = number of blocks).  One gather
    index then moves ``blk_b`` contiguous x values and the products run
    dense — the fix for unstructured tails at the TPU random-gather
    floor (~1.5e8 scalar gathers/s regardless of locality).  Requires a
    locality cp numbering (fem_mesh._morton_renumber) to keep the block
    fill factor low (~9x at b=8 on the pikachu tet mesh vs 57x in file
    order).

    Tail storage order is COMPONENT-MAJOR: entry (i, j) of block k
    lives at ``n_dense + (i*b + j)*n_blocks + k``, so the device view
    ``vals[n_dense:].reshape(b, b, nb)`` keeps the huge block axis in
    the LANE (minor) dimension.  The block-major view ``[nb, b, b]``
    gets XLA's T(8,128) tiling on the trailing (8, 8) dims — 16x HBM
    padding, an 18.7 GB allocation at pikachu-refine-2 scale (measured
    compile OOM); the component-major view is pad-free and its mv
    measured 84 ms vs 812 ms scalar at the same 4.58M-block size."""
    n: int                       # matrix dimension
    segments: Tuple[Segment, ...]
    n_storage: int               # dense part + tail
    n_dense: int
    coo_rows: np.ndarray         # [n_coo] tail rows (BLOCK ids if blk_b)
    coo_cols: np.ndarray
    storage_of_slot: np.ndarray  # [nnz] logical COO slot -> storage index
    diag_storage: np.ndarray     # [n] storage index of each diagonal entry
    pallas_groups: Tuple[PallasGroup, ...] = ()
    blk_b: int = 0               # BSR tail block size (0 = scalar COO)

    @property
    def n_coo(self) -> int:
        return self.coo_rows.size

    @property
    def n_block_rows(self) -> int:
        return -(-self.n // self.blk_b)


def build_offset_layout(wp_metas, nnz: int,
                        dense_budget_ratio: float = 6.0,
                        min_count_ratio: float = 1 / 16,
                        max_dense_offsets: int = 136,
                        dense_min_n: int = 4096,
                        blk_b: int = 8,
                        blk_min_tail: int = 500_000) -> OffsetLayout:
    """``wp_metas``: per workpiece a dict with dof_offset, n_cp, units
    ({unit: (dual_pos, base_pos)}), sparse_entry, unitsize, ci, cj (the
    unique cp pair arrays).

    Dense segments only pay off on large blocks (each is a separate
    fused op; hundreds of tiny segments explode compile time), so blocks
    with n_cp < dense_min_n use the COO tail except for the diagonal,
    and the offset count is capped at max_dense_offsets."""
    # storage indices fit int32 whenever the (over)estimated dense part
    # + tail do — halves the big first-touch allocations on this
    # page-fault-bound host
    est_dense = sum(len(m["units"]) * (max_dense_offsets + 1) * m["n_cp"]
                    for m in wp_metas)
    sdtype = np.int32 if nnz + est_dense < 2 ** 31 - 1 else np.int64
    storage_of_slot = np.full(nnz, -1, dtype=sdtype)
    segments: List[Segment] = []
    pallas_groups: List[PallasGroup] = []
    coo_rows_parts, coo_cols_parts, coo_slot_parts = [], [], []
    base = 0
    n = 0
    diag_info = []                      # (row0, n_cp, base)
    for m in wp_metas:
        n_cp = m["n_cp"]
        n = max(n, m["dof_offset"] + m["n_vars"] * n_cp)
        ci, cj = m["ci"], m["cj"]
        # shifted offsets d + n_cp, in the narrowest dtype (one temp)
        if ci.dtype == np.int32 and 2 * n_cp < 2 ** 31 - 1:
            dsh = cj - ci
            dsh += np.int32(n_cp)
        else:
            dsh = cj.astype(np.int64) - ci
            dsh += n_cp
        # offset histogram by bincount (O(n); np.unique's sort measured
        # ~10 s at the 116M-pair scale of a 176k-cp tet mesh)
        hist = np.bincount(dsh, minlength=2 * n_cp + 1)
        offs = np.nonzero(hist)[0]
        counts = hist[offs]
        offs = offs - n_cp
        order = np.argsort(-counts)
        offs, counts = offs[order], counts[order]
        # choose dense offsets: popular enough, within the storage budget
        budget = dense_budget_ratio * ci.size   # per unit, in stored vals
        dense_offs = []
        spent = 0
        if n_cp >= dense_min_n:
            for d, c in zip(offs, counts):
                if len(dense_offs) >= max_dense_offsets:
                    break
                if c < max(1, int(min_count_ratio * n_cp)):
                    continue
                if spent + n_cp > max(budget, n_cp):
                    break
                dense_offs.append(int(d))
                spent += n_cp
        if 0 not in dense_offs:
            dense_offs.append(0)        # the diagonal is always dense
        dense_set = {d: k for k, d in enumerate(sorted(dense_offs))}
        # O(1)-lookup table offset -> dense rank (np.isin/searchsorted
        # over the 100M+ raw-pair arrays cost seconds each per unit)
        rank_lut = np.full(2 * n_cp + 1, -1, np.int32)
        for d, kk in dense_set.items():
            rank_lut[d + n_cp] = kk
        d_rank = rank_lut[dsh]
        is_dense = d_rank >= 0
        # hoisted per-wp selections (the unit loop reuses them; each is
        # a fresh big array on this page-fault-bound host)
        ci_dense = ci[is_dense]
        rk_dense = d_rank[is_dense]
        any_coo = not is_dense.all()
        if any_coo:
            sel = ~is_dense
            ci_sel, cj_sel = ci[sel], cj[sel]
            flat_sel = np.flatnonzero(sel)
        del dsh, d_rank

        unit_order = sorted(m["units"].items())
        pallas_groups.append(PallasGroup(
            dof_offset=m["dof_offset"], n_cp=n_cp, n_vars=m["n_vars"],
            n_off=len(dense_set), offsets=tuple(sorted(dense_set)),
            units=tuple(pair for _u, pair in unit_order), base=base))

        for u, (pd, pb) in sorted(m["units"].items()):
            row0 = m["dof_offset"] + pd * n_cp
            col0 = m["dof_offset"] + pb * n_cp
            u_base = {}
            for d in sorted(dense_set):
                segments.append((row0, col0, n_cp, d, base))
                u_base[d] = base
                if pd == pb and d == 0:
                    diag_info.append((row0, n_cp, base))
                base += n_cp
            # map this unit's slots: masked assignment into a VIEW of
            # storage_of_slot (no slot-id arange materialization)
            slot0 = m["sparse_entry"] + u * m["unitsize"]
            sos_view = storage_of_slot[slot0:slot0 + ci.size]
            if dense_set:
                bases = np.asarray(
                    [u_base[d] for d in sorted(dense_set)], sdtype)
                sos_view[is_dense] = bases[rk_dense] + ci_dense
            if any_coo:
                coo_rows_parts.append(row0 + ci_sel)
                coo_cols_parts.append(col0 + cj_sel)
                coo_slot_parts.append(slot0 + flat_sel)

    n_dense = base
    use_blk = 0
    if coo_rows_parts:
        coo_rows = np.concatenate(coo_rows_parts).astype(np.int32,
                                                         copy=False)
        coo_cols = np.concatenate(coo_cols_parts).astype(np.int32,
                                                         copy=False)
        coo_slots = np.concatenate(coo_slot_parts)
        if blk_b and coo_rows.size >= blk_min_tail:
            # BSR tail: group entries into blk_b x blk_b dense blocks
            # over global dof ids.  Entries land at a unique in-block
            # position (logical pairs are unique); uncovered positions
            # are stored zeros never touched by assembly.
            from ..native import unique_pairs
            b = int(blk_b)
            use_blk = b
            bi = coo_rows.astype(np.int64) // b
            bj = coo_cols.astype(np.int64) // b
            nbr = -(-n // b)
            b_rows, b_cols, inv = unique_pairs(bi, bj, nbr)
            if nnz + n_dense + b_rows.size * b * b >= 2 ** 31 - 1:
                storage_of_slot = storage_of_slot.astype(np.int64)
                sdtype = np.int64
            # component-major (see class docstring): slot (i, j) of
            # block inv -> n_dense + (i*b + j)*n_blocks + inv
            storage_of_slot[coo_slots] = (
                n_dense
                + ((coo_rows.astype(sdtype, copy=False) % b) * b
                   + coo_cols % b) * b_rows.size
                + inv.astype(sdtype, copy=False))
            n_tail = b_rows.size * b * b
            coo_rows = b_rows.astype(np.int32, copy=False)
            coo_cols = b_cols.astype(np.int32, copy=False)
        else:
            storage_of_slot[coo_slots] = n_dense + np.arange(
                coo_rows.size, dtype=sdtype)
            n_tail = coo_rows.size
            if n_tail % 8:
                # round the scalar tail up to a multiple of 8 with
                # never-written (0, 0, value 0) entries, so n_storage
                # stays divisible by small device-mesh extents and the
                # row-sharded layouts split evenly (rowshard.py); the
                # zero values contribute nothing to any SpMV
                pad = 8 - n_tail % 8
                coo_rows = np.concatenate(
                    [coo_rows, np.zeros(pad, np.int32)])
                coo_cols = np.concatenate(
                    [coo_cols, np.zeros(pad, np.int32)])
                n_tail += pad
    else:
        coo_rows = np.zeros(0, np.int32)
        coo_cols = np.zeros(0, np.int32)
        n_tail = 0
    n_storage = n_dense + n_tail
    assert (storage_of_slot >= 0).all(), "unmapped sparse slot"

    diag_storage = np.full(n, -1, dtype=np.int64)
    for (row0, n_cp, b) in diag_info:
        diag_storage[row0:row0 + n_cp] = b + np.arange(n_cp)

    return OffsetLayout(n=n, segments=tuple(segments),
                        n_storage=n_storage, n_dense=n_dense,
                        coo_rows=coo_rows, coo_cols=coo_cols,
                        storage_of_slot=storage_of_slot,
                        diag_storage=diag_storage,
                        pallas_groups=tuple(pallas_groups),
                        blk_b=use_blk)


def tail_runs(layout: OffsetLayout):
    """The run structure of the BSR tail's sorted block rows, computed on
    the host once per layout and kept on it: (run_start int64 [n_runs +
    1], the first block of each run with nb at the end; run_row int64
    [n_runs], each run's block row).  The plan of ``bsr_tail_mv_plain``,
    the BSR storage's own product."""
    cached = layout.__dict__.get("_tail_runs")
    if cached is None:
        rows = np.asarray(layout.coo_rows)
        starts = np.flatnonzero(
            np.concatenate([[True], rows[1:] != rows[:-1]])) \
            if rows.size else np.zeros(0, np.int64)
        run_start = np.concatenate([starts, [rows.size]]).astype(np.int64)
        cached = (run_start, rows[starts].astype(np.int64))
        layout._tail_runs = cached
    return cached


def dense_only_layout(layout: OffsetLayout) -> OffsetLayout:
    """A tailless view of ``layout``: the same dense segments and groups,
    an empty tail, ``n_storage = n_dense``.  ``storage_of_slot`` is the
    parent's (it still holds tail positions, >= n_dense, which
    ``structural_mask`` leaves out), and the view's device tables share
    the parent's pack plans (the dense groups are identical).  Kept on
    the parent."""
    view = layout.__dict__.get("_dense_only_view")
    if view is None:
        view = dataclasses.replace(
            layout, n_storage=layout.n_dense,
            coo_rows=np.zeros(0, np.int32),
            coo_cols=np.zeros(0, np.int32), blk_b=0)
        view._dense_parent = layout
        layout._dense_only_view = view
    return view


def sorted_segment_plan(seg: np.ndarray, device=None):
    """Plan of a deterministic segment sum over the static segment ids
    ``seg``: (order, lengths, unique ids), with ``order`` the stable sort
    of ``seg``, computed on the host once and kept as int64 tensors on
    ``device``, so that a sum launches kernels and copies nothing."""
    seg = np.asarray(seg, np.int64)
    order = np.argsort(seg, kind="stable")
    uniq, lengths = np.unique(seg[order], return_counts=True)
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (order, lengths, uniq))


def sorted_segment_sum(data: torch.Tensor, plan, num: int) -> torch.Tensor:
    """out[s] = sum of data[i] over seg[i] == s (data [len(seg), ...]), in
    the fixed order of the
    plan (sorted_segment_plan, on data's device): a sorted segmented
    reduction and a write of each segment's sum to its own slot.  No
    atomics, so the result repeats bitwise on CUDA, where ``index_add_``
    would not."""
    order, lengths, uniq = plan
    out = torch.zeros((num,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    if len(uniq) == 0:
        return out
    out[uniq] = torch.segment_reduce(data[order], "sum", lengths=lengths)
    return out


def _device_tables(layout: OffsetLayout, device: torch.device) -> dict:
    """The layout's index tables on ``device``, copied from the host once
    per (layout, device) and kept on the layout: the tail's rows and
    columns (block ids under a BSR tail) and its column segment-sum plan
    (``tail_col_plan``, built at the first ``tmv``), the
    BSR tail's run plan (``tail_runs``), the diagonal's storage
    positions and each group's unit tables (the pack and tail plans are
    the window's, ``WindowLayout.tables``).  A product, a scaling or a
    new matrix then copies nothing from the host."""
    tables = layout.__dict__.setdefault("_device_tables", {})
    key = str(device)
    if key not in tables:
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)
        run_start, run_row = tail_runs(layout) if layout.blk_b else ((), ())
        tables[key] = {
            "coo_rows": dev(layout.coo_rows),
            "coo_cols": dev(layout.coo_cols),
            "diag": dev(layout.diag_storage),
            "pds": [dev([pd for pd, _pb in g.units])
                    for g in layout.pallas_groups],
            "pbs": [dev([pb for _pd, pb in g.units])
                    for g in layout.pallas_groups],
            "run_start": dev(run_start), "run_row": dev(run_row)}
    return tables[key]


def structural_mask(layout: OffsetLayout, device) -> torch.Tensor:
    """Bool mask over the storage, on ``device``, of the entries a
    product needs: those the assembly writes (``storage_of_slot``) and
    the diagonal.  Every other stored value is a zero that the assembly
    never touches: an offset that a row does not couple to, the rows of
    ghost control points (which hold only their diagonal), the padding
    of the COO tail, the unwritten entries of the BSR tail's blocks.  A
    dense-only view (``dense_only_layout``) leaves out its parent's tail
    positions."""
    lo = layout
    keep = torch.zeros(lo.n_storage, dtype=torch.bool, device=device)
    sos = torch.as_tensor(lo.storage_of_slot, dtype=torch.int64,
                          device=device)
    keep[sos[sos < lo.n_storage]] = True
    ds = lo.diag_storage[lo.diag_storage >= 0]
    keep[torch.as_tensor(ds, dtype=torch.int64, device=device)] = True
    return keep


class WindowLayout:
    """The rows of a block-offset matrix that a matrix holds, and the
    storage they own (numpy on the host, built once per window).

    ``cps``: per dense group of ``layout`` a window of control points
    (c0, c1); the window holds the rows dof_offset + c*n_cp + [c0, c1)
    of every channel c, in that order (``rows``; the window's vectors
    are ``v[rows]``).  Its storage is the group slabs' columns [c0, c1)
    of every unit and offset, as [G, n_off, c1 - c0] per group
    (``group_range``), then the tail's part from ``n_dense``: a scalar
    COO tail's entries of the window's rows, a BSR tail's blocks that
    touch a window row (whole, as the component-major [b, b, nb_w] view
    of ``tail_sel``, the blocks' ids); ``storage`` gives their positions
    in the whole storage.  The window (0, n_cp) of every group
    (``whole_window``) is the whole matrix: all n rows, the whole
    storage in its own order.  Pack and tail plans index the group's
    slab and the tail's part of the window's storage."""

    def __init__(self, layout: OffsetLayout, cps):
        lo = layout
        if len(cps) != len(lo.pallas_groups):
            raise ValueError(f"{len(cps)} windows for "
                             f"{len(lo.pallas_groups)} groups")
        self.layout = lo
        self.cps = tuple((int(a), int(b)) for a, b in cps)
        self.whole = all(c == (0, g.n_cp)
                         for g, c in zip(lo.pallas_groups, self.cps))
        rows, self.wbase = [], []
        n_dense_w = 0
        for g, (c0, c1) in zip(lo.pallas_groups, self.cps):
            if not 0 <= c0 <= c1 <= g.n_cp:
                raise ValueError(f"window {(c0, c1)} outside [0, {g.n_cp}]")
            for c in range(g.n_vars):
                rows.append(g.dof_offset + c * g.n_cp
                            + np.arange(c0, c1, dtype=np.int64))
            self.wbase.append(n_dense_w)
            n_dense_w += len(g.units) * g.n_off * (c1 - c0)
        self.n_dense = n_dense_w
        if self.whole:
            if self.wbase != [g.base for g in lo.pallas_groups] \
                    or n_dense_w != lo.n_dense:
                raise ValueError("the dense groups do not tile the storage")
            self.rows = np.arange(lo.n, dtype=np.int64)
            self.tail_sel = np.arange(lo.n_coo, dtype=np.int64)
            self.diag = np.asarray(lo.diag_storage, np.int64)
        else:
            self.rows = (np.concatenate(rows) if rows
                         else np.zeros(0, np.int64))
            inwin = self.row_mask()
            if lo.blk_b:
                b = lo.blk_b
                padded = np.zeros(lo.n_block_rows * b, bool)
                padded[:lo.n] = inwin
                touches = padded.reshape(-1, b).any(axis=1)
                self.tail_sel = np.flatnonzero(
                    touches[np.asarray(lo.coo_rows, np.int64)])
            else:
                self.tail_sel = np.flatnonzero(
                    inwin[np.asarray(lo.coo_rows, np.int64)])
            self.diag = self._window_diag()
        self.n_local = self.rows.size
        self.n_storage = self.n_dense + (lo.blk_b ** 2 if lo.blk_b else 1) \
            * self.tail_sel.size
        r0 = int(self.rows[0]) if self.n_local else 0
        self.row_slice = (slice(r0, r0 + self.n_local) if np.array_equal(
            self.rows, np.arange(r0, r0 + self.n_local)) else None)
        #: a dense-only view's window shares its parent's pack plans
        self.parent = None
        self._dev: dict = {}

    def row_mask(self) -> np.ndarray:
        """Bool [n]: True at the window's rows."""
        inwin = np.zeros(self.layout.n, bool)
        inwin[self.rows] = True
        return inwin

    def _window_diag(self) -> np.ndarray:
        """The diagonal's positions in the window's storage (-1 where a
        row stores none)."""
        lo = self.layout
        diag = np.full(self.rows.size, -1, np.int64)
        at = 0
        for gi, (g, (c0, c1)) in enumerate(zip(lo.pallas_groups, self.cps)):
            n_g = g.n_vars * (c1 - c0)
            ds = lo.diag_storage[self.rows[at:at + n_g]]
            p = ds - g.base
            uk, r = p // g.n_cp, p % g.n_cp
            diag[at:at + n_g] = np.where(
                ds < 0, -1, self.wbase[gi] + uk * (c1 - c0) + r - c0)
            at += n_g
        return diag

    @property
    def storage(self) -> np.ndarray:
        """The window's storage positions in the whole storage, in the
        window's order."""
        lo = self.layout
        if self.whole:
            return np.arange(lo.n_storage, dtype=np.int64)
        sto = []
        for g, (c0, c1) in zip(lo.pallas_groups, self.cps):
            starts = (g.base + c0 + g.n_cp * np.arange(
                len(g.units) * g.n_off, dtype=np.int64))
            sto.append((starts[:, None]
                        + np.arange(c1 - c0, dtype=np.int64)).reshape(-1))
        if lo.blk_b:
            comp = np.arange(lo.blk_b ** 2, dtype=np.int64)
            sto.append((lo.n_dense + comp[:, None] * lo.n_coo
                        + self.tail_sel[None, :]).reshape(-1))
        else:
            sto.append(lo.n_dense + self.tail_sel)
        return np.concatenate(sto)

    def group_range(self, i: int) -> slice:
        """Dense group i's slab in the window's storage: what its pack
        plan's positions index."""
        g, (c0, c1) = self.layout.pallas_groups[i], self.cps[i]
        return slice(self.wbase[i],
                     self.wbase[i] + len(g.units) * g.n_off * (c1 - c0))

    def dense_only(self) -> "WindowLayout":
        """This window of ``dense_only_layout(layout)``: the same dense
        storage and pack plans, no tail.  Kept on the window."""
        view = self.__dict__.get("_dense_only")
        if view is None:
            view = WindowLayout(dense_only_layout(self.layout), self.cps)
            view.parent = self
            self._dense_only = view
        return view

    def tables(self, device) -> dict:
        """The window's index tables on ``device``, copied once: rows,
        diagonal positions, the tail's rows and columns (block ids under a
        BSR tail) and a scalar tail's segment-sum plan over its rows, the
        pack and tail plans (by vector width), and under a BSR tail of a
        part of the rows the block rows the window touches
        (``block_rows``), each block row's place among them
        (``block_pos``) and each tail block's among the window's
        (``kpos``)."""
        key = str(device)
        if key not in self._dev:
            lo = self.layout

            def dev(a):
                return torch.as_tensor(np.asarray(a, np.int64),
                                       device=device)
            lt = _device_tables(lo, device)
            t = {"rows": dev(self.rows), "diag": dev(self.diag),
                 "pack_plans": ({} if self.parent is None else
                                self.parent.tables(device)["pack_plans"]),
                 "tail_pack_plans": {}}
            if self.whole:
                t["tail_rows"], t["tail_cols"] = lt["coo_rows"], lt["coo_cols"]
            else:
                t["tail_rows"] = dev(np.asarray(lo.coo_rows)[self.tail_sel])
                t["tail_cols"] = dev(np.asarray(lo.coo_cols)[self.tail_sel])
            if lo.n_coo and not lo.blk_b:
                t["tail_plan"] = sorted_segment_plan(
                    np.asarray(lo.coo_rows)[self.tail_sel], device)
            if lo.blk_b and not self.whole:
                br = np.unique(self.rows // lo.blk_b)
                t["block_rows"] = dev(br)
                pos = np.full(lo.n_block_rows, -1, np.int64)
                pos[br] = np.arange(br.size)
                t["block_pos"] = dev(pos)
                kpos = np.full(lo.n_coo, -1, np.int64)
                kpos[self.tail_sel] = np.arange(self.tail_sel.size)
                t["kpos"] = dev(kpos)
            self._dev[key] = t
        return self._dev[key]

    def local(self, v: torch.Tensor) -> torch.Tensor:
        """The window's rows of a whole vector (the last axis): a view
        when they are one slice."""
        if self.row_slice is not None:
            return v[..., self.row_slice]
        return v[..., self.tables(v.device)["rows"]]

    def pack_plans(self, device, vec: int) -> list:
        """Per dense group, the pack plan of its window
        (``offset_spmv.build_pack_plan(rows=...)``, built from
        ``structural_mask``), its positions in the window's slab of the
        group; built once per window, device and width."""
        plans = self.tables(device)["pack_plans"]
        if vec not in plans:
            keep = structural_mask(self.layout, device)
            out = []
            for g, (c0, c1) in zip(self.layout.pallas_groups, self.cps):
                n_slab = len(g.units) * g.n_off * g.n_cp
                plan = offset_spmv.build_pack_plan(
                    keep[g.base:g.base + n_slab].view(
                        len(g.units), g.n_off, g.n_cp), g, vec,
                    rows=(c0, c1))
                if (c0, c1) != (0, g.n_cp):
                    p = plan.positions.long()
                    uk = p // g.n_cp
                    pw = uk * (c1 - c0) + (p - uk * g.n_cp) - c0
                    pw[plan.pad] = 0
                    plan = dataclasses.replace(
                        plan, positions=pw.to(plan.positions.dtype))
                out.append(plan)
            plans[vec] = out
        return plans[vec]

    def tail_plan(self, device, vec: int):
        """The BSR tail's plan over the window's rows
        (``bsr_tail.build_tail_plan``, built from ``structural_mask``),
        its positions in the tail's part of the window's storage; built
        once per window, device and width."""
        plans = self.tables(device)["tail_pack_plans"]
        if vec not in plans:
            lo = self.layout
            keep = structural_mask(lo, device)[lo.n_dense:]
            if self.whole:
                plans[vec] = bsr_tail.build_tail_plan(lo, keep, vec)
                return plans[vec]
            t = self.tables(device)
            plan = bsr_tail.build_tail_plan(
                lo, keep, vec,
                row_mask=torch.as_tensor(self.row_mask(), device=device))
            nb, nbw = lo.n_coo, self.tail_sel.size
            p = plan.positions.long()
            comp = p // nb
            pw = comp * nbw + t["kpos"][p - comp * nb]
            pw[plan.pad] = 0
            plans[vec] = dataclasses.replace(
                plan, positions=pw.to(plan.positions.dtype))
        return plans[vec]


def whole_window(layout: OffsetLayout) -> WindowLayout:
    """The window of all of ``layout``'s rows (the whole matrix), kept on
    the layout; a dense-only view's is its parent's ``dense_only``."""
    w = layout.__dict__.get("_whole_window")
    if w is None:
        parent = layout.__dict__.get("_dense_parent")
        w = (whole_window(parent).dense_only() if parent is not None
             else WindowLayout(layout, [(0, g.n_cp)
                                        for g in layout.pallas_groups]))
        layout._whole_window = w
    return w


@dataclasses.dataclass
class OffsetMatrix:
    """Square sparse matrix in block-offset storage, or the rows of one
    that a rank holds.

    ``window`` (a ``WindowLayout``; by default ``whole_window``, the
    whole matrix) says which rows: ``vals`` is the window's storage,
    ``mv`` takes the whole x and returns the window's rows of A x,
    ``tmv`` takes the window's rows of x and returns their whole-length
    share of A.T x, ``diag`` the window's rows of the diagonal,
    ``scale_rows`` and ``scale_cols`` take the whole s.  ``mv`` runs on the packed
    structural values of each dense group (``offset_spmv.PackPlan``)
    and of a BSR tail (``bsr_tail.TailPlan``) over the window's plans,
    gathered from ``vals`` at the matrix's first product and kept in
    ``_packed``.  That copy stays valid because no code of the port
    changes ``vals`` in place after ``from_values``: every assembly,
    scaling and cast makes a new matrix."""
    vals: torch.Tensor           # [window.n_storage]
    coo_rows: torch.Tensor       # device copies of the tail indices
    coo_cols: torch.Tensor
    layout: OffsetLayout         # static
    _packed: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)
    window: WindowLayout = dataclasses.field(default=None, repr=False,
                                             compare=False)

    def __post_init__(self):
        if self.window is None:
            self.window = whole_window(self.layout)
        elif self.window.layout is not self.layout:
            raise ValueError("the window is not of the matrix's layout")

    @classmethod
    def from_values(cls, vals: torch.Tensor, layout: OffsetLayout,
                    window: WindowLayout = None) -> "OffsetMatrix":
        t = _device_tables(layout, vals.device)
        return cls(vals, t["coo_rows"], t["coo_cols"], layout,
                   window=window)

    @property
    def n(self) -> int:
        return self.layout.n

    def _tables(self) -> dict:
        return _device_tables(self.layout, self.vals.device)

    def _wtables(self) -> dict:
        return self.window.tables(self.vals.device)

    def _new(self, vals: torch.Tensor) -> "OffsetMatrix":
        return OffsetMatrix(vals, self.coo_rows, self.coo_cols, self.layout,
                            window=self.window)

    def _whole(self, what: str) -> None:
        if not self.window.whole:
            raise ValueError(f"{what} needs the whole matrix, not a window "
                             f"of its rows")

    def dense_part(self) -> "OffsetMatrix":
        """The matrix without its tail, over ``dense_only_layout``: the
        same values, and the same packed values (one pack serves both)."""
        view = dense_only_layout(self.layout)
        t = _device_tables(view, self.vals.device)
        return OffsetMatrix(self.vals, t["coo_rows"], t["coo_cols"], view,
                            _packed=self._packed,
                            window=self.window.dense_only())

    def _tail_col_plan(self):
        """The tail's segment-sum plan over its columns (block columns
        under a BSR tail), built once per layout (or window, over the
        window's tail entries) and device."""
        w = self.window
        t = self._tables() if w.whole else self._wtables()
        if "tail_col_plan" not in t:
            cols = np.asarray(self.layout.coo_cols)
            t["tail_col_plan"] = sorted_segment_plan(
                cols if w.whole else cols[w.tail_sel], self.vals.device)
        return t["tail_col_plan"]

    def pack_plans(self, vec: int = None) -> list:
        """One ``offset_spmv.PackPlan`` per dense group for vals' device
        and float width (or ``vec`` slots per load: the two-float product
        takes the float64 plan): the window's (``WindowLayout.pack_plans``)."""
        vec = vec or offset_spmv.VEC_BYTES // self.vals.element_size()
        return self.window.pack_plans(self.vals.device, vec)

    def packed(self, i: int) -> torch.Tensor:
        """Dense group i's structural values, gathered through its pack
        plan at the first call and kept."""
        if i not in self._packed:
            self._packed[i] = offset_spmv.pack(
                self.vals[self.window.group_range(i)], self.pack_plans()[i])
        return self._packed[i]

    def tail_plan(self, vec: int = None):
        """The BSR tail's ``bsr_tail.TailPlan`` for vals' device and float
        width (or ``vec`` slots per load: the two-float product takes the
        float64 plan): the window's (``WindowLayout.tail_plan``)."""
        vec = vec or offset_spmv.VEC_BYTES // self.vals.element_size()
        return self.window.tail_plan(self.vals.device, vec)

    def packed_tail(self) -> torch.Tensor:
        """The BSR tail's structural values, gathered through its tail
        plan at the first call and kept."""
        if "tail" not in self._packed:
            self._packed["tail"] = offset_spmv.pack(
                self.vals[self.window.n_dense:], self.tail_plan())
        return self._packed["tail"]

    def tail_blocks(self) -> torch.Tensor:
        """The BSR tail's values (the window's blocks) as the
        component-major [b, b, nb] view."""
        b = self.layout.blk_b
        return self.vals[self.window.n_dense:].view(
            b, b, self.window.tail_sel.size)

    def _blocked(self, v: torch.Tensor) -> torch.Tensor:
        """v [n] zero-padded to whole blocks, as [n_block_rows, b]."""
        return bsr_tail.blocked(v, self.layout.blk_b)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x (the window's rows of it; x whole): one
        offset_spmv.group_mv per dense group on its packed values (the
        hand-written kernel on CUDA, its plain version on the CPU), then
        the tail: a BSR tail through bsr_tail.tail_mv on its packed values
        (its kernel on CUDA) adding into y, a scalar COO tail as a sorted
        segment sum.  The kernels write the window's rows of a whole y."""
        lo = self.layout
        covered = sum(g.n_vars * g.n_cp for g in lo.pallas_groups)
        y = (torch.empty if covered == lo.n else torch.zeros)(
            lo.n, dtype=x.dtype, device=x.device)
        plans = self.pack_plans()
        for i, grp in enumerate(lo.pallas_groups):
            n_dof = grp.n_vars * grp.n_cp
            sl = slice(grp.dof_offset, grp.dof_offset + n_dof)
            offset_spmv.group_mv(self.packed(i),
                                 x[sl].view(grp.n_vars, grp.n_cp), plans[i],
                                 out=y[sl].view(grp.n_vars, grp.n_cp))
        if lo.blk_b:
            bsr_tail.tail_mv(self.packed_tail(), x, y, self.tail_plan())
        elif lo.n_coo:
            t = self._wtables()
            y = y + sorted_segment_sum(
                self.vals[self.window.n_dense:] * x[t["tail_cols"]],
                t["tail_plan"], lo.n)
        return y if self.window.whole else self.window.local(y)

    def tmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A.T x: per dense group and offset d_k, the products
        vals[g, k, r] * x[pd_g, r] land at y[pb_g, r + d_k] (shifted
        slice adds in unit order, no atomics); the COO tail is a sorted
        segment sum over the stable column order, a BSR tail's block
        products a sorted segment sum over the block columns.  Over a
        window, x holds the window's rows and y is the window rows'
        share of A.T x, whole-length, summed over every window's share to
        A.T x (``parallel.rowshard.RowShardedOp.tmv``): the window's
        slabs [G, n_off, c1 - c0] add the rows r in [c0, c1) that reach
        a column r + d_k, and the tail's entries (a BSR tail's blocks) of
        the window's rows add theirs against x scattered to a whole
        vector zero outside the window, so that a block shared with
        another window adds only its own rows."""
        lo, w = self.layout, self.window
        y = torch.zeros(lo.n, dtype=x.dtype, device=x.device)
        at = 0
        for i, (grp, (c0, c1)) in enumerate(zip(lo.pallas_groups, w.cps)):
            C, n_cp, n_off, nw = grp.n_vars, grp.n_cp, grp.n_off, c1 - c0
            if w.whole:
                at = grp.dof_offset
            xw = x[at:at + C * nw].view(C, nw)
            at += C * nw
            yw = y[grp.dof_offset:grp.dof_offset + C * n_cp].view(C, n_cp)
            slab = self.vals[w.group_range(i)].view(len(grp.units), n_off,
                                                    nw)
            for g, (pd, pb) in enumerate(grp.units):
                prod = slab[g] * xw[pd]                 # [n_off, nw]
                for k, d in enumerate(grp.offsets):
                    r0, r1 = max(c0, -d), min(c1, n_cp - d)
                    if r0 < r1:
                        yw[pb, r0 + d:r1 + d] += prod[k, r0 - c0:r1 - c0]
        if lo.n_coo:
            wt = self._wtables()
            xm = x
            if not w.whole:
                xm = torch.zeros(lo.n, dtype=x.dtype, device=x.device)
                xm[wt["rows"]] = x
            if lo.blk_b:
                b = lo.blk_b
                B = self.tail_blocks()
                xg = self._blocked(xm)[wt["tail_rows"]]         # [nb_w, b]
                contrib = B[0] * xg[:, 0]                       # [b, nb_w]
                for i in range(1, b):
                    contrib = contrib + B[i] * xg[:, i]
                yb = sorted_segment_sum(contrib.t(), self._tail_col_plan(),
                                        lo.n_block_rows)
                y = y + yb.reshape(-1)[:lo.n]
            else:
                y = y + sorted_segment_sum(
                    self.vals[w.n_dense:] * xm[wt["tail_rows"]],
                    self._tail_col_plan(), lo.n)
        return y

    def diag(self, diag_pos=None) -> torch.Tensor:
        """The diagonal (the window's rows of it; ``diag_pos`` is accepted
        for the signature of the reference's solvers: block-offset storage
        knows its diagonal positions)."""
        ds = self._wtables()["diag"]
        d = self.vals[ds.clamp(min=0)]
        return torch.where(ds < 0, torch.zeros_like(d), d)

    def _scaled(self, s: torch.Tensor, by_row: bool) -> "OffsetMatrix":
        """A copy with entry (i, j) times s[i] (``by_row``) or s[j]; s
        whole."""
        lo, w = self.layout, self.window
        t, wt = self._tables(), self._wtables()
        vals = self.vals.clone()
        for i, (grp, (c0, c1)) in enumerate(zip(lo.pallas_groups, w.cps)):
            C, n_cp, n_off = grp.n_vars, grp.n_cp, grp.n_off
            G = len(grp.units)
            sw = s[grp.dof_offset:grp.dof_offset + C * n_cp].view(C, n_cp)
            if by_row:
                sc = sw[t["pds"][i]][:, None, c0:c1].expand(
                    G, n_off, c1 - c0)
            else:
                sc = offset_spmv.shifted_stack(sw, grp.offsets)[:, :, c0:c1]
                sc = sc[:, t["pbs"][i]].transpose(0, 1)  # [G, n_off, w]
            region = w.group_range(i)
            vals[region] = vals[region] * sc.reshape(-1)
        ids = wt["tail_rows" if by_row else "tail_cols"]
        if lo.blk_b:
            sc = self._blocked(s)[ids].t()                     # [b, nb]
            tail = vals[w.n_dense:].view(lo.blk_b, lo.blk_b, -1)
            # entry (i, j) *= s[row i] or s[col j]
            tail.mul_(sc[:, None, :] if by_row else sc[None, :, :])
        elif lo.n_coo:
            vals[w.n_dense:] = vals[w.n_dense:] * s[ids]
        return self._new(vals)

    def scale_cols(self, s: torch.Tensor) -> "OffsetMatrix":
        """A diag(s): entry (i, j) times s[j]."""
        return self._scaled(s, by_row=False)

    def scale_rows(self, s: torch.Tensor) -> "OffsetMatrix":
        """diag(s) A: entry (i, j) times s[i]."""
        return self._scaled(s, by_row=True)

    def structural_mask(self) -> torch.Tensor:
        """``structural_mask`` of the layout on vals' device."""
        self._whole("structural_mask")
        return structural_mask(self.layout, self.vals.device)

    def _triplets(self, keep=None):
        """(rows, cols, storage positions), int64 on vals' device, of the
        stored entries whose column lies inside their block: the dense
        segments in storage order, then the tail (a BSR tail's entries
        component by component, those of padded edge blocks left out).
        ``keep`` (a bool mask over the storage) selects a subset."""
        self._whole("_triplets")
        lo = self.layout
        dev = self.vals.device
        rows, cols, pos = [], [], []
        for (row0, col0, n_cp, d, b) in lo.segments:
            r0, r1 = max(0, -d), min(n_cp, n_cp - d)
            r = torch.arange(r0, max(r0, r1), device=dev)
            if keep is not None:
                r = r[keep[b + r]]
            rows.append(row0 + r)
            cols.append(col0 + d + r)
            pos.append(b + r)
        if lo.blk_b:
            b, nb = lo.blk_b, lo.n_coo
            k = torch.arange(nb, device=dev)
            for i in range(b):
                for j in range(b):
                    p = lo.n_dense + (i * b + j) * nb + k
                    r = self.coo_rows * b + i
                    c = self.coo_cols * b + j
                    sel = (r < lo.n) & (c < lo.n)
                    if keep is not None:
                        sel &= keep[p]
                    rows.append(r[sel])
                    cols.append(c[sel])
                    pos.append(p[sel])
        elif lo.n_coo:
            p = torch.arange(lo.n_dense, lo.n_storage, device=dev)
            sel = slice(None) if keep is None else keep[p]
            rows.append(self.coo_rows[sel])
            cols.append(self.coo_cols[sel])
            pos.append(p[sel])
        return torch.cat(rows), torch.cat(cols), torch.cat(pos)

    def to_csr(self) -> torch.Tensor:
        """The entries of ``structural_mask`` as a torch sparse CSR tensor
        on vals' device: the operand of the library products that the
        kernels are timed against (no product of the port uses it)."""
        import warnings
        rows, cols, pos = self._triplets(self.structural_mask())
        order = torch.argsort(rows * self.n + cols, stable=True)
        rows, cols, pos = rows[order], cols[order], pos[order]
        del order
        crow = torch.searchsorted(
            rows, torch.arange(self.n + 1, device=rows.device))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "beta state"
            return torch.sparse_csr_tensor(crow, cols, self.vals[pos],
                                           size=(self.n, self.n))

    def to_scipy(self):
        import scipy.sparse as sp
        rows, cols, pos = self._triplets()
        return sp.csr_matrix(
            (self.vals.detach()[pos].cpu().numpy(),
             (rows.cpu().numpy(), cols.cpu().numpy())),
            shape=(self.n, self.n))

