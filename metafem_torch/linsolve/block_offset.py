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
The device half is ``OffsetMatrix``: on a CUDA tensor ``mv`` launches the
hand-written kernel of ``offset_spmv.py`` once per dense group; on a CPU
tensor it runs that kernel's plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from . import offset_spmv

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


def sorted_segment_plan(seg: np.ndarray):
    """Host plan of a deterministic segment sum over the static segment
    ids ``seg``: (order, lengths, unique ids), with ``order`` the stable
    sort of ``seg``."""
    seg = np.asarray(seg, np.int64)
    order = np.argsort(seg, kind="stable")
    uniq, lengths = np.unique(seg[order], return_counts=True)
    return order, lengths, uniq


def sorted_segment_sum(data: torch.Tensor, plan, num: int) -> torch.Tensor:
    """out[s] = sum of data[i] over seg[i] == s, in the fixed order of the
    host plan (sorted_segment_plan): a sorted segmented reduction and a
    write of each segment's sum to its own slot.  No atomics, so the
    result repeats bitwise on CUDA, where ``index_add_`` would not."""
    order, lengths, uniq = plan
    dev = data.device
    out = torch.zeros(num, dtype=data.dtype, device=dev)
    if len(uniq) == 0:
        return out
    vals = data[torch.as_tensor(order, device=dev)]
    sums = torch.segment_reduce(
        vals, "sum", lengths=torch.as_tensor(lengths, device=dev))
    out[torch.as_tensor(uniq, device=dev)] = sums
    return out


@dataclasses.dataclass
class OffsetMatrix:
    """Square sparse matrix in block-offset storage."""
    vals: torch.Tensor           # [n_storage]
    coo_rows: torch.Tensor       # device copies of the tail indices
    coo_cols: torch.Tensor
    layout: OffsetLayout         # static

    @classmethod
    def from_values(cls, vals: torch.Tensor,
                    layout: OffsetLayout) -> "OffsetMatrix":
        dev = vals.device
        return cls(vals,
                   torch.as_tensor(layout.coo_rows.astype(np.int64),
                                   device=dev),
                   torch.as_tensor(layout.coo_cols.astype(np.int64),
                                   device=dev),
                   layout)

    @property
    def n(self) -> int:
        return self.layout.n

    def _check_tail(self) -> None:
        if self.layout.blk_b:
            raise NotImplementedError(
                "block-offset matrices with a BSR tail (blk_b > 0) are not "
                "ported yet")

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x: one offset_spmv.group_mv per dense group (the
        hand-written kernel on CUDA, its plain version on the CPU) plus
        the COO tail as a sorted segment sum."""
        lo = self.layout
        self._check_tail()
        covered = sum(g.n_vars * g.n_cp for g in lo.pallas_groups)
        y = (torch.empty if covered == lo.n else torch.zeros)(
            lo.n, dtype=x.dtype, device=x.device)
        for grp in lo.pallas_groups:
            n_dof = grp.n_vars * grp.n_cp
            sl = slice(grp.dof_offset, grp.dof_offset + n_dof)
            offset_spmv.group_mv(self.vals, x[sl].view(grp.n_vars, grp.n_cp),
                                 grp, out=y[sl].view(grp.n_vars, grp.n_cp))
        if lo.n_coo:
            coo_vals = self.vals[lo.n_dense:]
            plan = getattr(lo, "_coo_plan", None)
            if plan is None:
                plan = lo._coo_plan = sorted_segment_plan(lo.coo_rows)
            y = y + sorted_segment_sum(coo_vals * x[self.coo_cols], plan,
                                       lo.n)
        return y

    def diag(self) -> torch.Tensor:
        lo = self.layout
        ds = torch.as_tensor(lo.diag_storage, device=self.vals.device)
        d = self.vals[ds.clamp(min=0)]
        return torch.where(ds < 0, torch.zeros_like(d), d)

    def _scaled_groups(self, vals: torch.Tensor, s: torch.Tensor,
                       by_row: bool) -> torch.Tensor:
        for grp in self.layout.pallas_groups:
            C, n_cp, n_off = grp.n_vars, grp.n_cp, grp.n_off
            G = len(grp.units)
            sw = s[grp.dof_offset:grp.dof_offset + C * n_cp].view(C, n_cp)
            if by_row:
                pds = torch.as_tensor([pd for (pd, _pb) in grp.units],
                                      device=s.device)
                sc = sw[pds][:, None, :].expand(G, n_off, n_cp)
            else:
                pbs = torch.as_tensor([pb for (_pd, pb) in grp.units],
                                      device=s.device)
                sc = offset_spmv.shifted_stack(sw, grp.offsets)
                sc = sc[:, pbs].transpose(0, 1)      # [G, n_off, n_cp]
            region = slice(grp.base, grp.base + G * n_off * n_cp)
            vals[region] = vals[region] * sc.reshape(-1)
        return vals

    def scale_cols(self, s: torch.Tensor) -> "OffsetMatrix":
        """A diag(s): entry (i, j) times s[j]."""
        lo = self.layout
        self._check_tail()
        vals = self._scaled_groups(self.vals.clone(), s, by_row=False)
        if lo.n_coo:
            vals[lo.n_dense:] = vals[lo.n_dense:] * s[self.coo_cols]
        return OffsetMatrix(vals, self.coo_rows, self.coo_cols, lo)

    def scale_rows(self, s: torch.Tensor) -> "OffsetMatrix":
        """diag(s) A: entry (i, j) times s[i]."""
        lo = self.layout
        self._check_tail()
        vals = self._scaled_groups(self.vals.clone(), s, by_row=True)
        if lo.n_coo:
            vals[lo.n_dense:] = vals[lo.n_dense:] * s[self.coo_rows]
        return OffsetMatrix(vals, self.coo_rows, self.coo_cols, lo)

    def to_scipy(self):
        import scipy.sparse as sp
        lo = self.layout
        self._check_tail()
        rows, cols, vals = [], [], []
        v = self.vals.detach().cpu().numpy()
        for (row0, col0, n_cp, d, b) in lo.segments:
            r = np.arange(n_cp)
            c = r + d
            ok = (c >= 0) & (c < n_cp)
            rows.append(row0 + r[ok])
            cols.append(col0 + c[ok])
            vals.append(v[b:b + n_cp][ok])
        rows.append(np.asarray(lo.coo_rows))
        cols.append(np.asarray(lo.coo_cols))
        vals.append(v[lo.n_dense:])
        return sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(lo.n, lo.n))
