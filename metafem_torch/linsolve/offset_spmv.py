"""Dense-group SpMV of the block-offset storage: the pack plan, the
hand-written CUDA kernel over the packed values, and two plain PyTorch
versions.

For one workpiece group (block_offset.PallasGroup) with G units (pd, pb),
n_off sorted offsets d_k and C channels of n_cp rows:

    y[pd, r] = sum_g sum_k vals[g, k, r] * x[pb_g, r + d_k]

with x zero outside [0, n_cp).  This replaces the TPU kernel
``metafem/linsolve/pallas_spmv.py:_group_kernel`` (its wrapper
``group_mv``).  On CUDA it is the SpMV of every Krylov solve.

Most of the stored values are zeros that the assembly never writes: the
rows of ghost control points (serendipity face and body centres) hold
only their diagonal, and an occupied row couples to a part of the
offsets (on the 3D tangent 89M of 368M stored values are structural).
So the product runs on a **pack plan** (``PackPlan``), built once per
layout, device and vector width from the storage's structural entries:

- rows are (pd, r); within one row every participating unit of channel
  pd has the same structural offsets (checked when the plan is built;
  where a unit lacks an offset that another one has, the entry is kept
  as a stored value, counted in ``n_fill``), so a row is one list of
  one-byte offset codes k (decoded through a table of d_k) shared by
  the units of a bit mask;
- rows with the same offsets share one code list: a lattice has a few
  hundred distinct lists (interior corner, edge and ghost points and
  their boundary cuts), so a row carries a list number and not its
  codes;
- rows are sorted by entry count, then by code list, within windows of
  ``WINDOW`` rows and cut into slices of 32 rows, one warp each; slices
  are ordered by their longest row;
- the packed values are sliced jagged-diagonal: slot group m (``vec``
  slots, 16 bytes) of every slice that reaches it lies at
  ``ptr[m] + (slice*32 + lane)*vec``, so a warp reads 512 contiguous
  bytes per load.  A row's slots run unit by unit, each unit's codes
  padded to a multiple of ``vec`` with zero values.

A row adds its entries in the reference's (unit, offset) order with the
zeros left out, so y equals the dense formula's: a zero value adds
nothing to the sum.

``group_mv`` launches the kernel (``csrc/offset_spmv.cu``) on a CUDA
tensor and runs ``group_mv_packed_plain`` on a CPU tensor; on any other
device it raises.  ``group_mv_plain``, the dense formula over the
block-offset storage, is the oracle the packed product is held to.  The
kernel is built with nvcc for sm_90a into a plain-C shared library
(metafem_torch/_build/) at first use and called through ctypes on the
current CUDA stream.  ``group_mv.launches`` counts kernel launches.

The two-float product (``twofloat.df_offset_mv``, the refined step's
``df32`` residual) runs over the float64 plan: ``pack_df`` packs the
(hi, lo) words of each structural entry side by side, so a 16-byte load
holds two entries, as for float64.  ``group_mv_df`` launches the
two-float kernel on CUDA tensors (``group_mv_df.launches``) and runs
``group_mv_df_plain`` on CPU tensors; ``group_mv_df_dense``, the
reference's formula over the block-offset storage, is its oracle.  A
row sums each unit's entries into a fresh pair with df_add, then adds
the unit's sum into the row's (``twofloat.py``); the transforms round
every step, so the kernel and its plain version give the same bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Optional, Tuple

import torch

from ..buildlib import build_cuda
from . import twofloat as tf

#: rows per sorting window of the pack plan (a multiple of SLICE): rows
#: are sorted by length within a window, so a slice's rows lie close
#: together on the lattice and share x's cache lines
WINDOW = 4096
#: rows per slice: one warp
SLICE = 32
#: bytes per vector load of the packed values
VEC_BYTES = 16
#: slots per load of the two-float product: the float64 plan, each slot
#: an (hi, lo) pair of float32
DF_VEC = 2

_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_cuda("offset_spmv"))
        for name, n_ptr in (("offset_spmv_packed_f64", 10),
                            ("offset_spmv_packed_f32", 10),
                            ("offset_spmv_packed_df", 12)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * 7
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        fn = lib.offset_spmv_df_occupancy
        fn.argtypes = ([ctypes.c_int64] * 4
                       + [ctypes.POINTER(ctypes.c_int)] * 4)
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def shifted_stack(xw: torch.Tensor, offsets) -> torch.Tensor:
    """[n_off, C, n_cp] stack of xw [C, n_cp] shifted by each offset d:
    entry r holds xw[:, r + d], zero outside [0, n_cp)."""
    n_cp = xw.shape[1]
    R = int(max(abs(d) for d in offsets))
    xp = torch.nn.functional.pad(xw, (R, R))
    return torch.stack([xp[:, R + d:R + d + n_cp] for d in offsets])


def group_mv_plain(slab: torch.Tensor, xw: torch.Tensor, group,
                   out: torch.Tensor) -> torch.Tensor:
    """The dense formula in plain PyTorch over the block-offset storage:
    the shifted multiply-adds in the reference's order (units, then
    offsets).  ``slab`` [G, n_off, n_cp].  The oracle of the packed
    product."""
    shifted = shifted_stack(xw, group.offsets)
    acc = [None] * group.n_vars
    for g, (pd, pb) in enumerate(group.units):
        for k in range(group.n_off):
            c = slab[g, k] * shifted[k, pb]
            acc[pd] = c if acc[pd] is None else acc[pd] + c
    for pd, a in enumerate(acc):
        if a is None:
            out[pd].zero_()
        else:
            out[pd].copy_(a)
    return out


@dataclasses.dataclass(eq=False)
class PackPlan:
    """Packed layout of one dense group's structural entries on one
    device (see the module docstring).  Per packed row q = slice*32 +
    lane: ``rows[q]`` the output row pd*n_cp + r (-1 for the lanes that
    pad the last slice) and ``meta[q]`` = mask | list << 8, with mask the
    row's participating units (bit i: the i-th unit of channel pd) and
    list the row's code list.  Code list l holds ``list_len[l]`` codes
    from byte ``l * 4 * words`` of ``codes``, padded with its first code.
    Slot group m of the packed values starts at ``ptr[m]``.
    ``positions`` gathers the packed values from the storage; ``pad``
    lists the packed slots that hold no entry (zeroed after the
    gather)."""
    group: object
    vec: int                     # slots per 16-byte load
    n_slices: int
    n_groups: int                # slot groups of the longest slice
    maxu: int                    # units per channel, at most
    words: int                   # 4-byte code words per code list
    ptr_host: Tuple[int, ...]    # ptr on the host, for the plain version
    rows: torch.Tensor           # int32 [n_slices*32]
    meta: torch.Tensor           # int32 [n_slices*32]
    codes: torch.Tensor          # uint8 [n_lists * 4 * words]
    list_len: torch.Tensor       # int32 [n_lists]
    ptr: torch.Tensor            # int64 [n_groups + 1]
    dk: torch.Tensor             # int32 [n_off]: d of code k
    chan_pb: torch.Tensor        # int32 [C, maxu]: pb of a channel's unit
    chan_unit: torch.Tensor      # int64 [C, maxu]: its unit index g
    positions: torch.Tensor      # int32 or int64 [n_packed]
    pad: torch.Tensor            # int64 [n_pad]
    n_entries: int               # entries read: structural + n_fill
    n_fill: int                  # stored values kept to share a code list
    build_s: float = 0.0
    #: the plain version's x index per packed slot (``packed_columns``),
    #: built at its first call; None frees it
    columns: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)

    @property
    def n_packed(self) -> int:
        return self.ptr_host[-1]

    @property
    def n_lists(self) -> int:
        return self.list_len.numel()

    @property
    def padding_share(self) -> float:
        """Share of the packed slots that hold no entry."""
        return 1.0 - self.n_entries / max(self.n_packed, 1)

    def bytes_per_product(self, itemsize: int) -> int:
        """Bytes one product moves at least: the packed values, the row
        tables and the code lists once, x read once and y written once."""
        g = self.group
        return (self.n_packed * itemsize + 8 * self.rows.numel()
                + self.codes.numel() + 4 * self.n_lists
                + 2 * g.n_vars * g.n_cp * itemsize)


def _popcount(mask: torch.Tensor, bits: int) -> torch.Tensor:
    n = torch.zeros_like(mask)
    for i in range(bits):
        n += (mask >> i) & 1
    return n


def _nth_bit(mask: torch.Tensor, u: torch.Tensor, bits: int) -> torch.Tensor:
    """Index of the u-th set bit (from 0) of each mask."""
    out = torch.zeros_like(mask)
    rank = torch.zeros_like(mask)
    for i in range(bits):
        bit = (mask >> i) & 1
        out = torch.where((bit == 1) & (rank == u), i, out)
        rank += bit
    return out


def _entries(plan: PackPlan, q0: int, q1: int) -> tuple:
    """The entries of packed rows [q0, q1) in the kernel's addressing:
    (packed slot, channel pd, unit bit i, code k, lattice row r), one per
    structural entry, in each row's order."""
    dev = plan.rows.device
    v = plan.vec
    meta = plan.meta[q0:q1].long()
    mask = meta & 0xFF
    lst = meta >> 8
    L = plan.list_len.long()[lst]
    n_e = _popcount(mask, plan.maxu) * L
    q = torch.repeat_interleave(torch.arange(q0, q1, device=dev), n_e)
    start = torch.cumsum(n_e, 0) - n_e
    jj = torch.arange(q.numel(), device=dev) - start[q - q0]
    Lq = L[q - q0]
    u = jj // Lq
    c = jj - u * Lq
    del jj
    ng = (Lq + v - 1) // v                      # slot groups per unit
    slot = plan.ptr[u * ng + c // v] + q * v + c % v
    del ng
    code = plan.codes[lst[q - q0] * (4 * plan.words) + c].long()
    del c
    bit = _nth_bit(mask[q - q0], u, plan.maxu)
    row = plan.rows[q].long()
    n_cp = plan.group.n_cp
    pd = row // n_cp
    return slot, pd, bit, code, row - pd * n_cp


def _row_chunks(plan: PackPlan):
    """Packed-row ranges of at most ~2^24 entries each."""
    g = plan.group
    step = max(SLICE, (1 << 24) // max(1, plan.maxu * g.n_off)
               // SLICE * SLICE)
    n_q = plan.rows.numel()
    for q0 in range(0, n_q, step):
        yield q0, min(n_q, q0 + step)


def _code_lists(K: torch.Tensor, vec: int) -> tuple:
    """The distinct rows of K [n_rows, n_off] (bool): (list id of each
    row, codes [n_lists, 4*words] uint8 with each list's offsets k in
    order, padded to a multiple of ``vec`` and of 4 with its first code,
    list lengths [n_lists], words)."""
    dev = K.device
    n_rows, n_off = K.shape
    bits = torch.arange(64, device=dev)
    keys = torch.stack(
        [(K[:, j:j + 64].long() << bits[:min(64, n_off - j)]).sum(1)
         for j in range(0, n_off, 64)], 1)
    _, lst = torch.unique(keys, dim=0, return_inverse=True)
    del keys
    n_lists = int(lst.max()) + 1 if n_rows else 0
    rep = torch.full((n_lists,), n_rows, dtype=torch.int64, device=dev)
    rep.scatter_reduce_(0, lst, torch.arange(n_rows, device=dev), "amin")
    Kl = K[rep]
    length = Kl.sum(1)
    Lp = (length + vec - 1) // vec * vec
    words = max(1, (int(Lp.max()) + 3) // 4) if n_lists else 1
    nz = Kl.nonzero()                             # (list, k), row-major
    first = torch.zeros(n_lists, dtype=torch.uint8, device=dev)
    start = torch.cumsum(length, 0) - length
    has = length > 0
    first[has] = nz[start[has], 1].to(torch.uint8)
    codes = first[:, None].repeat(1, 4 * words)
    c = torch.arange(nz.shape[0], device=dev) - start[nz[:, 0]]
    codes[nz[:, 0], c] = nz[:, 1].to(torch.uint8)
    return lst, codes.reshape(-1), length.to(torch.int32), words


def slice_rows(order: torch.Tensor, Ep: torch.Tensor, vec: int) -> tuple:
    """Cut rows into slices of SLICE rows, one warp each, and order the
    slices by their longest row (stable), as the jagged-diagonal layout
    wants.  ``order``: int64, the rows in their sorted order (a
    permutation of the row ids); ``Ep``: each row's slot count by row id,
    a multiple of ``vec``.  Returns (perm, ptr_host): perm, int64
    [n_slices*SLICE], the row id of each packed row q = slice*32 + lane
    (-1 for the lanes that pad the last slice); ptr_host, the first slot
    of each slot group m (``vec`` slots of every slice that reaches m,
    slice by slice) and the packed length last."""
    dev = order.device
    n_slices = -(-order.numel() // SLICE)
    fill = n_slices * SLICE - order.numel()
    order = torch.cat([order, torch.full((fill,), -1, dtype=torch.int64,
                                         device=dev)])
    Ep_max = torch.where(order >= 0, Ep[order.clamp(min=0)],
                         0).view(n_slices, SLICE).amax(1)
    sl = torch.argsort(-Ep_max, stable=True)
    perm = order.view(n_slices, SLICE)[sl].reshape(-1)
    n_grp = (Ep_max[sl] // vec).cpu()
    M = int(n_grp[0]) if n_slices else 0
    cnt = torch.bincount(n_grp, minlength=M + 1)
    n_act = n_slices - torch.cumsum(cnt, 0)[:M]   # slices reaching group m
    ptr_host = [0]
    for a in n_act.tolist():
        ptr_host.append(ptr_host[-1] + a * SLICE * vec)
    return perm, tuple(ptr_host)


def slot_sums(prod: torch.Tensor, ptr_host: tuple, vec: int,
              n_q: int) -> torch.Tensor:
    """Each packed row's sum of the slot values ``prod`` (over a
    jagged-diagonal layout of ``n_q`` packed rows), slot by slot in the
    row's order: slot group m, then its ``vec`` slots."""
    acc = torch.zeros(n_q, dtype=prod.dtype, device=prod.device)
    for m in range(len(ptr_host) - 1):
        blk = prod[ptr_host[m]:ptr_host[m + 1]].view(-1, vec)
        for t in range(vec):
            acc[:blk.shape[0]] += blk[:, t]
    return acc


def build_pack_plan(keep: torch.Tensor, group, vec: int,
                    rows: Optional[Tuple[int, int]] = None) -> PackPlan:
    """The pack plan of one dense group on keep's device.  ``keep``: bool
    [G, n_off, n_cp], True at the structural entries of the group's
    storage (``OffsetMatrix.structural_mask``); ``vec``: slots per
    16-byte load (2 for float64, 4 for float32).  ``rows``: (c0, c1),
    a row window: only the rows (pd, r) with c0 <= r < c1 are packed
    (the plan of a rank's rows, ``block_offset.WindowLayout``); the
    plan of the window (0, n_cp) is the whole plan."""
    t0 = time.perf_counter()
    dev = keep.device
    G, n_off, C, n_cp = (len(group.units), group.n_off, group.n_vars,
                         group.n_cp)
    if tuple(keep.shape) != (G, n_off, n_cp) or keep.dtype != torch.bool:
        raise ValueError(f"keep {tuple(keep.shape)} {keep.dtype} is not a "
                         f"bool mask of {(G, n_off, n_cp)}")
    c0, c1 = (0, n_cp) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= c0 <= c1 <= n_cp:
        raise ValueError(f"row window {(c0, c1)} outside [0, {n_cp}]")
    if (c0, c1) != (0, n_cp):
        keep = keep.clone()
        keep[:, :, :c0] = False
        keep[:, :, c1:] = False
    chan = [[g for g, (pd, _pb) in enumerate(group.units) if pd == c]
            for c in range(C)]
    maxu = max(1, max(len(u) for u in chan))
    if n_off > 256 or maxu > 8 or C * n_cp >= 2 ** 31:
        raise NotImplementedError(
            f"pack plan: n_off {n_off} > 256, {maxu} units per channel "
            f"> 8 or {C * n_cp} rows >= 2^31")
    i64 = torch.int64
    masks, Kts = [], []
    n_fill = 0
    for units in chan:
        if not units:
            masks.append(torch.zeros(n_cp, dtype=i64, device=dev))
            Kts.append(torch.zeros((n_cp, n_off), dtype=torch.bool,
                                   device=dev))
            continue
        Bu = keep[units]                          # [nu, n_off, n_cp]
        K = Bu.any(0)                             # the row's code list
        part = Bu.any(1)                          # [nu, n_cp]
        n_fill += int((K & ~Bu & part[:, None, :]).sum())
        del Bu
        mask = torch.zeros(n_cp, dtype=i64, device=dev)
        for i in range(len(units)):
            mask |= part[i].long() << i
        masks.append(mask)
        Kts.append(K.t())
    K = torch.cat(Kts)                            # [C*n_cp, n_off]
    mask_nat = torch.cat(masks)
    del Kts, masks
    lst_nat, codes, list_len, words = _code_lists(K, vec)
    if list_len.numel() >= 2 ** 23:
        raise NotImplementedError(f"pack plan: {list_len.numel()} code "
                                  f"lists >= 2^23")
    L_nat = K.sum(1)
    del K
    n_rows = C * n_cp
    n_units = _popcount(mask_nat, maxu)
    E = n_units * L_nat
    e_top = int(E.max()) + 1 if n_rows else 1
    ids = torch.arange(n_rows, device=dev)
    # within a window: longest rows first, rows of one code list together
    order = torch.argsort(((ids // WINDOW) * e_top + (e_top - 1 - E))
                          * list_len.numel() + lst_nat, stable=True)
    if (c0, c1) != (0, n_cp):
        r_of = order % n_cp
        order = order[(r_of >= c0) & (r_of < c1)]
        del r_of
    del ids, E
    rows, ptr_host = slice_rows(
        order, n_units * ((L_nat + vec - 1) // vec * vec), vec)
    meta = torch.where(rows >= 0,
                       (mask_nat | (lst_nat << 8))[rows.clamp(min=0)], 0)
    del order, n_units, L_nat, mask_nat, lst_nat
    n_slices, M = rows.numel() // SLICE, len(ptr_host) - 1
    chan_pb = torch.zeros((C, maxu), dtype=torch.int32)
    chan_unit = torch.zeros((C, maxu), dtype=i64)
    for pd, units in enumerate(chan):
        for i, g in enumerate(units):
            chan_pb[pd, i] = group.units[g][1]
            chan_unit[pd, i] = g
    plan = PackPlan(
        group=group, vec=vec, n_slices=n_slices, n_groups=M, maxu=maxu,
        words=words, ptr_host=ptr_host, rows=rows.to(torch.int32),
        meta=meta.to(torch.int32), codes=codes, list_len=list_len,
        ptr=torch.tensor(ptr_host, dtype=i64, device=dev),
        dk=torch.tensor(group.offsets, dtype=torch.int32, device=dev),
        chan_pb=chan_pb.to(dev), chan_unit=chan_unit.to(dev),
        positions=torch.empty(0, dtype=i64, device=dev),
        pad=torch.empty(0, dtype=i64, device=dev),
        n_entries=0, n_fill=n_fill)
    del rows, meta
    # storage position of every entry, through the kernel's addressing
    n_storage = G * n_off * n_cp
    pdtype = torch.int32 if n_storage < 2 ** 31 else i64
    positions = torch.zeros(plan.n_packed, dtype=pdtype, device=dev)
    used = torch.zeros(plan.n_packed, dtype=torch.bool, device=dev)
    n_entries = 0
    for q0, q1 in _row_chunks(plan):
        slot, pd, bit, code, r = _entries(plan, q0, q1)
        g = plan.chan_unit[pd, bit]
        positions[slot] = ((g * n_off + code) * n_cp + r).to(pdtype)
        used[slot] = True
        n_entries += slot.numel()
    plan.positions = positions
    plan.pad = (~used).nonzero().view(-1)
    plan.n_entries = n_entries
    if n_entries != int(keep.sum()) + n_fill:
        raise AssertionError(f"pack plan holds {n_entries} entries, not "
                             f"{int(keep.sum())} + {n_fill}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    plan.build_s = time.perf_counter() - t0
    return plan


def pack(slab: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    """The packed values of one group: ``slab`` (the group's storage,
    flat [G*n_off*n_cp]) gathered through the plan, padding zeroed."""
    packed = torch.index_select(slab, 0, plan.positions)
    return packed.index_fill_(0, plan.pad, 0)


def packed_columns(plan: PackPlan) -> torch.Tensor:
    """x index (pb*n_cp + r + d_k into x [C*n_cp]) of every packed slot,
    decoded from the plan as the kernel decodes it; 0 at padding slots.
    Built at the plain version's first call and kept on the plan."""
    if plan.columns is None:
        n_cp = plan.group.n_cp
        cols = torch.zeros(plan.n_packed, dtype=torch.int64,
                           device=plan.rows.device)
        for q0, q1 in _row_chunks(plan):
            slot, pd, bit, code, r = _entries(plan, q0, q1)
            cols[slot] = (plan.chan_pb[pd, bit].long() * n_cp + r
                          + plan.dk[code].long())
        plan.columns = cols
    return plan.columns


def group_mv_packed_plain(packed: torch.Tensor, xw: torch.Tensor,
                          plan: PackPlan, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel over the same plan: the
    products of every packed slot, then, slot by slot, each row's sum in
    the row's order (the products of padding slots are zeros)."""
    prod = packed * xw.reshape(-1)[packed_columns(plan)]
    acc = slot_sums(prod, plan.ptr_host, plan.vec, plan.rows.numel())
    rows = plan.rows.long()
    real = rows >= 0
    out.view(-1)[rows[real]] = acc[real]
    return out


def _check_group_args(packed: torch.Tensor, xws, outs, plan: PackPlan,
                      packed_shape: tuple, slot_bytes: int) -> None:
    """The checks of a group product's arguments: shapes against the
    plan, one float type, the plan's load width, one device, contiguity.
    ``xws`` and ``outs``: the x windows and destinations (one each, or the
    two words of a pair)."""
    grp = plan.group
    C, n_cp = grp.n_vars, grp.n_cp
    dev = xws[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"group products run on cuda or cpu, not {dev}")
    if tuple(packed.shape) != packed_shape:
        raise ValueError(f"packed {tuple(packed.shape)} != {packed_shape}")
    for xw in xws:
        if tuple(xw.shape) != (C, n_cp):
            raise ValueError(f"x window {tuple(xw.shape)} != {(C, n_cp)}")
    for out in outs:
        if tuple(out.shape) != (C, n_cp):
            raise ValueError(f"out {tuple(out.shape)} != {(C, n_cp)}")
    types = {t.dtype for t in (packed, *xws, *outs)}
    if len(types) != 1:
        raise TypeError(f"dtype mismatch: packed {packed.dtype}, x "
                        f"{[x.dtype for x in xws]}, out "
                        f"{[o.dtype for o in outs]}")
    if plan.vec * slot_bytes != VEC_BYTES:
        raise TypeError(f"a plan of {plan.vec} slots per load does not "
                        f"fit {packed.dtype}")
    if any(t.device != plan.rows.device for t in (packed, *xws, *outs)):
        raise ValueError("packed, x, out and the plan must lie on one "
                         "device")
    if not all(t.is_contiguous() for t in (packed, *xws, *outs)):
        raise ValueError("group products need contiguous tensors")


def _launch_check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def group_mv(packed: torch.Tensor, xw: torch.Tensor, plan: PackPlan,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y [C, n_cp] of one dense group.  ``packed``: the group's values
    gathered through ``plan`` (``pack``); ``xw``: the group's slice of x
    as [C, n_cp]; ``out``: optional contiguous [C, n_cp] destination (not
    aliasing xw or packed)."""
    grp = plan.group
    C, n_cp = grp.n_vars, grp.n_cp
    if out is None:
        out = torch.empty((C, n_cp), dtype=xw.dtype, device=xw.device)
    _check_group_args(packed, (xw,), (out,), plan, (plan.n_packed,),
                      packed.element_size())
    if xw.device.type == "cpu":
        return group_mv_packed_plain(packed, xw, plan, out)
    if xw.dtype == torch.float64:
        fn = load_library().offset_spmv_packed_f64
    elif xw.dtype == torch.float32:
        fn = load_library().offset_spmv_packed_f32
    else:
        raise TypeError(f"group_mv supports float32/float64, not {xw.dtype}")
    with torch.cuda.device(xw.device):
        # the launch runs in the current device's context
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(packed.data_ptr(), xw.data_ptr(), out.data_ptr(),
                 plan.rows.data_ptr(), plan.meta.data_ptr(),
                 plan.codes.data_ptr(), plan.list_len.data_ptr(),
                 plan.ptr.data_ptr(), plan.dk.data_ptr(),
                 plan.chan_pb.data_ptr(), plan.n_slices, plan.n_groups,
                 grp.n_off, plan.maxu, C, n_cp, plan.words, stream)
    _launch_check(err, "offset_spmv")
    group_mv.launches += 1
    group_mv.launches_by_dtype[xw.dtype] += 1
    return out


#: kernel launches, in all and per float type
group_mv.launches = 0
group_mv.launches_by_dtype = {torch.float32: 0, torch.float64: 0}


# ---------------------------------------------------------------------------
# the two-float product
# ---------------------------------------------------------------------------

def group_mv_df_dense(slab: tf.DF, xw: tf.DF, group) -> tf.DF:
    """The reference's two-float formula (``twofloat.df_offset_mv``, one
    dense group) in plain PyTorch over the block-offset storage: per unit
    a fresh pair summed with df_add over all n_off offsets, then the
    unit's sum df_added into its channel's.  ``slab``: the pair's words
    as [G, n_off, n_cp]; ``xw``: x's words as [C, n_cp].  Returns y's
    words as [C, n_cp].  The oracle of ``group_mv_df``."""
    sh_hi = shifted_stack(xw.hi, group.offsets)
    sh_lo = shifted_stack(xw.lo, group.offsets)
    zero = torch.zeros_like(xw.hi[0])
    acc = [None] * group.n_vars
    for g, (pd, pb) in enumerate(group.units):
        a = tf.DF(zero, zero)
        for k in range(group.n_off):
            vh, vl = slab.hi[g, k], slab.lo[g, k]
            p, e = tf.two_prod(vh, sh_hi[k, pb])
            e = e + ((vh * sh_lo[k, pb]) + (vl * sh_hi[k, pb]))
            a = tf.df_add(a, tf.DF(p, e))
        acc[pd] = a if acc[pd] is None else tf.df_add(acc[pd], a)
    return tf.DF(*(torch.stack([zero if a is None else getattr(a, w)
                                for a in acc]) for w in ("hi", "lo")))


def pack_df(hi_slab: torch.Tensor, lo_slab: torch.Tensor,
            plan: PackPlan) -> torch.Tensor:
    """The packed pair of one group over a float64 plan (``DF_VEC`` slots
    per load): float32 [n_packed, 2], slot s holding (hi, lo) of its
    entry, padding zeroed."""
    if plan.vec != DF_VEC:
        raise ValueError(f"the two-float product packs over the float64 "
                         f"plan ({DF_VEC} slots per load), not {plan.vec}")
    return torch.stack([pack(hi_slab, plan), pack(lo_slab, plan)], dim=1)


def group_mv_df_plain(packed: torch.Tensor, xw_hi: torch.Tensor,
                      xw_lo: torch.Tensor, plan: PackPlan,
                      out_hi: torch.Tensor, out_lo: torch.Tensor) -> tuple:
    """Plain PyTorch version of the two-float kernel over the same plan:
    the (p, e) terms of every packed slot, then, slot group by slot
    group, each row's walk: df_add into the unit's pair, and at each
    unit's end (every ``ceil(L / 2)`` groups) the unit's pair df_added
    into the row's.  A row takes part only in its own slot groups, as
    in the kernel: a short row of a long slice leaves the slice's
    trailing groups alone."""
    v = plan.vec
    cols = packed_columns(plan)
    vh, vl = packed[:, 0], packed[:, 1]
    xh = xw_hi.reshape(-1)[cols]
    xl = xw_lo.reshape(-1)[cols]
    p, e = tf.two_prod(vh, xh)
    e = e + ((vh * xl) + (vl * xh))
    del cols, xh, xl
    n_q = plan.rows.numel()
    meta = plan.meta.long()
    L = plan.list_len.long()[meta >> 8]
    n_unit = ((L + v - 1) // v).clamp(min=1)      # slot groups per unit
    n_own = _popcount(meta & 0xFF, plan.maxu) * ((L + v - 1) // v)
    del meta, L
    z = torch.zeros(n_q, dtype=packed.dtype, device=packed.device)
    row_hi, row_lo, unit_hi, unit_lo = z, z.clone(), z.clone(), z.clone()
    ptr = plan.ptr_host
    for m in range(plan.n_groups):
        bp = p[ptr[m]:ptr[m + 1]].view(-1, v)
        be = e[ptr[m]:ptr[m + 1]].view(-1, v)
        n = bp.shape[0]
        own = m < n_own[:n]
        if m:
            fold = own & ((m % n_unit[:n]) == 0)
            s = tf.df_add(tf.DF(row_hi[:n], row_lo[:n]),
                          tf.DF(unit_hi[:n], unit_lo[:n]))
            row_hi[:n] = torch.where(fold, s.hi, row_hi[:n])
            row_lo[:n] = torch.where(fold, s.lo, row_lo[:n])
            unit_hi[:n] = torch.where(fold, 0.0, unit_hi[:n])
            unit_lo[:n] = torch.where(fold, 0.0, unit_lo[:n])
        for t in range(v):
            u = tf.df_add(tf.DF(unit_hi[:n], unit_lo[:n]),
                          tf.DF(bp[:, t], be[:, t]))
            unit_hi[:n] = torch.where(own, u.hi, unit_hi[:n])
            unit_lo[:n] = torch.where(own, u.lo, unit_lo[:n])
    y = tf.df_add(tf.DF(row_hi, row_lo), tf.DF(unit_hi, unit_lo))
    rows = plan.rows.long()
    real = rows >= 0
    out_hi.view(-1)[rows[real]] = y.hi[real]
    out_lo.view(-1)[rows[real]] = y.lo[real]
    return out_hi, out_lo


def group_mv_df(packed: torch.Tensor, xw_hi: torch.Tensor,
                xw_lo: torch.Tensor, plan: PackPlan,
                out_hi: Optional[torch.Tensor] = None,
                out_lo: Optional[torch.Tensor] = None) -> tuple:
    """(y_hi, y_lo), each [C, n_cp], of one dense group in two-float
    arithmetic.  ``packed``: the pair packed through the group's float64
    plan (``pack_df``); ``xw_hi``/``xw_lo``: x's words as [C, n_cp];
    ``out_hi``/``out_lo``: optional contiguous destinations (not
    aliasing the inputs).  On CUDA tensors the kernel or an error; on
    CPU tensors the plain version."""
    grp = plan.group
    C, n_cp = grp.n_vars, grp.n_cp
    outs = [torch.empty((C, n_cp), dtype=xw_hi.dtype, device=xw_hi.device)
            if o is None else o for o in (out_hi, out_lo)]
    _check_group_args(packed, (xw_hi, xw_lo), outs, plan,
                      (plan.n_packed, 2), 2 * packed.element_size())
    if xw_hi.dtype != torch.float32:
        raise TypeError(f"group_mv_df takes float32 words, not "
                        f"{xw_hi.dtype}")
    if xw_hi.device.type == "cpu":
        return group_mv_df_plain(packed, xw_hi, xw_lo, plan, *outs)
    with torch.cuda.device(xw_hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_library().offset_spmv_packed_df(
            packed.data_ptr(), xw_hi.data_ptr(), xw_lo.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(),
            plan.rows.data_ptr(), plan.meta.data_ptr(),
            plan.codes.data_ptr(), plan.list_len.data_ptr(),
            plan.ptr.data_ptr(), plan.dk.data_ptr(),
            plan.chan_pb.data_ptr(), plan.n_slices, plan.n_groups,
            grp.n_off, plan.maxu, C, n_cp, plan.words, stream)
    _launch_check(err, "offset_spmv_packed_df")
    group_mv_df.launches += 1
    return tuple(outs)


#: two-float kernel launches
group_mv_df.launches = 0


def occupancy_numbers(fn, *args) -> dict:
    """Registers and spilled bytes per thread of a kernel and its
    resident blocks and warps per SM, from the library's occupancy query
    ``fn(*args, &regs, &local_bytes, &blocks, &warps)`` (CUDA only)."""
    out = [ctypes.c_int(0) for _ in range(4)]
    _launch_check(fn(*args, *(ctypes.byref(o) for o in out)), "occupancy")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm",
                     "warps_per_sm"), (o.value for o in out)))


def df_occupancy(plan: PackPlan) -> dict:
    """``occupancy_numbers`` of the two-float kernel with the plan's
    shared tables."""
    g = plan.group
    return occupancy_numbers(load_library().offset_spmv_df_occupancy,
                             plan.n_groups, g.n_off, plan.maxu, g.n_vars)


def reset_launches() -> None:
    group_mv.launches = 0
    for k in group_mv.launches_by_dtype:
        group_mv.launches_by_dtype[k] = 0
    group_mv_df.launches = 0
