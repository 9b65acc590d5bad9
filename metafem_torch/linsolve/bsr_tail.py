"""SpMV of the BSR tail of the block-offset storage: the tail's pack plan,
the hand-written CUDA kernels over it (float32/float64 and two-float),
and their plain PyTorch versions.

Unstructured meshes spill the rare offsets of their tangent into a tail
of dense ``b x b`` blocks (``block_offset.OffsetLayout.blk_b``, b = 8).
The tail's storage is component-major: entry (i, j) of block k lies at
``(i*b + j)*nb + k`` of the tail's values, and the blocks are sorted by
block row.  Its product adds into y:

    y[R*b + i] += sum_k sum_j vals[(i*b + j)*nb + k] * x[cols[k]*b + j]

over the blocks k of block row R.  The reference computes it outside
Pallas (``metafem/linsolve/block_offset.py:_blk_tail_mv``, XLA on the
TPU).  The BSR storage stays the port's storage, but on an unstructured
brick only ~7% of its 64 nb stored values are structural, so the product
runs on a **tail plan** (``TailPlan``) of the structural entries alone,
built once per layout, device and float width, as the dense groups' pack
plan is (``offset_spmv.PackPlan``):

- a packed row is one matrix row that holds tail entries; its entries
  are ordered by ascending column;
- rows are sorted by entry count within windows of
  ``offset_spmv.WINDOW`` rows, cut into slices of 32 rows (one warp),
  and the slices ordered by their longest row
  (``offset_spmv.slice_rows``);
- the values and their int32 column ids are sliced jagged-diagonal:
  slot group m (``vec`` slots, 16 bytes of values) of packed row q lies
  at ``ptr[m] + q*vec``.  Every row of a slice runs to the slice's
  longest row; the slots past its own entries hold zero values and the
  row's first column.

``tail_mv`` launches the kernel (``csrc/bsr_tail.cu``) on a CUDA tensor
and runs ``tail_mv_packed_plain`` on a CPU tensor; on any other device it
raises, and on a CUDA tensor a failed build or launch raises too.
``tail_mv_df`` and ``tail_mv_df_plain`` are the two-float product (the
refined step's ``df32`` residual) over the float64 plan, each slot an
(hi, lo) pair of float32 words; on the card they agree bit for bit.
``bsr_tail_mv_plain``, the product over the BSR storage itself, is the
oracle the packed products are held to.  ``tail_mv.launches`` and
``tail_mv_df.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Optional

import torch

from ..buildlib import build_cuda
from . import offset_spmv
from . import twofloat as tf

_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_cuda("bsr_tail"))
        for name, n_ptr in (("bsr_tail_packed_f64", 6),
                            ("bsr_tail_packed_f32", 6),
                            ("bsr_tail_packed_df", 8)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * 2
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        fn = lib.bsr_tail_df_occupancy
        fn.argtypes = ([ctypes.c_int64]
                       + [ctypes.POINTER(ctypes.c_int)] * 4)
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def blocked(v: torch.Tensor, b: int) -> torch.Tensor:
    """v [n] zero-padded to whole blocks, as [ceil(n / b), b]."""
    n = v.shape[0]
    vp = torch.zeros(-(-n // b) * b, dtype=v.dtype, device=v.device)
    vp[:n] = v
    return vp.view(-1, b)


def bsr_tail_mv_plain(tail: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      cols: torch.Tensor, run_start: torch.Tensor,
                      run_row: torch.Tensor, b: int) -> torch.Tensor:
    """The tail's product added into y over the BSR storage, in plain
    PyTorch: per block the products of each row i summed over j = 0..b-1,
    then each run's block sums added in the run's order
    (``torch.segment_reduce`` over the sorted blocks), and each run's row
    written once.  ``cols``: int64 block column of each block;
    ``run_start``/``run_row``: ``block_offset.tail_runs``.  The oracle of
    the packed products."""
    n = y.shape[0]
    nb = cols.shape[0]
    if nb == 0:
        return y
    xg = blocked(x, b)[cols]                                # [nb, b]
    B = tail.view(b, b, nb)
    contrib = B[:, 0, :] * xg[:, 0]                          # [b, nb]
    for j in range(1, b):
        contrib = contrib + B[:, j, :] * xg[:, j]
    lengths = run_start[1:] - run_start[:-1]
    sums = torch.segment_reduce(contrib.t(), "sum", lengths=lengths)
    rows = (run_row[:, None] * b
            + torch.arange(b, device=y.device)).reshape(-1)
    keep = rows < n
    y[rows[keep]] += sums.reshape(-1)[keep]
    return y


@dataclasses.dataclass(eq=False)
class TailPlan:
    """Packed layout of the BSR tail's structural entries on one device
    (see the module docstring).  Per packed row q = slice*32 + lane:
    ``rows[q]`` its matrix row (-1 for the lanes that pad the last
    slice).  Slot s: ``cols[s]`` its column; ``positions[s]`` its value's
    index into the tail's values (``vals[n_dense:]``), through which
    ``offset_spmv.pack`` gathers the packed values; ``pad`` lists the
    slots that hold no entry (zeroed after the gather)."""
    vec: int                     # slots per 16-byte load of values
    n_slices: int
    n_groups: int                # slot groups of the longest slice
    ptr_host: tuple              # ptr on the host, for the plain version
    rows: torch.Tensor           # int32 [n_slices*32]
    cols: torch.Tensor           # int32 [n_packed]
    ptr: torch.Tensor            # int64 [n_groups + 1]
    positions: torch.Tensor      # int32 or int64 [n_packed]
    pad: torch.Tensor            # int64 [n_pad]
    n: int                       # rows (and columns) of the matrix
    n_touched: int               # rows that hold tail entries
    n_entries: int               # structural tail entries
    build_s: float = 0.0

    @property
    def n_packed(self) -> int:
        return self.ptr_host[-1]

    @property
    def padding_share(self) -> float:
        """Share of the packed slots that hold no entry."""
        return 1.0 - self.n_entries / max(self.n_packed, 1)

    def bytes_per_product(self, itemsize: int) -> int:
        """Bytes one product moves at least: the packed values and their
        int32 column ids, the row ids, x read once, and the touched rows
        of y read and written (the product adds into y)."""
        return (self.n_packed * (itemsize + 4) + 4 * self.rows.numel()
                + self.n * itemsize + 2 * self.n_touched * itemsize)


def slot_rows(ptr: torch.Tensor, vec: int) -> torch.Tensor:
    """The packed row q of every slot of a jagged-diagonal layout whose
    slot group m starts at ``ptr[m]`` (slot ptr[m] + q*vec + t)."""
    dev = ptr.device
    m = torch.repeat_interleave(torch.arange(ptr.numel() - 1, device=dev),
                                torch.diff(ptr))
    return (torch.arange(m.numel(), device=dev) - ptr[m]) // vec


def build_tail_plan(layout, keep: torch.Tensor, vec: int,
                    row_mask: torch.Tensor = None) -> TailPlan:
    """The tail plan of ``layout``'s BSR tail on keep's device.
    ``keep``: bool [b*b*nb], True at the structural entries of the tail's
    storage (``OffsetMatrix.structural_mask()[n_dense:]``); ``vec``:
    slots per 16-byte load (2 for float64 and two-float, 4 for
    float32).  ``row_mask``: bool [n] on keep's device, the rows to pack
    (a rank's row window, ``block_offset.WindowLayout``); None packs
    every row."""
    t0 = time.perf_counter()
    dev = keep.device
    b, nb, n = layout.blk_b, layout.n_coo, layout.n
    if tuple(keep.shape) != (b * b * nb,) or keep.dtype != torch.bool:
        raise ValueError(f"keep {tuple(keep.shape)} {keep.dtype} is not a "
                         f"bool mask of ({b * b * nb},)")
    if n >= 2 ** 31:
        raise NotImplementedError(f"tail plan: {n} rows >= 2^31")
    i64 = torch.int64
    pos = keep.nonzero().view(-1)
    comp = pos // nb
    k = pos - comp * nb
    r = torch.as_tensor(layout.coo_rows, dtype=i64, device=dev)[k] * b \
        + comp // b
    c = torch.as_tensor(layout.coo_cols, dtype=i64, device=dev)[k] * b \
        + comp % b
    del comp, k
    if pos.numel() and int(torch.maximum(r, c).max()) >= n:
        raise ValueError("a structural tail entry lies outside the matrix")
    if row_mask is not None:
        sel = row_mask[r]
        pos, r, c = pos[sel], r[sel], c[sel]
        del sel
    order = torch.argsort(r * n + c, stable=True)     # by row, then column
    pos, r, c = pos[order], r[order], c[order]
    del order
    n_e = pos.numel()
    counts = torch.bincount(r, minlength=n)
    touched = counts.nonzero().view(-1)
    L = counts[touched]
    del counts
    n_t = touched.numel()
    e_top = int(L.max()) + 1 if n_t else 1
    ids = torch.arange(n_t, device=dev)
    # within a window: longest rows first, then by row
    order = torch.argsort((ids // offset_spmv.WINDOW) * e_top
                          + (e_top - 1 - L), stable=True)
    perm, ptr_host = offset_spmv.slice_rows(order, (L + vec - 1) // vec * vec,
                                            vec)
    del order
    n_q = perm.numel()
    real = perm >= 0
    q_of = torch.empty(n_t, dtype=i64, device=dev)
    q_of[perm[real]] = torch.arange(n_q, device=dev)[real]
    # slot of every entry, from its rank in its row's ascending columns
    start = torch.cumsum(L, 0) - L
    t_of = torch.repeat_interleave(ids, L)
    rank = torch.arange(n_e, device=dev) - start[t_of]
    ptr = torch.tensor(ptr_host, dtype=i64, device=dev)
    slot = ptr[rank // vec] + q_of[t_of] * vec + rank % vec
    del rank, t_of, q_of
    # every slot first takes its row's first column (0 on padding lanes)
    owner = perm[slot_rows(ptr, vec)]
    cols = torch.where(owner >= 0, c[start][owner.clamp(min=0)],
                       0).to(torch.int32)
    del owner
    cols[slot] = c.to(torch.int32)
    n_packed = ptr_host[-1]
    pdtype = torch.int32 if b * b * nb < 2 ** 31 else i64
    positions = torch.zeros(n_packed, dtype=pdtype, device=dev)
    positions[slot] = pos.to(pdtype)
    used = torch.zeros(n_packed, dtype=torch.bool, device=dev)
    used[slot] = True
    rows = torch.where(real, touched[perm.clamp(min=0)], -1)
    plan = TailPlan(
        vec=vec, n_slices=n_q // offset_spmv.SLICE,
        n_groups=len(ptr_host) - 1, ptr_host=ptr_host,
        rows=rows.to(torch.int32), cols=cols, ptr=ptr, positions=positions,
        pad=(~used).nonzero().view(-1), n=n, n_touched=n_t, n_entries=n_e)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    plan.build_s = time.perf_counter() - t0
    return plan


def _check_args(packed: torch.Tensor, xs, ys, plan: TailPlan,
                packed_shape: tuple, slot_bytes: int) -> None:
    """The checks of a tail product's arguments: shapes against the
    plan, one float type, the plan's load width, one device, contiguity.
    ``xs`` and ``ys``: x and y (one each, or the two words of a pair)."""
    dev = xs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tail products run on cuda or cpu, not {dev}")
    if tuple(packed.shape) != packed_shape:
        raise ValueError(f"packed {tuple(packed.shape)} != {packed_shape}")
    for v in (*xs, *ys):
        if tuple(v.shape) != (plan.n,):
            raise ValueError(f"x and y must be ({plan.n},), not "
                             f"{tuple(v.shape)}")
    types = {t.dtype for t in (packed, *xs, *ys)}
    if len(types) != 1:
        raise TypeError(f"dtype mismatch: packed {packed.dtype}, x "
                        f"{[x.dtype for x in xs]}, y {[y.dtype for y in ys]}")
    if plan.vec * slot_bytes != offset_spmv.VEC_BYTES:
        raise TypeError(f"a plan of {plan.vec} slots per load does not "
                        f"fit {packed.dtype}")
    if any(t.device != plan.rows.device for t in (packed, *xs, *ys)):
        raise ValueError("packed, x, y and the plan must lie on one device")
    if not all(t.is_contiguous() for t in (packed, *xs, *ys)):
        raise ValueError("tail products need contiguous tensors")


def tail_mv_packed_plain(packed: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor, plan: TailPlan) -> torch.Tensor:
    """Plain PyTorch version of the kernel over the same plan: the
    products of every packed slot, each row's sum slot by slot in the
    row's order (the products of padding slots are zeros), then the sum
    added into the row's y."""
    prod = packed * torch.index_select(x, 0, plan.cols)
    acc = offset_spmv.slot_sums(prod, plan.ptr_host, plan.vec,
                                plan.rows.numel())
    rows = plan.rows.long()
    real = rows >= 0
    y[rows[real]] += acc[real]
    return y


def tail_mv(packed: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            plan: TailPlan) -> torch.Tensor:
    """y += (BSR tail) x, in place.  ``packed``: the tail's structural
    values gathered through ``plan`` (``offset_spmv.pack`` of
    ``vals[n_dense:]``, ``OffsetMatrix.packed_tail``); ``x``, ``y``:
    [n].  On CUDA tensors the kernel or an error; on CPU tensors the
    plain version."""
    _check_args(packed, (x,), (y,), plan, (plan.n_packed,),
                packed.element_size())
    if x.device.type == "cpu":
        return tail_mv_packed_plain(packed, x, y, plan)
    if x.dtype == torch.float64:
        fn = load_library().bsr_tail_packed_f64
    elif x.dtype == torch.float32:
        fn = load_library().bsr_tail_packed_f32
    else:
        raise TypeError(f"tail_mv supports float32/float64, not {x.dtype}")
    with torch.cuda.device(x.device):
        # the launch runs in the current device's context
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(packed.data_ptr(), plan.cols.data_ptr(), x.data_ptr(),
                 y.data_ptr(), plan.rows.data_ptr(), plan.ptr.data_ptr(),
                 plan.n_slices, plan.n_groups, stream)
    offset_spmv._launch_check(err, "bsr_tail_packed")
    tail_mv.launches += 1
    tail_mv.launches_by_dtype[x.dtype] += 1
    return y


#: kernel launches, in all and per float type
tail_mv.launches = 0
tail_mv.launches_by_dtype = {torch.float32: 0, torch.float64: 0}


# ---------------------------------------------------------------------------
# the two-float product
# ---------------------------------------------------------------------------

def tail_mv_df_plain(packed: torch.Tensor, x_hi: torch.Tensor,
                     x_lo: torch.Tensor, y_hi: torch.Tensor,
                     y_lo: torch.Tensor, plan: TailPlan) -> tuple:
    """Plain PyTorch version of the two-float kernel over the same plan:
    the (p, e) terms of every packed slot, each row's walk over its
    slice's slots with df_add into a fresh pair, then the row's pair
    df_added into its (y_hi, y_lo), in place."""
    v = plan.vec
    vh, vl = packed[:, 0], packed[:, 1]
    xh = torch.index_select(x_hi, 0, plan.cols)
    xl = torch.index_select(x_lo, 0, plan.cols)
    p, e = tf.two_prod(vh, xh)
    e = e + ((vh * xl) + (vl * xh))
    del xh, xl
    n_q = plan.rows.numel()
    rh = torch.zeros(n_q, dtype=packed.dtype, device=packed.device)
    rl = torch.zeros_like(rh)
    ptr = plan.ptr_host
    for m in range(plan.n_groups):
        bp = p[ptr[m]:ptr[m + 1]].view(-1, v)
        be = e[ptr[m]:ptr[m + 1]].view(-1, v)
        nm = bp.shape[0]
        for t in range(v):
            s = tf.df_add(tf.DF(rh[:nm], rl[:nm]), tf.DF(bp[:, t], be[:, t]))
            rh[:nm], rl[:nm] = s.hi, s.lo
    rows = plan.rows.long()
    real = rows >= 0
    rows, rh, rl = rows[real], rh[real], rl[real]
    s = tf.df_add(tf.DF(y_hi[rows], y_lo[rows]), tf.DF(rh, rl))
    y_hi[rows] = s.hi
    y_lo[rows] = s.lo
    return y_hi, y_lo


def tail_mv_df(packed: torch.Tensor, x_hi: torch.Tensor, x_lo: torch.Tensor,
               y_hi: torch.Tensor, y_lo: torch.Tensor,
               plan: TailPlan) -> tuple:
    """(y_hi, y_lo) += (BSR tail) (x_hi, x_lo) in two-float arithmetic, in
    place.  ``packed``: float32 [n_packed, 2], the pair (hi, lo) of the
    tail's structural values packed through the float64 plan
    (``offset_spmv.pack_df``); x's and y's words: float32 [n].  On CUDA
    tensors the kernel or an error; on CPU tensors the plain version."""
    _check_args(packed, (x_hi, x_lo), (y_hi, y_lo), plan,
                (plan.n_packed, 2), 2 * packed.element_size())
    if x_hi.dtype != torch.float32:
        raise TypeError(f"tail_mv_df takes float32 words, not "
                        f"{x_hi.dtype}")
    if x_hi.device.type == "cpu":
        return tail_mv_df_plain(packed, x_hi, x_lo, y_hi, y_lo, plan)
    with torch.cuda.device(x_hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_library().bsr_tail_packed_df(
            packed.data_ptr(), plan.cols.data_ptr(), x_hi.data_ptr(),
            x_lo.data_ptr(), y_hi.data_ptr(), y_lo.data_ptr(),
            plan.rows.data_ptr(), plan.ptr.data_ptr(), plan.n_slices,
            plan.n_groups, stream)
    offset_spmv._launch_check(err, "bsr_tail_packed_df")
    tail_mv_df.launches += 1
    return y_hi, y_lo


#: two-float kernel launches
tail_mv_df.launches = 0


def df_occupancy(plan: TailPlan) -> dict:
    """``offset_spmv.occupancy_numbers`` of the two-float tail kernel
    with the plan's shared ptr."""
    return offset_spmv.occupancy_numbers(
        load_library().bsr_tail_df_occupancy, plan.n_groups)


def reset_launches() -> None:
    tail_mv.launches = 0
    for k in tail_mv.launches_by_dtype:
        tail_mv.launches_by_dtype[k] = 0
    tail_mv_df.launches = 0
