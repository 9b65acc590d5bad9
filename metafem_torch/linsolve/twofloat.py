"""Two-float ("double-f32") vector arithmetic: each value is an (hi, lo)
pair of float32 words carrying ~48 significant bits.

Port of ``metafem/linsolve/twofloat.py``.  The reference exists for the
TPU, whose float64 is emulated in software; there the refined Newton
step carries x, the frozen affine operator A_td and the constant b as
two-float pairs (``make_refined_step(residual_mode="df32")``).  The card
computes float64 natively, so in the port the two-float mode is opt-in
parity with the reference's production mode, not a speed path.

The classic error-free transforms (Knuth's two_sum, Dekker's
fast_two_sum and two_prod) build every operation from float32 adds and
multiplies, each rounded on its own.  **FMA contraction breaks them**: a
fused ``s + a*b`` skips the rounding of the product that the transform
relies on (the reference measured XLA:CPU's fusions degrading df_dot2 to
float32 accuracy).  Here every step of a transform is its own eager
PyTorch op, which rounds its result to float32 before the next op reads
it, on the CPU and on CUDA.  Do not rewrite them with
``torch.add(..., alpha=...)``, ``addcmul``, ``lerp``, ``einsum`` or
``matmul`` on DF words, and do not pass them through ``torch.compile``:
each of those may fuse a product into a sum.  The CUDA kernel of the
two-float SpMV (``csrc/offset_spmv.cu``) writes the same transforms
with ``__fadd_rn``/``__fmul_rn``, which nvcc never contracts.

``df_offset_mv`` runs each dense group through
``offset_spmv.group_mv_df`` and a BSR tail (unstructured meshes) through
``bsr_tail.tail_mv_df``: the hand-written kernels on a CUDA tensor,
their plain versions on a CPU tensor.  The CUDA kernel of the two-float
tail (``csrc/bsr_tail.cu``) follows the same rules.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import device_constant

#: Veltkamp's split constant for the 24-bit float32 mantissa (2^12 + 1)
_SPLIT = 4097.0


class DF(NamedTuple):
    """A two-float vector: value = hi + lo, |lo| <= ulp(hi)/2."""
    hi: torch.Tensor
    lo: torch.Tensor


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free a + b = s + e; requires |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Error-free a * b = p + e by Dekker's splitting (2^12 + 1 splits the
    24-bit float32 mantissa).  Each product is its own op, so it is
    rounded to float32 before the next subtraction reads it."""
    p = a * b
    ca = a * _SPLIT
    cb = b * _SPLIT
    ah = ca - (ca - a)
    bh = cb - (cb - b)
    al = a - ah
    bl = b - bh
    e = (((ah * bh) - p) + (ah * bl)) + (al * bh)
    e = e + al * bl
    return p, e


def df_normalize(hi, lo) -> DF:
    s, e = fast_two_sum(hi, lo)
    return DF(s, e)


def df_from_f64(a, device=None) -> DF:
    """Split a float64 tensor (or array) into an f32 pair, exact to
    ~2^-48 relative, on the tensor's own device (``device`` for an
    array)."""
    a = torch.as_tensor(a, dtype=torch.float64, device=device)
    hi = a.to(torch.float32)
    return DF(hi, (a - hi.to(torch.float64)).to(torch.float32))


def df_to_f64(x: DF) -> torch.Tensor:
    return x.hi.to(torch.float64) + x.lo.to(torch.float64)


def df_zeros_like(v: torch.Tensor) -> DF:
    return DF(torch.zeros_like(v), torch.zeros_like(v))


def df_add(x: DF, y: DF) -> DF:
    s, e = two_sum(x.hi, y.hi)
    return df_normalize(s, e + (x.lo + y.lo))


def df_add_f32(x: DF, v) -> DF:
    s, e = two_sum(x.hi, v)
    return df_normalize(s, e + x.lo)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def _f32(c, like: torch.Tensor):
    """A plain-number factor as a float32 tensor on ``like``'s device (the
    reference's weak typing rounds it to float32 the same way)."""
    if torch.is_tensor(c):
        return c
    return device_constant(float(np.float32(c)), torch.float32, like.device)


def df_scale(x: DF, c) -> DF:
    """x * c with c a float32 scalar or tensor (a number is rounded to
    float32 first)."""
    c = _f32(c, x.hi)
    p, e = two_prod(x.hi, c)
    return df_normalize(p, e + x.lo * c)


def df_scale_df(x: DF, c: DF) -> DF:
    p, e = two_prod(x.hi, c.hi)
    return df_normalize(p, e + ((x.hi * c.lo) + (x.lo * c.hi)))


def df_const(c, device="cpu") -> DF:
    """Exact DF split of a host scalar, as 0-d float32 tensors on
    ``device`` (copied there once per value, ``config.device_constant``)."""
    c = np.float64(c)
    hi = np.float32(c)
    lo = np.float32(c - np.float64(hi))
    return DF(device_constant(float(hi), torch.float32, device),
              device_constant(float(lo), torch.float32, device))


def as_df(v, device="cpu") -> DF:
    """A number, an f32 or f64 tensor, or a DF as a DF (a number's words
    on ``device``)."""
    if isinstance(v, DF):
        return v
    if isinstance(v, (int, float)):
        return df_const(v, device)
    if v.dtype == torch.float64:
        return df_from_f64(v)
    v = v.to(torch.float32)
    return DF(v, torch.zeros_like(v))


def df_mul(x: DF, y: DF) -> DF:
    return df_scale_df(x, y)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_div(x: DF, y: DF) -> DF:
    """Long division: a quotient digit and two compensated remainder
    digits, ~2^-47 relative error."""
    q0 = x.hi / y.hi
    r = df_add(x, df_neg(df_scale(y, q0)))
    q1 = r.hi / y.hi
    r2 = df_add(r, df_neg(df_scale(y, q1)))
    q2 = r2.hi / y.hi
    s, e = two_sum(q0, q1)
    return df_normalize(s, e + q2)


def df_dot2(pairs) -> DF:
    """Compensated sum of elementwise DF*DF products (Ogita-Rump-Oishi dot2
    over a static list): error-free hi products, two_sum-compensated hi
    accumulation, and the O(eps) terms (product errors, cross terms)
    summed in plain float32; error ~2^-48 |sum|.  ``pairs``: iterable of
    (DF, DF) with broadcast-compatible words."""
    s = c = None
    for a, b in pairs:
        p, e = two_prod(a.hi, b.hi)
        e = e + ((a.hi * b.lo) + (a.lo * b.hi))
        if s is None:
            s, c = p, e
        else:
            s, e2 = two_sum(s, p)
            c = c + (e + e2)
    return df_normalize(s, c)


def df_pack(vals: DF, layout, window=None) -> list:
    """Per dense group of ``layout``, the structural values of the pair
    ``vals`` packed as (hi, lo) slots (``offset_spmv.pack_df``) over the
    group's float64 pack plan, and last, where the layout has a BSR
    tail, the tail's pair packed over its float64 tail plan: gathered
    once per matrix, then passed to every ``df_offset_mv`` of it.
    ``window``: a rank's rows (``block_offset.WindowLayout``; None: the
    whole matrix), ``vals`` then its storage and the plans the
    window's."""
    from . import offset_spmv
    from .block_offset import OffsetMatrix
    A = OffsetMatrix.from_values(vals.hi, layout, window)
    w = A.window
    out = [offset_spmv.pack_df(vals.hi[w.group_range(i)],
                               vals.lo[w.group_range(i)], plan)
           for i, plan in enumerate(A.pack_plans(vec=offset_spmv.DF_VEC))]
    if layout.blk_b:
        out.append(offset_spmv.pack_df(
            vals.hi[w.n_dense:], vals.lo[w.n_dense:],
            A.tail_plan(vec=offset_spmv.DF_VEC)))
    return out


def df_offset_mv(vals: DF, layout, x: DF,
                 packed: Optional[list] = None, window=None) -> DF:
    """y = A @ x with the matrix values and the vector as DF pairs, the
    refined residual's product: each dense group through
    ``offset_spmv.group_mv_df`` (per-unit compensated sums over the
    offsets, in the reference's order), a BSR tail through
    ``bsr_tail.tail_mv_df`` (per row a compensated sum over its packed
    entries, df_added into y), the scalar COO tail as one float64 sorted
    segment sum over the layout's device tables, split back and
    df_added.  ``packed``: the pair's ``df_pack`` (packed here when
    None).  ``window``: a rank's rows (``block_offset.WindowLayout``):
    ``vals`` is its storage, x stays whole and y is the window's rows."""
    from . import bsr_tail, offset_spmv
    from .block_offset import OffsetMatrix, sorted_segment_sum
    A = OffsetMatrix.from_values(vals.hi, layout, window)
    w = A.window
    plans = A.pack_plans(vec=offset_spmv.DF_VEC)
    if packed is None:
        packed = df_pack(vals, layout, window)
    covered = sum(g.n_vars * g.n_cp for g in layout.pallas_groups)
    new = torch.empty if covered == layout.n else torch.zeros
    y_hi = new(layout.n, dtype=torch.float32, device=x.hi.device)
    y_lo = new(layout.n, dtype=torch.float32, device=x.hi.device)
    for grp, plan, pk in zip(layout.pallas_groups, plans, packed):
        sl = slice(grp.dof_offset, grp.dof_offset + grp.n_vars * grp.n_cp)
        shape = (grp.n_vars, grp.n_cp)
        offset_spmv.group_mv_df(pk, x.hi[sl].view(shape),
                                x.lo[sl].view(shape), plan,
                                out_hi=y_hi[sl].view(shape),
                                out_lo=y_lo[sl].view(shape))
    y = DF(y_hi, y_lo)
    if layout.blk_b:
        bsr_tail.tail_mv_df(packed[-1], x.hi, x.lo, y_hi, y_lo,
                            A.tail_plan(vec=offset_spmv.DF_VEC))
    elif layout.n_coo:
        # the (small) COO tail in float64; lattice meshes have none
        f64 = torch.float64
        t = w.tables(vals.hi.device)
        n0, cols, plan = w.n_dense, t["tail_cols"], t["tail_plan"]
        cv = vals.hi[n0:].to(f64) + vals.lo[n0:].to(f64)
        xv = x.hi[cols].to(f64) + x.lo[cols].to(f64)
        t64 = sorted_segment_sum(cv * xv, plan, layout.n)
        y = df_add(y, df_from_f64(t64))
    if not w.whole:
        y = DF(w.local(y.hi), w.local(y.lo))
    return y
