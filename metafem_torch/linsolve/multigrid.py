"""Lattice geometric multigrid, the strong preconditioner of the port.

Port of ``metafem/linsolve/multigrid.py``.
With lattice control-point numbering the FEM tangent is a
variable-coefficient stencil, so every multigrid ingredient is dense
strided tensor work:

- **Restriction / prolongation**: separable per-axis linear
  interpolation between a lattice and its every-other-point sublattice,
  strided slices; exact adjoints of each other.
- **Galerkin coarse operators** built by probing: ``T = R A P`` is again
  a stencil of per-axis radius ``r_c``, and applying it to comb vectors
  (indicators of the points whose coordinates are congruent to a colour
  modulo ``m = 2 r_c + 1``) reads every coefficient off exactly.
- **Smoother**: damped (block-)Jacobi, the damping from a power-iteration
  estimate of rho(D^-1 A) per level.
- **Coarsest level**: the stencil made dense and inverted once per setup
  (regularized), so each V-cycle ends in one dense matvec.

Level 0 applies the assembled ``OffsetMatrix``, whose ``mv`` is the CUDA
SpMV kernel on the card; coarser levels apply their stencils with plain
tensor code (one padded copy, one strided view of the shifted windows,
one multiply and one sum).  The V-cycle is the right preconditioner of
``MGOperator``: solve (A M) y = b with a Krylov or Chebyshev solver, then
x = M y.

Random start vectors (the smoother calibration, the spectrum estimate,
the Chebyshev tune) come from a CPU ``torch.Generator`` seeded as the
reference seeds its keys, so runs on the CPU and on the card start
alike; each function also takes the start vector as an argument.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .block_offset import OffsetMatrix


# ---------------------------------------------------------------------------
# static hierarchy description
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MGHierarchy:
    """Static description of the multigrid hierarchy."""
    dim: int
    channels: int
    shapes: Tuple[Tuple[int, ...], ...]   # level 0 = fine lattice
    radius: int                           # stencil radius at levels >= 1
    offsets: Tuple[Tuple[int, ...], ...]  # all offsets within radius
    nu1: int = 2
    nu2: int = 2
    n_power: int = 10
    #: damped BLOCK-Jacobi smoothing with the per-node C x C channel
    #: blocks inverted at setup (coupled channels)
    block_smooth: bool = False

    @property
    def n_levels(self) -> int:
        return len(self.shapes)

    @property
    def m(self) -> int:                   # colors per axis for probing
        return 2 * self.radius + 1


def _coarse_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple((s + 1) // 2 for s in shape)


def decompose_offsets(flat_offsets: np.ndarray,
                      shape: Tuple[int, ...]) -> Optional[np.ndarray]:
    """Decompose flat row-major offsets d = sum_a k_a * stride_a into
    per-axis steps k (nearest decomposition).  Returns [n, dim] or None
    if any offset fails to reconstruct (|k_a| must stay < shape[a]/2)."""
    d = np.asarray(flat_offsets, dtype=np.int64).copy()
    strides = np.cumprod((1,) + shape[:0:-1])[::-1]     # row-major
    ks = np.zeros((d.size, len(shape)), dtype=np.int64)
    for a, stride in enumerate(strides):
        k = np.floor_divide(d + stride // 2, stride)    # round to nearest
        ks[:, a] = k
        d = d - k * stride
    if (d != 0).any():
        return None
    for a, s in enumerate(shape):
        if (np.abs(ks[:, a]) * 2 >= s).any():
            return None
    return ks


def build_hierarchy(lattice_shape: Tuple[int, ...], channels: int,
                    fine_radius: int, max_coarse: int = 2048,
                    max_levels: int = 16, nu1: int = 2, nu2: int = 2,
                    n_power: int = 10,
                    block_smooth: bool = False) -> MGHierarchy:
    """Coarsen by 2 per axis until the dense-solve level is small."""
    r_c = max(2, (fine_radius + 2) // 2)
    shapes = [tuple(lattice_shape)]
    while len(shapes) < max_levels:
        nxt = _coarse_shape(shapes[-1])
        if any(n < 3 for n in nxt) or nxt == shapes[-1]:
            break
        shapes.append(nxt)
        if channels * int(np.prod(nxt)) <= max_coarse:
            break
    if len(shapes) < 2:
        raise ValueError("multigrid: lattice too small to coarsen — use a "
                         "direct or Jacobi-preconditioned solve instead")
    offsets = tuple(itertools.product(range(-r_c, r_c + 1),
                                      repeat=len(lattice_shape)))
    return MGHierarchy(dim=len(lattice_shape), channels=channels,
                       shapes=tuple(shapes), radius=r_c, offsets=offsets,
                       nu1=nu1, nu2=nu2, n_power=n_power,
                       block_smooth=block_smooth)


def mask_for_domain(domain) -> Optional[torch.Tensor]:
    """Occupancy mask [n_cp] (1.0 real / 0.0 ghost) of the single lattice
    workpiece, in the domain's dtype and on its device, or None when
    every lattice slot is occupied.  Ghost slots carry a unit-diagonal
    regularizer; the transfers are masked to the occupied subspace so
    the Galerkin coarse operators do not mix the two."""
    occ = domain.workpieces[0].mesh.is_occupied
    if occ is None or occ.all():
        return None
    return torch.as_tensor(occ.astype(np.float64), dtype=domain.dtype,
                           device=domain.device)


def hierarchy_for_domain(domain, **kwargs) -> MGHierarchy:
    """Build the hierarchy from a compiled FEM_Domain (single lattice
    workpiece).  Raises with a clear message when not applicable."""
    if len(domain.workpieces) != 1:
        raise ValueError("multigrid preconditioner: single-workpiece "
                         "domains only (got %d)" % len(domain.workpieces))
    mesh = domain.workpieces[0].mesh
    if mesh.lattice_shape is None:
        raise ValueError("multigrid preconditioner requires lattice "
                         "control-point numbering (structured mesh); this "
                         "mesh did not qualify — use precond='jacobi'")
    pattern = domain.pattern
    n_cp = mesh.n_cp
    # all cp-pair offsets present in the sparsity (dense segments + tail)
    d_cp = np.unique((pattern.coo_cols.astype(np.int64) % n_cp)
                     - (pattern.coo_rows.astype(np.int64) % n_cp))
    ks = decompose_offsets(d_cp, mesh.lattice_shape)
    if ks is None:
        raise ValueError("multigrid preconditioner: sparsity offsets do "
                         "not decompose on the lattice")
    fine_radius = int(np.abs(ks).max())
    n_vars = pattern.wp_infos[0].n_vars
    assert pattern.basicfield_size == n_vars * n_cp
    return build_hierarchy(mesh.lattice_shape, n_vars, fine_radius,
                           **kwargs)


def _start_vector(seed: int, shape, dtype: torch.dtype,
                  device) -> torch.Tensor:
    """Standard-normal start vector from a CPU generator seeded ``seed``,
    moved to ``device`` (the same numbers on every device)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype).to(device)


def _as_start(v, shape, dtype, device) -> torch.Tensor:
    v = v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
    return v.to(dtype=dtype, device=device).reshape(shape)


# ---------------------------------------------------------------------------
# transfer operators (separable, strided slices; exact adjoints)
# ---------------------------------------------------------------------------

def _p_axis(c: torch.Tensor, s_fine: int) -> torch.Tensor:
    """Linear prolongation along the last axis: [..., Sc] -> [..., S].
    out[2j] = c[j]; out[2j+1] = (c[j] + c[j+1]) / 2 (c zero past its end)."""
    sc = c.shape[-1]
    n_odd = s_fine // 2
    m = min(n_odd, sc - 1)              # odd points with a right neighbour
    out = torch.empty(c.shape[:-1] + (s_fine,), dtype=c.dtype,
                      device=c.device)
    out[..., 0::2] = c[..., :(s_fine + 1) // 2]
    odd = out[..., 1::2]
    odd.copy_(c[..., :n_odd])
    odd[..., :m] += c[..., 1:m + 1]
    odd.mul_(0.5)
    return out


def _r_axis(r: torch.Tensor) -> torch.Tensor:
    """Adjoint of _p_axis along the last axis: [..., S] -> [..., Sc]."""
    s_fine = r.shape[-1]
    sc = (s_fine + 1) // 2
    odd = r[..., 1::2]                      # [..., S//2]
    n_odd = odd.shape[-1]
    t = torch.zeros(r.shape[:-1] + (sc,), dtype=r.dtype, device=r.device)
    t[..., :n_odd] = odd
    t[..., 1:] += odd[..., :sc - 1]
    t.mul_(0.5)
    return r[..., ::2] + t


def prolong(xc: torch.Tensor, fine_shape: Tuple[int, ...]) -> torch.Tensor:
    """[C, *Sc] -> [C, *S] separable per-axis linear interpolation."""
    x = xc
    for a, s in enumerate(fine_shape):
        x = torch.movedim(_p_axis(torch.movedim(x, a + 1, -1), s), -1, a + 1)
    return x


def restrict(xf: torch.Tensor) -> torch.Tensor:
    """[C, *S] -> [C, *Sc]; exact adjoint of prolong."""
    x = xf
    for a in range(x.dim() - 1):
        x = torch.movedim(_r_axis(torch.movedim(x, a + 1, -1)), -1, a + 1)
    return x


# ---------------------------------------------------------------------------
# stencil operator application (levels >= 1)
# ---------------------------------------------------------------------------

def _stencil_mv(coefs: torch.Tensor, x: torch.Tensor,
                offsets: Tuple[Tuple[int, ...], ...],
                radius: int) -> torch.Tensor:
    """y[ci, r] = sum_{o, cj} coefs[o, ci, cj, r] * x[cj, r + o].

    coefs: [n_off, C, C, *S]; x: [C, *S]; ``offsets`` are all offsets of
    the cube of ``radius`` in row-major order (build_hierarchy).  One
    zero-padded copy of x, one strided view of its (2R+1)^dim shifted
    windows [n_off, C, *S], one multiply and one sum: four launches
    instead of the reference's per-offset loop, which XLA fused."""
    C = x.shape[0]
    spatial = tuple(x.shape[1:])
    dim = len(spatial)
    w = 2 * radius + 1
    if len(offsets) != w ** dim or tuple(offsets[0]) != (-radius,) * dim:
        raise ValueError("_stencil_mv expects the full offset cube of "
                         "build_hierarchy")
    xp = torch.nn.functional.pad(x, (radius, radius) * dim)
    st = xp.stride()
    # windows[k_0..k_{dim-1}, c, s...] = xp[c, s_0 + k_0, ..., s + k]
    win = xp.as_strided((w,) * dim + (C,) + spatial,
                        st[1:] + st[:1] + st[1:])
    coefs_v = coefs.view((w,) * dim + (C, C) + spatial)
    lead = tuple(range(dim))
    if C == 1:
        return (coefs_v.select(dim, 0) * win).sum(dim=lead)
    prod = coefs_v * win.unsqueeze(dim)          # [w.., Ci, Cj, *S]
    return prod.sum(dim=lead + (dim + 1,))


def _stencil_diag(coefs: torch.Tensor, offsets, C: int) -> torch.Tensor:
    i0 = list(offsets).index(tuple([0] * (coefs.dim() - 3)))
    d0 = coefs[i0]                                          # [C, C, *S]
    return torch.stack([d0[c, c] for c in range(C)])        # [C, *S]


def _stencil_to_dense(coefs: torch.Tensor, shape: Tuple[int, ...],
                      offsets, C: int) -> torch.Tensor:
    """Materialize the coarsest stencil as a dense [N, N] matrix using
    host-precomputed indices (flat dof = c*P + lattice).  Every (row,
    col) pair occurs once, so the placement is a plain indexed write."""
    P = int(np.prod(shape))
    N = C * P
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    stride = np.cumprod((1,) + shape[:0:-1])[::-1]
    flat = np.zeros(shape, dtype=np.int64)
    for g, s in zip(grids, stride):
        flat = flat + g * s
    rows_l, cols_l, src_l = [], [], []
    n_off = len(offsets)
    for i, off in enumerate(offsets):
        ok = np.ones(shape, dtype=bool)
        for a, o in enumerate(off):
            idx = grids[a] + o
            ok &= (idx >= 0) & (idx < shape[a])
        r = flat[ok]
        c = r + sum(o * s for o, s in zip(off, stride))
        for ci in range(C):
            for cj in range(C):
                rows_l.append(ci * P + r)
                cols_l.append(cj * P + c)
                # flat index into coefs [n_off, C, C, P]
                src_l.append(((i * C + ci) * C + cj) * P + r)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    src = np.concatenate(src_l)
    assert n_off * C * C * P == coefs.numel()
    dev = coefs.device
    dense = torch.zeros(N * N, dtype=coefs.dtype, device=dev)
    dense[torch.as_tensor(rows * N + cols, device=dev)] = \
        coefs.reshape(-1)[torch.as_tensor(src, device=dev)]
    return dense.view(N, N)


# ---------------------------------------------------------------------------
# setup: probing + smoother calibration + coarsest inverse
# ---------------------------------------------------------------------------

def _apply_level(hier: MGHierarchy, state, level: int,
                 x: torch.Tensor) -> torch.Tensor:
    """Apply the level operator to x [C, *S_level] (at a row-sharded fine
    level, x [C, w] the window's rows: the product gathers x and runs
    the window's rows of A)."""
    if level == 0 and "A" in state[0]:
        A: OffsetMatrix = state[0]["A"]
        rows = state[0].get("rows")
        if rows is not None:
            return A.mv(rows.gather(x.reshape(-1))).view(x.shape)
        return A.mv(x.reshape(-1)).view(x.shape)
    return _stencil_mv(state[level]["coefs"], x, hier.offsets, hier.radius)


def _color_index(shape: Tuple[int, ...], off: Tuple[int, ...], m: int,
                 device) -> torch.Tensor:
    """Color id of (r + off) mod m at each point r, int64 [*shape]."""
    idx = torch.zeros(shape, dtype=torch.int64, device=device)
    for a, o in enumerate(off):
        g = torch.arange(shape[a], dtype=torch.int64, device=device)
        g = g.view((1,) * a + (-1,) + (1,) * (len(shape) - a - 1))
        idx = idx * m + torch.remainder(g + o, m)
    return idx


def _masked_prolong(hier, state, level, xc):
    """P' v = M_level P v: prolong to ``level``, zero ghost slots (at a
    row-sharded fine level, the window's rows of the whole
    prolongation)."""
    x = prolong(xc, hier.shapes[level])
    rows = state[level].get("rows")
    if rows is not None:
        x = rows.lattice_local(x, 1)
    mask = state[level].get("mask")
    return x if mask is None else x * mask


def _masked_restrict(hier, state, level, xf):
    """R' r = P'^T r = restrict(M_level r) (exact adjoint of above; at a
    row-sharded fine level the masked window is gathered first, so the
    coarse levels run whole on every rank)."""
    mask = state[level].get("mask")
    xf = xf if mask is None else xf * mask
    rows = state[level].get("rows")
    if rows is not None:
        xf = rows.gather(xf.reshape(-1)).view(
            (hier.channels,) + hier.shapes[level])
    return restrict(xf)


def _probe_level(hier: MGHierarchy, state, level: int,
                 dtype: torch.dtype, device) -> torch.Tensor:
    """Galerkin coarse stencil for ``level+1`` by probing R A_level P.

    One probe per (channel, colour), applied one after another: each
    materializes a few fine-lattice temporaries, which bounds the memory
    as the reference's batch cap (batch * n_off * fine <= ~1e8 values)
    does for its batched map."""
    C, m = hier.channels, hier.m
    s_coarse = hier.shapes[level + 1]
    n_colors = m ** hier.dim
    cid = _color_index(s_coarse, (0,) * hier.dim, m, device)   # [*Sc]
    t_all = torch.empty((C, n_colors, C) + s_coarse, dtype=dtype,
                        device=device)                # [Cj, ncol, Ci, *Sc]
    for cj in range(C):
        for k in range(n_colors):
            v = torch.zeros((C,) + s_coarse, dtype=dtype, device=device)
            v[cj] = (cid == k).to(dtype)
            t_all[cj, k] = _masked_restrict(
                hier, state, level,
                _apply_level(hier, state, level,
                             _masked_prolong(hier, state, level, v)))
    Pc = int(np.prod(s_coarse))
    t_flat = t_all.view(C, n_colors, C, Pc)
    coef_list = []
    for off in hier.offsets:
        cidx = _color_index(s_coarse, off, m, device).reshape(1, 1, 1, Pc)
        sel = torch.gather(t_flat, 1, cidx.expand(C, 1, C, Pc))[:, 0]
        coef_list.append(sel.transpose(0, 1))          # [Ci, Cj, Pc]
    return torch.stack(coef_list).reshape(
        (len(hier.offsets), C, C) + s_coarse)


def _calibrate(hier, state, level, dtype, device, v0=None):
    """Power-iteration estimate of rho(D^-1 A); damped-Jacobi omega as a
    0-d tensor (nothing is read back).  At a row-sharded level the start
    vector is drawn and normalised whole, then cut to the window, and
    each norm is the whole vector's (``RowWindow.norm``)."""
    shape = (hier.channels,) + hier.shapes[level]
    v = (_start_vector(3 + level, shape, dtype, device) if v0 is None
         else _as_start(v0, shape, dtype, device))
    v = v / torch.linalg.norm(v)
    rows = state[level].get("rows")
    norm = torch.linalg.norm
    if rows is not None:
        v, norm = rows.lattice_local(v, 1), rows.norm
    lam = None
    for _ in range(hier.n_power):
        w = _diag_solve(state[level], _apply_level(hier, state, level, v))
        lam = norm(w)
        v = w / torch.where(lam == 0, torch.ones_like(lam), lam)
    lam = lam * 1.1                        # safety headroom
    return (4.0 / 3.0) / torch.where(lam == 0, torch.ones_like(lam), lam)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(d)
    return torch.where(d == 0, torch.zeros_like(d),
                       1.0 / torch.where(d == 0, one, d))


def _floored_inv(d: torch.Tensor) -> torch.Tensor:
    """Jacobi inverse with a relative magnitude floor: entries below
    1e-6x the median nonzero magnitude are clamped (sign kept).  Exact
    zeros stay zero.  The median is numpy's (mean of the middle two)."""
    a = torch.abs(d)
    nz = a[a != 0]
    med = (torch.quantile(nz, 0.5) if nz.numel()
           else torch.ones((), dtype=d.dtype, device=d.device))
    floor = 1e-6 * med
    sgn = torch.where(d < 0, -torch.ones_like(d), torch.ones_like(d))
    df = torch.where((a > 0) & (a < floor), sgn * floor, d)
    return _safe_inv(df)


def _fine_diag_blocks(A: OffsetMatrix, C: int,
                      shape: Tuple[int, ...]) -> torch.Tensor:
    """Same-node channel-coupling blocks [C, C, *S] of the fine operator,
    read from the d=0 dense segments (absent pairs are zero); over a row
    window ``shape`` is the window's (its c1 - c0 points)."""
    grp = A.layout.pallas_groups[0]
    c0, c1 = A.window.cps[0]
    slab = A.vals[A.window.group_range(0)].view(len(grp.units), grp.n_off,
                                                c1 - c0)
    k0 = grp.offsets.index(0)
    blocks = [[None] * C for _ in range(C)]
    for g, (pd, pb) in enumerate(grp.units):
        blocks[pd][pb] = slab[g, k0]
    z = torch.zeros(c1 - c0, dtype=A.vals.dtype, device=A.vals.device)
    M = torch.stack([torch.stack([blocks[i][j] if blocks[i][j] is not None
                                  else z for j in range(C)])
                     for i in range(C)])
    return M.reshape((C, C) + tuple(shape))


def _inv_blocks(M: torch.Tensor, C: int) -> torch.Tensor:
    """Per-node inverse of [C, C, *S] blocks (all-zero diagonal entries
    are set to 1 first)."""
    S = M.shape[2:]
    P = int(np.prod(S))
    Mp = torch.movedim(M.reshape(C, C, P), -1, 0)         # [P, C, C]
    dg = torch.diagonal(Mp, dim1=1, dim2=2)               # [P, C]
    fix = (dg == 0).to(M.dtype)
    eye = torch.eye(C, dtype=M.dtype, device=M.device)
    Mp = Mp + fix[:, :, None] * eye[None]
    inv = torch.linalg.inv(Mp)
    return torch.movedim(inv, 0, -1).reshape((C, C) + tuple(S))


def _diag_solve(state_level: dict, v: torch.Tensor) -> torch.Tensor:
    """Apply the smoother's D^-1: channel-block inverse when built,
    pointwise inverse diagonal otherwise."""
    blk = state_level.get("inv_diag_blk")
    if blk is not None:
        return (blk * v.unsqueeze(0)).sum(dim=1)
    return state_level["inv_diag"] * v


def mg_setup(hier: MGHierarchy, A: OffsetMatrix,
             mask: Optional[torch.Tensor] = None,
             starts: Optional[Sequence] = None) -> tuple:
    """Build the V-cycle state (a tuple of per-level dicts) from the
    assembled fine operator.

    ``mask``: flat [n_cp] occupancy (1.0 real / 0.0 ghost) or None; see
    mask_for_domain.  ``starts``: optional start vectors of the smoother
    calibration, one per level 0..n_levels-2 (default: seeded 3+level).

    ``A`` a row-sharded operator (``parallel.rowshard.RowShardedOp``):
    the fine level holds the rank's window, as ``local_mg_state`` cuts a
    whole setup (the window's matrix and the window under "rows"; mask,
    smoother diagonal and channel blocks [.., c1 - c0]); the coarse
    levels are probed through the gathered restriction and computed
    whole on every rank from the same bits."""
    rows = getattr(A, "row_window", None)
    if rows is not None:
        A = A.inner
    dtype, device = A.vals.dtype, A.vals.device
    C = hier.channels
    state: List[dict] = [{"A": A}]
    fine = hier.shapes[0]
    if rows is not None:
        state[0]["rows"] = rows
        c0, c1 = rows.mine.cps[0]
        fine = (c1 - c0,)
    if mask is not None:
        m = mask.reshape((1,) + hier.shapes[0]).to(dtype)
        state[0]["mask"] = m if rows is None else rows.lattice_local(m, 1)
    d0 = A.diag().reshape((C,) + fine)
    state[0]["inv_diag"] = _safe_inv(d0)
    if hier.block_smooth and C > 1:
        state[0]["inv_diag_blk"] = _inv_blocks(
            _fine_diag_blocks(A, C, fine), C)
    state[0]["omega"] = _calibrate(hier, state, 0, dtype, device,
                                   None if starts is None else starts[0])
    return _setup_coarser_levels(hier, state, dtype, device, starts)


def mg_setup_from_stencil(hier: MGHierarchy, coefs0: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          starts: Optional[Sequence] = None) -> tuple:
    """Build the V-cycle state when the FINEST level is already a lattice
    stencil (``coefs0`` [n_off, C, C, *shapes[0]]) rather than an
    assembled OffsetMatrix: the auxiliary-space path (auxmg.py) seeds
    the hierarchy with the host Galerkin operator of its lattice.  The
    state lives on coefs0's device in its dtype; ``mask`` and ``starts``
    as for mg_setup."""
    dtype, device = coefs0.dtype, coefs0.device
    C = hier.channels
    state: List[dict] = [{"coefs": coefs0}]
    if mask is not None:
        state[0]["mask"] = mask.reshape((1,) + hier.shapes[0]).to(dtype)
    state[0]["inv_diag"] = _floored_inv(
        _stencil_diag(coefs0, hier.offsets, C))
    if hier.block_smooth and C > 1:
        i0 = list(hier.offsets).index((0,) * hier.dim)
        state[0]["inv_diag_blk"] = _inv_blocks(coefs0[i0], C)
    state[0]["omega"] = _calibrate(hier, state, 0, dtype, device,
                                   None if starts is None else starts[0])
    return _setup_coarser_levels(hier, state, dtype, device, starts)


def _setup_coarser_levels(hier: MGHierarchy, state: List[dict],
                          dtype, device, starts=None) -> tuple:
    """Probe levels 1.. from an initialized level-0 entry and invert the
    coarsest level."""
    C = hier.channels
    i0 = list(hier.offsets).index((0,) * hier.dim)
    for level in range(1, hier.n_levels):
        coefs = _probe_level(hier, state, level - 1, dtype, device)
        entry = {"coefs": coefs,
                 "inv_diag": _floored_inv(
                     _stencil_diag(coefs, hier.offsets, C))}
        if hier.block_smooth and C > 1:
            entry["inv_diag_blk"] = _inv_blocks(coefs[i0], C)
        state.append(entry)
        if level < hier.n_levels - 1:
            entry["omega"] = _calibrate(
                hier, state, level, dtype, device,
                None if starts is None else starts[level])

    # coarsest: dense inverse (all-zero rows regularized to identity),
    # equilibrated by sqrt|diag| and shifted by 1e-6 toward the dominant
    # diagonal sign, which caps ||inv|| where the Galerkin operator has
    # near-null rows (the reference's regularized inverse, step for step)
    last = hier.n_levels - 1
    dense = _stencil_to_dense(state[last]["coefs"], hier.shapes[last],
                              hier.offsets, C)
    diag = torch.diagonal(dense)
    dense = dense + torch.diag((diag == 0).to(dtype))
    s = _safe_inv(torch.sqrt(torch.abs(torch.diagonal(dense))))
    s = torch.where(s == 0, torch.ones_like(s), s)
    B = s[:, None] * dense * s[None, :]
    sgn = torch.sign(torch.sum(torch.sign(torch.diagonal(B))))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn).to(dtype)
    B = B + (1e-6 * sgn) * torch.eye(B.shape[0], dtype=dtype, device=device)
    state[last]["inv"] = s[:, None] * torch.linalg.inv(B) * s[None, :]
    return tuple(state)


# ---------------------------------------------------------------------------
# the V-cycle
# ---------------------------------------------------------------------------

def _smooth(hier, state, level, x, b, n):
    om = state[level]["omega"]
    for _ in range(n):
        x = x + om * _diag_solve(
            state[level], b - _apply_level(hier, state, level, x))
    return x


def _vcycle_level(hier, state, level, b):
    if level == hier.n_levels - 1:
        x = torch.mv(state[level]["inv"], b.reshape(-1))
        return x.view(b.shape)
    om = state[level]["omega"]
    x = om * _diag_solve(state[level], b)
    x = _smooth(hier, state, level, x, b, hier.nu1 - 1)
    r = b - _apply_level(hier, state, level, x)
    xc = _vcycle_level(hier, state, level + 1,
                       _masked_restrict(hier, state, level, r))
    x = x + _masked_prolong(hier, state, level, xc)
    return _smooth(hier, state, level, x, b, hier.nu2)


def vcycle(hier: MGHierarchy, state: tuple, b: torch.Tensor) -> torch.Tensor:
    """One V(nu1, nu2) cycle on the flat residual vector: M b ~= A^-1 b.
    With a row-sharded state (``parallel.rowshard.shard_mg_state``) b and
    the result are the window's rows."""
    if state[0].get("rows") is not None:
        shape = (hier.channels, -1)
    else:
        shape = (hier.channels,) + hier.shapes[0]
    return _vcycle_level(hier, state, 0, b.reshape(shape)).reshape(-1)


# ---------------------------------------------------------------------------
# Krylov integration: right-preconditioned operator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MGOperator:
    """A ∘ M as a matrix-like operator for the Krylov menu: solve
    (A M) y = b with any krylov solver, then x = M y (vcycle)."""
    A: OffsetMatrix
    state: tuple
    hier: MGHierarchy

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        rows = self.state[0].get("rows")
        if rows is not None:
            # row-sharded: the window's rows of A on the gathered M v
            return self.A.mv(rows.gather(vcycle(self.hier, self.state, v)))
        return self.A.mv(vcycle(self.hier, self.state, v))

    def apply_m(self, y: torch.Tensor) -> torch.Tensor:
        return vcycle(self.hier, self.state, y)


def estimate_spectrum(op, n_dof: int, dtype, n_iter: int = 24,
                      seed: int = 11, v0=None, device=None) -> tuple:
    """(lam_min, lam_max) estimate for the MG-preconditioned operator A·M
    by two power iterations: lam_max directly, lam_min through the
    shifted operator s·I - A·M (s slightly above lam_max).  Both start
    from ``v0`` (default: normal numbers seeded ``seed``).  One readback
    per power iteration run."""
    device = op.A.vals.device if device is None else device
    start = (_start_vector(seed, (n_dof,), dtype, device) if v0 is None
             else _as_start(v0, (n_dof,), dtype, device))

    def power(alpha, beta):
        v = start / torch.linalg.norm(start)
        lam = torch.zeros((), dtype=dtype, device=device)
        for _ in range(n_iter):
            u = alpha * v + beta * op.mv(v)
            lam = torch.linalg.norm(u)
            v = u / torch.where(lam == 0, torch.ones_like(lam), lam)
        return float(lam)

    lam_max = power(0.0, 1.0)
    s = 1.05 * lam_max
    f = np.float32 if dtype == torch.float32 else np.float64
    lam_min = s - power(float(f(s)), -1.0)
    return lam_min, lam_max


def tune_chebyshev(op, n_dof: int, dtype, spectrum, n_iter: int = 16,
                   seed: int = 5, b0=None, device=None):
    """(interval, measured_rate) for Chebyshev inner solves on A·M, or
    None when no candidate contracts well enough.

    Power-iteration edge estimates are optimistic when the
    preconditioned modes cluster, so a few lower-edge candidates are
    scanned and each trial solve's ACTUAL reduction over ``n_iter``
    iterations is measured; the best is kept.  The trial right-hand side
    is ``b0`` (default: normal numbers seeded ``seed``)."""
    from .krylov import chebyshev_init, chebyshev_steps
    lo0, hi0 = spectrum
    if not (np.isfinite(lo0) and np.isfinite(hi0) and lo0 > 0
            and hi0 > 0):
        return None
    device = op.A.vals.device if device is None else device
    b = (_start_vector(seed, (n_dof,), dtype, device) if b0 is None
         else _as_start(b0, (n_dof,), dtype, device))
    nb = float(torch.linalg.norm(b))
    f = np.float32 if dtype == torch.float32 else np.float64
    hi_m = 1.05 * hi0

    def measure(interval):
        # the interval in the working precision, as the reference's
        # traced arguments are
        iv = (float(f(interval[0])), float(f(interval[1])))
        carry = chebyshev_init(op, b, interval=iv)
        carry = chebyshev_steps(op, carry, n_iter, iv)
        red = float(torch.linalg.norm(carry[1])) / nb
        if not np.isfinite(red) or red <= 0:
            return None
        return float(min(red, 1.0) ** (1.0 / n_iter))

    best = None
    for fac in (1.0, 0.4, 0.15, 0.05):
        lo_m = 0.9 * lo0 * fac
        if lo_m <= 1e-3 * hi_m:
            continue
        rate = measure((lo_m, hi_m))
        if rate is not None and (best is None or rate < best[1]):
            best = ((lo_m, hi_m), rate)
    if best is None or best[1] > 0.93:
        return None
    return best
