"""Auxiliary-space multigrid preconditioner for unstructured meshes.

Port of ``metafem/linsolve/auxmg.py``.  The lattice multigrid
(multigrid.py) needs a lattice control-point numbering, which graded tet
meshes never have.  Auxiliary-space preconditioning (Xu 1996) keeps the
true unstructured operator A for the fine-level smoothing and routes the
coarse-grid correction through a uniform auxiliary lattice that need
not resolve the fine mesh:

    M = smoother(A)  +  P · MG_lattice(Pᵀ A P) · Pᵀ

* P is nodewise multilinear interpolation from the 2^d corners of each
  node's auxiliary cell: one row gather of a shift-stacked lattice table
  (``_p``); Pᵀ is a sorted segment sum of [n_cp, 2^d] rows over the
  node cells followed by 2^d static lattice shifts (``_pt``).  The
  segment sum runs over a plan built once at setup
  (``block_offset.sorted_segment_plan``), in a fixed order with no
  atomics, so a V-cycle repeats bitwise on the card.
* The Galerkin operator Pᵀ A P is assembled once on the host (scipy)
  and lands in the lattice-stencil form the lattice hierarchy consumes
  (``multigrid.mg_setup_from_stencil``, run on the CPU in float64);
  only the finished V-cycle state moves to the domain's device, in its
  dtype.
* Aux cells never touched by a node are ghost slots: a typical-magnitude
  diagonal of the operator's sign and masked transfers.

``smooth="sparse"`` smooths against a sparsified operator (the dense
offset groups, the BSR tail's block diagonal and the dropped tail
couplings lumped onto the diagonal), so only the outer product A·M
touches the tail.  The fine operator's products (``OffsetMatrix.mv``)
run the packed SpMV and BSR-tail kernels on the card.

Random start vectors (the damped-Jacobi calibration, the spectrum
estimate, the Chebyshev tune, the lattice calibrations) come from CPU
``torch.Generator``s seeded as the reference seeds its keys; ``setup``
also takes them as arguments (``starts``), so a test can hand both
packages the same numbers.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import bsr_tail, multigrid
from .block_offset import (OffsetMatrix, sorted_segment_plan,
                           sorted_segment_sum)
from .multigrid import MGHierarchy, _safe_inv


@dataclasses.dataclass(frozen=True)
class AuxDesc:
    """Static description of the aux-space transfer."""
    dim: int
    channels: int
    n_cp: int
    n_lat: int
    aux_shape: Tuple[int, ...]
    corner_offs: Tuple[int, ...]        # 2^d flat lattice offsets (>= 0)
    nu1: int = 2
    nu2: int = 2
    #: "full": smoothing residuals on the true operator (every V-cycle
    #: pays nu1+nu2+1 tail SpMVs).  "sparse": smoothing and the
    #: coarse-grid residual run on a sparsified operator (dense offset
    #: groups + the BSR tail's block diagonal, the dropped tail couplings
    #: lumped onto the diagonal, so the row sums stay exact); only the
    #: outer A·M product touches the tail.  The sparsified pieces are
    #: refreshed per tangent by refresh_tangent().
    smooth: str = "full"


def estimate_spacing(coords: np.ndarray, el_cp: np.ndarray,
                     sample: int = 20000, seed: int = 0,
                     diam_q: float = 0.99) -> Tuple[float, float]:
    """(median min intra-element cp distance, ``diam_q``-quantile of the
    element diameter) over (sampled) elements: the natural fine
    resolution of the mesh and the span of its largest elements."""
    n_el = len(el_cp)
    if n_el > sample:
        idx = np.random.default_rng(seed).choice(n_el, sample,
                                                 replace=False)
        el_cp = el_cp[idx]
    p = coords[el_cp]                                   # [e, a, dim]
    d = np.linalg.norm(p[:, :, None, :] - p[:, None, :, :], axis=-1)
    iu = np.triu_indices(el_cp.shape[1], 1)
    pair_d = d[:, iu[0], iu[1]]
    return (float(np.median(pair_d.min(axis=1))),
            float(np.quantile(pair_d.max(axis=1), diam_q)))


def build_transfer(coords: np.ndarray, h: float, wclamp: float = 0.1):
    """Cell ids + multilinear corner weights of each node on a uniform
    lattice of spacing ``h`` covering the point cloud (1-cell margin so
    corner ids never leave the lattice).  Corner weights below
    ``wclamp`` are dropped and the rest renormalized (the partition of
    unity stays; aux points touched only through weak interpolation
    tails would give near-null Galerkin rows).

    Returns (cell_flat [n], weights [n, 2^d], aux_shape, corner_offs)."""
    n, dim = coords.shape
    lo = coords.min(axis=0) - 1.5 * h
    rel = (coords - lo) / h
    cell = np.floor(rel).astype(np.int64)
    frac = rel - cell
    shape = tuple(int(s) for s in (cell.max(axis=0) + 2))
    strides = np.cumprod((1,) + shape[:0:-1])[::-1].astype(np.int64)
    cell_flat = cell @ strides
    corners = list(itertools.product((0, 1), repeat=dim))
    corner_offs = tuple(int(np.dot(c, strides)) for c in corners)
    w = np.ones((n, len(corners)))
    for j, c in enumerate(corners):
        for a, bit in enumerate(c):
            w[:, j] *= frac[:, a] if bit else (1.0 - frac[:, a])
    w[w < wclamp] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    return cell_flat, w, shape, corner_offs


def galerkin_stencil(A_scipy, cell_flat: np.ndarray, w: np.ndarray,
                     aux_shape: Tuple[int, ...], channels: int,
                     radius: int, dtype=torch.float64, lump: bool = True):
    """Host Galerkin Pᵀ A P on the aux lattice, in the stencil form
    [n_off, C, C, *aux_shape] the lattice hierarchy consumes, plus the
    occupancy mask [n_lat] and the dropped-entry fraction; the two
    arrays as CPU tensors in ``dtype``.

    Entries whose per-axis lattice displacement exceeds ``radius``
    (couplings through elements much larger than the aux spacing) are,
    with ``lump`` (default), folded onto the row diagonal, which keeps
    the row sums and with them the action on the low-frequency modes the
    coarse correction exists for (plain dropping makes the
    preconditioned operator indefinite once the dropped share is not
    negligible)."""
    import scipy.sparse as sp

    n_lat = int(np.prod(aux_shape))
    dim = len(aux_shape)
    n_cp = len(cell_flat)
    rows = np.repeat(np.arange(n_cp, dtype=np.int64), w.shape[1])
    strides = np.cumprod((1,) + aux_shape[:0:-1])[::-1].astype(np.int64)
    corners = list(itertools.product((0, 1), repeat=dim))
    corner_offs = np.asarray([np.dot(c, strides) for c in corners])
    cols = (cell_flat[:, None] + corner_offs[None, :]).reshape(-1)
    P1 = sp.coo_matrix((w.reshape(-1), (rows, cols)),
                       shape=(n_cp, n_lat)).tocsr()
    P = sp.kron(sp.eye(channels, format="csr"), P1, format="csr")
    Ac = (P.T @ A_scipy.tocsr() @ P).tocoo()

    ci, cj = Ac.row // n_lat, Ac.col // n_lat
    li, lj = Ac.row % n_lat, Ac.col % n_lat
    # per-axis lattice displacements by integer arithmetic on the flat ids
    n_off = (2 * radius + 1) ** dim
    oi = np.zeros(li.shape, np.int64)        # flat offset index
    keep = np.ones(li.shape, bool)
    ldiv_i, ldiv_j = li, lj
    k_rev = []
    for s in reversed(aux_shape):
        k_rev.append(ldiv_j % s - ldiv_i % s)
        ldiv_i, ldiv_j = ldiv_i // s, ldiv_j // s
    for ka in reversed(k_rev):               # axis 0 first (slowest)
        keep &= np.abs(ka) <= radius
        oi = oi * (2 * radius + 1) + np.clip(ka + radius, 0, 2 * radius)
    dropped = 1.0 - (np.abs(Ac.data[keep]).sum()
                     / max(np.abs(Ac.data).sum(), 1e-300))

    offsets = list(itertools.product(range(-radius, radius + 1),
                                     repeat=dim))
    assert len(offsets) == n_off
    # scatter-add through bincount on the composite flat index
    lin = (((oi[keep] * channels + ci[keep]) * channels + cj[keep])
           * n_lat + li[keep])
    weights = Ac.data[keep]
    if lump and not keep.all():
        # out-of-radius couplings onto the row diagonal (same channel,
        # zero offset)
        nd = ~keep
        i0d = (n_off - 1) // 2
        lin_d = (((np.full(int(nd.sum()), i0d, np.int64) * channels
                   + ci[nd]) * channels + ci[nd]) * n_lat + li[nd])
        lin = np.concatenate([lin, lin_d])
        weights = np.concatenate([weights, Ac.data[nd]])
    coefs = np.bincount(
        lin, weights=weights,
        minlength=n_off * channels * channels * n_lat).reshape(
            n_off, channels, channels, n_lat)

    # occupancy: aux points receiving any interpolation weight
    occupied = np.zeros(n_lat, dtype=bool)
    occupied[np.unique(cols[w.reshape(-1) != 0.0])] = True
    # ghost slots: a typical-magnitude diagonal of the PDE's sign, so the
    # smoother calibration and Jacobi stay sane; the masked transfers
    # keep them out of the correction
    i0 = (n_off - 1) // 2          # the all-zero (diagonal) offset
    diag_occ = coefs[i0, np.arange(channels)[:, None],
                     np.arange(channels)[:, None], occupied]
    dmed = np.median(np.abs(diag_occ)) or 1.0
    dsign = np.sign(np.median(diag_occ)) or 1.0
    for c in range(channels):
        coefs[i0, c, c, ~occupied] = dsign * dmed
    coefs = coefs.reshape((len(offsets), channels, channels) + aux_shape)
    mask = occupied.astype(np.float64)
    return (torch.as_tensor(coefs, dtype=dtype),
            torch.as_tensor(mask, dtype=dtype), float(dropped))


def _state_to(state, dtype, device):
    """The lattice V-cycle state (a tuple of per-level dicts of tensors)
    in ``dtype`` on ``device``."""
    return tuple({k: v.to(device=device, dtype=dtype)
                  for k, v in lvl.items()} for lvl in state)


def setup(domain, K_total, h: float = None, h_factor: float = 2.0,
          radius: int = 2, nu1: int = 2, nu2: int = 2, n_power: int = 12,
          smooth: str = "full", verbose: bool = False,
          starts: Optional[dict] = None, **hier_opts):
    """Freeze the aux-space MG state from an assembled tangent's storage
    values ``K_total`` (numpy, float64; see FEM_Domain.setup_auxmg) and
    record the preconditioned spectrum and the tuned Chebyshev enclosure
    on the domain (``_auxmg_spectrum``, ``_auxmg_cheb``).  Returns
    (tree, (desc, hier)).

    ``starts``: optional start vectors (numpy or tensors), by name:
    ``"omega"`` the damped-Jacobi calibration's (default: normal numbers
    seeded 7), ``"levels"`` the lattice calibrations' (mg_setup's
    ``starts``), ``"spectrum"`` and ``"tune"`` those of
    multigrid.estimate_spectrum and tune_chebyshev.  The seconds of each
    part land in ``domain._auxmg_timings``: "galerkin",
    "mg_setup_from_stencil", "calibration", "spectrum", "tune"."""
    import scipy.sparse as sp

    starts = starts or {}
    times = domain._auxmg_timings = {}

    def tick(key, t0):
        if domain.device.type == "cuda":
            torch.cuda.synchronize(domain.device)
        times[key] = time.perf_counter() - t0
        return time.perf_counter()

    if len(domain.workpieces) != 1:
        raise ValueError("auxmg: single-workpiece domains only")
    if smooth not in ("full", "sparse"):
        raise ValueError(f"unknown smooth {smooth!r}")
    wp = domain.workpieces[0]
    mesh = wp.mesh
    if mesh.lattice_shape is not None:
        raise ValueError("auxmg targets unstructured meshes; this mesh "
                         "has lattice numbering: use precond='mg'")
    t0 = time.perf_counter()
    pattern = domain.pattern
    layout = pattern.offset_layout
    C = pattern.wp_infos[0].n_vars
    n_cp = mesh.n_cp
    coords = mesh.cp_coords
    occ = mesh.is_occupied
    if occ is not None and not occ.all():
        # ghost cps (NaN coords, unit-diagonal rows): park them in a valid
        # cell with ZERO interpolation weight
        coords = np.where(occ[:, None], coords,
                          np.nanmin(coords, axis=0))
    if h is None:
        # resolution (h ~ h_factor x the median fine spacing) and
        # coupling span (the largest elements fit the stencil radius)
        spacing, diam_hi = estimate_spacing(coords, mesh.el_cp)
        h = max(h_factor * spacing, diam_hi / radius)
    cell_flat, w, aux_shape, corner_offs = build_transfer(coords, h)
    if occ is not None and not occ.all():
        w = np.where(occ[:, None], w, 0.0)

    K_total = np.asarray(K_total, np.float64)
    A_sp = sp.coo_matrix(
        (K_total[layout.storage_of_slot],
         (pattern.coo_rows.astype(np.int64),
          pattern.coo_cols.astype(np.int64))),
        shape=(pattern.basicfield_size, pattern.basicfield_size))
    hier = multigrid.build_hierarchy(
        aux_shape, C, fine_radius=2 * radius - 2, nu1=nu1, nu2=nu2,
        n_power=n_power, **hier_opts)
    assert hier.radius == radius
    # the Galerkin operator and the lattice hierarchy in float64 on the
    # CPU (one-time setup); only the finished state moves to the device
    coefs, mask, dropped = galerkin_stencil(
        A_sp, cell_flat, w, aux_shape, C, radius)
    del A_sp
    t0 = tick("galerkin", t0)
    lat_state = multigrid.mg_setup_from_stencil(hier, coefs, mask,
                                                starts.get("levels"))
    del coefs, mask
    t0 = tick("mg_setup_from_stencil", t0)
    if verbose:
        print(f"[auxmg] aux lattice {aux_shape} = "
              f"{int(np.prod(aux_shape))} points "
              f"({np.prod(aux_shape) / n_cp:.2f}x of {n_cp} cps), "
              f"dropped |A_c| fraction {dropped:.2e}")
    dev, dtype = domain.device, domain.dtype
    lat_state = _state_to(lat_state, dtype, dev)

    # fine-level damped-Jacobi calibration in the domain dtype on its
    # device, on the SMOOTHING operator (omega damps its spectrum)
    A_dev = OffsetMatrix.from_values(
        torch.as_tensor(K_total, dtype=dtype, device=dev), layout)
    del K_total
    desc = AuxDesc(dim=mesh.dim, channels=C, n_cp=n_cp,
                   n_lat=int(np.prod(aux_shape)), aux_shape=aux_shape,
                   corner_offs=corner_offs, nu1=nu1, nu2=nu2,
                   smooth=smooth)
    tree = {"cell": torch.as_tensor(cell_flat, dtype=torch.int64,
                                    device=dev),
            "cell_plan": sorted_segment_plan(cell_flat, dev),
            "w": torch.as_tensor(w, dtype=dtype, device=dev),
            "lat": lat_state}
    if smooth == "sparse" and layout.blk_b:
        # the BSR tail's block-diagonal positions (block row == column)
        bd_sel = np.flatnonzero(layout.coo_rows == layout.coo_cols)
        tree["bd_sel"] = torch.as_tensor(bd_sel, dtype=torch.int64,
                                         device=dev)
        tree["bd_rows"] = torch.as_tensor(layout.coo_rows[bd_sel],
                                          dtype=torch.int64, device=dev)
    tree = refresh_tangent(A_dev, tree, desc)
    invd = tree["inv_diag"]
    S = AuxMGOperator(A_dev, {**tree, "omega": 1.0}, hier,
                      desc)._smoother()
    nb = pattern.basicfield_size
    v = (multigrid._start_vector(7, (nb,), dtype, dev)
         if starts.get("omega") is None
         else multigrid._as_start(starts["omega"], (nb,), dtype, dev))
    v = v / torch.linalg.norm(v)
    lam = None
    for _ in range(n_power):
        u = invd * S.mv(v)
        lam = torch.linalg.norm(u)
        v = u / torch.where(lam == 0, torch.ones_like(lam), lam)
    lam = lam * 1.1
    tree["omega"] = (4.0 / 3.0) / torch.where(lam == 0,
                                              torch.ones_like(lam), lam)
    del S, v, u
    t0 = tick("calibration", t0)
    # preconditioned-spectrum estimate + tuned Chebyshev enclosure
    op = AuxMGOperator(A_dev, tree, hier, desc)
    domain._auxmg_spectrum = multigrid.estimate_spectrum(
        op, nb, dtype, v0=starts.get("spectrum"))
    t0 = tick("spectrum", t0)
    domain._auxmg_cheb = multigrid.tune_chebyshev(
        op, nb, dtype, domain._auxmg_spectrum, b0=starts.get("tune"))
    tick("tune", t0)
    if verbose:
        lo, hi = domain._auxmg_spectrum
        print(f"[auxmg] precond spectrum ~ [{lo:.3f}, {hi:.3f}], "
              f"cheb {domain._auxmg_cheb}", flush=True)
    return tree, (desc, hier)


def _shift_flat(s: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """y[i + k] = s[i] on the flat lattice axis (k >= 0 here)."""
    if k == 0:
        return s
    return torch.cat([torch.zeros(s.shape[:-1] + (k,), dtype=s.dtype,
                                  device=s.device), s[..., :n - k]], dim=-1)


# ---------------------------------------------------------------------------
# sparsified smoothing operator (desc.smooth == "sparse")
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SparseSmoothOp:
    """Sparsified stand-in for the fine operator inside the V-cycle:

        As = dense offset groups + BSR-tail block diagonal
             + diag(lumped dropped-tail row sums)

    The dense part is the tangent's tailless view
    (``OffsetMatrix.dense_part``: the packed kernel on the card, with the
    tangent's packed values); the block diagonal is a product over the
    [b, b, nbr] block-diagonal values.  Row sums match the true
    operator's exactly (lumping)."""
    dense: OffsetMatrix               # tailless view, shares vals
    bd_vals: Optional[torch.Tensor]   # [b, b, nbr] block diagonal
    lump: torch.Tensor                # [n] dropped-tail row sums
    #: a rank's rows (``block_offset.WindowLayout``) of a row-sharded
    #: tangent: ``dense`` is over the window, ``bd_vals`` [b, b, nbr_w]
    #: over the block rows the window touches, ``lump`` the window's
    #: rows; ``mv`` takes the whole x and returns the window's rows
    window: object = None

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        w = self.window
        y = self.dense.mv(x) + self.lump * (x if w is None else w.local(x))
        if self.bd_vals is not None:
            b = self.bd_vals.shape[0]
            xb = bsr_tail.blocked(x, b)
            if w is None:
                xpT = xb.t()                                  # [b, nbr]
                yT = (self.bd_vals * xpT[None, :, :]).sum(dim=1)  # [b, nbr]
                return y + yT.t().reshape(-1)[:x.shape[0]]
            br = w.tables(x.device)["block_rows"]
            xpT = xb[br].t()                                  # [b, nbr_w]
            yT = (self.bd_vals * xpT[None, :, :]).sum(dim=1)
            yb = torch.zeros_like(xb)
            yb[br] = yT.t()
            y = y + w.local(yb.reshape(-1)[:x.shape[0]])
        return y


@dataclasses.dataclass
class SparseInnerOp:
    """Ã ∘ M for a tail-free inner solve: the Krylov iteration runs on the
    sparsified tangent (SparseSmoothOp); the outer refined Newton step
    measures true residuals, so the sparsification error sets the
    per-refine contraction, never the answer."""
    op: "AuxMGOperator"

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        return self.op._smv(self.op.apply_m(v))

    def apply_m(self, y: torch.Tensor) -> torch.Tensor:
        return self.op.apply_m(y)


def _rank_rows(A: OffsetMatrix):
    """The rows A holds when they are a rank's window of a row-sharded
    tangent, else None (the whole matrix)."""
    return None if A.window.whole else A.window


def refresh_tangent(A: OffsetMatrix, tree: dict, desc: AuxDesc) -> dict:
    """Per-tangent refresh of the V-cycle's fine-level state: the Jacobi
    inverse diagonal and, with smooth='sparse', the sparsified smoothing
    pieces: the block diagonal (a plain indexed write: each block row
    has one diagonal block) and the lumped row sums (one tail SpMV on
    ones)."""
    tree = {**tree, "inv_diag": _safe_inv(A.diag())}
    if desc.smooth != "sparse":
        return tree
    lo = A.layout
    dt, dev = A.vals.dtype, A.vals.device
    w = _rank_rows(A)
    n_rows = lo.n if w is None else w.n_local
    bd_vals = None
    if lo.blk_b and w is None:
        b, nbr = lo.blk_b, lo.n_block_rows
        B3 = A.vals[lo.n_dense:].view(b, b, lo.n_coo)
        bd_vals = torch.zeros((b, b, nbr), dtype=dt, device=dev)
        bd_vals[:, :, tree["bd_rows"]] = B3[:, :, tree["bd_sel"]]
    elif lo.blk_b:
        # the diagonal blocks of the block rows the window touches
        t = w.tables(dev)
        at = t["block_pos"][tree["bd_rows"]]
        sel = at >= 0
        bd_vals = torch.zeros((lo.blk_b, lo.blk_b, t["block_rows"].numel()),
                              dtype=dt, device=dev)
        bd_vals[:, :, at[sel]] = A.tail_blocks()[
            :, :, t["kpos"][tree["bd_sel"][sel]]]
    ones = torch.ones(lo.n, dtype=dt, device=dev)
    As0 = SparseSmoothOp(A.dense_part(), bd_vals,
                         torch.zeros(n_rows, dtype=dt, device=dev), window=w)
    tree["smooth_lump"] = A.mv(ones) - As0.mv(ones)
    tree["smooth_bd"] = bd_vals
    return tree


@dataclasses.dataclass
class AuxMGOperator:
    """A ∘ M for the Krylov menu: solve (A M) y = b, then x = M y.  The
    smoothing operator (``_smoother``) is built once per operator, and
    so once per tangent: the sparsified one shares the tangent's packed
    values."""
    A: OffsetMatrix
    tree: dict
    hier: MGHierarchy
    desc: AuxDesc
    #: row-sharded (``parallel.rowshard.RowWindow``): A is the window's
    #: rows (an ``OffsetMatrix`` over the window) and ``tree`` its
    #: ``refresh_tangent``; vectors in and out are the window's rows, the
    #: smoothing products gather x, the transfers and the lattice cycle
    #: run whole on the gathered residual
    rows: object = None

    def __post_init__(self):
        t = self.tree
        if self.desc.smooth == "sparse" and t.get("smooth_lump") is not None:
            self._S = SparseSmoothOp(self.A.dense_part(), t.get("smooth_bd"),
                                     t["smooth_lump"],
                                     window=_rank_rows(self.A))
        else:
            self._S = self.A

    def _gather(self, v: torch.Tensor) -> torch.Tensor:
        return v if self.rows is None else self.rows.gather(v)

    def _smv(self, x: torch.Tensor) -> torch.Tensor:
        """The smoothing operator's product (x the window's rows when
        row-sharded)."""
        return self._S.mv(self._gather(x))

    # -- transfers: one index stream of n_cp each ------------------------
    def _pt(self, r: torch.Tensor) -> torch.Tensor:
        """Pᵀ r: [C*n_cp] -> [C, *aux_shape].  Each cp's 2^d corner
        contributions move under its cell id (a sorted segment sum over
        the setup's plan), then the corner offsets apply as static flat
        shifts."""
        d, t = self.desc, self.tree
        rw = r.view(d.channels, d.n_cp)
        rc = []
        for c in range(d.channels):
            data = t["w"] * rw[c][:, None]                    # [n_cp, 2^d]
            s8 = sorted_segment_sum(data, t["cell_plan"], d.n_lat)
            acc = _shift_flat(s8[:, 0], d.corner_offs[0], d.n_lat)
            for j in range(1, len(d.corner_offs)):
                acc = acc + _shift_flat(s8[:, j], d.corner_offs[j], d.n_lat)
            rc.append(acc)
        return torch.stack(rc).view((d.channels,) + d.aux_shape)

    def _p(self, xc: torch.Tensor) -> torch.Tensor:
        """P xc: [C, *aux_shape] -> [C*n_cp]: one row gather of the
        shift-stacked table xpad[c, j] = xf[c + off_j]."""
        d, t = self.desc, self.tree
        xf = xc.reshape(d.channels, d.n_lat)
        out = []
        for c in range(d.channels):
            xpad = torch.stack(
                [xf[c] if off == 0 else torch.cat(
                    [xf[c, off:], torch.zeros(off, dtype=xc.dtype,
                                              device=xc.device)])
                 for off in d.corner_offs], dim=1)            # [n_lat, 2^d]
            out.append((t["w"] * xpad[t["cell"]]).sum(dim=1))
        return torch.cat(out)

    # -- the aux V-cycle -------------------------------------------------
    def _smoother(self):
        """The operator the smoothing residuals run against: the true A
        (smooth='full') or the sparsified As (SparseSmoothOp); the outer
        A∘M product always uses the true A."""
        return self._S

    def apply_m(self, b: torch.Tensor) -> torch.Tensor:
        d, t = self.desc, self.tree
        invd, om = t["inv_diag"], t["omega"]
        smv = self._smv
        x = om * invd * b
        for _ in range(d.nu1 - 1):
            x = x + om * invd * (b - smv(x))
        r = b - smv(x)
        xc = multigrid._vcycle_level(self.hier, t["lat"], 0,
                                     self._pt(self._gather(r)))
        p = self._p(xc)
        x = x + (p if self.rows is None else self.rows.local(p))
        for _ in range(d.nu2):
            x = x + om * invd * (b - smv(x))
        return x

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        return self.A.mv(self._gather(self.apply_m(v)))
