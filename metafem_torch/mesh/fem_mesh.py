"""FEM runtime mesh: control-point generation + facet links.

The analog of the reference's mesh_Classical / allocate_Basic_WP_Mesh
(unstructured_mesh/2_Interface.jl, 3_InitializeMesh.jl), redesigned: shared
high-order control points are deduplicated by quantized position
(lexsort/unique on the host) instead of per-entity GPU generation with
orientation alignment — one uniform mechanism for every order, shape and
face orientation (the reference errors out beyond 1 cp per 3D face,
3_InitializeMesh.jl:132-134; this handles arbitrary order).

Output: static arrays ready for device upload -
  cp_coords[n_cp, dim], el_cp[n_el, n_itp], and per boundary-group facet
  (element id, local face index) pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..elements.discretization import ClassicalDiscretization
from .ref_geometry import GeoMesh


@dataclasses.dataclass
class BoundaryGroup:
    element_ids: np.ndarray   # [n_facet]
    eindex: np.ndarray        # [n_facet] local face index into bdy tables


@dataclasses.dataclass
class WPMesh:
    """Per-workpiece runtime mesh (host numpy; device copies made at
    assembly compile time).

    ``is_occupied``: on lattice-numbered meshes (see build_wp_mesh) some
    control-point slots are ghosts — never referenced by any element,
    coordinates NaN, fields zero; the analog of the reference's
    is_occupied mask (misc/05_GPU_Table.jl).  Ghost DOF rows are
    diagonally regularized in K and stay exactly zero."""
    dim: int
    cp_coords: np.ndarray               # [n_cp, dim] (NaN for ghosts)
    el_cp: np.ndarray                   # [n_el, n_itp] control-point ids
    boundary_groups: Dict[int, BoundaryGroup]
    fields: Dict[str, np.ndarray]       # named per-cp columns (T, s, ...)
    is_occupied: np.ndarray = None      # [n_cp] bool
    #: per-axis lattice sizes when lattice numbering succeeded (cp id =
    #: row-major index over this grid, axis 0 slowest); None otherwise.
    #: Consumed by the geometric-multigrid preconditioner
    #: (linsolve/multigrid.py) and by any stencil-aware fast path.
    lattice_shape: tuple = None

    @property
    def n_cp(self) -> int:
        return len(self.cp_coords)

    @property
    def n_occupied(self) -> int:
        if self.is_occupied is None:
            return self.n_cp
        return int(self.is_occupied.sum())

    @property
    def n_el(self) -> int:
        return len(self.el_cp)

    def field(self, name: str) -> np.ndarray:
        if name not in self.fields:
            self.fields[name] = np.zeros(self.n_cp)
        return self.fields[name]

    def set_field(self, name: str, values) -> None:
        arr = self.fields.setdefault(name, np.zeros(self.n_cp))
        arr[...] = values


def _dedup_positions(pos: np.ndarray, tol: float):
    """Map each row of pos [N, dim] to a unique id; positions within tol
    collapse.  Grid quantization with straddle verification + offset retry."""
    for shift in (0.0, tol / 3.0, 2.0 * tol / 3.0):
        keys = np.round((pos + shift) / tol).astype(np.int64)
        order = np.lexsort(keys.T[::-1])
        sk = keys[order]
        is_new = np.ones(len(order), dtype=bool)
        if len(order) > 1:
            is_new[1:] = np.any(sk[1:] != sk[:-1], axis=1)
        gid_sorted = np.cumsum(is_new) - 1
        gid = np.empty(len(order), dtype=np.int64)
        gid[order] = gid_sorted
        n_unique = gid_sorted[-1] + 1 if len(order) else 0
        # representative position per group (first occurrence)
        rep = np.zeros((n_unique, pos.shape[1]))
        first_pos = order[is_new.nonzero()[0]]
        rep[gid[first_pos]] = pos[first_pos]
        # verify no same-point pair got split across grid cells
        if np.abs(pos - rep[gid]).max() <= tol:
            return gid, rep
    raise RuntimeError("control-point dedup failed: mesh has distinct nodes "
                       "closer than the dedup tolerance")


def _try_lattice_numbering(gid: np.ndarray, rep: np.ndarray, tol: float,
                           max_inflation: float = 4.0, pad_axis0: int = 1):
    """If every control point quantizes to a regular per-axis lattice with
    acceptable inflation, renumber row-major over the full lattice (ghost
    slots where no cp exists).  Returns (gid, coords, occupied, shape).

    ``pad_axis0``: round the LEADING (most-significant) lattice axis up
    to a multiple — extra all-ghost planes at the end of the numbering.
    Axis 0 never enters the row-major strides, so pair offsets are
    unchanged; the point is multi-device sharding: with S[0] divisible
    by the mesh size, n_cp, the DOF vector and the dense block-offset
    storage all split evenly over the device mesh (uneven shardings are
    rejected by device_put and silently REPLICATED by GSPMD sharding
    constraints in current JAX — padding is the only sound route)."""
    n_real, dim = rep.shape
    bail = (gid, rep, np.ones(n_real, dtype=bool), None)
    axes = []
    for d in range(dim):
        coords = np.unique(np.round(rep[:, d] / tol).astype(np.int64))
        if len(coords) < 2:
            return bail
        diffs = np.diff(coords)
        h = diffs.min()
        if h <= 0:
            return bail
        # every coordinate must be an integer multiple of h from the min
        k = (coords - coords[0]) / h
        if np.abs(k - np.round(k)).max() > 0.25:
            return bail
        axes.append((coords[0], h, int(np.round(k[-1])) + 1))
    # Python-int product: np.prod over int64 silently overflows (an
    # irregular mesh can imply an astronomically fine lattice), wrapping
    # negative and slipping past the inflation guard
    lattice_size = 1
    for (_, _, nd) in axes:
        lattice_size *= nd
        if lattice_size > max_inflation * n_real:
            return bail

    idx = np.zeros(n_real, dtype=np.int64)
    for d, (c0, h, nd) in enumerate(axes):
        kd = np.round((np.round(rep[:, d] / tol) - c0) / h).astype(np.int64)
        idx = idx * nd + kd
    if len(np.unique(idx)) != n_real:
        return bail                                   # collision: bail

    if pad_axis0 > 1:
        c0, h, nd0 = axes[0]
        nd0p = -(-nd0 // pad_axis0) * pad_axis0
        # idx is unaffected: axis 0 is most significant (its size is not
        # a stride); the pad planes are appended ghost slots
        axes[0] = (c0, h, nd0p)
        lattice_size = lattice_size // nd0 * nd0p

    coords = np.full((lattice_size, rep.shape[1]), np.nan)
    coords[idx] = rep
    occupied = np.zeros(lattice_size, dtype=bool)
    occupied[idx] = True
    return idx[gid], coords, occupied, tuple(a[2] for a in axes)


def _morton_renumber(gid: np.ndarray, rep: np.ndarray):
    """Locality renumbering for unstructured meshes: sort control points
    along a Morton (Z-order) space-filling curve over quantized
    coordinates.  Spatially-near cps get near ids, so (a) matrix
    column-minus-row offsets concentrate and (b) each cp's neighbors
    span few fixed-size id blocks — the property the block-structured
    COO tail (linsolve/block_offset.py) converts into contiguous-row
    gathers instead of scalar gathers (measured 6x fill-9x on the
    pikachu tet mesh vs 57x fill in file order, blocktail_probe.py).
    Pure permutation: ids change, nothing else does."""
    n, dim = rep.shape
    if n == 0:
        return gid, rep
    lo = rep.min(axis=0)
    span = rep.max(axis=0) - lo
    span[span <= 0] = 1.0
    bits = 63 // dim                       # 21 bits/axis in 3D, 31 in 2D
    q = ((rep - lo) / span * ((1 << bits) - 1)).astype(np.uint64)

    def spread(v, stride):
        out = np.zeros_like(v)
        for i in range(bits):
            out |= ((v >> np.uint64(i)) & np.uint64(1)) << np.uint64(
                i * stride)
        return out

    code = np.zeros(n, np.uint64)
    for d in range(dim):
        code |= spread(q[:, d], dim) << np.uint64(d)
    perm = np.argsort(code, kind="stable")
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n)
    return rank[gid], rep[perm]


def build_wp_mesh(geo: GeoMesh, disc: ClassicalDiscretization,
                  boundary_facets: Dict[int, np.ndarray],
                  lattice_pad: int = 1) -> WPMesh:
    """Generate high-order control points for all elements of ``geo`` and
    link boundary facet groups to (element, local face)."""
    et = disc.element_type
    if geo.shape != et.shape or geo.dim != et.dim:
        raise ValueError("element type does not match the geometric mesh")

    corners = geo.vert[geo.connections]          # [E, n_vert, dim]
    w = et.corner_weights()                      # [n_itp, n_vert]
    all_pos = np.einsum("av,evd->ead", w, corners)  # [E, n_itp, dim]
    n_el, n_itp, dim = all_pos.shape

    # dedup tolerance: a small fraction of the smallest element edge
    edge_vecs = corners - corners[:, [0], :]
    scale = np.linalg.norm(edge_vecs[:, 1:, :], axis=2).min()
    tol = max(scale, 1e-300) * 1e-6 / max(et.order, 1)

    gid, rep = _dedup_positions(all_pos.reshape(-1, dim), tol)

    # lattice renumbering: if the control points sit on a regular grid
    # (structured meshes at any interpolation order do — half-step
    # lattices for order 2 etc.), number them by lattice coordinates,
    # KEEPING unoccupied lattice slots as ghost control points.  FEM
    # matrix column-minus-row offsets then become exactly constant, which
    # the block-offset sparse storage (linsolve/block_offset.py) turns
    # into dense diagonal segments — stencil-speed instead of
    # gather-speed SpMV on TPU.  Ghosts cost ~25-50% extra rows; their
    # coordinates are NaN (coordinate-based selections skip them), their
    # DOF rows are regularized with a unit diagonal and stay zero.
    gid, rep, occupied, lattice_shape = _try_lattice_numbering(
        gid, rep, tol, pad_axis0=lattice_pad)
    if lattice_shape is None:
        # unstructured: fall back to space-filling-curve locality order
        gid, rep = _morton_renumber(gid, rep)
        if lattice_pad > 1 and len(rep) % lattice_pad:
            # scale-out padding (the unstructured analog of the lattice
            # pad-axis): append ghost control points so n_cp divides the
            # device-mesh extent and the row-sharded solver layouts
            # split evenly (parallel/rowshard.put_divisible).  Ghosts
            # are untouched by any element; their DOF rows get the unit
            # diagonal regularizer like lattice ghosts.
            pad = lattice_pad - len(rep) % lattice_pad
            rep = np.vstack([rep, np.full((pad, rep.shape[1]), np.nan)])
            occupied = np.ones(len(rep), dtype=bool)
            occupied[-pad:] = False

    el_cp = gid.reshape(n_el, n_itp)

    groups: Dict[int, BoundaryGroup] = {}
    for bg_id, f_ids in boundary_facets.items():
        f_ids = np.asarray(f_ids, dtype=np.int64)
        els = geo.facet_elements[f_ids, 0]
        eis = geo.facet_eindex[f_ids, 0]
        if (els < 0).any():
            raise ValueError("boundary group references an invalid facet")
        inner = geo.facet_elements[f_ids, 1]
        if (inner >= 0).any():
            raise ValueError("boundary group contains interior facets")
        groups[bg_id] = BoundaryGroup(element_ids=els.astype(np.int64),
                                      eindex=eis.astype(np.int64))

    return WPMesh(dim=dim, cp_coords=rep, el_cp=el_cp.astype(np.int64),
                  boundary_groups=groups, fields={}, is_occupied=occupied,
                  lattice_shape=lattice_shape)
