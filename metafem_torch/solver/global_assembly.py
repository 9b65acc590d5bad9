"""Global DOF numbering + sparsity pattern (host-side, sort/unique).

The analog of the reference's ``assemble_Global_Variables!`` /
``assemble_SparseID!`` (solver/03_GlobalAssembly.jl): the GPU hash-dict over
cp-pair keys becomes a host numpy ``np.unique`` over packed pair keys; the
CUSPARSE COO sort becomes an argsort permutation.  The resulting pattern is
fully static — assembly then never re-sorts: element contributions flow
through the precomputed ``pair_slot`` map into COO value slots via
``segment_sum`` (deterministic, unlike the reference's atomics).

DOF layout (matches solver/03_GlobalAssembly.jl:9-31,44-56):
  dof(wp, var p, cp c)    = wp.dof_offset + p * wp.n_cp + c
  x[time level l, dof]    — x is stored [max_time_level + 1, basicfield_size]
COO slot layout (matches 03_GlobalAssembly.jl:77-140):
  slot(wp, unit u, pair)  = wp.sparse_entry + u * wp.unitsize + pair_slot
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..mesh.fem_mesh import WPMesh
from .local_assembly import LocalAssembly


@dataclasses.dataclass
class WPGlobalInfo:
    dof_offset: int
    n_cp: int                       # = variable_size in the reference
    n_vars: int
    pair_slot: np.ndarray           # [E, na, na] int32, wp-local pair id
    unitsize: int                   # number of unique cp pairs
    sparse_entry: int               # global COO slot offset
    n_units: int


@dataclasses.dataclass
class GlobalPattern:
    basicfield_size: int
    max_time_level: int
    wp_infos: List[WPGlobalInfo]
    nnz: int
    coo_rows: np.ndarray            # [nnz] int32 (COO slot order)
    coo_cols: np.ndarray            # [nnz]
    #: block-offset storage (TPU-native; see linsolve/block_offset.py) —
    #: K buffers are sized n_storage and indexed via slot_storage()
    offset_layout: object = None
    #: CSR view (perm / sorted rows+cols / row_ptr / diag positions) is
    #: built lazily — the runtime path works in block-offset storage and
    #: never needs it
    _csr: object = dataclasses.field(default=None, repr=False)

    @property
    def dof_block_extents(self):
        """Ordered (base, n_cp) lattice blocks tiling [0, basicfield):
        one per (workpiece, variable) — the residual concat layout for
        the lattice fast path."""
        out = []
        for info in self.wp_infos:
            for v in range(info.n_vars):
                out.append((info.dof_offset + v * info.n_cp, info.n_cp))
        return tuple(out)

    @property
    def k_segment_extents(self):
        """Ordered (base, n_cp) dense segments tiling [0, n_dense) of the
        block-offset storage (tail = COO spill, zero-filled by the
        concat)."""
        return tuple((s[4], s[2]) for s in self.offset_layout.segments)

    def _build_csr(self):
        if self._csr is None:
            order = np.lexsort((self.coo_cols, self.coo_rows))
            rows_sorted = self.coo_rows[order]
            cols_sorted = self.coo_cols[order]
            row_ptr = np.zeros(self.basicfield_size + 1, dtype=np.int64)
            np.add.at(row_ptr, rows_sorted.astype(np.int64) + 1, 1)
            row_ptr = np.cumsum(row_ptr)
            diag_pos = np.full(self.basicfield_size, -1, dtype=np.int64)
            hits = rows_sorted == cols_sorted
            diag_pos[rows_sorted[hits]] = np.nonzero(hits)[0]
            self._csr = (order.astype(np.int32), rows_sorted, cols_sorted,
                         row_ptr, diag_pos)
        return self._csr

    @property
    def csr_perm(self):
        return self._build_csr()[0]

    @property
    def rows_sorted(self):
        return self._build_csr()[1]

    @property
    def cols_sorted(self):
        return self._build_csr()[2]

    @property
    def row_ptr(self):
        return self._build_csr()[3]

    @property
    def diag_pos(self):
        return self._build_csr()[4]

    @property
    def n_storage(self) -> int:
        return self.offset_layout.n_storage

    def slot_storage(self, slots: np.ndarray) -> np.ndarray:
        """Map logical COO slot ids to storage indices."""
        return self.offset_layout.storage_of_slot[slots]


def build_global_pattern(meshes: List[WPMesh],
                         assemblies: List[LocalAssembly],
                         **layout_opts) -> GlobalPattern:
    wp_infos: List[WPGlobalInfo] = []
    dof_offset = 0
    for mesh, la in zip(meshes, assemblies):
        wp_infos.append(WPGlobalInfo(
            dof_offset=dof_offset, n_cp=mesh.n_cp, n_vars=la.n_vars,
            pair_slot=np.empty(0, np.int32), unitsize=0, sparse_entry=0,
            n_units=len(la.sparse_mapping)))
        dof_offset += la.n_vars * mesh.n_cp
    basicfield_size = dof_offset
    max_time_level = max((la.max_time_level for la in assemblies), default=0)

    rows_parts, cols_parts = [], []
    wp_metas = []
    sparse_entry = 0
    for mesh, la, info in zip(meshes, assemblies, wp_infos):
        from ..native import unique_pairs_elcp
        ci, cj, info.pair_slot = unique_pairs_elcp(mesh.el_cp, mesh.n_cp)
        info.unitsize = len(ci)
        info.sparse_entry = sparse_entry
        for (dual_pos, base_pos), _u in sorted(la.sparse_mapping.items(),
                                               key=lambda kv: kv[1]):
            rows_parts.append(info.dof_offset + dual_pos * mesh.n_cp + ci)
            cols_parts.append(info.dof_offset + base_pos * mesh.n_cp + cj)
        wp_metas.append({
            "dof_offset": info.dof_offset, "n_cp": mesh.n_cp,
            "n_vars": la.n_vars,
            "units": {u: pair for pair, u in la.sparse_mapping.items()},
            "sparse_entry": info.sparse_entry, "unitsize": info.unitsize,
            "ci": ci, "cj": cj})
        sparse_entry += info.n_units * info.unitsize

    nnz = sparse_entry
    if nnz:
        coo_rows = np.concatenate(rows_parts)
        coo_cols = np.concatenate(cols_parts)
    else:
        coo_rows = np.zeros(0, np.int64)
        coo_cols = np.zeros(0, np.int64)

    from ..linsolve.block_offset import build_offset_layout
    offset_layout = build_offset_layout(wp_metas, nnz, **layout_opts)

    return GlobalPattern(
        offset_layout=offset_layout,
        basicfield_size=basicfield_size, max_time_level=max_time_level,
        wp_infos=wp_infos, nnz=nnz,
        coo_rows=coo_rows.astype(np.int32, copy=False),
        coo_cols=coo_cols.astype(np.int32, copy=False))


def assemble_x(meshes: List[WPMesh], assemblies: List[LocalAssembly],
               pattern: GlobalPattern) -> np.ndarray:
    """Initial global x [max_time_level+1, basicfield_size] from the named
    controlpoint field columns (assemble_X!, 03_GlobalAssembly.jl:44-56)."""
    x = np.zeros((pattern.max_time_level + 1, pattern.basicfield_size))
    for mesh, la, info in zip(meshes, assemblies, pattern.wp_infos):
        for (local_sym, basic_pos, td) in la.local_innervar_infos:
            col = mesh.fields.get(local_sym)
            if col is None:
                continue
            start = info.dof_offset + basic_pos * mesh.n_cp
            x[td, start:start + mesh.n_cp] = col
    return x


def dessemble_x(x: np.ndarray, meshes: List[WPMesh],
                assemblies: List[LocalAssembly],
                pattern: GlobalPattern) -> None:
    """Write global x back into the named controlpoint columns
    (dessemble_X!, 03_GlobalAssembly.jl:63-75)."""
    x = np.asarray(x)
    for mesh, la, info in zip(meshes, assemblies, pattern.wp_infos):
        for (local_sym, basic_pos, td) in la.local_innervar_infos:
            start = info.dof_offset + basic_pos * mesh.n_cp
            mesh.field(local_sym)[...] = x[td, start:start + mesh.n_cp]
