"""Legacy ASCII VTK writer (UNSTRUCTURED_GRID).

A copy of the reference package's ``io/vtk.py`` for the port (host
numpy only; it writes the same bytes for the same mesh and fields).
The analog of MetaFEM.jl's write_VTK (unstructured_mesh/5_VTK.jl):
linear and quadratic quad/hex/tri/tet cells (Lagrange and Serendipity
variants), every named controlpoint column dumped as POINT_DATA scalars,
optional coordinate shift by a vector field (e.g. displacement).

Instead of per-type hard-coded node permutation tables
(5_VTK.jl:27-119), the permutation from the lexicographic node order to
VTK's order is computed by matching reference-coordinate positions: one
mechanism for every supported cell type.  Orders above 2 fall back to
linear cells over the corner nodes (MetaFEM.jl does not support them
either).  Ghost lattice slots (unoccupied control points) are compacted
away.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..elements.structures import ElementType
from ..mesh.fem_mesh import WPMesh
_COORD_FIELDS = {"x", "y", "z"}


def _edge_mid(verts, a, b):
    return (verts[a] + verts[b]) / 2.0


def _vtk_nodes(et: ElementType):
    """(cell_type, node reference positions in VTK order) for the element
    type, or a linear fallback."""
    v = et.vertices
    dim, shape, order, n = et.dim, et.shape, et.order, et.n_cp
    if shape == "CUBE" and dim == 2:
        corners = [v[i] for i in range(4)]
        if order == 1:
            return 9, corners                                   # VTK_QUAD
        edges = [_edge_mid(v, *e) for e in ((0, 1), (1, 2), (2, 3), (3, 0))]
        if order == 2 and n == 8:
            return 23, corners + edges          # VTK_QUADRATIC_QUAD
        if order == 2 and n == 9:
            return 28, corners + edges + [v.mean(0)]  # VTK_BIQUADRATIC_QUAD
    if shape == "CUBE" and dim == 3:
        corners = [v[i] for i in range(8)]
        vtk_edges = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6),
                     (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7))
        if order == 1:
            return 12, corners                                  # VTK_HEX
        edges = [_edge_mid(v, *e) for e in vtk_edges]
        if order == 2 and n == 20:
            return 25, corners + edges          # VTK_QUADRATIC_HEXAHEDRON
        if order == 2 and n == 27:
            # faces x-, x+, y-, y+, z-, z+ then center
            faces = [np.array(p) for p in
                     ([0.0, .5, .5], [1.0, .5, .5], [.5, 0.0, .5],
                      [.5, 1.0, .5], [.5, .5, 0.0], [.5, .5, 1.0])]
            return 29, corners + edges + faces + [v.mean(0)]
    if shape == "SIMPLEX" and dim == 2:
        corners = [v[i] for i in range(3)]
        if order == 1:
            return 5, corners                                   # VTK_TRIANGLE
        if order == 2:
            edges = [_edge_mid(v, *e) for e in ((0, 1), (1, 2), (2, 0))]
            return 22, corners + edges          # VTK_QUADRATIC_TRIANGLE
    if shape == "SIMPLEX" and dim == 3:
        corners = [v[i] for i in range(4)]
        if order == 1:
            return 10, corners                                  # VTK_TETRA
        if order == 2:
            edges = [_edge_mid(v, *e) for e in
                     ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))]
            return 24, corners + edges          # VTK_QUADRATIC_TETRA
    # fallback: linear cell over the corner nodes
    if shape == "CUBE":
        return (9, [v[i] for i in range(4)]) if dim == 2 else \
               (12, [v[i] for i in range(8)])
    return (5, [v[i] for i in range(3)]) if dim == 2 else \
           (10, [v[i] for i in range(4)])


def _node_permutation(et: ElementType):
    cell_type, vtk_pos = _vtk_nodes(et)
    perm = []
    for p in vtk_pos:
        d = np.linalg.norm(et.node_pos - np.asarray(p)[None, :], axis=1)
        j = int(np.argmin(d))
        if d[j] > 1e-9:
            raise RuntimeError("VTK node matching failed")
        perm.append(j)
    return cell_type, np.asarray(perm, dtype=np.int64)


def write_vtk(path: str, mesh: WPMesh, element_type: ElementType,
              fields: Optional[Sequence[str]] = None,
              shift_field: Optional[str] = None,
              shift_scale: float = 1.0) -> None:
    """Write the workpiece mesh + named controlpoint columns.

    ``shift_field``: base name of a vector field (components
    ``<name>1..<name>dim``) added to the coordinates, the analog of the
    reference's shift_sym displacement plotting (5_VTK.jl:22-25,69-71).
    """
    cell_type, perm = _node_permutation(element_type)
    coords = np.asarray(mesh.cp_coords, dtype=float)
    dim = coords.shape[1]
    el_cp = mesh.el_cp
    field_data = mesh.fields
    occ = mesh.is_occupied
    if occ is not None and not occ.all():
        # compact away ghost lattice slots (cells never reference them)
        compact = np.cumsum(occ) - 1
        coords = coords[occ]
        el_cp = compact[el_cp]
        field_data = {k: np.asarray(v)[occ] for k, v in mesh.fields.items()}
    if shift_field is not None:
        shift = np.stack([field_data[f"{shift_field}{d + 1}"]
                          for d in range(dim)], axis=1)
        coords = coords + shift_scale * shift
    pts = np.zeros((len(coords), 3))
    pts[:, :dim] = coords
    cells = el_cp[:, perm]
    n_el, npc = cells.shape

    if fields is None:
        fields = [k for k in field_data if k not in _COORD_FIELDS]

    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nmetafem output\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(pts)} double\n")
        np.savetxt(f, pts, fmt="%.12g")
        f.write(f"\nCELLS {n_el} {n_el * (npc + 1)}\n")
        np.savetxt(f, np.hstack([np.full((n_el, 1), npc, dtype=np.int64),
                                 cells]), fmt="%d")
        f.write(f"\nCELL_TYPES {n_el}\n")
        np.savetxt(f, np.full(n_el, cell_type, dtype=np.int64), fmt="%d")
        f.write(f"\nPOINT_DATA {len(pts)}\n")
        for name in fields:
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            np.savetxt(f, np.asarray(field_data[name]), fmt="%.12g")
