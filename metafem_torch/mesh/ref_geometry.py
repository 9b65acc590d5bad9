"""First-order geometric mesh: topology construction + boundary extraction.

The analog of the reference's ``construct_TotalMesh`` / ``get_BoundaryMesh``
(ref_geometry/002_Initialization.jl), rebuilt host-side with vectorized
numpy sort/unique instead of the GPU hash dict: facets are deduplicated by
sorted-vertex keys; boundary facets are those referenced by exactly one
element.  Mesh building is a one-time host cost; everything downstream is
static device arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..elements.structures import (HEX_FACES, QUAD_FACES, TET_FACES,
                                   TRI_FACES)


def _local_faces(dim: int, n_vert_el: int):
    if dim == 2:
        if n_vert_el == 4:
            return QUAD_FACES, "CUBE"
        if n_vert_el == 3:
            return TRI_FACES, "SIMPLEX"
    if dim == 3:
        if n_vert_el == 8:
            return HEX_FACES, "CUBE"
        if n_vert_el == 4:
            return TET_FACES, "SIMPLEX"
    raise ValueError(
        f"unsupported element: dim={dim}, {n_vert_el} vertices")


@dataclasses.dataclass
class GeoMesh:
    """First-order mesh. ``facets`` lists every unique (dim-1)-facet;
    ``facet_elements``/``facet_eindex`` give up to two (element, local
    face) incidences (-1 padding); boundary facets have exactly one."""

    dim: int
    shape: str                    # CUBE | SIMPLEX
    vert: np.ndarray              # [n_vert, dim] float
    connections: np.ndarray       # [n_el, n_vert_per_el] int, 0-based
    facets: np.ndarray            # [n_facet, n_fv] vertex ids (as seen from
    #                               the FIRST incident element's local face)
    facet_elements: np.ndarray    # [n_facet, 2] element ids, -1 if none
    facet_eindex: np.ndarray      # [n_facet, 2] local face index, -1 if none

    @property
    def n_vert(self) -> int:
        return len(self.vert)

    @property
    def n_el(self) -> int:
        return len(self.connections)

    def boundary_facet_ids(self) -> np.ndarray:
        return np.where(self.facet_elements[:, 1] < 0)[0]

    def facet_centers(self) -> np.ndarray:
        return self.vert[self.facets].mean(axis=1)


def construct_total_mesh(vert: np.ndarray,
                         connections: np.ndarray) -> GeoMesh:
    """vert: [n_vert, dim] (or [dim, n_vert], auto-detected);
    connections: [n_el, n_vert_per_el] (or transposed), 0- or 1-based
    (1-based detected when the minimum vertex id is 1 and 0 never occurs)."""
    vert = np.asarray(vert, dtype=float)
    connections = np.asarray(connections)
    if vert.shape[0] <= 3 and vert.shape[0] < vert.shape[1]:
        vert = vert.T
    dim = vert.shape[1]
    valid_per_el = (3, 4) if dim == 2 else (4, 8)
    if connections.shape[1] not in valid_per_el:
        if connections.shape[0] in valid_per_el:
            connections = connections.T
        else:
            raise ValueError(
                f"cannot infer element size from connections shape "
                f"{connections.shape} for dim {dim}")
    if connections.min() == 1:
        connections = connections - 1
    connections = connections.astype(np.int64)

    local_faces, shape = _local_faces(dim, connections.shape[1])
    n_el = len(connections)
    n_faces = len(local_faces)
    nfv = len(local_faces[0])

    # all (element, local face) incidences
    all_face_verts = np.stack(
        [connections[:, list(lf)] for lf in local_faces], axis=1
    ).reshape(n_el * n_faces, nfv)                     # [E*F, nfv]
    keys = np.sort(all_face_verts, axis=1)
    order = np.lexsort(keys.T[::-1])
    sorted_keys = keys[order]
    is_new = np.ones(len(order), dtype=bool)
    if len(order) > 1:
        is_new[1:] = np.any(sorted_keys[1:] != sorted_keys[:-1], axis=1)
    group_id_sorted = np.cumsum(is_new) - 1            # unique facet id
    n_facet = group_id_sorted[-1] + 1 if len(order) else 0
    group_id = np.empty(len(order), dtype=np.int64)
    group_id[order] = group_id_sorted

    el_of = np.repeat(np.arange(n_el), n_faces)
    ei_of = np.tile(np.arange(n_faces), n_el)

    facet_elements = np.full((n_facet, 2), -1, dtype=np.int64)
    facet_eindex = np.full((n_facet, 2), -1, dtype=np.int64)
    facets = np.zeros((n_facet, nfv), dtype=np.int64)
    # first incidence (in sorted order the first of each group)
    first_pos = order[is_new.nonzero()[0]]
    facets[group_id[first_pos]] = all_face_verts[first_pos]
    facet_elements[group_id[first_pos], 0] = el_of[first_pos]
    facet_eindex[group_id[first_pos], 0] = ei_of[first_pos]
    # second incidence (if any)
    second_mask = ~is_new
    second_pos = order[second_mask.nonzero()[0]]
    if len(second_pos):
        gids = group_id[second_pos]
        # an interior facet is shared by exactly 2 elements in a manifold mesh
        counts = np.bincount(group_id, minlength=n_facet)
        if counts.max() > 2:
            raise ValueError("non-manifold mesh: a facet belongs to >2 "
                             "elements")
        facet_elements[gids, 1] = el_of[second_pos]
        facet_eindex[gids, 1] = ei_of[second_pos]

    return GeoMesh(dim=dim, shape=shape, vert=vert,
                   connections=connections, facets=facets,
                   facet_elements=facet_elements, facet_eindex=facet_eindex)


def get_boundary_mesh(mesh: GeoMesh) -> np.ndarray:
    """Ids of facets on the boundary (single-element incidence), the analog
    of get_BoundaryMesh (ref_geometry/002_Initialization.jl:277-289)."""
    return mesh.boundary_facet_ids()
