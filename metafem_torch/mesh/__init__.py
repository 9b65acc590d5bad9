"""Mesh layer: geometric topology, builders, readers, runtime FEM mesh."""

from .ref_geometry import GeoMesh, construct_total_mesh, get_boundary_mesh
from .builders import make_square, make_brick, refine_simplex, select_facets
from .readers import read_mesh, read_inp, read_mphtxt
from .fem_mesh import WPMesh, BoundaryGroup, build_wp_mesh
