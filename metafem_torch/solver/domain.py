"""FEM_Domain: the user-facing problem object of the PyTorch port.

Port of ``metafem/solver/domain.py`` (the analog of
MetaFEM.jl's ``FEM_Domain`` / ``WorkPiece`` / ``Physics``,
solver/01_Types.jl): declare variables, add workpieces and boundaries,
assign weak forms, mesh, compile, then step with a Newton loop whose
linear solves are right-Jacobi BiCGStab over the block-offset SpMV.

    dom = FEM_Domain(dim=2)                # device=None: CUDA
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    i = mf.index("i")
    wp = dom.add_workpiece(geo_mesh)
    bg = dom.add_boundary(wp, facet_ids)
    dom.assign_workpiece_weakform(wp, -k * Bilinear(T.d(i), T.d(i)) + ...)
    dom.assign_boundary_weakform(wp, bg, ...)
    dom.initialize_local_assembly()
    dom.mesh_classical(itp_order=2, itg_order=5)
    dom.assemble_global_variables()
    dom.compile()
    dom.update_one_step()

The production path of ``bench.py`` freezes the operator once and then
steps with exact float64 residuals and working-precision multigrid
solves:

    dom.freeze_linear_tangent()
    dom.setup_mg(tune=False)
    dom.freeze_refined_residual()
    step = dom.make_refined_step(sv_func=krylov.chebyshev)
    x, dx, res, refines = step(dom._runtime_state(), x, t, dt)

Steps in one call and other solvers:

    dom.linear_solver = dom.make_iterative_solver(
        sv_func=krylov.bicgstabl, s=4)     # or dom.make_direct_solver()
    dom.update_one_step_jit(max_iter=7)    # make_jitted_step's host loop

User callbacks and history state (the J2 example):

    dom.register_function("strain_updater", fn)   # fn(*args, user=...)
    dom.user_state = {"ep": ep0, "Y": Y0}          # moved to the device
    e11 = dom.evaluate_at_itg(wp, dom.sym("e")[1, 1])   # [n_el, n_itg]

The reference's production mode on its TPU, two-float residuals, is
opt-in on a float32 domain:

    step = dom.make_refined_step(sv_func=krylov.chebyshev,
                                 residual_mode="df32")
    x_df, dx, res, refines = step(dom._runtime_state(),
                                  twofloat.df_from_f64(x), t, dt)

Repeated runs of one problem reload the freezes instead of computing
them (the validity contract is the caller's: the same mesh, weak forms,
fields and global constants):

    dom.save_freezes("fz.pkl")             # after the freezes and tune
    dom2.load_freezes("fz.pkl")            # a fresh identical domain
    dom2.free_volume_tables()              # affine volume: tables unused

Unstructured meshes (no lattice numbering) spill their rare offsets
into a BSR tail of 8 x 8 blocks and precondition with the
auxiliary-space multigrid (the pikachu-class production path):

    dom.freeze_linear_tangent()            # on the host for these meshes
    dom.freeze_refined_residual()
    dom.setup_auxmg(smooth="full")
    dom.free_volume_tables()
    step = dom.make_refined_step(sv_func=krylov.bicgstab, precond="auxmg",
                                 maxiter=12, max_refine=4, forcing=0.3)
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, device_constant, resolve_device
from ..elements.discretization import (ClassicalDiscretization,
                                       initialize_classical_element)
from ..linsolve import krylov, multigrid
from ..linsolve.block_offset import OffsetMatrix, _device_tables
from ..linsolve.driver import iterative_solve, solver_lu
from ..mesh.fem_mesh import WPMesh, build_wp_mesh
from ..mesh.ref_geometry import GeoMesh
from ..symbolics.api import SymRef, as_term
from ..symbolics.ir import free_index
from ..symbolics.registry import (EXTERNAL_VAR, INTEGRATION_POINT_VAR,
                                  INTERNAL_VAR, VariableRegistry)
from ..symbolics.simplify import unroll_and_simplify
from ..symbolics.tensor_table import TensorTable
from ..symbolics.weakform import BilinearForm, build_weakform
from .assembly import (CompiledWP, _build_env, build_phase_maps,
                       collect_phase_streams, gather_fast_maps,
                       make_updaters)
from .df_lowering import df_tables
from .geometry import update_element_geometry, update_facet_geometry
from .global_assembly import (GlobalPattern, assemble_x, build_global_pattern,
                              dessemble_x)
from .local_assembly import (LocalAssembly, _extervar_info, _innervar_info,
                             extract_words, initialize_local_assembly)
from .lowering import LoweringContext
from .time_domain import (GeneralAlpha, initialize_dx, normalized_norm,
                          update_dx, x_star_of)

_COORD_NAMES = ("x", "y", "z")
_CPU = torch.device("cpu")
#: save_freezes' stand-ins for what load_freezes rebuilds from the live
#: domain: the state's volume tables (aliased by the refined record),
#: the float64 field columns, and an OffsetMatrix's layout
_STATE_EL = "__state_el__"
_MESH_FIELDS64 = "__mesh_fields64__"
_OFFSET_MATRIX = "__offset_matrix__"


class StaleFreezeCache(ValueError):
    """load_freezes: the file was saved under another storage layout."""


def _is_tag(value, tag: str) -> bool:
    return isinstance(value, str) and value == tag


def _to_host(tree):
    """``tree`` with every tensor as a numpy array (its dtype kept) and
    every OffsetMatrix as {_OFFSET_MATRIX: values}: no device tensor and
    no pack plan is pickled."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, OffsetMatrix):
        return {_OFFSET_MATRIX: _to_host(tree.vals)}
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _to_device(tree, device, layout):
    """The inverse of _to_host: numpy arrays become tensors on
    ``device`` in the dtype they were saved in."""
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree).to(device)
    if isinstance(tree, dict):
        if set(tree) == {_OFFSET_MATRIX}:
            return OffsetMatrix.from_values(
                _to_device(tree[_OFFSET_MATRIX], device, layout), layout)
        return {k: _to_device(v, device, layout) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(v, device, layout) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device, layout) for v in tree)
    return tree


@dataclasses.dataclass
class WorkPiece:
    geo: GeoMesh
    boundary_facets: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)
    domain_forms: List[BilinearForm] = dataclasses.field(default_factory=list)
    boundary_forms: Dict[int, List[BilinearForm]] = dataclasses.field(
        default_factory=dict)
    extra_vars: List[str] = dataclasses.field(default_factory=list)
    local_assembly: Optional[LocalAssembly] = None
    disc: Optional[ClassicalDiscretization] = None
    mesh: Optional[WPMesh] = None
    #: boundary group id -> [(eindex, facet positions within group)]
    bdy_parts: Dict[int, List[Tuple[int, np.ndarray]]] = dataclasses.field(
        default_factory=dict)


class FEM_Domain:
    def __init__(self, dim: int, dtype=DEFAULT_DTYPE, device=None):
        """``dtype``: working precision of geometry tables, assembly and
        Krylov solves (float64 by default, as the reference).  ``device``:
        None means CUDA, which must then be present; pass "cpu" to run on
        the CPU."""
        self.dim = dim
        self.dtype = dtype
        self.device = resolve_device(device)
        self.registry = VariableRegistry()
        self.tensor_table = TensorTable(dim, self.registry)
        self.workpieces: List[WorkPiece] = []
        self.global_vars: Dict[str, float] = {}
        self.functions: Dict[str, Callable] = {}
        self._user_state: dict = {}
        self.time_discretization = GeneralAlpha()
        self.converge_tol: float = 1e-6
        self.t: float = 0.0
        self.dt: float = 1.0
        self.linear_solver: Optional[Callable] = None  # (A, b) -> x
        #: one (Krylov iterations, true residual) pair per solver pass of
        #: the default iterative solver, appended as the steps run
        self.solve_log: List[Tuple[int, float]] = []
        # runtime
        self.pattern: Optional[GlobalPattern] = None
        self.x: Optional[torch.Tensor] = None           # [L+1, bfs]
        self.dx: Optional[torch.Tensor] = None
        self.state: Optional[dict] = None
        self._k_linear = None
        self._res_k = None
        self._run_phase = None
        self._compiled_wps: List[CompiledWP] = []
        self._device_maps: Dict[str, dict] = {}
        # freezes (freeze_linear_tangent, freeze_refined_residual,
        # setup_mg) and the multigrid occupancy mask
        self._k_linear_td: Optional[torch.Tensor] = None
        self._refined: Optional[dict] = None
        self._mg_hier = None
        self._mg_frozen: Optional[tuple] = None
        self._mg_mask: Optional[torch.Tensor] = None
        self._mg_spectrum: Optional[Tuple[float, float]] = None
        self._mg_cheb = None
        # the auxiliary-space multigrid (setup_auxmg): (tree, (desc,
        # hier)), its preconditioned spectrum and Chebyshev enclosure
        self._auxmg: Optional[tuple] = None
        self._auxmg_spectrum: Optional[Tuple[float, float]] = None
        self._auxmg_cheb = None
        self._auxmg_timings: dict = {}   # seconds per part of setup_auxmg
        self._jit_step = None
        # the host float64 caches shared by the one-time freezes, the
        # CPU copies of the reduction maps they run with, and whether
        # free_volume_tables released the volume tables
        self._host_wp64_cache: Optional[list] = None
        self._host_lin_td64_cache: Optional[List[np.ndarray]] = None
        self._host_maps: Dict[str, dict] = {}
        self._volume_tables_freed = False

    def _tensor(self, arr, dtype=None, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype or self.dtype,
                               device=device or self.device)

    @property
    def user_state(self) -> dict:
        """User state passed to registered callbacks that declare a
        ``user`` parameter (e.g. plasticity history per quadrature
        point).  On assignment every array value (numpy or tensor)
        becomes a tensor on the domain's device, floating arrays in the
        domain's dtype, so no assembly copies the state from the host
        again; other values stay as they are.  Assign a new dict to
        change it."""
        return self._user_state

    @user_state.setter
    def user_state(self, value: dict) -> None:
        self._user_state = {k: self._to_device(v) for k, v in value.items()}

    def _to_device(self, v):
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            return v
        t = torch.as_tensor(v)
        if t.is_floating_point():
            t = t.to(self.dtype)
        return t.to(self.device)

    # ------------------------------------------------------------------
    # variable declaration (the @Sym / @External_Sym / @Def analogs)
    # ------------------------------------------------------------------
    def internal_var(self, name: str, *extra_attrs: str) -> SymRef:
        self.registry.declare(name, INTERNAL_VAR, *extra_attrs)
        return SymRef(name, self.registry)

    def external_var(self, name: str, *attrs: str) -> SymRef:
        self.registry.declare(name, EXTERNAL_VAR, *attrs)
        return SymRef(name, self.registry)

    def sym(self, name: str) -> SymRef:
        return SymRef(name, self.registry)

    def define(self, name: str, free_ids: Sequence[str], expr) -> SymRef:
        """The @Def analog: record a named definition (possibly tensorial
        with the given free indices).  For a declared integration-point
        variable the RHS is a user function returning all components at
        once, so the free-index check is skipped."""
        if INTEGRATION_POINT_VAR in self.registry.attributes(name):
            self.tensor_table.define_raw(name, list(free_ids), as_term(expr))
        else:
            self.tensor_table.define(name, list(free_ids), as_term(expr))
        return SymRef(name, self.registry)

    def register_function(self, name: str, fn: Callable) -> None:
        """User callbacks referenced by name in weak forms (the analog of
        Main.$op dispatch, symbolics/08_Tensor.jl:210).  A callback that
        declares a ``user`` parameter receives ``user_state``."""
        self.functions[name] = fn

    # ------------------------------------------------------------------
    # geometry / physics wiring
    # ------------------------------------------------------------------
    def add_workpiece(self, geo: GeoMesh) -> int:
        if geo.dim != self.dim:
            raise ValueError("workpiece dimension mismatch")
        self.workpieces.append(WorkPiece(geo=geo))
        return len(self.workpieces) - 1

    def add_boundary(self, wp_id: int, facet_ids) -> int:
        wp = self.workpieces[wp_id]
        bg_id = len(wp.boundary_facets)
        wp.boundary_facets[bg_id] = np.asarray(facet_ids, dtype=np.int64)
        return bg_id

    def assign_workpiece_weakform(self, wp_id: int, expr) -> None:
        self.workpieces[wp_id].domain_forms = build_weakform(
            self.tensor_table, as_term(expr))

    def assign_boundary_weakform(self, wp_id: int, bg_id: int, expr) -> None:
        self.workpieces[wp_id].boundary_forms[bg_id] = build_weakform(
            self.tensor_table, as_term(expr))

    # ------------------------------------------------------------------
    # compilation pipeline
    # ------------------------------------------------------------------
    def initialize_local_assembly(self,
                                  explicit_max_sd_order: int = 9) -> None:
        for wp in self.workpieces:
            wp.local_assembly = initialize_local_assembly(
                self.tensor_table, wp.domain_forms, wp.boundary_forms,
                extra_vars=wp.extra_vars,
                explicit_max_sd_order=explicit_max_sd_order)

    def mesh_classical(self, wp_ids: Optional[Sequence[int]] = None,
                       itp_order: int = 1, itg_order: int = 2,
                       itp_type: str = "Lagrange",
                       lattice_pad: int = 1) -> None:
        """Build element tables + runtime mesh (mesh_Classical,
        unstructured_mesh/2_Interface.jl:7-39).

        ``lattice_pad``: round the leading lattice axis up to a multiple
        (ghost planes), or on an unstructured mesh the control-point
        count (ghost control points), so that the DOF vector and the
        storage split evenly over that many ranks: pass the rank count
        when the domain will be row-sharded (parallel/rowshard.py)."""
        ids = range(len(self.workpieces)) if wp_ids is None else wp_ids
        for wp_id in ids:
            wp = self.workpieces[wp_id]
            if wp.local_assembly is None:
                raise RuntimeError("call initialize_local_assembly first")
            wp.disc = initialize_classical_element(
                self.dim, wp.geo.shape, itp_order,
                wp.local_assembly.max_sd_order, itg_order, itp_type)
            wp.mesh = build_wp_mesh(wp.geo, wp.disc, wp.boundary_facets,
                                    lattice_pad=lattice_pad)
            # coordinate columns (built-in controlpoint vars x, y, z)
            for d in range(self.dim):
                wp.mesh.fields[_COORD_NAMES[d]] = wp.mesh.cp_coords[:, d]
            # DOF columns + external controlpoint columns, zero-initialized
            for (local_sym, _, _) in wp.local_assembly.local_innervar_infos:
                wp.mesh.field(local_sym)
            for name in wp.local_assembly.controlpoint_extervars:
                wp.mesh.field(name)
            # group each boundary's facets by local face index
            wp.bdy_parts = {}
            for bg_id, grp_f in wp.boundary_facets.items():
                els = wp.geo.facet_elements[grp_f, 0]
                eis = wp.geo.facet_eindex[grp_f, 0]
                wp.bdy_parts[bg_id] = [
                    (int(ei), els[eis == ei].astype(np.int64))
                    for ei in np.unique(eis)]

    def assemble_global_variables(self, **layout_opts) -> None:
        """``layout_opts`` forward to block_offset.build_offset_layout
        (e.g. dense_min_n, or blk_b / blk_min_tail for the BSR tail of
        unstructured meshes)."""
        meshes = [wp.mesh for wp in self.workpieces]
        assemblies = [wp.local_assembly for wp in self.workpieces]
        self.pattern = build_global_pattern(meshes, assemblies,
                                            **layout_opts)
        self.assemble_x()
        self.dx = torch.zeros_like(self.x)

    def compile(self) -> None:
        """Build the two updaters and every reduction map (the
        compile_Updater_GPU analog): lattice strided reads and adds where
        a stream is affine in the lattice index, gather maps for the
        rest, the ghost-row regularizer, then the geometry tables."""
        if self.pattern is None:
            self.assemble_global_variables()
        self._compiled_wps = [
            CompiledWP(disc=wp.disc, la=wp.local_assembly,
                       info=self.pattern.wp_infos[i],
                       bdy_parts=wp.bdy_parts,
                       el_cp=wp.mesh.el_cp.astype(np.int64),
                       lattice_shape=wp.mesh.lattice_shape)
            for i, wp in enumerate(self.workpieces)]
        self._fast_maps = {"gather": {}}
        self._k_linear, self._res_k, self._run_phase = make_updaters(
            self.tensor_table, self._compiled_wps, self.pattern,
            self.functions, fast_maps=self._fast_maps)
        # lattice node-gather fast path: el_cp columns as strided slices
        for w_i, wp in enumerate(self.workpieces):
            fs_list = gather_fast_maps(wp.mesh.el_cp, wp.mesh.lattice_shape,
                                       wp.mesh.n_cp)
            if fs_list is not None:               # node reads need ALL
                self._fast_maps["gather"][w_i] = fs_list
        self._device_maps = {}
        self._ensure_device_maps("lin", "nl")
        self._ghost_diag = self._ghost_diag_vector()
        # occupancy mask of the multigrid transfers (single lattice
        # workpiece with ghost slots)
        self._mg_mask = (multigrid.mask_for_domain(self)
                         if len(self.workpieces) == 1 else None)
        self.update_mesh()
        if self.linear_solver is None:
            self.linear_solver = self.make_iterative_solver()

    def _ensure_device_maps(self, *phases) -> None:
        """Build the reduction maps of the given assembly phases on the
        domain's device (idempotent)."""
        for ph in phases:
            if ph not in self._device_maps:
                self._device_maps[ph] = self._build_phase_maps(ph)

    def _phase_maps(self, device, *phases) -> dict:
        """The reduction maps of ``phases`` on ``device``: the domain's
        own on its device, CPU copies kept in ``_host_maps`` for the host
        freezes of a CUDA domain."""
        if torch.device(device) == self.device:
            self._ensure_device_maps(*phases)
            return self._device_maps
        for ph in phases:
            if ph not in self._host_maps:
                self._host_maps[ph] = self._build_phase_maps(ph, device)
        return self._host_maps

    def _build_phase_maps(self, phase_key: str, device=None) -> dict:
        """Reduction maps of one assembly phase (``build_phase_maps``):
        lattice strided adds (into self._fast_maps) where a stream's slot
        columns are affine in the lattice index, gather maps on
        ``device`` (the domain's by default; returned) for the rest."""
        streams = collect_phase_streams(
            self._compiled_wps, self.pattern, phase_key)
        fast, entry = build_phase_maps(streams, self._compiled_wps,
                                       self.pattern, device or self.device)
        self._fast_maps[phase_key] = fast
        return entry

    def _ghost_diag_vector(self) -> Optional[torch.Tensor]:
        """Unit-diagonal regularizer for ghost (unoccupied lattice) DOF
        rows; None when every control point is occupied."""
        lo = self.pattern.offset_layout
        vec = np.zeros(self.pattern.n_storage, dtype=np.float64)
        any_ghost = False
        for wp, info in zip(self.workpieces, self.pattern.wp_infos):
            occ = wp.mesh.is_occupied
            if occ is None or occ.all():
                continue
            any_ghost = True
            ghost_cp = np.nonzero(~occ)[0]
            for pos in range(info.n_vars):
                rows = info.dof_offset + pos * info.n_cp + ghost_cp
                vec[lo.diag_storage[rows]] = 1.0
        return self._tensor(vec) if any_ghost else None

    def make_iterative_solver(self, sv_func=None, precond=None,
                              **kwargs) -> Callable:
        """The reference's iterative_Solve! behavior: right-Jacobi scaled
        Krylov (02_Preconditioner.jl:30-78), BiCGStab by default.  Each
        pass's (iterations, true residual) lands in ``self.solve_log``.
        ``precond='auxmg'``: auxiliary-space multigrid (auxmg.py) as the
        right preconditioner; call ``setup_auxmg()`` first.  The frozen
        aux hierarchy is combined with each tangent's values and
        diagonal (``auxmg.refresh_tangent``)."""
        sv_func = sv_func or krylov.bicgstab
        kwargs.setdefault("maxiter", 2000)
        kwargs.setdefault("max_pass", 10)
        if precond == "auxmg":
            from ..linsolve import auxmg

            def solve_aux(A, b):
                if self._auxmg is None:
                    raise RuntimeError("call domain.setup_auxmg() first")
                tree, (desc, hier) = self._auxmg
                op = auxmg.AuxMGOperator(
                    A, auxmg.refresh_tangent(A, tree, desc), hier, desc)
                y = iterative_solve(op, b, None,
                                    converge_tol=self.converge_tol,
                                    sv_func=sv_func, use_pr_jacobi=False,
                                    log=self.solve_log, **kwargs)
                return op.apply_m(y)
            return solve_aux
        if precond is not None:
            raise ValueError(f"unknown precond {precond!r}")

        def solve(A, b):
            return iterative_solve(A, b, None, converge_tol=self.converge_tol,
                                   sv_func=sv_func, log=self.solve_log,
                                   **kwargs)
        return solve

    def make_direct_solver(self) -> Callable:
        """Sparse LU on the host (solver_lu); x comes back on the
        domain's device."""
        return lambda A, b: solver_lu(A, b)

    # ------------------------------------------------------------------
    # runtime state
    # ------------------------------------------------------------------
    def _geometry_state(self, dtype=None, volume: bool = True,
                        device=None) -> list:
        """Geometry tables per workpiece on ``device`` (the domain's by
        default), computed from the host coordinates in ``dtype`` (the
        domain's by default).  ``volume=False`` skips the element tables
        (boundary-only views for the refined step's nonaffine
        remainder)."""
        wp_states = []
        for wp in self.workpieces:
            coords = self._tensor(wp.mesh.cp_coords, dtype, device)
            el_cp = self._tensor(wp.mesh.el_cp, torch.int64, device)
            el_state = None
            if volume:
                itg_vals, itg_w = update_element_geometry(coords, el_cp,
                                                          wp.disc)
                el_state = {"itg_vals": itg_vals, "weights": itg_w,
                            "el_cp": el_cp}
            bdy_state: Dict[int, list] = {}
            for bg_id, parts in wp.bdy_parts.items():
                plist = []
                for (ei, els) in parts:
                    el_cp_f = el_cp[self._tensor(els, torch.int64, device)]
                    f_vals, f_w, f_n = update_facet_geometry(
                        coords, el_cp_f, wp.disc, ei)
                    plist.append({"itg_vals": f_vals, "weights": f_w,
                                  "normals": f_n, "el_cp": el_cp_f})
                bdy_state[bg_id] = plist
            wp_states.append({"el": el_state, "bdy": bdy_state,
                              "fields": {}})
        return wp_states

    def update_mesh(self) -> None:
        """(Re)compute geometry tables into the runtime state (update_Mesh
        analog); volume tables released by free_volume_tables come back."""
        self.drop_host_caches()
        self.state = {"wp": self._geometry_state()}
        self._volume_tables_freed = False
        self.refresh_fields()

    def refresh_fields(self) -> None:
        """Re-upload the named controlpoint columns (call after mutating
        mesh fields)."""
        self.drop_host_caches()
        for wps, fields in zip(self.state["wp"], self._fields()):
            wps["fields"] = fields

    def set_field(self, wp_id: int, name: str, values) -> None:
        self.drop_host_caches()
        self.workpieces[wp_id].mesh.set_field(name, values)

    def _fields(self, dtype=None, device=None) -> list:
        """Named controlpoint columns per workpiece, in ``dtype`` on
        ``device`` (the domain's by default)."""
        return [{name: self._tensor(col, dtype, device)
                 for name, col in wp.mesh.fields.items()}
                for wp in self.workpieces]

    # ------------------------------------------------------------------
    # shared host-f64 freeze caches
    # ------------------------------------------------------------------
    def drop_host_caches(self) -> None:
        """Invalidate the cached host float64 geometry and field tables
        and linear-tangent components shared by the one-time freezes
        (freeze_linear_tangent(on_host=True), freeze_refined_residual,
        _host_tangent).  Called whenever mesh fields change; call it to
        reclaim host memory after the freezes are done."""
        self._host_wp64_cache = None
        self._host_lin_td64_cache = None

    def _host_wp64(self) -> list:
        """float64 geometry and field tables on the CPU, cached: every
        host freeze reads the same tables.  Invalidated by
        refresh_fields, set_field, dessemble_x and update_mesh."""
        if self._host_wp64_cache is None:
            self._host_wp64_cache = self._f64_tables(device=_CPU)
        return self._host_wp64_cache

    def _host_lin_td64(self) -> List[np.ndarray]:
        """Per-time-level float64 linear tangent components (one 'lin'
        assembly each, one-hot K_params) on the CPU, cached as numpy
        arrays.  Each still holds the ghost regularizer when there is
        one (the 'lin' phase adds it once per run); consumers subtract
        it by their own combine convention.  Shared by
        freeze_linear_tangent(on_host=True), _host_tangent and, when
        every linear gradient is affine, freeze_refined_residual."""
        if self._host_lin_td64_cache is None:
            st = self._host_phase_state("lin")
            comps = []
            for td in range(self.pattern.max_time_level + 1):
                st["K_params"] = self._one_hot_k_params(td, torch.float64,
                                                        _CPU)
                comps.append(self._run_phase(st, "lin")[1].numpy())
            self._host_lin_td64_cache = comps
        return self._host_lin_td64_cache

    def _all_forms_affine(self) -> bool:
        """True when every linear gradient comes from an affine form:
        then the 'lin' phase and the refined step's 'aff_lin' phase
        assemble the same operator and the host components are shared.
        Nonaffine forms may exist (a T^4 radiation boundary) as long as
        all their gradients are nonlinear."""
        for wp in self.workpieces:
            la = wp.local_assembly
            wfs = ([la.assembled_weakform]
                   + list(la.assembled_boundary_weakform_pairs.values()))
            for wf in wfs:
                aff = wf.affine_form_ids()
                if any(g.form_id not in aff for g in wf.linear_gradients):
                    return False
        return True

    def _host_phase_state(self, *phases: str) -> dict:
        """The runtime state rebuilt in float64 on the CPU from host
        sources (tables from the _host_wp64 cache), with the CPU
        reduction maps of ``phases``, for one-time assemblies of the
        freezes."""
        f64 = torch.float64
        ghost = self._ghost_diag
        return {
            "wp": self._host_wp64(),
            "maps": self._phase_maps(_CPU, *phases),
            "ghost_diag": None if ghost is None else ghost.to(_CPU, f64),
            "x_star": self.x.to(_CPU, f64),
            "t": float(self.t), "dt": float(self.dt or 1.0),
            "K_params": self._tensor(self.time_discretization.K_params,
                                     f64, _CPU),
            "global_vars": {k: float(v)
                            for k, v in self.global_vars.items()},
            "user": {k: v.to(_CPU) if isinstance(v, torch.Tensor) else v
                     for k, v in self.user_state.items()}}

    def _host_tangent(self) -> np.ndarray:
        """The tangent at the current x assembled on the CPU in float64
        (the frozen linear components plus the nonlinear blocks), as
        numpy storage values: the auxiliary-space multigrid's setup
        input, which never needs the volume gather maps on the card."""
        comps = self._host_lin_td64()
        Kp = np.asarray(self.time_discretization.K_params, np.float64)
        ghost = self._ghost_diag
        g64 = (ghost.to(_CPU, torch.float64).numpy() if ghost is not None
               else 0.0)
        K_lin = sum(Kp[td] * (c - g64) for td, c in enumerate(comps))
        K_lin = K_lin + g64
        st = self._host_phase_state("nl")
        return K_lin + self._run_phase(st, "nl")[1].numpy()

    def _coo_dev(self) -> tuple:
        """The tail's row and column ids (block ids under a BSR tail) on
        the domain's device, from the layout's device tables; (None,
        None) when the layout has no tail (lattice meshes)."""
        lo = self.pattern.offset_layout
        if not lo.n_coo:
            return None, None
        t = _device_tables(lo, self.device)
        return t["coo_rows"], t["coo_cols"]

    def _runtime_state(self) -> dict:
        ga = self.time_discretization
        coo_rows, coo_cols = self._coo_dev()
        return {**self.state,
                "coo_rows": coo_rows, "coo_cols": coo_cols,
                "ghost_diag": self._ghost_diag,
                "mg_mask": self._mg_mask,
                "mg_frozen": self._mg_frozen,
                "auxmg_tree": (self._auxmg[0] if self._auxmg is not None
                               else None),
                "K_linear_td": self._k_linear_td,
                "refined": self._refined,
                "maps": self._device_maps,
                "layout": self.pattern.offset_layout,
                "x_star": self.x,
                "K_linear": torch.zeros(self.pattern.n_storage,
                                        dtype=self.dtype, device=self.device),
                "t": self.t, "dt": self.dt,
                "K_params": device_constant(ga.K_params, self.dtype,
                                            self.device),
                "global_vars": {k: float(v)
                                for k, v in self.global_vars.items()},
                "user": self.user_state}

    def assemble_tangent(self) -> Tuple[OffsetMatrix, torch.Tensor]:
        """(tangent as an OffsetMatrix, residue) at the current x, with
        the time parameters of a step of ``self.dt``."""
        self._require_volume_tables("assemble_tangent")
        self.time_discretization.update_time(self.dt,
                                             self.pattern.max_time_level)
        state = self._runtime_state()
        state["K_linear"] = self._k_linear(state)
        residue, K_total = self._res_k(state)
        return (OffsetMatrix.from_values(K_total, self.pattern.offset_layout),
                residue)

    # ------------------------------------------------------------------
    # freezes of the refined step
    # ------------------------------------------------------------------
    def _one_hot_k_params(self, td: int, dtype, device=None) -> torch.Tensor:
        one_hot = np.zeros(self.pattern.max_time_level + 1)
        one_hot[td] = 1.0
        return self._tensor(one_hot, dtype, device)

    def freeze_linear_tangent(self, on_host: Optional[bool] = None) -> None:
        """Precompute the per-time-level linear tangent components G_td
        (x-independent), so the refined step combines them as
        sum(K_params[td] * G_td) instead of re-assembling K_linear.  One
        'lin' assembly per time level with one-hot K_params; the ghost
        diagonal is subtracted (the combine adds it once).

        ``on_host``: assemble the components on the CPU in float64
        (``_host_lin_td64``, cached) and move them to the domain's device
        in its dtype, instead of assembling them there.  None means on
        for any workpiece without a lattice (unstructured meshes, whose
        volume gather maps are too large to ship).

        Valid while geometry, controlpoint fields and global material
        constants stay fixed; call again after changing any of them."""
        if on_host is None:
            on_host = any(wp.mesh.lattice_shape is None
                          for wp in self.workpieces)
        ghost = self._ghost_diag
        if on_host:
            comps = [self._tensor(G) for G in self._host_lin_td64()]
            if ghost is not None:
                comps = [c - ghost for c in comps]
            self._k_linear_td = torch.stack(comps)
            return
        self._require_volume_tables("freeze_linear_tangent")
        state = self._runtime_state()
        comps = []
        for td in range(self.pattern.max_time_level + 1):
            st = dict(state)
            st["K_params"] = self._one_hot_k_params(td, self.dtype)
            G = self._k_linear(st)
            if ghost is not None:
                G = G - ghost     # added once at combine time, not per td
            comps.append(G)
        self._k_linear_td = torch.stack(comps)

    def freeze_refined_residual(self) -> None:
        """Freeze the exact-residual decomposition of the refined step:

            R(x*) = sum_td A_td @ x*[td] + b + R_nonaffine(x*)

        with A_td / b the affine forms' gradients / residues at zero (an
        exact discrete identity: every gradient of an affine form is
        x-independent), assembled once here in float64 on the domain's
        device from float64 geometry, and R_nonaffine the (typically
        boundary-only) remainder that the step re-assembles per
        iteration, also in float64.  A_td and b are stored as float64
        tensors.  When a host freeze already cached the float64 linear
        components (``_host_lin_td64``) and every linear gradient is
        affine, A_td is taken from them.  The float64 volume tables are
        freed afterwards unless a volume form is nonaffine (then the
        remainder needs them).

        For the two-float mode of the refined step it also records
        ``bnd_dofs``, the DOF rows the boundary elements read (None when
        a volume form is nonaffine), and, on a float32 domain with a
        nonaffine volume form, ``wp_df``: the float64 tables split into
        DF pairs (``df_lowering.df_tables``).  The DF split of A_td and
        b is made at the first two-float step and kept here.

        Same validity contract as freeze_linear_tangent."""
        host = self._host_lin_td64_cache
        from_host = host is not None and self._all_forms_affine()
        # the 'aff_lin' maps only when A_td is assembled here
        self._ensure_device_maps(*(() if from_host else ("aff_lin",)),
                                 "aff_res", "nonaff_nl")
        f64 = torch.float64
        L = self.pattern.max_time_level
        wp64 = self._f64_tables()
        st = {"wp": wp64, "maps": self._device_maps, "ghost_diag": None,
              "x_star": torch.zeros((L + 1, self.pattern.basicfield_size),
                                    dtype=f64, device=self.device),
              "t": float(self.t), "dt": float(self.dt),
              "global_vars": {k: float(v)
                              for k, v in self.global_vars.items()},
              "user": self.user_state}
        if from_host:
            # aff_lin == lin: each host component holds the ghost
            # regularizer once, which the refined operator excludes
            ghost = self._ghost_diag
            g64 = (ghost.to(_CPU, f64).numpy() if ghost is not None
                   else 0.0)
            A = torch.stack([self._tensor(c - g64, f64) for c in host])
        else:
            A_list = []
            for td in range(L + 1):
                st["K_params"] = self._one_hot_k_params(td, f64)
                A_list.append(self._run_phase(st, "aff_lin")[1])
            A = torch.stack(A_list)
        st["K_params"] = self._tensor(np.ones(L + 1), f64)
        b64 = self._run_phase(st, "aff_res")[0]
        del st
        self._refined = self._refined_record(A, b64, wp64)

    def _vol_nonaffine(self) -> bool:
        """True when a volume weak form has a nonaffine residue."""
        return any(
            wp.local_assembly.assembled_weakform.affine_form_ids()
            != {r.form_id
                for r in wp.local_assembly.assembled_weakform.residues}
            for wp in self.workpieces)

    def _refined_record(self, A: torch.Tensor, b: torch.Tensor,
                        wp64: Optional[list] = None) -> dict:
        """The frozen operator of the refined step: float64 A_td and b,
        the float64 tables of its nonaffine remainder, and the two-float
        mode's ``bnd_dofs`` and ``wp_df``."""
        wp = self._refined_tables(wp64)
        vol_nonaff = self._vol_nonaffine()
        wp_df = None
        if vol_nonaff and self.dtype == torch.float32:
            wp_df = df_tables(wp)
        return {"A": A, "b": b, "wp": wp, "wp_df": wp_df,
                "bnd_dofs": None if vol_nonaff else self._boundary_dofs()}

    def _boundary_dofs(self) -> torch.Tensor:
        """The DOF rows the boundary elements read (the union of their
        control points over every variable), sorted, int64 on the
        device: the two-float step evaluates the boundary-only nonaffine
        remainder in float64 at these rows only."""
        dofs = []
        for wp, info in zip(self.workpieces, self.pattern.wp_infos):
            cps = [els for parts in wp.bdy_parts.values()
                   for (_, els) in parts]
            if not cps:
                continue
            cp_set = np.unique(wp.mesh.el_cp[np.concatenate(cps)].reshape(-1))
            for pos in range(info.n_vars):
                dofs.append(info.dof_offset + pos * info.n_cp + cp_set)
        rows = (np.unique(np.concatenate(dofs)) if dofs
                else np.zeros(0, np.int64))
        return torch.as_tensor(rows.astype(np.int64), device=self.device)

    def _f64_tables(self, volume: bool = True, device=None) -> list:
        """float64 geometry tables and fields on ``device`` (the
        domain's by default)."""
        wp64 = self._geometry_state(torch.float64, volume=volume,
                                    device=device)
        for wps, fields in zip(wp64, self._fields(torch.float64, device)):
            wps["fields"] = fields
        return wp64

    def _refined_tables(self, wp64: Optional[list] = None) -> list:
        """The float64 tables the refined step's nonaffine remainder
        reads.  When every volume form is affine the remainder is
        boundary-only: the float64 volume tables are dropped and the
        (unused) volume entry points at the working-precision ones."""
        vol_nonaff = self._vol_nonaffine()
        if wp64 is None:
            wp64 = self._f64_tables(volume=vol_nonaff)
        if vol_nonaff:
            return wp64
        return [{**w64, "el": wps["el"]}
                for w64, wps in zip(wp64, self.state["wp"])]

    def setup_mg(self, tune: bool = True, **mg_opts) -> None:
        """Build the geometric-multigrid state once from the tangent at
        the current x, for refined steps with ``precond='mg'``.

        ``tune=False`` skips the preconditioned-spectrum estimate and the
        Chebyshev enclosure scan; use it when the tangent at the current
        x is not the one production steps around (before a converge-once
        pass with an adaptive Krylov inner solver) and tune once at the
        converged state instead."""
        self._require_volume_tables("setup_mg")
        hier = multigrid.hierarchy_for_domain(self, **mg_opts)
        self._mg_hier = hier    # steps must reuse the SAME hierarchy
        ga = self.time_discretization
        ga.update_time(self.dt or 1.0, self.pattern.max_time_level)
        state = self._runtime_state()
        state["K_linear"] = self._k_linear(state)
        # the tangent in the DOMAIN dtype even when x is carried in f64
        state["x_star"] = self.x.to(self.dtype)
        _, K_total = self._res_k(state)
        A = OffsetMatrix.from_values(K_total.to(self.dtype),
                                     self.pattern.offset_layout)
        self._mg_frozen = multigrid.mg_setup(hier, A, self._mg_mask)
        self._mg_spectrum = self._mg_cheb = None
        if not tune:
            return
        op = multigrid.MGOperator(A, self._mg_frozen, hier)
        n = self.pattern.basicfield_size
        self._mg_spectrum = multigrid.estimate_spectrum(op, n, self.dtype)
        self._mg_cheb = multigrid.tune_chebyshev(op, n, self.dtype,
                                                 self._mg_spectrum)

    def setup_auxmg(self, **opts) -> None:
        """Freeze the auxiliary-space multigrid preconditioner (for
        unstructured meshes: the counterpart of setup_mg) from the
        tangent at the current x, assembled on the CPU in float64
        (``_host_tangent``: the Galerkin build consumes it on the host,
        and the volume gather maps never need the card).  Consumed by
        ``make_iterative_solver(precond='auxmg')`` and
        ``make_refined_step(precond='auxmg')``; valid while that tangent
        stays representative (linear problems: exact).  ``opts`` forward
        to auxmg.setup (smooth, h, radius, nu1, nu2, n_power, starts,
        verbose).  The seconds of each part land in ``_auxmg_timings``:
        "host_tangent" and those of auxmg.setup."""
        from ..linsolve import auxmg
        ga = self.time_discretization
        ga.update_time(self.dt or 1.0, self.pattern.max_time_level)
        t0 = time.perf_counter()
        K = self._host_tangent()
        host_s = time.perf_counter() - t0
        self._auxmg = auxmg.setup(self, K, **opts)
        self._auxmg_timings = {"host_tangent": host_s,
                               **self._auxmg_timings}

    # ------------------------------------------------------------------
    # freeze persistence: repeated runs of one problem reload the
    # freezes instead of computing them
    # ------------------------------------------------------------------
    #: the freezes save_freezes writes
    _FREEZE_ATTRS = ("_k_linear_td", "_refined", "_auxmg", "_auxmg_cheb",
                     "_auxmg_spectrum", "_mg_frozen", "_mg_hier",
                     "_mg_cheb", "_mg_spectrum")

    def save_freezes(self, path: str) -> None:
        """Write the production freezes (linear tangent components, the
        refined float64 operator, the multigrid state and its tuned
        spectrum) to ``path`` as a pickle of numpy arrays and plain
        Python objects, with the storage layout's fingerprint.  Not
        written: the volume tables the refined record shares with the
        runtime state, its float64 field columns (both rebuilt from the
        live domain on load), pack plans and packed values, device
        constants and gather maps (all rebuilt at first use).  The
        validity contract is the caller's: reload only for the same
        mesh, weak forms, fields and global constants."""
        blob = {}
        for name in self._FREEZE_ATTRS:
            val = getattr(self, name, None)
            if val is None:
                continue
            if name == "_refined":
                val = self._refined_to_save(val)
            blob[name] = _to_host(val)
        blob["_layout_fp"] = self._layout_fp()
        with open(path, "wb") as f:
            pickle.dump(blob, f, protocol=4)

    def _refined_to_save(self, ref: dict) -> dict:
        """The refined record with the sentinels of save_freezes in place
        of the state's volume tables and the float64 fields, and without
        what the steps derive from the freeze (the float64 residual's
        matrices, the two-float mode's packed pairs, and those of other
        row windows)."""
        ref = {k: v for k, v in ref.items()
               if k not in ("A_mats", "A_packed", "windows")}
        if ref.get("wp") is not None:
            wp = []
            for w, wps in zip(ref["wp"], self.state["wp"]):
                w = dict(w)
                if w.get("el") is not None and w["el"] is wps["el"]:
                    w["el"] = _STATE_EL
                if isinstance(w.get("fields"), dict):
                    w["fields"] = _MESH_FIELDS64
                wp.append(w)
            ref["wp"] = wp
        return ref

    def _layout_fp(self) -> tuple:
        """The storage layout's fingerprint: (DOF count, stored values,
        dense values, BSR tail block size), plus the tail's storage
        order version when there is a BSR tail."""
        lo = self.pattern.offset_layout
        fp = (self.pattern.basicfield_size, lo.n_storage, lo.n_dense,
              lo.blk_b)
        if lo.blk_b:
            fp += ("tail-cm2",)
        return fp

    def load_freezes(self, path: str) -> None:
        """Counterpart of save_freezes: restore the freezes onto the
        domain's device, each array in the dtype it was saved in.  The
        refined record's volume tables are the live state's (re-attached
        by identity; a full copy in an older file is dropped, not
        loaded) unless a volume form is nonaffine, and its float64
        fields are rebuilt from the mesh.  Raises StaleFreezeCache (a
        ValueError) when the file was saved under another layout."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        fp = self._layout_fp()
        saved_fp = blob.pop("_layout_fp", None)
        if saved_fp is not None and tuple(saved_fp) != fp:
            raise StaleFreezeCache(
                f"load_freezes: stale cache {path}: saved layout "
                f"{tuple(saved_fp)} != current {fp}; recompute the freezes")
        layout = self.pattern.offset_layout
        # with an affine volume the record's volume tables alias the
        # state's, so any table in the file is a copy of those
        shares_el = not self._vol_nonaffine()
        for name, val in blob.items():
            attach, refields = [], []
            if name == "_refined" and val.get("wp") is not None:
                val = dict(val)
                val["wp"] = [dict(w) for w in val["wp"]]
                for i, w in enumerate(val["wp"]):
                    el = w.get("el")
                    if el is not None and (shares_el or _is_tag(el,
                                                                _STATE_EL)):
                        w["el"] = None
                        attach.append(i)
                    if _is_tag(w.get("fields"), _MESH_FIELDS64):
                        w["fields"] = None
                        refields.append(i)
            val = _to_device(val, self.device, layout)
            for i in attach:
                val["wp"][i]["el"] = self.state["wp"][i]["el"]
            if refields:
                fields64 = self._fields(torch.float64)
                for i in refields:
                    val["wp"][i]["fields"] = fields64[i]
            setattr(self, name, val)

    def free_volume_tables(self) -> None:
        """Release the volume element tables
        (``state['wp'][i]['el']['itg_vals'/'weights']``; ``el_cp``
        stays) for refined stepping of physics whose volume forms are all
        affine: the refined step reads the frozen A_td and b and the
        boundary-only nonaffine phases, so the tables are dead device
        memory.  Call after ``freeze_refined_residual()``;
        ``update_mesh()`` rebuilds them.  Paths that assemble volume
        integrals refuse to run in between."""
        ref = self._refined
        if ref is None:
            raise RuntimeError("call freeze_refined_residual() first")
        if ref.get("wp_df") is not None or self._vol_nonaffine():
            raise RuntimeError(
                "free_volume_tables: volume-nonaffine physics evaluates "
                "volume residues per iteration; the tables are live")
        for i, wps in enumerate(self.state["wp"]):
            if wps.get("el") is not None:
                wps["el"] = {**wps["el"], "itg_vals": None, "weights": None}
            if ref.get("wp") is not None and \
                    ref["wp"][i].get("el") is not None:
                ref["wp"][i] = {**ref["wp"][i], "el": wps["el"]}
        self._volume_tables_freed = True

    def _require_volume_tables(self, what: str) -> None:
        """Fail fast, instead of deep inside assembly, when a path that
        assembles volume integrals runs after free_volume_tables()."""
        if self._volume_tables_freed:
            raise RuntimeError(
                f"{what} assembles volume integrals, but the volume "
                "element tables were released by free_volume_tables(); "
                "call update_mesh() to rebuild them (or keep to the "
                "refined step, which does not need them)")

    def make_jitted_step(self, **kwargs):
        """The whole Newton step in one call (see
        jit_step.make_jitted_step; a host loop in PyTorch):

            step = dom.make_jitted_step(sv_func=krylov.bicgstab)
            x, dx, res, iters = step(dom._runtime_state(), dom.x, t, dt)
        """
        self._require_volume_tables("make_jitted_step")
        from .jit_step import make_jitted_step
        return make_jitted_step(self, **kwargs)

    def make_refined_step(self, **kwargs):
        """Exact-f64-residual Newton step at working-precision solve cost
        (see jit_step.make_refined_step).  Call freeze_linear_tangent(),
        freeze_refined_residual() and setup_mg() first."""
        from .jit_step import make_refined_step
        return make_refined_step(self, **kwargs)

    def update_one_step_jit(self, max_iter: int = 4, **kwargs) -> float:
        """One step through make_jitted_step (built at the first call
        with ``max_newton=max_iter`` and ``kwargs``, then reused); each
        solver pass's (iterations, true residual) lands in
        ``self.solve_log``."""
        self._require_volume_tables("update_one_step_jit")
        if self._jit_step is None:
            kwargs.setdefault("log", self.solve_log)
            self._jit_step = self.make_jitted_step(max_newton=max_iter,
                                                   **kwargs)
        self.t += self.dt
        x, dx, res, _ = self._jit_step(self._runtime_state(), self.x,
                                       self.t, self.dt)
        self.x, self.dx = x, dx
        return float(res)

    # ------------------------------------------------------------------
    # the hot loop (update_OneStep!, solver/04_Time_Domain.jl:59-80)
    # ------------------------------------------------------------------
    def update_one_step(self, max_iter: int = 4,
                        verbose: bool = False) -> float:
        ga = self.time_discretization
        L = self.pattern.max_time_level
        self._require_volume_tables("update_one_step")
        self.t += self.dt
        ga.update_time(self.dt, L)
        state = self._runtime_state()
        dx = initialize_dx(self.x, self.dt, ga.gamma_params)
        state["K_linear"] = self._k_linear(state)
        res = np.inf
        for counter in range(max_iter + 1):
            state["x_star"] = x_star_of(self.x, dx, ga.alpha_params)
            residue, K_total = self._res_k(state)
            res = normalized_norm(residue)
            if verbose:
                print(f"step iteration {counter}: residue = {res:.6e}")
            if res < self.converge_tol or counter >= max_iter:
                break
            A = OffsetMatrix.from_values(K_total,
                                         self.pattern.offset_layout)
            delta_x = self.linear_solver(A, residue)
            dx = update_dx(dx, -delta_x, ga.beta_params)
        self.x = self.x + dx
        self.dx = dx
        return res

    # ------------------------------------------------------------------
    # integration-point evaluation (for history-variable return maps)
    # ------------------------------------------------------------------
    def evaluate_at_itg(self, wp_id: int, expr) -> torch.Tensor:
        """Evaluate a (scalar, concrete-index) expression at the domain
        quadrature points of a workpiece using the current solution x:
        returns [n_el, n_itg] on the domain's device.  This is how user
        code recomputes converged integration-point quantities to update
        history state (replacing MetaFEM.jl's in-callback mutation,
        J2Plasticity.jl:201-208)."""
        self._require_volume_tables("evaluate_at_itg")
        term = as_term(expr)
        if free_index(term):
            raise ValueError("evaluate_at_itg expects concrete indices")
        term = unroll_and_simplify(term, self.dim)
        tb = self.tensor_table
        la = self.workpieces[wp_id].local_assembly
        inner, exter = extract_words(tb, term)
        inner_infos = [_innervar_info(self.dim, w, la.bvar_mapping)
                       for w in inner]
        exter_infos = [_extervar_info(self.dim, w) for w in exter]
        wp_state = self.state["wp"][wp_id]
        env = _build_env(tb, wp_state, wp_state["el"],
                         self._compiled_wps[wp_id], inner_infos,
                         exter_infos, self.x, self.t, self.dt,
                         {k: float(v) for k, v in self.global_vars.items()},
                         is_boundary=False)
        ctx = LoweringContext(tb, env, self.functions,
                              user_state=self.user_state)
        return ctx.lower(term)

    # ------------------------------------------------------------------
    # state sync (assemble_X! / dessemble_X!)
    # ------------------------------------------------------------------
    def assemble_x(self) -> None:
        meshes = [wp.mesh for wp in self.workpieces]
        assemblies = [wp.local_assembly for wp in self.workpieces]
        self.x = self._tensor(assemble_x(meshes, assemblies, self.pattern))

    def dessemble_x(self) -> None:
        meshes = [wp.mesh for wp in self.workpieces]
        assemblies = [wp.local_assembly for wp in self.workpieces]
        dessemble_x(self.x.cpu().numpy(), meshes, assemblies, self.pattern)
        self.drop_host_caches()   # solution columns live in mesh.fields
