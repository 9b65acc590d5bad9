"""FEM_Domain: the user-facing problem object of the PyTorch port.

Port of the README subset of ``metafem/solver/domain.py`` (the analog of
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

Not ported yet: the two-float residual mode, the jitted step, the
auxiliary-space multigrid, direct solvers, integration-point evaluation,
freeze persistence and checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..elements.discretization import (ClassicalDiscretization,
                                       initialize_classical_element)
from ..linsolve import krylov, multigrid
from ..linsolve.block_offset import OffsetMatrix
from ..linsolve.driver import iterative_solve
from ..mesh.fem_mesh import WPMesh, build_wp_mesh
from ..mesh.ref_geometry import GeoMesh
from ..symbolics.api import SymRef, as_term
from ..symbolics.registry import (EXTERNAL_VAR, INTEGRATION_POINT_VAR,
                                  INTERNAL_VAR, VariableRegistry)
from ..symbolics.tensor_table import TensorTable
from ..symbolics.weakform import BilinearForm, build_weakform
from .assembly import CompiledWP, collect_phase_streams, make_updaters
from .geometry import update_element_geometry, update_facet_geometry
from .global_assembly import (GlobalPattern, assemble_x, build_global_pattern,
                              dessemble_x)
from .lattice_reduce import fit_stream_columns
from .local_assembly import LocalAssembly, initialize_local_assembly
from .scatter import build_compact_gather_reduce, maps_to_device
from .time_domain import (GeneralAlpha, initialize_dx, normalized_norm,
                          update_dx, x_star_of)

_COORD_NAMES = ("x", "y", "z")


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
        #: user state passed to registered callbacks declaring ``user``
        self.user_state: dict = {}
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

    def _tensor(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype or self.dtype,
                               device=self.device)

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
                       itp_type: str = "Lagrange") -> None:
        """Build element tables + runtime mesh (mesh_Classical,
        unstructured_mesh/2_Interface.jl:7-39)."""
        ids = range(len(self.workpieces)) if wp_ids is None else wp_ids
        for wp_id in ids:
            wp = self.workpieces[wp_id]
            if wp.local_assembly is None:
                raise RuntimeError("call initialize_local_assembly first")
            wp.disc = initialize_classical_element(
                self.dim, wp.geo.shape, itp_order,
                wp.local_assembly.max_sd_order, itg_order, itp_type)
            wp.mesh = build_wp_mesh(wp.geo, wp.disc, wp.boundary_facets)
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
        (e.g. dense_min_n)."""
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
        if self.pattern.offset_layout.blk_b:
            raise NotImplementedError(
                "meshes whose block-offset layout needs a BSR tail are not "
                "ported yet")
        self._compiled_wps = [
            CompiledWP(disc=wp.disc, la=wp.local_assembly,
                       info=self.pattern.wp_infos[i],
                       bdy_parts=wp.bdy_parts,
                       el_cp=wp.mesh.el_cp.astype(np.int64))
            for i, wp in enumerate(self.workpieces)]
        self._fast_maps = {"gather": {}}
        self._k_linear, self._res_k, self._run_phase = make_updaters(
            self.tensor_table, self._compiled_wps, self.pattern,
            self.functions, fast_maps=self._fast_maps)
        # lattice node-gather fast path: el_cp columns as strided slices
        for w_i, wp in enumerate(self.workpieces):
            mesh = wp.mesh
            if mesh.lattice_shape is None:
                continue
            n_cp = mesh.n_cp

            def in_block(slot, n_cp=n_cp):
                return 0 if 0 <= slot < n_cp else None

            fs_list, rest_cols = fit_stream_columns(
                mesh.el_cp.astype(np.int64), mesh.lattice_shape, in_block)
            if fs_list and rest_cols.size == 0:   # node reads need ALL
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

    def _build_phase_maps(self, phase_key: str) -> dict:
        """Reduction maps of one assembly phase: lattice strided adds
        (into self._fast_maps) where a stream's slot columns are affine in
        the lattice index, device gather maps (returned) for the rest."""
        seg_bases = np.asarray(
            [s[4] for s in self.pattern.offset_layout.segments])
        seg_ncp = np.asarray(
            [s[2] for s in self.pattern.offset_layout.segments])
        order = np.argsort(seg_bases)
        seg_bases, seg_ncp = seg_bases[order], seg_ncp[order]

        def k_block_of(slot):
            j = np.searchsorted(seg_bases, slot, side="right") - 1
            if j < 0 or slot >= seg_bases[j] + seg_ncp[j]:
                return None
            return int(seg_bases[j])

        streams = collect_phase_streams(
            self._compiled_wps, self.pattern, phase_key)
        fast = {"r": {}, "k": {}}
        rest = {"r": [], "k": []}
        counters = {"r": 0, "k": 0}
        for s in streams:
            kind = s["kind"]
            si = counters[kind]
            counters[kind] += 1
            fs_list, rest_cols = None, None
            mesh = self.workpieces[s["wp"]].mesh
            if s["volume"] and mesh.lattice_shape is not None:
                if kind == "k":
                    block_of = k_block_of
                else:
                    info = self.pattern.wp_infos[s["wp"]]

                    def block_of(slot, info=info):
                        rel = slot - info.dof_offset
                        if rel < 0 or rel >= info.n_vars * info.n_cp:
                            return None
                        return (info.dof_offset
                                + (rel // info.n_cp) * info.n_cp)
                slots2 = s["slots"].reshape(s["slots"].shape[0], -1)
                fs_list, rest_cols = fit_stream_columns(
                    slots2, mesh.lattice_shape, block_of)
            if fs_list:
                # per-column split: fitting columns reduce by strided
                # adds, the rest (e.g. COO-spilled offsets) via gather
                fast[kind][si] = (fs_list, rest_cols)
                if rest_cols.size:
                    rest[kind].append(slots2[:, rest_cols].reshape(-1))
            else:
                rest[kind].append(s["slots"].reshape(-1))
        self._fast_maps[phase_key] = fast

        entry = {}
        for kind, num in (("r", self.pattern.basicfield_size),
                          ("k", self.pattern.n_storage)):
            if not rest[kind]:
                continue
            gr, touched = build_compact_gather_reduce(
                np.concatenate(rest[kind]), num)
            entry[kind] = maps_to_device(gr, self.device)
            if touched is not None:
                entry[kind + "_touched"] = torch.as_tensor(
                    touched.astype(np.int64), device=self.device)
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

    def make_iterative_solver(self, sv_func=None, **kwargs) -> Callable:
        """The reference's iterative_Solve! behavior: right-Jacobi scaled
        Krylov (02_Preconditioner.jl:30-78), BiCGStab by default.  Each
        pass's (iterations, true residual) lands in ``self.solve_log``."""
        sv_func = sv_func or krylov.bicgstab
        kwargs.setdefault("maxiter", 2000)
        kwargs.setdefault("max_pass", 10)

        def solve(A, b):
            return iterative_solve(A, b, converge_tol=self.converge_tol,
                                   sv_func=sv_func, log=self.solve_log,
                                   **kwargs)
        return solve

    # ------------------------------------------------------------------
    # runtime state
    # ------------------------------------------------------------------
    def _geometry_state(self, dtype=None, volume: bool = True) -> list:
        """Geometry tables per workpiece on the domain's device, computed
        from the host coordinates in ``dtype`` (the domain's by default).
        ``volume=False`` skips the element tables (boundary-only views
        for the refined step's nonaffine remainder)."""
        wp_states = []
        for wp in self.workpieces:
            coords = self._tensor(wp.mesh.cp_coords, dtype)
            el_cp = self._tensor(wp.mesh.el_cp, torch.int64)
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
                    el_cp_f = el_cp[self._tensor(els, torch.int64)]
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
        analog)."""
        self.state = {"wp": self._geometry_state()}
        self.refresh_fields()

    def refresh_fields(self) -> None:
        """Re-upload the named controlpoint columns (call after mutating
        mesh fields)."""
        for wps, fields in zip(self.state["wp"], self._fields()):
            wps["fields"] = fields

    def set_field(self, wp_id: int, name: str, values) -> None:
        self.workpieces[wp_id].mesh.set_field(name, values)

    def _fields(self, dtype=None) -> list:
        """Named controlpoint columns per workpiece, in ``dtype``."""
        return [{name: self._tensor(col, dtype)
                 for name, col in wp.mesh.fields.items()}
                for wp in self.workpieces]

    def _runtime_state(self) -> dict:
        ga = self.time_discretization
        return {**self.state,
                "ghost_diag": self._ghost_diag,
                "mg_mask": self._mg_mask,
                "mg_frozen": self._mg_frozen,
                "K_linear_td": self._k_linear_td,
                "refined": self._refined,
                "maps": self._device_maps,
                "x_star": self.x,
                "K_linear": torch.zeros(self.pattern.n_storage,
                                        dtype=self.dtype, device=self.device),
                "t": self.t, "dt": self.dt,
                "K_params": self._tensor(ga.K_params),
                "global_vars": {k: float(v)
                                for k, v in self.global_vars.items()},
                "user": self.user_state}

    def assemble_tangent(self) -> Tuple[OffsetMatrix, torch.Tensor]:
        """(tangent as an OffsetMatrix, residue) at the current x, with
        the time parameters of a step of ``self.dt``."""
        self.time_discretization.update_time(self.dt,
                                             self.pattern.max_time_level)
        state = self._runtime_state()
        state["K_linear"] = self._k_linear(state)
        residue, K_total = self._res_k(state)
        return (OffsetMatrix.from_values(K_total, self.pattern.offset_layout),
                residue)

    # ------------------------------------------------------------------
    # freezes of the refined step (all on the domain's device)
    # ------------------------------------------------------------------
    def _one_hot_k_params(self, td: int, dtype) -> torch.Tensor:
        one_hot = np.zeros(self.pattern.max_time_level + 1)
        one_hot[td] = 1.0
        return self._tensor(one_hot, dtype)

    def freeze_linear_tangent(self) -> None:
        """Precompute the per-time-level linear tangent components G_td
        (x-independent), so the refined step combines them as
        sum(K_params[td] * G_td) instead of re-assembling K_linear.  One
        'lin' assembly per time level with one-hot K_params; the ghost
        diagonal is subtracted (the combine adds it once).

        Valid while geometry, controlpoint fields and global material
        constants stay fixed; call again after changing any of them."""
        ghost = self._ghost_diag
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
        tensors.  The float64 volume tables are freed afterwards unless
        a volume form is nonaffine (then the remainder needs them).

        Same validity contract as freeze_linear_tangent."""
        self._ensure_device_maps("aff_lin", "aff_res", "nonaff_nl")
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
        A_list = []
        for td in range(L + 1):
            st["K_params"] = self._one_hot_k_params(td, f64)
            A_list.append(self._run_phase(st, "aff_lin")[1])
        st["K_params"] = self._tensor(np.ones(L + 1), f64)
        b64 = self._run_phase(st, "aff_res")[0]
        del st
        self._refined = {"A": torch.stack(A_list), "b": b64,
                         "wp": self._refined_tables(wp64)}

    def _f64_tables(self, volume: bool = True) -> list:
        """float64 geometry tables and fields on the domain's device."""
        wp64 = self._geometry_state(torch.float64, volume=volume)
        for wps, fields in zip(wp64, self._fields(torch.float64)):
            wps["fields"] = fields
        return wp64

    def _refined_tables(self, wp64: Optional[list] = None) -> list:
        """The float64 tables the refined step's nonaffine remainder
        reads.  When every volume form is affine the remainder is
        boundary-only: the float64 volume tables are dropped and the
        (unused) volume entry points at the working-precision ones."""
        vol_nonaff = any(
            wp.local_assembly.assembled_weakform.affine_form_ids()
            != {r.form_id
                for r in wp.local_assembly.assembled_weakform.residues}
            for wp in self.workpieces)
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

    def make_refined_step(self, **kwargs):
        """Exact-f64-residual Newton step at working-precision solve cost
        (see jit_step.make_refined_step).  Call freeze_linear_tangent(),
        freeze_refined_residual() and setup_mg() first."""
        from .jit_step import make_refined_step
        return make_refined_step(self, **kwargs)

    # ------------------------------------------------------------------
    # the hot loop (update_OneStep!, solver/04_Time_Domain.jl:59-80)
    # ------------------------------------------------------------------
    def update_one_step(self, max_iter: int = 4,
                        verbose: bool = False) -> float:
        ga = self.time_discretization
        L = self.pattern.max_time_level
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
