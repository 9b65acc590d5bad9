"""The assembly updaters: residual and tangent from the weak forms.

Port of ``metafem/solver/assembly.py`` (the analog of MetaFEM.jl's
runtime code generator, solver/05_CodeGenerator.jl +
solver/06_FEM_Kernel.jl):

* ``_Var_Basic`` gathers become batched einsums
  ``val[b, q] = itg_vals[b, q, a, mode] @ x_star[rows[b, a]]``;
* ``_Kval_Basic`` scatters become per-element batched products
  ``kel[b, a, c] = sum_q phi_a phi_c (coef * w)`` reduced into the
  block-offset storage by strided lattice adds (lattice_reduce.py) and
  precomputed gather maps (scatter.py) — no atomics, bitwise-repeatable;
* ``_Res_Basic`` likewise over DOF rows.

Two functions are built (compile_Updater_GPU, 05_CodeGenerator.jl:265-291):
``k_linear(state)`` assembles the x-independent gradient blocks once per
time step; ``res_k_nonlinear(state)`` assembles the residual and the
state-dependent gradient blocks every Newton iteration, on top of the
cached linear part.  ``run_phase(state, phase)`` runs any phase of
``_phase_parts``, which the freezes and the refined step use; the
two-float residual phases are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..elements.discretization import (ClassicalDiscretization,
                                       sd_ids_to_mode)
from ..symbolics.registry import (CONTROLPOINT_VAR, GLOBAL_VAR,
                                  INTEGRATION_POINT_VAR)
from ..symbolics.tensor_table import TensorTable
from .global_assembly import GlobalPattern, WPGlobalInfo
from .lattice_reduce import gather_lattice_nodes, scan_apply_group
from .local_assembly import (AssembleBilinear, AssembleWeakform,
                             ExtervarInfo, InnervarInfo, LocalAssembly)
from .lowering import LoweringContext
from .scatter import apply_device_maps


@dataclasses.dataclass
class CompiledWP:
    """Static (host) per-workpiece metadata closed over by the updaters."""
    disc: ClassicalDiscretization
    la: LocalAssembly
    info: WPGlobalInfo
    #: boundary group id -> list of (eindex, facet element ids) partitions
    bdy_parts: Dict[int, List[Tuple[int, np.ndarray]]]
    #: host copy of the element control-point ids [E, na]
    el_cp: np.ndarray = None


def _build_env(tb: TensorTable, wp_state: dict, part_state: dict,
               cw: CompiledWP, inner_infos: List[InnervarInfo],
               exter_infos: List[ExtervarInfo], x_star, t, dt,
               global_vars: dict, is_boundary: bool,
               gather_fast=None) -> dict:
    """Gather quadrature-point values for every referenced variable — the
    analog of declare_Innervar_GPU / declare_Extervar_GPU
    (solver/05_CodeGenerator.jl:1-50).  ``gather_fast``: FastStream list
    for lattice strided node reads (lattice_reduce.gather_lattice_nodes)
    on the volume part, or None for the generic [B, na] gather."""
    env: dict = {}
    itg_vals = part_state["itg_vals"]           # [B, nq, na, n_modes]
    el_cp = part_state["el_cp"]                 # [B, na]
    disc, info, la = cw.disc, cw.info, cw.la

    def node_vals(vec, block_base):
        """vec[block_base + el_cp] as [B, na]."""
        if gather_fast is not None:
            block = vec[block_base:block_base + info.n_cp]
            return gather_lattice_nodes(block, gather_fast)
        return vec[el_cp + block_base] if block_base else vec[el_cp]

    for (sym, td, sd_ids, pos) in inner_infos:
        if len(sd_ids) > la.max_sd_order:
            env[sym] = 0.0  # truncated derivative (explicit_max_sd_order)
            continue
        m = sd_ids_to_mode(tb.dim, sd_ids, disc.sd_modes)
        nodes = node_vals(x_star[td], info.dof_offset + pos * info.n_cp)
        env[sym] = torch.einsum("bqa,ba->bq", itg_vals[..., m], nodes)

    for (sym, local_sym, base, sd_ids, c_ids) in exter_infos:
        attrs = tb.registry.attributes(base)
        if GLOBAL_VAR in attrs:
            if base == "t":
                env[sym] = t
            elif base == "dt":
                env[sym] = dt
            elif sym in global_vars:
                # read from the runtime state: changeable between steps
                # (MetaFEM.jl reads physics.global_vars at run time,
                # 05_CodeGenerator.jl:26)
                env[sym] = global_vars[sym]
            else:
                raise KeyError(
                    f"global variable {sym!r} has no value; set "
                    f"domain.global_vars[{sym!r}] before compile()")
        elif CONTROLPOINT_VAR in attrs:
            if len(sd_ids) > la.max_sd_order:
                env[sym] = 0.0
                continue
            m = sd_ids_to_mode(tb.dim, sd_ids, disc.sd_modes)
            col = wp_state["fields"][local_sym]             # [n_cp]
            env[sym] = torch.einsum("bqa,ba->bq", itg_vals[..., m],
                                  node_vals(col, 0))
        elif INTEGRATION_POINT_VAR in attrs and base == "n":
            if not is_boundary:
                raise ValueError("the normal n{i} only exists on boundaries")
            env[sym] = part_state["normals"][..., c_ids[0] - 1]
        else:
            raise ValueError(f"unresolved external variable {sym!r}")
    return env


def _assemble_part(tb: TensorTable, cw: CompiledWP, part_state: dict,
                   bilinears_res: List[AssembleBilinear],
                   bilinears_grad: List[AssembleBilinear],
                   ctx: LoweringContext, K_params,
                   ) -> Tuple[Dict[int, torch.Tensor],
                              Dict[int, torch.Tensor]]:
    """Per-DOF-position residual contributions [B, na] and per-unit
    element-stiffness blocks [B, na, na] for one batch of elements or
    facets (gen_K_Linear_GPU / gen_Res_K_NonLinear_GPU,
    05_CodeGenerator.jl:52-154).  No scattering here — the caller reduces
    everything through precomputed gather maps."""
    disc, la = cw.disc, cw.la
    itg_vals = part_state["itg_vals"]
    weights = part_state["weights"]

    res_contribs: Dict[int, torch.Tensor] = {}
    for bil in bilinears_res:
        _, _, sd_ids, pos = bil.dual_info
        if len(sd_ids) > la.max_sd_order:
            continue
        m = sd_ids_to_mode(tb.dim, sd_ids, disc.sd_modes)
        cwgt = ctx.lower(bil.base_term) * weights              # [B, nq]
        contrib = torch.einsum("bqa,bq->ba", itg_vals[..., m], cwgt)
        res_contribs[pos] = res_contribs.get(pos, 0.0) + contrib

    kel_units: Dict[int, torch.Tensor] = {}
    for bil in bilinears_grad:
        _, _, dual_sd, dual_pos = bil.dual_info
        _, der_td, der_sd, der_pos = bil.derivative_info
        if max(len(dual_sd), len(der_sd)) > la.max_sd_order:
            continue
        u = la.sparse_mapping[(dual_pos, der_pos)]
        m1 = sd_ids_to_mode(tb.dim, dual_sd, disc.sd_modes)
        m2 = sd_ids_to_mode(tb.dim, der_sd, disc.sd_modes)
        cwgt = ctx.lower(bil.base_term) * K_params[der_td] * weights
        kel = torch.einsum("bqa,bq,bqc->bac",
                         itg_vals[..., m1], cwgt, itg_vals[..., m2])
        kel_units[u] = kel_units.get(u, 0.0) + kel

    return res_contribs, kel_units


def _phase_parts(wf: AssembleWeakform, phase: str):
    """(res_bils, grad_bils) contributing in a phase.

    Phases: ``lin`` — x-independent gradient blocks, once per step;
    ``nl`` — residues + x-dependent gradients, per Newton iteration;
    ``aff_lin`` — linear gradients of *affine* forms only (the frozen
    f64 affine operator A_td of the refined step); ``aff_res`` —
    residues of affine forms (evaluated at x=0 to freeze the constant
    part b); ``nonaff_nl`` — residues and nonlinear gradients of
    nonaffine forms (the small per-refinement-iteration assembly).  The
    two-float mode's ``nonaff_res`` and ``nl_grad`` are not ported."""
    if phase == "lin":
        return [], wf.linear_gradients
    if phase == "nl":
        return wf.residues, wf.nonlinear_gradients
    aff = wf.affine_form_ids()
    if phase == "aff_lin":
        return [], [g for g in wf.linear_gradients if g.form_id in aff]
    if phase == "aff_res":
        return [r for r in wf.residues if r.form_id in aff], []
    if phase == "nonaff_nl":
        return ([r for r in wf.residues if r.form_id not in aff],
                wf.nonlinear_gradients)
    if phase in ("nonaff_res", "nl_grad"):
        raise NotImplementedError(
            f"assembly phase {phase!r} belongs to the two-float residual "
            "mode, not ported yet (ROADMAP.md queue 1, item 9)")
    raise ValueError(f"unknown assembly phase {phase!r}")


def _phase_bilinears(wf: AssembleWeakform, la: LocalAssembly,
                     phase: str):
    """(residual positions, K units) this weak form contributes in the
    given phase — shared by _run and the host map builder so
    the contribution concatenation orders match exactly."""
    res_bils, grad_bils = _phase_parts(wf, phase)
    positions = sorted({b.dual_info[3] for b in res_bils
                        if len(b.dual_info[2]) <= la.max_sd_order})
    units = sorted({la.sparse_mapping[(b.dual_info[3],
                                       b.derivative_info[3])]
                    for b in grad_bils
                    if max(len(b.dual_info[2]),
                           len(b.derivative_info[2])) <= la.max_sd_order})
    return positions, units


def collect_phase_streams(compiled_wps: List[CompiledWP],
                          pattern: GlobalPattern, phase: str):
    """Host mirror of _run's contribution order, one entry per stream:
    dicts {kind: 'r'|'k', slots: [E, n_cols] int64, volume: bool,
    wp: index}.  The order matches _run's emission exactly (volume weak
    form first, then boundary parts; residual positions then K units,
    both sorted)."""
    streams: List[dict] = []
    for w_i, cw in enumerate(compiled_wps):
        la, info = cw.la, cw.info

        def handle(wf, el_cp_np, pair_slot_np, volume):
            positions, units = _phase_bilinears(wf, la, phase)
            for pos in positions:
                streams.append(dict(
                    kind="r", volume=volume, wp=w_i,
                    slots=(el_cp_np.astype(np.int64) + info.dof_offset
                           + pos * info.n_cp)))
            for u in units:
                B = pair_slot_np.shape[0]
                streams.append(dict(
                    kind="k", volume=volume, wp=w_i,
                    slots=pattern.slot_storage(
                        (pair_slot_np.astype(np.int64) + info.sparse_entry
                         + u * info.unitsize).reshape(-1)
                    ).reshape(B, -1)))

        handle(la.assembled_weakform, cw.el_cp, info.pair_slot, True)
        for bg_id, wf in la.assembled_boundary_weakform_pairs.items():
            for (_, els) in cw.bdy_parts[bg_id]:
                handle(wf, cw.el_cp[els], info.pair_slot[els], False)
    return streams


def collect_phase_slots(compiled_wps: List[CompiledWP],
                        pattern: GlobalPattern, phase: str):
    """Concatenated residual DOF rows and K storage slots for one phase
    (all streams; see collect_phase_streams for the per-stream view)."""
    streams = collect_phase_streams(compiled_wps, pattern, phase)
    r = [s["slots"].reshape(-1) for s in streams if s["kind"] == "r"]
    k = [s["slots"].reshape(-1) for s in streams if s["kind"] == "k"]
    return (np.concatenate(r) if r else None,
            np.concatenate(k) if k else None)


def make_updaters(tb: TensorTable, compiled_wps: List[CompiledWP],
                  pattern: GlobalPattern,
                  functions: Dict[str, object],
                  fast_maps: Dict[str, dict] = None):
    """Build (k_linear, res_k_nonlinear, run_phase) as functions of the
    runtime ``state`` dict; ``run_phase(state, phase)`` returns (residue,
    K) of one phase of ``_phase_parts``.

    ``fast_maps``: {phase_key: {"r"|"k": {stream_idx: (fs_list,
    rest_cols)}}, "gather": {wp: fs_list}} — the lattice strided
    reductions and node reads, filled in by FEM_Domain.compile.  Streams
    covered by them bypass the gather maps; ``state["maps"][phase]``
    (device gather maps, scatter.maps_to_device) reduces the rest."""
    fast_maps = fast_maps if fast_maps is not None else {}
    bfs = pattern.basicfield_size

    def _run(state, phase: str):
        x_star = state["x_star"]
        dtype, dev = x_star.dtype, x_star.device
        t, dt, K_params = state["t"], state["dt"], state["K_params"]
        global_vars = state.get("global_vars", {})

        r_vals: List[torch.Tensor] = []
        k_vals: List[torch.Tensor] = []

        for w_i, cw in enumerate(compiled_wps):
            wp_state = state["wp"][w_i]
            la = cw.la

            def do_wf(wf: AssembleWeakform, part_state, is_boundary):
                res_bils, grad_bils = _phase_parts(wf, phase)
                if phase in ("lin", "aff_lin"):
                    inner_infos: List[InnervarInfo] = []
                    exter_infos = wf.linear_extervar_infos
                else:
                    inner_infos = wf.innervar_infos
                    exter_infos = wf.extervar_infos
                if not (res_bils or grad_bils):
                    return
                gather_fast = None
                if not is_boundary:
                    gather_fast = fast_maps.get("gather", {}).get(w_i)
                env = _build_env(tb, wp_state, part_state, cw, inner_infos,
                                 exter_infos, x_star, t, dt, global_vars,
                                 is_boundary, gather_fast=gather_fast)
                ctx = LoweringContext(tb, env, functions,
                                      user_state=state.get("user"))
                res_contribs, kel_units = _assemble_part(
                    tb, cw, part_state, res_bils, grad_bils, ctx, K_params)
                for pos in sorted(res_contribs):
                    r_vals.append(res_contribs[pos])       # [B, na]
                for u in sorted(kel_units):
                    k_vals.append(kel_units[u])            # [B, na, nb]

            do_wf(la.assembled_weakform, wp_state["el"], False)
            for bg_id, wf in la.assembled_boundary_weakform_pairs.items():
                for part_state in wp_state["bdy"][bg_id]:
                    do_wf(wf, part_state, True)

        device_maps = state["maps"][phase]
        fast = fast_maps.get(phase, {})

        def reduce_streams(vals_list, fast_dict, total):
            """Strided lattice adds for the fitting columns, in list
            order; returns (partial sum, flat non-fitting remainders)."""
            out = torch.zeros(total, dtype=dtype, device=dev)
            rest = []
            for si, v in enumerate(vals_list):
                entry = fast_dict.get(si)
                if entry is None:
                    rest.append(v.reshape(-1))
                    continue
                fs_list, rest_cols = entry
                vf = v.reshape(v.shape[0], -1)
                scan_apply_group(out, [(vf[:, fs.col], fs)
                                       for fs in fs_list])
                if rest_cols.size:
                    rest.append(vf[:, torch.as_tensor(rest_cols, device=dev)
                                   ].reshape(-1))
            return out, rest

        def add_rest(out, rest, kind, total):
            if not rest:
                return out
            data = torch.cat(rest)
            touched = device_maps.get(kind + "_touched")
            if touched is not None:
                # compact reduction over the touched slots + one small
                # expand (touched slots are unique: no accumulation)
                compact = apply_device_maps(device_maps.get(kind), data,
                                            touched.shape[0])
                out[touched] = out[touched] + compact
                return out
            return out + apply_device_maps(device_maps.get(kind), data,
                                           total)

        residue, rest_r = reduce_streams(r_vals, fast.get("r", {}), bfs)
        residue = add_rest(residue, rest_r, "r", bfs)
        K, rest_k = reduce_streams(k_vals, fast.get("k", {}),
                                   pattern.n_storage)
        K = add_rest(K, rest_k, "k", pattern.n_storage)
        if phase == "lin" and state.get("ghost_diag") is not None:
            # unit diagonal on ghost (unoccupied lattice) DOF rows
            K = K + state["ghost_diag"]
        return residue, K

    def k_linear(state):
        """K_linear: x-independent gradient blocks, once per step."""
        _, K = _run(state, "lin")
        return K

    def res_k_nonlinear(state):
        """(residue, K_total = K_linear + nonlinear blocks), per Newton
        iteration."""
        residue, K = _run(state, "nl")
        return residue, state["K_linear"] + K

    return k_linear, res_k_nonlinear, _run
