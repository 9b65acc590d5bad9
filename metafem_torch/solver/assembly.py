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
``_phase_parts``, which the freezes and the refined step use.  A phase
name ending in ``_df`` (``nonaff_res_df``) evaluates that phase's
residues in two-float arithmetic (df_lowering.py) and reduces them
exactly (``_reduce_df``): the refined step's ``df32`` residual mode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..elements.discretization import (ClassicalDiscretization,
                                       sd_ids_to_mode)
from ..linsolve import twofloat as tf
from ..symbolics.registry import (CONTROLPOINT_VAR, GLOBAL_VAR,
                                  INTEGRATION_POINT_VAR)
from ..symbolics.tensor_table import TensorTable
from .global_assembly import GlobalPattern, WPGlobalInfo
from .df_lowering import DFLoweringContext, assemble_part_df, build_env_df
from .lattice_reduce import (fit_stream_columns, gather_lattice_nodes,
                             scan_apply_group, scan_apply_group_df)
from .local_assembly import (AssembleBilinear, AssembleWeakform,
                             ExtervarInfo, InnervarInfo, LocalAssembly)
from .lowering import LoweringContext
from .scatter import (apply_device_maps, apply_device_maps_df,
                      build_compact_gather_reduce, maps_to_device)


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
    #: the workpiece's lattice shape (None: unstructured)
    lattice_shape: tuple = None


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
    nonaffine forms (the small per-refinement-iteration assembly);
    ``nonaff_res`` and ``nl_grad`` — its two halves, which the two-float
    mode runs apart (the residues in two-float or compact float64, the
    gradients in the working precision)."""
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
    if phase == "nonaff_res":
        return [r for r in wf.residues if r.form_id not in aff], []
    if phase == "nl_grad":
        return [], wf.nonlinear_gradients
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
                          pattern: GlobalPattern, phase: str,
                          volume: bool = True, boundary: bool = True):
    """Host mirror of _run's contribution order, one entry per stream:
    dicts {kind: 'r'|'k', slots: [E, n_cols] int64, volume: bool,
    wp: index}.  The order matches _run's emission exactly (volume weak
    form first, then boundary parts; residual positions then K units,
    both sorted).  ``volume``/``boundary``: the parts to list (the
    element-sharded assembly reduces them apart)."""
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

        if volume:
            handle(la.assembled_weakform, cw.el_cp, info.pair_slot, True)
        if not boundary:
            continue
        for bg_id, wf in la.assembled_boundary_weakform_pairs.items():
            for (_, els) in cw.bdy_parts[bg_id]:
                handle(wf, cw.el_cp[els], info.pair_slot[els], False)
    return streams


def build_phase_maps(streams: List[dict], compiled_wps: List[CompiledWP],
                     pattern: GlobalPattern, device) -> tuple:
    """(fast, entry): the reduction maps of the streams of one assembly
    phase (``collect_phase_streams``).  ``fast``: {"r"|"k": {stream
    index: (FastStream list, rest columns)}}, lattice strided adds where
    a volume stream's slot columns are affine in the lattice index;
    ``entry``: gather maps on ``device`` for the rest, and under
    "rest_cols" the remaining columns of each split stream as indices
    there."""
    seg_bases = np.asarray([s[4] for s in pattern.offset_layout.segments])
    seg_ncp = np.asarray([s[2] for s in pattern.offset_layout.segments])
    order = np.argsort(seg_bases)
    seg_bases, seg_ncp = seg_bases[order], seg_ncp[order]

    def k_block_of(slot):
        j = np.searchsorted(seg_bases, slot, side="right") - 1
        if j < 0 or slot >= seg_bases[j] + seg_ncp[j]:
            return None
        return int(seg_bases[j])

    fast = {"r": {}, "k": {}}
    rest = {"r": [], "k": []}
    rest_cols_dev = {}
    counters = {"r": 0, "k": 0}
    for s in streams:
        kind = s["kind"]
        si = counters[kind]
        counters[kind] += 1
        fs_list, rest_cols = None, None
        lattice_shape = compiled_wps[s["wp"]].lattice_shape
        if s["volume"] and lattice_shape is not None:
            if kind == "k":
                block_of = k_block_of
            else:
                info = pattern.wp_infos[s["wp"]]

                def block_of(slot, info=info):
                    rel = slot - info.dof_offset
                    if rel < 0 or rel >= info.n_vars * info.n_cp:
                        return None
                    return (info.dof_offset
                            + (rel // info.n_cp) * info.n_cp)
            slots2 = s["slots"].reshape(s["slots"].shape[0], -1)
            fs_list, rest_cols = fit_stream_columns(
                slots2, lattice_shape, block_of)
        if fs_list:
            # per-column split: fitting columns reduce by strided adds,
            # the rest (e.g. COO-spilled offsets) via gather
            fast[kind][si] = (fs_list, rest_cols)
            if rest_cols.size:
                rest[kind].append(slots2[:, rest_cols].reshape(-1))
                rest_cols_dev[kind, si] = torch.as_tensor(
                    rest_cols.astype(np.int64), device=device)
        else:
            rest[kind].append(s["slots"].reshape(-1))

    entry = {"rest_cols": rest_cols_dev}
    for kind, num in (("r", pattern.basicfield_size),
                      ("k", pattern.n_storage)):
        if not rest[kind]:
            continue
        gr, touched = build_compact_gather_reduce(
            np.concatenate(rest[kind]), num)
        entry[kind] = maps_to_device(gr, device)
        if touched is not None:
            entry[kind + "_touched"] = torch.as_tensor(
                touched.astype(np.int64), device=device)
    return fast, entry


def gather_fast_maps(el_cp: np.ndarray, lattice_shape, n_cp: int):
    """The lattice strided node reads of a volume part (el_cp [E, na]),
    or None when a column does not fit (then the generic gather)."""
    if lattice_shape is None:
        return None

    def in_block(slot):
        return 0 if 0 <= slot < n_cp else None

    fs_list, rest_cols = fit_stream_columns(el_cp.astype(np.int64),
                                            lattice_shape, in_block)
    return fs_list if fs_list and rest_cols.size == 0 else None


def collect_phase_slots(compiled_wps: List[CompiledWP],
                        pattern: GlobalPattern, phase: str):
    """Concatenated residual DOF rows and K storage slots for one phase
    (all streams; see collect_phase_streams for the per-stream view)."""
    streams = collect_phase_streams(compiled_wps, pattern, phase)
    r = [s["slots"].reshape(-1) for s in streams if s["kind"] == "r"]
    k = [s["slots"].reshape(-1) for s in streams if s["kind"] == "k"]
    return (np.concatenate(r) if r else None,
            np.concatenate(k) if k else None)


def _reduce_df(r_vals: List[tf.DF], fast_r: dict, total: int,
               device_maps: dict, dev) -> tf.DF:
    """Two-float residual reduction: per-stream DF contribution pairs to
    a DF global residual.  Lattice columns are placed exactly and
    df_added in list order (``scan_apply_group_df``); the other columns
    reduce through the compensated gather maps
    (``apply_device_maps_df``), over the touched rows where the map is
    compact."""
    z = torch.zeros(total, dtype=torch.float32, device=dev)
    residue = tf.DF(z, z.clone())
    pairs, rest = [], []
    for si, v in enumerate(r_vals):
        entry = fast_r.get(si)
        if entry is None:
            rest.append(tf.DF(v.hi.reshape(-1), v.lo.reshape(-1)))
            continue
        fs_list, rest_cols = entry
        B = v.hi.shape[0]
        vf = tf.DF(v.hi.reshape(B, -1), v.lo.reshape(B, -1))
        pairs.extend((tf.DF(vf.hi[:, fs.col], vf.lo[:, fs.col]), fs)
                     for fs in fs_list)
        if rest_cols.size:
            cols = device_maps["rest_cols"]["r", si]
            rest.append(tf.DF(vf.hi[:, cols].reshape(-1),
                              vf.lo[:, cols].reshape(-1)))
    if pairs:
        residue = scan_apply_group_df(residue, pairs)
    if not rest:
        return residue
    data = tf.DF(torch.cat([d.hi for d in rest]),
                 torch.cat([d.lo for d in rest]))
    touched = device_maps.get("r_touched")
    if touched is None:
        return tf.df_add(residue, apply_device_maps_df(
            device_maps.get("r"), data, total))
    compact = apply_device_maps_df(device_maps.get("r"), data,
                                   touched.shape[0])
    new = tf.df_add(tf.DF(residue.hi[touched], residue.lo[touched]),
                    compact)
    residue.hi[touched] = new.hi
    residue.lo[touched] = new.lo
    return residue


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
    (device gather maps, scatter.maps_to_device, and the remaining
    columns of split streams) reduces the rest."""
    fast_maps = fast_maps if fast_maps is not None else {}
    bfs = pattern.basicfield_size

    def _contributions(state, phase: str, df_mode: bool, volume: bool,
                       boundary: bool, gather=None):
        """The per-stream contributions of one phase in the emission
        order of ``collect_phase_streams``: residual [B, na] (DF pairs in
        a two-float phase) and K blocks [B, na, nb].  ``gather``: the
        lattice node reads per workpiece (default: the compiled ones)."""
        x_star = state["x_star"]
        dev = x_star.hi.device if df_mode else x_star.device
        t, dt, K_params = state["t"], state["dt"], state["K_params"]
        global_vars = state.get("global_vars", {})
        if gather is None:
            gather = fast_maps.get("gather", {})

        r_vals: List[torch.Tensor] = []
        k_vals: List[torch.Tensor] = []

        for w_i, cw in enumerate(compiled_wps):
            wp_state = state["wp"][w_i]
            la = cw.la

            def do_wf(wf: AssembleWeakform, part_state, is_boundary):
                res_bils, grad_bils = _phase_parts(wf, phase)
                if df_mode and grad_bils:
                    raise ValueError(f"two-float phases evaluate residues "
                                     f"only; {phase!r} has gradients")
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
                    gather_fast = gather.get(w_i)
                if df_mode:
                    env = build_env_df(tb, wp_state, part_state, cw,
                                       inner_infos, exter_infos, x_star,
                                       t, dt, global_vars, is_boundary,
                                       gather_fast=gather_fast)
                    ctx = DFLoweringContext(tb, env, functions,
                                            user_state=state.get("user"),
                                            device=dev)
                    res_contribs = assemble_part_df(tb, cw, part_state,
                                                    res_bils, ctx)
                    for pos in sorted(res_contribs):
                        r_vals.append(res_contribs[pos])   # DF [B, na]
                    return
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

            if volume:
                do_wf(la.assembled_weakform, wp_state["el"], False)
            if not boundary:
                continue
            for bg_id, wf in la.assembled_boundary_weakform_pairs.items():
                for part_state in wp_state["bdy"][bg_id]:
                    do_wf(wf, part_state, True)
        return r_vals, k_vals

    def _reduce(r_vals, k_vals, device_maps: dict, fast: dict, dtype, dev):
        """(residue, K) of the contributions: strided lattice adds for
        the fitting columns, in list order, then the gather maps for the
        rest."""
        def reduce_streams(vals_list, fast_dict, kind, total):
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
                    cols = device_maps["rest_cols"][kind, si]
                    rest.append(vf[:, cols].reshape(-1))
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

        residue, rest_r = reduce_streams(r_vals, fast.get("r", {}), "r",
                                         bfs)
        residue = add_rest(residue, rest_r, "r", bfs)
        K, rest_k = reduce_streams(k_vals, fast.get("k", {}), "k",
                                   pattern.n_storage)
        K = add_rest(K, rest_k, "k", pattern.n_storage)
        return residue, K

    def _shard_maps(shard: dict, phase: str, part: str, device) -> tuple:
        """(fast, entry, gather) of the rank's element block
        (``part="volume"``, maps and node reads rebuilt for the block) or
        of the whole boundary (``"boundary"``), built once per shard,
        phase and device."""
        key = (phase, part, str(device))
        cache = shard["maps"]
        if key not in cache:
            if part == "volume":
                cws = []
                for cw, (e0, e1) in zip(compiled_wps, shard["ranges"]):
                    info = dataclasses.replace(
                        cw.info, pair_slot=cw.info.pair_slot[e0:e1])
                    cws.append(dataclasses.replace(cw, el_cp=cw.el_cp[e0:e1],
                                                   info=info))
                streams = collect_phase_streams(cws, pattern, phase,
                                                boundary=False)
                gather = {}
                for w_i, cw in enumerate(cws):
                    fs = gather_fast_maps(cw.el_cp, cw.lattice_shape,
                                          cw.info.n_cp)
                    if fs is not None:
                        gather[w_i] = fs
            else:
                cws = compiled_wps
                streams = collect_phase_streams(cws, pattern, phase,
                                                volume=False)
                gather = {}
            fast, entry = build_phase_maps(streams, cws, pattern, device)
            cache[key] = (fast, entry, gather)
        return cache[key]

    def _run_sharded(state, phase: str):
        """(residue, K) of one phase of an element-sharded state: the
        rank's element block reduced into a partial sum, the collective
        (an all-reduce, or with ``state["row_window"]`` a reduce-scatter
        onto the rank's rows and storage), then the whole boundary, added
        once, and the ghost regularizer."""
        from ..parallel import comm
        from ..parallel.rowshard import constrain
        shard = state["el_shard"]
        rows = state.get("row_window")
        x_star = state["x_star"]
        dtype, dev = x_star.dtype, x_star.device
        fast, entry, gather = _shard_maps(shard, phase, "volume", dev)
        r_vals, k_vals = _contributions(state, phase, False, True, False,
                                        gather=gather)
        residue, K = _reduce(r_vals, k_vals, entry, fast, dtype, dev)
        if rows is not None:
            residue = rows.reduce_scatter_rows(residue)
            K = rows.reduce_scatter_storage(K)
        else:
            residue = comm.all_reduce(residue, shard["mesh"])
            K = comm.all_reduce(K, shard["mesh"])
        fast, entry, _ = _shard_maps(shard, phase, "boundary", dev)
        r_vals, k_vals = _contributions(state, phase, False, False, True)
        if r_vals or k_vals:
            r_b, K_b = _reduce(r_vals, k_vals, entry, fast, dtype, dev)
            residue = residue + constrain(rows, r_b)
            K = K + constrain(rows, K_b, storage=True)
        if phase == "lin" and state.get("ghost_diag") is not None:
            K = K + constrain(rows, state["ghost_diag"], storage=True)
        return residue, K

    def _run(state, phase: str):
        """(residue, K) of one phase.  ``<phase>_df``: the phase's
        residues in two-float arithmetic from DF tables (``state["wp"]``)
        and a DF ``x_star``, returned as a DF residue and a 0-d K.
        ``state["r_compact"]``: the residue over the phase's touched rows
        only (``maps[phase]["r_touched"]``, the caller expands it) and a
        0-d K; for phases without lattice residual streams.  A state
        whose volume tables are a rank's element block
        (``parallel.shard_domain_state``) runs ``_run_sharded``."""
        df_mode = phase.endswith("_df")
        if df_mode:
            phase = phase[:-3]
        sharded = any("el_range" in w for w in state["wp"])
        if sharded:
            if df_mode or state.get("r_compact"):
                raise ValueError("two-float and compact phases run on "
                                 "whole tables, not a rank's block")
            return _run_sharded(state, phase)
        x_star = state["x_star"]
        dev = x_star.hi.device if df_mode else x_star.device
        dtype = torch.float32 if df_mode else x_star.dtype
        r_vals, k_vals = _contributions(state, phase, df_mode, True, True)

        device_maps = state["maps"][phase]
        fast = fast_maps.get(phase, {})
        if df_mode:
            return (_reduce_df(r_vals, fast.get("r", {}), bfs, device_maps,
                               dev),
                    torch.zeros((), dtype=dtype, device=dev))
        if state.get("r_compact") and "r_touched" in device_maps:
            if fast.get("r"):
                raise ValueError(f"r_compact: phase {phase!r} has lattice "
                                 f"residual streams")
            n_touched = device_maps["r_touched"].shape[0]
            data = (torch.cat([v.reshape(-1) for v in r_vals]) if r_vals
                    else torch.zeros(0, dtype=dtype, device=dev))
            return (apply_device_maps(device_maps.get("r"), data,
                                      n_touched),
                    torch.zeros((), dtype=dtype, device=dev))
        residue, K = _reduce(r_vals, k_vals, device_maps, fast, dtype, dev)
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
