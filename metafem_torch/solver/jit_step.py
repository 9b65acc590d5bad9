"""Newton steps with the whole step in one call: ``make_jitted_step``
(assembled residuals, right-Jacobi or multigrid Krylov solves) and the
refined step ``make_refined_step`` (exact residuals, working-precision
multigrid solves).

Port of ``metafem/solver/jit_step.py``.  The reference stages each step
as one jitted ``lax.while_loop``; in PyTorch each is a host loop over
device tensors that reads one residual norm back per Newton (or refine)
iteration, and keeps the names of the reference so that a reader finds
the counterpart.  The refined step has both of the reference's residual
modes.  ``"f64"`` is the default: the card computes float64 natively,
so ``x`` is carried in float64 between steps.  ``"df32"``, the
reference's production mode on its TPU (whose float64 is emulated),
carries ``x``, A_td and b as two-float pairs (linsolve/twofloat.py) on a
float32 domain; each A_td product runs the two-float SpMV kernel on the
card.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..config import device_constant
from ..linsolve import krylov
from ..linsolve import twofloat as tf
from ..linsolve.block_offset import OffsetMatrix
from ..linsolve.precond import pr_jacobi
from ..parallel.rowshard import (RowShardedMGOperator, RowShardedOp,
                                 constrain, held, local_mg_state,
                                 row_window, uncut, whole_mg_state)
from .time_domain import initialize_dx, x_star_of


def combine_klin(state, K_params, rows=None) -> torch.Tensor:
    """sum_td K_params[td] * K_linear_td[td] (+ ghost diagonal): the
    linear tangent from the components frozen by
    ``freeze_linear_tangent``, one scalar-times-vector add per time
    level.  ``rows``: a row-sharded step's window (the window's
    storage); a whole step on a state that ``shard_domain_state`` cut
    gathers the stack back once (``rowshard.held``)."""
    K_td = held(rows, state, "K_linear_td", storage=True)
    K = float(K_params[0]) * K_td[0]
    for td in range(1, K_td.shape[0]):
        K = K + float(K_params[td]) * K_td[td]
    if state.get("ghost_diag") is not None:
        K = K + constrain(rows, state["ghost_diag"], storage=True)
    return K


def _row_window(domain, rowshard_mesh):
    """The rank's row window of the domain's layout over a DeviceMesh, or
    None without one."""
    if rowshard_mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(rowshard_mesh, DeviceMesh):
        raise TypeError(f"rowshard_mesh must be a torch.distributed "
                        f"DeviceMesh, not {type(rowshard_mesh).__name__}")
    return row_window(domain.pattern.offset_layout, rowshard_mesh)


def _sharded_ops(rows):
    """(A_of(vals), norm, gather) of a row-sharded step, or of a whole
    one (``rows`` None)."""
    if rows is None:
        return None, torch.linalg.norm, lambda v: v

    def A_of(vals):
        return RowShardedOp(OffsetMatrix.from_values(
            vals, rows.layout, rows.mine), rows)
    return A_of, rows.norm, rows.gather


def _frozen_mg(state, rows, hier):
    """The frozen multigrid state (``setup_mg``) on the step's layout:
    its fine level on the window for a row-sharded step
    (``local_mg_state``), whole for a whole step (gathered once from a
    state that ``shard_domain_state`` cut, ``whole_mg_state``)."""
    mg = state["mg_frozen"]
    if rows is not None:
        return local_mg_state(mg, rows)
    if mg[0].get("rows") is None:
        return mg
    return uncut(state, "mg_frozen",
                 lambda m: whole_mg_state(m, hier.shapes[0]))


def _matrices(ref: dict, rows) -> dict:
    """Where a refined step keeps the matrices it builds from the record
    ``ref`` (``A_mats``, ``A_packed``): the record itself where the step
    runs on the record's own layout (``rows`` is its ``cut_to``), else a
    dict per window kept in the record."""
    if rows is ref.get("cut_to"):
        return ref
    return ref.setdefault("windows", {}).setdefault(
        None if rows is None else rows.mine, {})


def make_jitted_step(domain, sv_func: Callable = krylov.bicgstab,
                     maxiter: int = 2000, max_newton: int = 4,
                     max_pass: int = 2, precond: str = "jacobi",
                     mg_opts: dict = None, forcing: float = 1e-2,
                     stall_ratio: float = 0.9,
                     static_k_linear: bool = False,
                     reuse_mg: bool = False, rowshard_mesh=None,
                     log: Optional[list] = None, **sv_kwargs):
    """Build ``step(state, x, t, dt) -> (x_new, dx, res, n_newton)``.

    In the reference this is one jitted dispatch; in PyTorch it is a host
    Newton loop with the reference's exits: below ``converge_tol`` (read
    from the domain at build time), after ``max_newton`` iterations, or
    when the residual falls by less than ``stall_ratio``.  Every Newton
    iteration assembles the residual and tangent and solves with
    ``sv_func`` in ``max_pass`` restart passes, each stopping at the
    inexact-Newton tolerance max(converge_tol, forcing * ||rhs|| /
    sqrt(n)).

    ``precond``: 'jacobi' (right diagonal scaling, the reference's
    Pr_Jacobi!) or 'mg' (the lattice multigrid V-cycle as right
    preconditioner, set up once per step from the predictor tangent, or
    taken from ``domain.setup_mg()`` with ``reuse_mg``).
    ``static_k_linear``: combine the components frozen by
    ``domain.freeze_linear_tangent()`` instead of assembling the linear
    tangent.  ``log``, when given, receives one (Krylov iterations, true
    residual of the pass's system) pair per solver pass.

    ``rowshard_mesh``: a DeviceMesh, the scale-out layout
    (parallel/rowshard.py): pass a state from
    ``parallel.shard_domain_state``; the assembly lands reduce-scattered
    on this rank's row window, the Krylov vectors hold the window's
    rows, every product gathers x and every dot all-reduces over the
    mesh, and x and dx come back whole on every rank.  Multigrid runs
    its fine level on the window: set up per step from the window's
    predictor tangent (``multigrid.mg_setup`` of a ``RowShardedOp``), or
    the frozen state's, cut at the step.  Without ``rowshard_mesh`` a
    state of ``shard_domain_state`` steps whole: its cut caches are
    gathered back once (``rowshard.held``, ``_frozen_mg``), on every
    rank of its mesh."""
    rows = _row_window(domain, rowshard_mesh)
    A_sh, norm, gather = _sharded_ops(rows)
    mg_hier = None
    if precond == "mg":
        from ..linsolve import multigrid
        if reuse_mg and domain._mg_hier is not None:
            mg_hier = domain._mg_hier
        else:
            mg_hier = multigrid.hierarchy_for_domain(domain,
                                                     **(mg_opts or {}))
    elif precond != "jacobi":
        raise ValueError(f"unknown precond {precond!r}")
    if static_k_linear and domain._k_linear_td is None:
        raise RuntimeError("call domain.freeze_linear_tangent() first")

    pattern = domain.pattern
    ga = domain.time_discretization
    gamma = tuple(ga.gamma_params)
    alpha = tuple(ga.alpha_params)
    tol = float(domain.converge_tol)
    L = pattern.max_time_level
    layout = pattern.offset_layout
    res_k, k_linear = domain._res_k, domain._k_linear
    sqrt_n = math.sqrt(pattern.basicfield_size)

    def A_of(vals) -> OffsetMatrix:
        if A_sh is not None:
            return A_sh(vals)
        return OffsetMatrix.from_values(vals, layout)

    def norm_n(v) -> float:
        return float(norm(v)) / sqrt_n

    def passes(A, residue, solve_once):
        """max_pass restart passes of solve_once(rr) -> (delta_i, iters)
        with the true residual recomputed between them."""
        delta, rr = None, residue
        for _ in range(max_pass):
            d_i, iters = solve_once(rr)
            delta = d_i if delta is None else delta + d_i
            rr = residue - A.mv(delta)
            if log is not None:
                log.append((int(iters), norm_n(rr)))
        return delta

    def inner_tol(rr) -> float:
        return max(tol, forcing * norm_n(rr))

    def step(state, x, t, dt):
        dev, dtype = x.device, x.dtype
        levels = L + 1
        f = np.float32 if dtype == torch.float32 else np.float64
        prod_gamma = np.asarray([np.prod(gamma[:i]) for i in range(levels)],
                                f)
        dt_pow = np.asarray([f(dt) ** i for i in range(levels)], f)
        beta = f(1.0) / (prod_gamma * dt_pow)
        K_params = np.asarray(alpha[:levels], f) * beta
        beta_t = device_constant(beta, dtype, dev)
        st = dict(state)
        st["t"], st["dt"] = float(t), float(dt)
        st["K_params"] = device_constant(K_params, dtype, dev)
        st["x_star"] = x
        if rows is not None:
            st["row_window"] = rows
        st["K_linear"] = (combine_klin(state, K_params, rows)
                          if static_k_linear else k_linear(st))

        def res_of(dx):
            st2 = dict(st)
            st2["x_star"] = x_star_of(x, dx, alpha)
            return res_k(st2)

        dx = initialize_dx(x, float(dt), gamma)
        residue, K_total = res_of(dx)
        res = norm_n(residue)
        mg_state = None
        if mg_hier is not None:
            # set up once per step from the predictor tangent (a
            # row-sharded step's on its window) and frozen across the
            # Newton iterations
            mg_state = (_frozen_mg(state, rows, mg_hier) if reuse_mg
                        else multigrid.mg_setup(mg_hier, A_of(K_total),
                                                st.get("mg_mask")))
        res_prev = float(np.finfo(np.float32).max)
        it = 0
        while res > tol and it < max_newton and res < stall_ratio * res_prev:
            A = A_of(K_total)
            if mg_hier is not None:
                op = multigrid.MGOperator(getattr(A, "inner", A), mg_state,
                                          mg_hier)
                if rows is not None:
                    op = RowShardedMGOperator(op, rows)

                def solve_once(rr):
                    y_i, iters, _ = sv_func(op, rr, tol=inner_tol(rr),
                                            maxiter=maxiter, **sv_kwargs)
                    return op.apply_m(y_i), iters
                delta = passes(A, residue, solve_once)
            else:
                As, unscale = pr_jacobi(A)

                def solve_once(rr):
                    d_i, iters, _ = sv_func(As, rr, tol=inner_tol(rr),
                                            maxiter=maxiter, **sv_kwargs)
                    return d_i, iters
                delta = unscale(passes(As, residue, solve_once))
            delta = gather(delta)               # whole on every rank
            dx = dx + beta_t[:, None] * (-delta)[None, :]     # update_dx!
            # the residual and tangent at the new dx serve the stop test
            # and the next iteration (the reference assembles them twice)
            residue, K_total = res_of(dx)
            res_prev, res = res, norm_n(residue)
            it += 1
        return x + dx, dx, res, it

    return step


def make_refined_step(domain, sv_func: Callable = krylov.bicgstab,
                      maxiter: int = 60, max_refine: int = 10,
                      max_pass: int = 1, precond: str = "mg",
                      forcing: float = 1e-2, stall_ratio: float = 0.9,
                      residual_mode: str = None, rowshard_mesh=None,
                      inner_operator: str = "exact",
                      static_nl_tangent: bool = False,
                      **sv_kwargs):
    """Newton / mixed-precision-iterative-refinement step with exact
    residuals and working-precision tangent solves.

    Builds ``step(state, x, t, dt) -> (x_new, dx, res, n_refines)``.
    Every iteration:

    1. the exact residual from the frozen affine decomposition
       (``domain.freeze_refined_residual``): SpMVs against A_td and b
       plus the small nonaffine boundary remainder;
    2. the tangent = frozen linear part (``freeze_linear_tangent``) +
       the per-iteration nonaffine gradient blocks;
    3. a working-precision solve, multigrid right-preconditioned
       (``precond="mg"``: ``setup_mg``; ``precond="auxmg"``, unstructured
       meshes: ``setup_auxmg``) or right-Jacobi scaled, with
       inexact-Newton forcing.

    ``inner_operator="sparse"`` (with ``setup_auxmg(smooth="sparse")``)
    runs the inner Krylov iteration on the sparsified tangent
    (``auxmg.SparseInnerOp``), so no inner iteration touches the BSR
    tail.

    The loop stops below ``domain.converge_tol``, after ``max_refine``
    iterations, or when the residual falls by less than ``stall_ratio``.
    With ``sv_func=krylov.chebyshev`` the trip count comes from the
    Chebyshev rate that ``setup_mg()`` measured.

    ``residual_mode``: ``"f64"`` (the default, also for None) carries x
    and the residual in float64.  ``"df32"`` (float32 domains only)
    carries them as two-float pairs: the A_td products through
    ``twofloat.df_offset_mv``, a nonaffine volume's residues in two-float
    arithmetic (``nonaff_res_df``), a boundary-only remainder in float64
    over the boundary rows (``bnd_dofs``, compact ``nonaff_res``), the
    nonaffine tangent blocks in float32 at x's high word (``nl_grad``).
    A ``twofloat.DF`` x gives a DF x back; a tensor x is split on entry
    and the results come back in float64."""
    if domain._refined is None:
        raise RuntimeError("call domain.freeze_refined_residual() first")
    if domain._k_linear_td is None:
        raise RuntimeError("call domain.freeze_linear_tangent() first")
    if residual_mode is None:
        residual_mode = "f64"
    if residual_mode not in ("f64", "df32"):
        raise ValueError(f"unknown residual_mode {residual_mode!r}")
    if residual_mode == "df32" and domain.dtype != torch.float32:
        raise ValueError("residual_mode='df32' expects a float32 domain")
    rows = _row_window(domain, rowshard_mesh)
    A_sh, norm, gather = _sharded_ops(rows)
    mg_hier = None
    aux_static = None
    if precond == "mg":
        from ..linsolve import multigrid
        if domain._mg_frozen is None:
            raise RuntimeError("call domain.setup_mg() first")
        # the hierarchy the frozen state was built for
        mg_hier = domain._mg_hier or multigrid.hierarchy_for_domain(domain)
    elif precond == "auxmg":
        # unstructured meshes: the frozen auxiliary-space hierarchy, its
        # fine Jacobi diagonal refreshed per tangent
        from ..linsolve import auxmg
        if domain._auxmg is None:
            raise RuntimeError("call domain.setup_auxmg() first")
        aux_static = domain._auxmg[1]           # (desc, hier)
    elif precond != "jacobi":
        raise ValueError(f"unknown precond {precond!r}")
    if inner_operator not in ("exact", "sparse"):
        raise ValueError(f"unknown inner_operator {inner_operator!r}")
    if inner_operator == "sparse" and (aux_static is None
                                       or aux_static[0].smooth != "sparse"):
        raise ValueError(
            "inner_operator='sparse' needs precond='auxmg' with "
            "setup_auxmg(smooth='sparse'): the sparsified tangent is the "
            "aux smoother's operator")

    domain._ensure_device_maps(*(("nonaff_nl",) if residual_mode == "f64"
                                 else ("nonaff_res", "nl_grad")))
    pattern = domain.pattern
    ga = domain.time_discretization
    gamma = tuple(ga.gamma_params)
    alpha = tuple(ga.alpha_params)
    tol = float(domain.converge_tol)
    L = pattern.max_time_level
    layout = pattern.offset_layout
    run_phase = domain._run_phase
    sqrt_n = math.sqrt(pattern.basicfield_size)
    sdtype = domain.dtype                       # solve (tangent) precision
    s_np = np.float32 if sdtype == torch.float32 else np.float64

    def A_of(vals) -> OffsetMatrix:
        if A_sh is not None:
            return A_sh(vals)
        return OffsetMatrix.from_values(vals, layout)

    if sv_func is krylov.chebyshev:
        # static trip count and enclosure from the MEASURED rate of the
        # preconditioned operator (setup_mg's or setup_auxmg's tune); the
        # outer loop measures true residuals, so a drifting bound only
        # slows it
        if precond not in ("mg", "auxmg"):
            raise ValueError("chebyshev inner solves need a multigrid "
                             "preconditioner (precond='mg'/'auxmg')")
        tuned = domain._mg_cheb if precond == "mg" else domain._auxmg_cheb
        if tuned is None:
            raise RuntimeError(
                "chebyshev inner solves need the tuned enclosure from "
                "setup_mg()/setup_auxmg() — None there means Chebyshev "
                "can't contract this operator; use a Krylov sv_func")
        interval, rate = tuned
        n_cheb = int(np.ceil(np.log(forcing / 2.0) / np.log(rate)))
        maxiter = int(np.clip(n_cheb, 2, maxiter))
        sv_kwargs = {**sv_kwargs, "interval": interval}

    def solve_f32(state, A, rr, tol_i):
        if mg_hier is not None or aux_static is not None:
            Aw = getattr(A, "inner", A)         # a row-sharded A's window
            if mg_hier is not None:
                op = multigrid.MGOperator(
                    Aw, _frozen_mg(state, rows, mg_hier), mg_hier)
            else:
                desc, hier = aux_static
                op = auxmg.AuxMGOperator(
                    Aw, auxmg.refresh_tangent(Aw, state["auxmg_tree"], desc),
                    hier, desc, rows=rows)
                if inner_operator == "sparse":
                    # tail-free inner iteration on the sparsified tangent;
                    # the outer loop's true residual absorbs the
                    # sparsification error as extra refines
                    op = auxmg.SparseInnerOp(op)
            if rows is not None:
                op = RowShardedMGOperator(op, rows)
            r0, delta = rr, None
            for p in range(max_pass):
                y_i, _, _ = sv_func(op, rr, tol=tol_i, maxiter=maxiter,
                                    **sv_kwargs)
                d_i = op.apply_m(y_i)
                delta = d_i if delta is None else delta + d_i
                if p + 1 < max_pass:
                    rr = r0 - A.mv(delta)
            return delta
        As, unscale = pr_jacobi(A)
        r0, delta = rr, None
        for p in range(max_pass):
            d_i, _, _ = sv_func(As, rr, tol=tol_i, maxiter=maxiter,
                                **sv_kwargs)
            delta = d_i if delta is None else delta + d_i
            if p + 1 < max_pass:
                rr = r0 - As.mv(delta)
        return unscale(delta)

    def inner_tol(res_n: float) -> float:
        return float(max(s_np(tol), s_np(forcing) * s_np(res_n)))

    if residual_mode == "df32":
        step = _df32_step(domain, A_of, solve_f32, inner_tol, max_refine,
                          stall_ratio, static_nl_tangent, rows)
        step.inner_solver = sv_func.__name__
        step.inner_maxiter = maxiter
        return step

    def step(state, x, t, dt):
        f64 = torch.float64
        x = x.to(f64)
        dev = x.device
        levels = L + 1
        dt64 = float(dt)
        prod_gamma = np.asarray([np.prod(gamma[:i]) for i in range(levels)],
                                np.float64)
        dt_pow = np.asarray([dt64 ** i for i in range(levels)], np.float64)
        beta = 1.0 / (prod_gamma * dt_pow)
        K_params64 = np.asarray(alpha[:levels], np.float64) * beta
        beta_t = device_constant(beta, f64, dev)
        K_params64_t = device_constant(K_params64, f64, dev)

        ref = state["refined"]
        mats = _matrices(ref, rows)
        if "A_mats" not in mats:
            # the frozen A_td as matrices kept in the freeze's record, so
            # that each packs its values (dense groups and tail) once (a
            # row-sharded step: the window's rows, products of a whole x)
            mats["A_mats"] = [A_of(a) for a in held(rows, ref, "A",
                                                   storage=True)]
            if rows is not None:
                mats["A_mats"] = [a.inner for a in mats["A_mats"]]
        A64 = mats["A_mats"]
        b64 = held(rows, ref, "b")
        K_lin = combine_klin(state, K_params64.astype(s_np), rows)

        def residual_and_knl(dx, with_grad=True):
            xs = x_star_of(x, dx, alpha)                        # f64
            r = b64
            for td in range(levels):
                r = r + A64[td].mv(xs[td])
            st64 = {**state, "wp": ref["wp"], "x_star": xs,
                    "K_params": K_params64_t, "t": float(t), "dt": dt64}
            r_nl, K_nl = run_phase(st64, "nonaff_nl")
            return (r + constrain(rows, r_nl),
                    constrain(rows, K_nl, storage=True) if with_grad
                    else None)

        dx = initialize_dx(x, dt64, gamma)
        r64, K_nl = residual_and_knl(dx)
        res = float(norm(r64)) / sqrt_n
        res_prev = float(np.finfo(np.float32).max)
        it = 0
        while res > tol and it < max_refine and res < stall_ratio * res_prev:
            A = A_of(K_lin + K_nl.to(sdtype))
            delta = solve_f32(state, A, r64.to(sdtype), inner_tol(res))
            delta = gather(delta)               # whole on every rank
            dx = dx + beta_t[:, None] * (-delta.to(f64))[None, :]
            r64, K_nlb = residual_and_knl(dx,
                                          with_grad=not static_nl_tangent)
            if K_nlb is not None:
                K_nl = K_nlb
            res_prev, res = res, float(norm(r64)) / sqrt_n
            it += 1
        return x + dx, dx, res, it

    step.inner_solver = sv_func.__name__
    step.inner_maxiter = maxiter        # the Chebyshev trip count
    return step


def _df_operator(ref: dict, layout, rows=None) -> tuple:
    """The frozen operator of the two-float mode: A_td and b as DF pairs
    (split from the float64 freeze on its device at the first call, or
    the pairs loaded from the reference) and each A_td's packed pair
    (``twofloat.df_pack``), kept in the freeze's record.  ``rows``: a
    row-sharded step's window (the pairs of its rows and storage, packed
    over its plans)."""
    if "A_hi" not in ref:
        A, b = tf.df_from_f64(ref["A"]), tf.df_from_f64(ref["b"])
        ref.update(A_hi=A.hi, A_lo=A.lo, b_hi=b.hi, b_lo=b.lo)
    A = [tf.DF(hi, lo) for hi, lo in zip(held(rows, ref, "A_hi", True),
                                         held(rows, ref, "A_lo", True))]
    mats = _matrices(ref, rows)
    if "A_packed" not in mats:
        mats["A_packed"] = [tf.df_pack(a, layout,
                                       window=None if rows is None
                                       else rows.mine) for a in A]
    return (A, tf.DF(held(rows, ref, "b_hi"), held(rows, ref, "b_lo")),
            mats["A_packed"])


def _df32_step(domain, A_of, solve_f32, inner_tol, max_refine, stall_ratio,
               static_nl_tangent, rows=None):
    """The refined step's ``df32`` branch (the reference's
    ``jit_step.py:532-674``) as a host loop: x, dx and the residual as DF
    pairs, the tangent and the solves in float32 (``A_of``,
    ``solve_f32`` and ``inner_tol`` of ``make_refined_step``)."""
    ga = domain.time_discretization
    gamma = tuple(ga.gamma_params)
    alpha = tuple(ga.alpha_params)
    tol = float(domain.converge_tol)
    pattern = domain.pattern
    L = pattern.max_time_level
    layout = pattern.offset_layout
    run_phase = domain._run_phase
    sqrt_n = math.sqrt(pattern.basicfield_size)
    bfs = pattern.basicfield_size
    f32, f64 = torch.float32, torch.float64
    nonaff_maps = domain._device_maps["nonaff_res"]
    _, norm, gather = _sharded_ops(rows)
    window = None if rows is None else rows.mine
    touched_at = None
    if rows is not None and "r_touched" in nonaff_maps:
        # the touched rows the window holds: (their place among the
        # touched rows, their place in the window)
        touched = nonaff_maps["r_touched"]
        lpos = torch.full((bfs,), -1, dtype=torch.int64,
                          device=touched.device)
        lpos[window.tables(touched.device)["rows"]] = torch.arange(
            rows.n_local, device=touched.device)
        lt = lpos[touched]
        sel = lt >= 0
        touched_at = (sel, lt[sel])

    def step(state, x, t, dt):
        as_pair = isinstance(x, tf.DF)
        xdf = x if as_pair else tf.df_from_f64(x.to(f64))
        dev = xdf.hi.device
        levels = L + 1
        dt64 = float(dt)
        prod_gamma = np.asarray([np.prod(gamma[:i]) for i in range(levels)],
                                np.float64)
        dt_pow = np.asarray([dt64 ** i for i in range(levels)], np.float64)
        beta64 = 1.0 / (prod_gamma * dt_pow)
        K_params64 = np.asarray(alpha[:levels], np.float64) * beta64
        beta32 = device_constant(beta64.astype(np.float32), f32, dev)
        K_params64_t = device_constant(K_params64, f64, dev)
        K_params32_t = device_constant(K_params64.astype(np.float32), f32,
                                       dev)
        alpha32 = device_constant(np.float32(alpha[:levels]), f32, dev)

        ref = state["refined"]
        A_df, b_df, packed = _df_operator(ref, layout, rows)
        K_lin = combine_klin(state, K_params64.astype(np.float32), rows)
        dtp = tf.df_const(dt64, dev)

        def df_initialize_dx(xp: tf.DF) -> tf.DF:
            """The generalized-alpha predictor in DF arithmetic."""
            dx_hi = torch.zeros_like(xp.hi)
            dx_lo = torch.zeros_like(xp.lo)
            for level in range(levels - 1, 0, -1):
                row = tf.df_add(tf.DF(xp.hi[level], xp.lo[level]),
                                tf.df_scale(tf.DF(dx_hi[level],
                                                  dx_lo[level]),
                                            float(gamma[level - 1])))
                row = tf.df_scale_df(row, dtp)
                dx_hi[level - 1] = row.hi
                dx_lo[level - 1] = row.lo
            return tf.DF(dx_hi, dx_lo)

        def residual_and_knl(dxdf: tf.DF, with_grad=True):
            xs = tf.df_add(xdf, tf.df_scale(dxdf, alpha32[:, None]))
            r = b_df
            for td in range(levels):
                r = tf.df_add(r, tf.df_offset_mv(
                    A_df[td], layout, tf.DF(xs.hi[td], xs.lo[td]),
                    packed=packed[td], window=window))
            if ref["wp_df"] is not None:
                # nonaffine volume: every nonaffine residue in two-float
                # arithmetic over the frozen DF tables
                st_df = {**state, "wp": ref["wp_df"], "x_star": xs,
                         "K_params": K_params64_t, "t": float(t),
                         "dt": dt64}
                r_nl = run_phase(st_df, "nonaff_res_df")[0]
                r = tf.df_add(r, tf.DF(constrain(rows, r_nl.hi),
                                       constrain(rows, r_nl.lo)))
            elif "r_touched" in nonaff_maps:
                # boundary-only nonaffinity: float64 x* at the boundary
                # rows only, the remainder over the touched rows, added
                # into the pair there exactly
                bnd = ref["bnd_dofs"]
                xs64 = torch.zeros((levels, bfs), dtype=f64, device=dev)
                xs64[:, bnd] = (xs.hi[:, bnd].to(f64)
                                + xs.lo[:, bnd].to(f64))
                st64 = {**state, "wp": ref["wp"], "x_star": xs64,
                        "K_params": K_params64_t, "r_compact": True,
                        "t": float(t), "dt": dt64}
                r_nl_c = run_phase(st64, "nonaff_res")[0]
                touched = nonaff_maps["r_touched"]
                if touched_at is not None:
                    # the window's touched rows, at their window places
                    r_nl_c = r_nl_c[touched_at[0]]
                    touched = touched_at[1]
                t_df = tf.df_from_f64(r.hi[touched].to(f64)
                                      + r.lo[touched].to(f64) + r_nl_c)
                r.hi[touched] = t_df.hi     # r is this call's own pair
                r.lo[touched] = t_df.lo
            elif "r" in nonaff_maps:
                # a boundary remainder touching too many rows for a
                # compact map: float64 over the whole vector
                st64 = {**state, "wp": ref["wp"], "x_star": tf.df_to_f64(xs),
                        "K_params": K_params64_t, "t": float(t),
                        "dt": dt64}
                r = tf.df_add(r, tf.df_from_f64(
                    constrain(rows, run_phase(st64, "nonaff_res")[0])))
            if not with_grad:
                return r, None
            # the nonaffine tangent blocks in float32 at x's high word:
            # the tangent sets the convergence rate, not the answer (a
            # sharded state's element block lands on the window's
            # storage by the assembly's reduce-scatter)
            st32 = {**state, "x_star": xs.hi, "K_params": K_params32_t}
            if rows is not None:
                st32["row_window"] = rows
            return r, run_phase(st32, "nl_grad")[1]

        def norm_n(r: tf.DF) -> float:
            return float(norm(r.hi)) / sqrt_n

        dx = df_initialize_dx(xdf)
        r, K_nl = residual_and_knl(dx)
        res = norm_n(r)
        res_prev = float(np.finfo(np.float32).max)
        it = 0
        while res > tol and it < max_refine and res < stall_ratio * res_prev:
            A = A_of(K_lin + K_nl)
            delta = gather(solve_f32(state, A, r.hi, inner_tol(res)))
            dx = tf.df_add_f32(dx, -beta32[:, None] * delta[None, :])
            r, K2 = residual_and_knl(dx, with_grad=not static_nl_tangent)
            if K2 is not None:
                K_nl = K2
            res_prev, res = res, norm_n(r)
            it += 1
        x_new = tf.df_add(xdf, dx)
        if as_pair:
            return x_new, dx, res, it
        return tf.df_to_f64(x_new), tf.df_to_f64(dx), res, it

    return step
