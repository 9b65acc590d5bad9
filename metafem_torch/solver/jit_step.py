"""The refined Newton step: exact float64 residuals, working-precision
multigrid solves.

Port of ``make_refined_step`` of ``metafem/solver/jit_step.py`` in its
``residual_mode="f64"``.  The reference stages the whole step as one
jitted ``lax.while_loop``; here it is a host loop over device tensors
that reads the float64 residual norm back once per refine iteration.
The card computes float64 natively, so ``x`` is carried in float64
between steps (the two-float carry of the reference's ``df32`` mode,
which exists for the TPU's emulated float64, is not needed in this mode
and is not ported).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..linsolve import krylov
from ..linsolve.block_offset import OffsetMatrix
from ..linsolve.precond import pr_jacobi
from .time_domain import initialize_dx, x_star_of


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

    1. the float64 residual from the frozen affine decomposition
       (``domain.freeze_refined_residual``): SpMVs against A_td and b
       plus the small nonaffine boundary remainder;
    2. the tangent = frozen linear part (``freeze_linear_tangent``) +
       the per-iteration nonaffine gradient blocks;
    3. a working-precision solve, multigrid right-preconditioned
       (``setup_mg``) or right-Jacobi scaled, with inexact-Newton
       forcing.

    The loop stops below ``domain.converge_tol``, after ``max_refine``
    iterations, or when the residual falls by less than ``stall_ratio``.
    With ``sv_func=krylov.chebyshev`` the trip count comes from the
    Chebyshev rate that ``setup_mg()`` measured."""
    if domain._refined is None:
        raise RuntimeError("call domain.freeze_refined_residual() first")
    if domain._k_linear_td is None:
        raise RuntimeError("call domain.freeze_linear_tangent() first")
    if residual_mode is None:
        residual_mode = "f64"
    if residual_mode == "df32":
        raise NotImplementedError(
            "residual_mode='df32' (two-float residuals) is not ported yet "
            "(ROADMAP.md queue 1, item 9)")
    if residual_mode != "f64":
        raise ValueError(f"unknown residual_mode {residual_mode!r}")
    if rowshard_mesh is not None:
        raise NotImplementedError(
            "rowshard_mesh (multi-device row sharding) is not ported yet "
            "(ROADMAP.md queue 1, item 13)")
    if inner_operator == "sparse":
        raise NotImplementedError(
            "inner_operator='sparse' needs the auxiliary-space multigrid, "
            "not ported yet (ROADMAP.md queue 1, item 11)")
    if inner_operator != "exact":
        raise ValueError(f"unknown inner_operator {inner_operator!r}")
    if precond == "auxmg":
        raise NotImplementedError(
            "precond='auxmg' is not ported yet (ROADMAP.md queue 1, "
            "item 11)")
    mg_hier = None
    if precond == "mg":
        from ..linsolve import multigrid
        if domain._mg_frozen is None:
            raise RuntimeError("call domain.setup_mg() first")
        # the hierarchy the frozen state was built for
        mg_hier = domain._mg_hier or multigrid.hierarchy_for_domain(domain)
    elif precond != "jacobi":
        raise ValueError(f"unknown precond {precond!r}")

    domain._ensure_device_maps("nonaff_nl")
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
        return OffsetMatrix.from_values(vals, layout)

    if sv_func is krylov.chebyshev:
        # static trip count and enclosure from the MEASURED rate of the
        # preconditioned operator (setup_mg's tune); the outer loop
        # measures true residuals, so a drifting bound only slows it
        if precond != "mg":
            raise ValueError("chebyshev inner solves need the multigrid "
                             "preconditioner (precond='mg')")
        if domain._mg_cheb is None:
            raise RuntimeError(
                "chebyshev inner solves need the tuned enclosure from "
                "setup_mg() — None there means Chebyshev can't contract "
                "this operator; use a Krylov sv_func")
        interval, rate = domain._mg_cheb
        n_cheb = int(np.ceil(np.log(forcing / 2.0) / np.log(rate)))
        maxiter = int(np.clip(n_cheb, 2, maxiter))
        sv_kwargs = {**sv_kwargs, "interval": interval}

    def combine_klin(state, K_params_s):
        """sum_td K_params[td] * K_linear_td[td] (+ ghost diagonal), one
        scalar-times-vector add per time level."""
        K_td = state["K_linear_td"]
        K = float(K_params_s[0]) * K_td[0]
        for td in range(1, L + 1):
            K = K + float(K_params_s[td]) * K_td[td]
        if state.get("ghost_diag") is not None:
            K = K + state["ghost_diag"]
        return K

    def solve_f32(state, A, rr, tol_i):
        if mg_hier is not None:
            op = multigrid.MGOperator(A, state["mg_frozen"], mg_hier)
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
        beta_t = torch.as_tensor(beta, dtype=f64, device=dev)
        K_params64_t = torch.as_tensor(K_params64, dtype=f64, device=dev)

        ref = state["refined"]
        A64, b64 = ref["A"], ref["b"]
        K_lin = combine_klin(state, K_params64.astype(s_np))

        def residual_and_knl(dx, with_grad=True):
            xs = x_star_of(x, dx, alpha)                        # f64
            r = b64
            for td in range(levels):
                r = r + A_of(A64[td]).mv(xs[td])
            st64 = {**state, "wp": ref["wp"], "x_star": xs,
                    "K_params": K_params64_t, "t": float(t), "dt": dt64}
            r_nl, K_nl = run_phase(st64, "nonaff_nl")
            return r + r_nl, (K_nl if with_grad else None)

        dx = initialize_dx(x, dt64, gamma)
        r64, K_nl = residual_and_knl(dx)
        res = float(torch.linalg.norm(r64)) / sqrt_n
        res_prev = float(np.finfo(np.float32).max)
        it = 0
        while res > tol and it < max_refine and res < stall_ratio * res_prev:
            A = A_of(K_lin + K_nl.to(sdtype))
            delta = solve_f32(state, A, r64.to(sdtype), inner_tol(res))
            dx = dx + beta_t[:, None] * (-delta.to(f64))[None, :]
            r64, K_nlb = residual_and_knl(dx,
                                          with_grad=not static_nl_tangent)
            if K_nlb is not None:
                K_nl = K_nlb
            res_prev, res = res, float(torch.linalg.norm(r64)) / sqrt_n
            it += 1
        return x + dx, dx, res, it

    step.inner_solver = sv_func.__name__
    step.inner_maxiter = maxiter        # the Chebyshev trip count
    return step
