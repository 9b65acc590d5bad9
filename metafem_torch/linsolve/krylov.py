"""Matrix-free Krylov solvers, host-driven loops over device tensors.

The port of the reference's ``metafem/linsolve/krylov.py``: the shared
helpers (``_dot``, ``_norm``, ``_nn``, ``_prep``, ``_modify_omega``) and
the whole solver menu, CG, BiCGStab, BiCGStab(l) (Gram and Gram-Schmidt
minimal-residual parts), IDR(s) (biorthogonal and original), restarted
GMRES, LSQR, CGS, CGS2, TFQMR and the Chebyshev iteration.  Signature of
every solver:

    solver(A, b, x0=None, tol=..., maxiter=..., pl=None, ...)
        -> (x, iters, normalized_residual)

with ``tol`` on the normalized norm ||r|| / sqrt(n) and ``pl`` an
optional left-preconditioner diagonal.  The reference's
``lax.while_loop`` becomes a Python loop that reads ``_nn(r) > tol`` back
once per iteration; the arithmetic runs in the reference's order and the
iteration counts are the reference's (BiCGStab(l) counts l per cycle,
IDR(s) s + 1, GMRES its restart length).  Vectors stay on the operator's
device; the small dense systems (the l x l Gram solve of BiCGStab(l),
the s x s solves of IDR(s), GMRES's Givens rotations and triangular
solve) run on the host in float64 after one readback each.  Chebyshev has
a fixed trip count and reads nothing back inside its loop.

The reference draws the shadow spaces of IDR(s), CGS2 and TFQMR from
``jax.random`` keys 0, 1 and 2.  Here each solver takes that array as an
argument (``P``, ``s0``, ``jitter``), by default normal numbers from a
CPU ``torch.Generator`` seeded 0, 1 and 2, so runs on the CPU and on the
card start alike.

Every solver also runs on a row-sharded operator (``parallel.rowshard``):
its vectors hold the rank's rows, every dot and norm is all-reduced, a
shadow array is drawn whole and cut to the rank's rows, the host's small
systems are built from all-reduced values (so every rank takes the same
branch), and LSQR's A.T u is ``RowShardedOp.tmv``.

float32 dots are compensated (the reference's dot2, ``_dot``): at ~1e6
DOF plain float32 dots cancel and the Krylov recurrences break down.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.linalg import solve_triangular

from .twofloat import two_prod as _two_prod

_BLOCK = 1024


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """Sums of 1024-element blocks of a float32 vector, accumulated in
    float64, then a float64 sum of the (short) block-sum vector.

    The reference accumulates the blocks in float32 because float64 is
    emulated on its TPU; there the result rests on XLA summing
    neighbours first.  PyTorch's vectorized reductions interleave far
    elements, which leaves float32 block sums ~u * sum|v| off on
    cancelling dots (tests/test_torch_krylov.py), and the card computes
    float64 natively, so the blocks accumulate in float64 here."""
    n = v.shape[0]
    m = -(-n // _BLOCK)
    vp = torch.nn.functional.pad(v, (0, m * _BLOCK - n)).view(m, _BLOCK)
    return vp.sum(dim=1, dtype=torch.float64).sum()


def _rows(A):
    """The row window of a row-sharded operator (``parallel.rowshard``:
    vectors hold the rank's rows, every reduction is a local sum plus one
    all-reduce over the mesh), or None for a whole operator."""
    return getattr(A, "row_window", None)


def _local_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The inner product of the vectors at hand: float64 for float32
    vectors, accumulated as the reference's dot2 (error-free elementwise
    products p + err, both block-summed with a float64 tail)."""
    if a.dtype == torch.float64:
        return torch.dot(a, b)
    if a.dtype != torch.float32:
        raise NotImplementedError(
            f"Krylov solves run in float32 or float64, not {a.dtype}")
    p, err = _two_prod(a, b)
    return _block_sum(p) + _block_sum(err)


def _reduce(fn, rows, *vs) -> torch.Tensor:
    """fn of the vectors vs; over a row window (``_rows``) the sum over
    ranks of fn of each rank's rows (``rows.reduce``), the same bits on
    every rank."""
    return fn(*vs) if rows is None else rows.reduce(fn, *vs)


def _dot(a: torch.Tensor, b: torch.Tensor, rows=None) -> torch.Tensor:
    """Inner product (``_local_dot``, reduced over ``rows``); float32
    vectors sum in float64 and return float32."""
    d = _reduce(_local_dot, rows, a, b)
    return d if a.dtype == torch.float64 else d.to(torch.float32)


def _norm(v: torch.Tensor, rows=None) -> torch.Tensor:
    return torch.sqrt(_dot(v, v, rows))


def _nn(v: torch.Tensor, rows=None) -> torch.Tensor:
    n = v.shape[0] if rows is None else rows.n
    return _norm(v, rows) / math.sqrt(n)


def _mdot(M: torch.Tensor, v: torch.Tensor, rows=None) -> torch.Tensor:
    """M @ v for a short stack of vectors M (IDR(s)'s shadow space,
    GMRES's basis), reduced over ``rows``."""
    return _reduce(torch.matmul, rows, M, v)


def _pl(pl, v):
    return v if pl is None else pl * v


def _prep(A, b, x0, pl):
    x = torch.zeros_like(b) if x0 is None else x0
    r = _pl(pl, b - A.mv(x))
    return x, r


def bicgstab(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None):
    rw = _rows(A)
    x, r = _prep(A, b, x0, pl)
    rt = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    i = 0
    while i < maxiter and float(_nn(r, rw)) > tol:
        rho_new = _dot(rt, r, rw)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = _pl(pl, A.mv(p))
        alpha = rho_new / _dot(rt, v, rw)
        s = r - alpha * v
        t = _pl(pl, A.mv(s))
        omega = _dot(t, s, rw) / _dot(t, t, rw)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        i += 1
    return x, i, _nn(r, rw)


# ---------------------------------------------------------------------------
# Chebyshev
# ---------------------------------------------------------------------------

def _np_dtype(dtype: torch.dtype):
    if dtype == torch.float32:
        return np.float32
    if dtype == torch.float64:
        return np.float64
    raise NotImplementedError(
        f"Krylov solves run in float32 or float64, not {dtype}")


def _cheb_scalars(interval, dtype: torch.dtype):
    """(theta, delta, sigma1) of the enclosure, in the working precision
    (numpy scalars of the tensor dtype, so the host arithmetic rounds as
    the device's would)."""
    f = _np_dtype(dtype)
    lo, hi = interval
    theta = f((hi + lo) / 2.0)
    delta = f((hi - lo) / 2.0)
    return theta, delta, theta / delta


def chebyshev(A, b, x0=None, tol=None, maxiter=8, pl=None,
              interval=(0.05, 1.95)):
    """Preconditioned Chebyshev iteration (Saad, Iterative Methods,
    Alg. 12.1) on a spectrum enclosure ``interval`` of A: no inner
    products, each iteration one operator apply plus two axpys, a fixed
    trip count of ``maxiter``.  ``tol`` is ignored; the caller measures
    true residuals outside."""
    rw = _rows(A)
    carry = chebyshev_init(A, b, x0=x0, pl=pl, interval=interval)
    x, r, _, _ = chebyshev_steps(A, carry, maxiter, interval, pl=pl)
    return x, maxiter, _nn(r, rw)


def chebyshev_init(A, b, x0=None, pl=None, interval=(0.05, 1.95)):
    """Initial (x, r, d, rho) recurrence carry for chebyshev_steps."""
    theta, _, sigma1 = _cheb_scalars(interval, b.dtype)
    x = torch.zeros_like(b) if x0 is None else x0
    r = _pl(pl, b - A.mv(x)) if x0 is not None else _pl(pl, b)
    return x, r, r / float(theta), sigma1.dtype.type(1.0) / sigma1


def chebyshev_steps(A, carry, n, interval, pl=None):
    """Advance the Chebyshev recurrence ``n`` iterations; returns the
    carry (resumable: composing chunks reproduces one long solve).  The
    scalar recurrence depends on the interval alone, so it runs on the
    host in the working precision and no value is read back."""
    x, r, d, rho_prev = carry
    _, delta, sigma1 = _cheb_scalars(interval, x.dtype)
    f = _np_dtype(x.dtype)
    one, two = f(1.0), f(2.0)
    rho_prev = f(rho_prev)
    for _ in range(n):
        x = x + d
        r = r - _pl(pl, A.mv(d))
        rho_k = one / (two * sigma1 - rho_prev)
        d = float(rho_k * rho_prev) * d + float(two * rho_k / delta) * r
        rho_prev = rho_k
    return x, r, d, rho_prev


# ---------------------------------------------------------------------------
# shared pieces of the rest of the menu
# ---------------------------------------------------------------------------

_ANGLE = math.sqrt(2.0) / 2.0


def _full(value: float, b: torch.Tensor) -> torch.Tensor:
    """A device scalar of b's type (a fill, no host-to-device copy)."""
    return torch.full((), value, dtype=b.dtype, device=b.device)


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    """v with exact zeros replaced by 1 (the reference's guarded
    divisions)."""
    return torch.where(v == 0, torch.ones_like(v), v)


def _shadow(v, seed: int, shape, b: torch.Tensor,
            rows=None) -> torch.Tensor:
    """The random array ``v`` on b's device and type, or normal numbers
    from a CPU generator seeded ``seed`` when ``v`` is None; ``shape``
    whole.  With a row window (``_rows``) the rank's rows of it (the
    last axis): every rank draws the whole array and keeps its rows, so
    the sharded solve works in the whole solve's random space."""
    if v is None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        v = torch.randn(shape, generator=gen, dtype=b.dtype).to(b.device)
    else:
        v = v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
        v = v.to(dtype=b.dtype, device=b.device).reshape(shape)
    return v if rows is None else rows.local(v)


def _host(v: torch.Tensor) -> np.ndarray:
    """One readback, as float64 numbers."""
    return v.detach().cpu().numpy().astype(np.float64)


def _dev(a: np.ndarray, b: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=b.dtype).to(b.device)


def _modify_omega(t, r, rows=None):
    """Omega angle stabilization (modify_Omega, 04_IDRs.jl:1-8)."""
    tn, rn = _norm(t, rows), _norm(r, rows)
    tr = _dot(t, r, rows)
    rho = torch.abs(tr / _nonzero(tn * rn))
    omega = tr / torch.where(tn == 0, torch.ones_like(tn), tn * tn)
    return torch.where(rho < _ANGLE, omega * _ANGLE / _nonzero(rho), omega)


# ---------------------------------------------------------------------------
# CG (for SPD systems)
# ---------------------------------------------------------------------------

def cg(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None):
    rw = _rows(A)
    x, r = _prep(A, b, x0, pl)
    p = r
    rs = _dot(r, r, rw)
    i = 0
    while i < maxiter and float(_nn(r, rw)) > tol:
        Ap = _pl(pl, A.mv(p))
        alpha = rs / _dot(p, Ap, rw)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _dot(r, r, rw)
        p = r + (rs_new / rs) * p
        rs = rs_new
        i += 1
    return x, i, _nn(r, rw)


# ---------------------------------------------------------------------------
# BiCGStab(l) (03_BiCGstabl.jl)
# ---------------------------------------------------------------------------

def _bicg_part(A, rt, x, rs, us, rho0, alpha, pl, l):
    """The l BiCG steps of one BiCGStab(l) cycle, in place on the lists
    rs and us; returns (x, rho0, alpha)."""
    for j in range(l):
        rw = _rows(A)
        rho1 = _dot(rt, rs[j], rw)
        beta = alpha * rho1 / rho0
        rho0 = rho1
        for k in range(j + 1):
            us[k] = rs[k] - beta * us[k]
        us[j + 1] = _pl(pl, A.mv(us[j]))
        gamma = _dot(rt, us[j + 1], rw)
        alpha = rho0 / gamma
        for k in range(j + 1):
            rs[k] = rs[k] - alpha * us[k + 1]
        rs[j + 1] = _pl(pl, A.mv(rs[j]))
        x = x + alpha * us[0]
    return x, rho0, alpha


def bicgstabl(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None, s: int = 2):
    """BiCGStab(l) with l = s stages (03_BiCGstabl.jl); the
    minimal-residual part solves the small normal equations on the Gram
    matrix, read back once per cycle and solved on the host in
    float64."""
    rw = _rows(A)
    l = s
    x, r0 = _prep(A, b, x0, pl)
    rt = r0
    u0 = torch.zeros_like(b)
    rho0 = _full(1.0, b)
    alpha = _full(0.0, b)
    omega = 1.0
    i = 0
    while i < maxiter and float(_nn(r0, rw)) > tol:
        rho0 = -omega * rho0
        rs = [r0] + [None] * l
        us = [u0] + [None] * l
        x, rho0, alpha = _bicg_part(A, rt, x, rs, us, rho0, alpha, pl, l)
        # MR part: minimize || rs[0] - sum_j gamma_j rs[j] || (the Gram
        # matrix is symmetric, and so is each dot: computed once)
        dots = {}
        for i_ in range(1, l + 1):
            for j_ in range(i_, l + 1):
                dots[i_, j_] = _dot(rs[i_], rs[j_], rw)
        z0 = [_dot(rs[0], rs[j_], rw) for j_ in range(1, l + 1)]
        host = _host(torch.stack(list(dots.values()) + z0))
        Z = np.empty((l, l))
        for (i_, j_), v in zip(dots, host):
            Z[i_ - 1, j_ - 1] = Z[j_ - 1, i_ - 1] = v
        gam = np.linalg.solve(Z, host[len(dots):])
        omega = float(gam[l - 1])
        u0_, r0_, x_ = us[0], rs[0], x
        for j in range(1, l + 1):
            g = float(gam[j - 1])
            u0_ = u0_ - g * us[j]
            x_ = x_ + g * rs[j - 1]
            r0_ = r0_ - g * rs[j]
        x, r0, u0 = x_, r0_, u0_
        i += l
    return x, i, _nn(r0, rw)


def bicgstabl_gs(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None,
                 s: int = 2):
    """BiCGStab(l) with the minimal-residual part solved by modified
    Gram-Schmidt orthogonalization (Sleijpen-Fokkema 1993, Alg. 3.1), the
    reference's ``bicgstabl_GS!`` (03_BiCGstabl.jl:16): MGS works on the
    residual vectors directly instead of the Gram matrix, whose
    conditioning is squared.  Its scalars stay on the device."""
    rw = _rows(A)
    l = s
    x, r0 = _prep(A, b, x0, pl)
    rt = r0
    u0 = torch.zeros_like(b)
    rho0 = _full(1.0, b)
    alpha = _full(0.0, b)
    omega = _full(1.0, b)
    i = 0
    while i < maxiter and float(_nn(r0, rw)) > tol:
        rho0 = -omega * rho0
        rs = [r0] + [None] * l
        us = [u0] + [None] * l
        x, rho0, alpha = _bicg_part(A, rt, x, rs, us, rho0, alpha, pl, l)
        tau = [[None] * (l + 1) for _ in range(l + 1)]
        sigma = [None] * (l + 1)
        gamma_p = [None] * (l + 1)
        for j in range(1, l + 1):
            for i_ in range(1, j):
                tij = _dot(rs[j], rs[i_], rw) / sigma[i_]
                tau[i_][j] = tij
                rs[j] = rs[j] - tij * rs[i_]
            sigma[j] = _dot(rs[j], rs[j], rw)
            gamma_p[j] = _dot(rs[0], rs[j], rw) / sigma[j]
        gam = [None] * (l + 1)
        gam[l] = gamma_p[l]
        omega = gam[l]
        for j in range(l - 1, 0, -1):
            acc = _full(0.0, b)
            for i_ in range(j + 1, l + 1):
                acc = acc + tau[j][i_] * gam[i_]
            gam[j] = gamma_p[j] - acc
        gam_pp = [None] * l
        for j in range(1, l):
            acc = _full(0.0, b)
            for i_ in range(j + 1, l):
                acc = acc + tau[j][i_] * gam[i_ + 1]
            gam_pp[j] = gam[j + 1] + acc
        x = x + gam[1] * rs[0]
        rs[0] = rs[0] - gamma_p[l] * rs[l]
        us[0] = us[0] - gam[l] * us[l]
        for j in range(1, l):
            us[0] = us[0] - gam[j] * us[j]
            x = x + gam_pp[j] * rs[j]
            rs[0] = rs[0] - gamma_p[j] * rs[j]
        r0, u0 = rs[0], us[0]
        i += l
    return x, i, _nn(r0, rw)


# ---------------------------------------------------------------------------
# IDR(s) (04_IDRs.jl)
# ---------------------------------------------------------------------------

def idrs(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None, s: int = 4,
         P=None):
    """IDR(s), biorthogonal variant (04_IDRs.jl idrs!).  ``P``: the
    [s, n] shadow space (default: normal numbers seeded 0).  The s x s
    matrix M and the projections f = P r live on the host in float64:
    one readback of f per cycle and of P g_k per inner step."""
    rw = _rows(A)
    x, r = _prep(A, b, x0, pl)
    n = b.shape[0] if rw is None else rw.n
    P = _shadow(P, 0, (s, n), b, rw)   # the rank's rows of the space
    n = b.shape[0]
    G = torch.zeros((s, n), dtype=b.dtype, device=b.device)
    U = torch.zeros_like(G)
    M = np.eye(s)
    omega = _full(1.0, b)
    i = 0
    while i < maxiter and float(_nn(r, rw)) > tol:
        f = _host(_mdot(P, r, rw))
        for k in range(s):
            # lower-triangular M[k:, k:] c = f[k:], zero above k
            c = np.zeros(s)
            c[k:] = solve_triangular(M[k:, k:], f[k:], lower=True)
            ct = _dev(c, b)[:, None]
            v = r - (ct * G).sum(0)
            q = (ct * U).sum(0)
            u_k = q + omega * v
            g_k = _pl(pl, A.mv(u_k))
            for i2 in range(k):      # biorthogonalize against P[:k]
                alpha = _dot(P[i2], g_k, rw) / float(M[i2, i2])
                g_k = g_k - alpha * G[i2]
                u_k = u_k - alpha * U[i2]
            G[k] = g_k
            U[k] = u_k
            m_col = _host(_mdot(P, g_k, rw))
            M[k:, k] = m_col[k:]
            beta = float(f[k] / M[k, k])
            r = r - beta * g_k
            x = x + beta * u_k
            f[k + 1:] = f[k + 1:] - beta * m_col[k + 1:]
        # entering G_{j+1}
        v = r
        t = _pl(pl, A.mv(v))
        omega = _modify_omega(t, r, rw)
        x = x + omega * v
        r = r - omega * t
        i += s + 1
    return x, i, _nn(r, rw)


def idrs_original(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None,
                  s: int = 4, P=None):
    """IDR(s), original (non-biorthogonalized) variant: the Sonneveld &
    van Gijzen 2008 prototype with direct s x s ``M c = f`` solves
    against the full shadow matrix, the counterpart of the reference's
    ``idrs_original!`` (04_IDRs.jl:97-166).  ``P`` as in ``idrs``; M
    and f on the host in float64."""
    rw = _rows(A)
    x, r = _prep(A, b, x0, pl)
    P = _shadow(P, 0, (s, b.shape[0] if rw is None else rw.n), b, rw)
    n = b.shape[0]
    U = torch.zeros((s, n), dtype=b.dtype, device=b.device)
    G = torch.zeros_like(U)
    M = np.zeros((s, s))
    omega = _full(1.0, b)
    # initial space: s smoothed power steps fill U, G = A U, M = P G'
    # (M and f = P r from all-reduced projections: every rank solves the
    # same s x s systems with the same bits)
    for k in range(s):
        u = r
        g = _pl(pl, A.mv(r))
        omega = _modify_omega(g, r, rw)
        x = x + omega * u
        r = r - omega * g
        U[k] = u
        G[k] = g
        M[:, k] = _host(_mdot(P, g, rw))
    i = 0
    while i < maxiter and float(_nn(r, rw)) > tol:
        # k = 0: step into G_{j+1}, refresh omega
        c = _dev(np.linalg.solve(M, _host(_mdot(P, r, rw))), b)
        v = r - c @ G
        q = c @ U
        t = _pl(pl, A.mv(v))
        omega = _modify_omega(t, v, rw)
        x = x + q + omega * v
        r = v - omega * t
        # k = 1..s: rebuild the s directions inside G_{j+1}
        for k in range(s):
            c = _dev(np.linalg.solve(M, _host(_mdot(P, r, rw))), b)
            v = r - c @ G
            u_k = c @ U + omega * v
            g_k = _pl(pl, A.mv(u_k))
            x = x + u_k
            r = r - g_k
            U[k] = u_k
            G[k] = g_k
            M[:, k] = _host(_mdot(P, g_k, rw))
        i += s + 1
    return x, i, _nn(r, rw)


# ---------------------------------------------------------------------------
# restarted GMRES (05_GMRES.jl)
# ---------------------------------------------------------------------------

def _givens_solve(H: np.ndarray, beta: float, restart: int) -> np.ndarray:
    """Least-squares y of the (restart+1) x restart Hessenberg system
    H y = beta e1 by one Givens rotation per column (05_GMRES.jl:7-37),
    then the upper-triangular solve, zero diagonals read as 1."""
    R = H.copy()
    g = np.zeros(restart + 1)
    g[0] = beta
    for j in range(restart):
        a, c_ = R[j, j], R[j + 1, j]
        denom = math.sqrt(a * a + c_ * c_)
        cs, sn = (1.0, 0.0) if denom == 0 else (a / denom, c_ / denom)
        row_j = cs * R[j] + sn * R[j + 1]
        row_j1 = cs * R[j + 1] - sn * R[j]
        R[j], R[j + 1] = row_j, row_j1
        g[j], g[j + 1] = cs * g[j] + sn * g[j + 1], cs * g[j + 1] - sn * g[j]
    Ru = np.triu(R[:restart, :restart])
    d = np.diag(Ru).copy()
    d[d == 0] = 1.0
    Ru[np.diag_indices(restart)] = d
    return solve_triangular(Ru, g[:restart], lower=False)


def gmres(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None, s: int = 20):
    """Restarted GMRES(s) with classical Gram-Schmidt Arnoldi on the
    device; the Hessenberg matrix is read back once per cycle and its
    Givens QR and triangular solve run on the host in float64."""
    rw = _rows(A)
    restart = s
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    i = 0
    r = _pl(pl, b - A.mv(x))
    while i < maxiter and float(_nn(r, rw)) > tol:
        beta = _norm(r, rw)
        V = torch.zeros((restart + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / _nonzero(beta)
        H = torch.zeros((restart + 1, restart), dtype=b.dtype,
                        device=b.device)
        for j in range(restart):
            w = _pl(pl, A.mv(V[j]))
            hcol = _mdot(V[:j + 1], w, rw)
            w = w - (hcol[:, None] * V[:j + 1]).sum(0)
            hnorm = _norm(w, rw)
            H[:j + 1, j] = hcol
            H[j + 1, j] = hnorm
            V[j + 1] = w / _nonzero(hnorm)
        host = _host(torch.cat([H.reshape(-1), beta.reshape(1)]))
        y = _givens_solve(host[:-1].reshape(restart + 1, restart),
                          float(host[-1]), restart)
        x = x + _dev(y, b) @ V[:restart]
        i += restart
        r = _pl(pl, b - A.mv(x))
    return x, i, _nn(r, rw)


# ---------------------------------------------------------------------------
# LSQR (06_LSQR.jl): Golub-Kahan bidiagonalization, needs A^T x
# ---------------------------------------------------------------------------

def lsqr(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None):
    """LSQR: its products A x and A.T u (``tmv``; on a row-sharded
    operator each window's share summed onto the windows)."""
    del pl  # LSQR runs unpreconditioned (as the reference)
    rw = _rows(A)
    x = torch.zeros_like(b) if x0 is None else x0
    sqrt_n = math.sqrt(b.shape[0] if rw is None else rw.n)
    u = b - A.mv(x)
    beta = _norm(u, rw)
    u = u / _nonzero(beta)
    v = A.tmv(u)
    alpha = _norm(v, rw)
    v = v / _nonzero(alpha)
    w = v
    phibar, rhobar = beta, alpha
    i = 0
    while i < maxiter and float(phibar) / sqrt_n > tol:
        u = A.mv(v) - alpha * u
        beta = _norm(u, rw)
        u = u / _nonzero(beta)
        v = A.tmv(u) - beta * v
        alpha = _norm(v, rw)
        v = v / _nonzero(alpha)
        rho = torch.sqrt(rhobar ** 2 + beta ** 2)
        c_ = rhobar / rho
        s_ = beta / rho
        theta = s_ * alpha
        rhobar = -c_ * alpha
        phi = c_ * phibar
        phibar = s_ * phibar
        x = x + (phi / rho) * w
        w = v - (theta / rho) * w
        i += 1
    return x, i, _nn(b - A.mv(x), rw)


# ---------------------------------------------------------------------------
# CGS / CGS2 (07_CGS.jl)
# ---------------------------------------------------------------------------

def cgs(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None):
    rw = _rows(A)
    x, r = _prep(A, b, x0, pl)
    r0 = r
    rho = alpha = _full(1.0, b)
    u = p = torch.zeros_like(b)
    i = 0
    while i < maxiter and float(_nn(r, rw)) > tol:
        rhobar = rho
        rho = _dot(r, r0, rw)
        beta = rho / rhobar
        s_ = r + beta * p
        u = s_ + beta * (p + beta * u)
        v = _pl(pl, A.mv(u))
        alpha = rho / _dot(v, r0, rw)
        p = s_ - alpha * v
        x = x + alpha * (p + s_)
        r = _pl(pl, b - A.mv(x))
        i += 1
    return x, i, _nn(r, rw)


def cgs2(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None, s0=None):
    """CGS2 with a second, random shadow vector ``s0`` (default: normal
    numbers seeded 1)."""
    rw = _rows(A)
    x, r = _prep(A, b, x0, pl)
    r0 = r
    s0 = _shadow(s0, 1, (b.shape[0] if rw is None else rw.n,), b, rw)
    alpha = alphabar = sigma = sigmabar = _full(1.0, b)
    u = w = s_ = torch.zeros_like(b)
    i = 0
    while i < maxiter and float(_nn(r, rw)) > tol:
        rho = _dot(r, r0, rw)
        beta = (1.0 / alphabar) * rho / sigma
        v = r + beta * u
        rhobar = _dot(r, s0, rw)
        betabar = (1.0 / alpha) * rhobar / sigmabar
        t = r + betabar * s_
        w = t + beta * (u + betabar * w)
        cv = _pl(pl, A.mv(w))
        sigma = _dot(cv, r0, rw)
        alpha = rho / sigma
        s_ = t - alpha * cv
        sigmabar = _dot(cv, s0, rw)
        alphabar = rhobar / sigmabar
        u = v - alphabar * cv
        x = x + alpha * v + alphabar * s_
        r = _pl(pl, b - A.mv(x))
        i += 1
    return x, i, _nn(r, rw)


# ---------------------------------------------------------------------------
# TFQMR (08_QMR.jl): transpose-free QMR (Freund)
# ---------------------------------------------------------------------------

def tfqmr(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None, jitter=None):
    """CGS-recurrence TFQMR (QMR smoothing of CGS, Freund 1993), the
    variant the reference implements.  The shadow residual is
    r + 0.1 ||r|| ``jitter`` (default: normal numbers seeded 2), which
    avoids the exact Lanczos breakdown of r0* = r0 on symmetric
    systems; tau is the quasi-residual bound of the stop test, and the
    true residual is returned at exit."""
    rw = _rows(A)
    n = b.shape[0] if rw is None else rw.n
    x, r = _prep(A, b, x0, pl)
    r0 = r + 0.1 * _norm(r, rw) * _shadow(jitter, 2, (n,), b, rw)
    sqrt_n = math.sqrt(n)
    r_cgs = r
    p = u = r
    v = _pl(pl, A.mv(p))
    d = torch.zeros_like(b)
    tau = _norm(r, rw)
    r_norm = tau
    rho = _dot(r, r0, rw)
    theta = eta = _full(0.0, b)
    i = 0
    while i < maxiter and float(tau) / sqrt_n > tol:
        alpha = rho / _dot(v, r0, rw)
        q = u - alpha * v
        w = u + q
        r_cgs = r_cgs - alpha * _pl(pl, A.mv(w))
        r_norm_old = r_norm
        r_norm = _norm(r_cgs, rw)
        # two QMR-smoothed half updates
        d = u + (theta ** 2 * eta / alpha) * d
        theta = r_norm_old / tau
        cf = 1.0 / torch.sqrt(1.0 + theta ** 2)
        tau = tau * theta * cf
        eta = cf ** 2 * alpha
        x = x + eta * d
        d = q + (theta ** 2 * eta / alpha) * d
        theta = torch.sqrt(r_norm * r_norm_old) / tau
        cf = 1.0 / torch.sqrt(1.0 + theta ** 2)
        tau = tau * theta * cf
        eta = cf ** 2 * alpha
        x = x + eta * d
        rho_new = _dot(r_cgs, r0, rw)
        beta = rho_new / rho
        u = r_cgs + beta * q
        p = u + beta * (q + beta * p)
        v = _pl(pl, A.mv(p))
        rho = rho_new
        i += 1
    return x, i, _nn(_pl(pl, b - A.mv(x)), rw)
