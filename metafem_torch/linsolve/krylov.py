"""Matrix-free Krylov solvers, host-driven loops over device tensors.

The port of the reference's ``metafem/linsolve/krylov.py`` core: the
shared helpers ``_dot``, ``_norm``, ``_nn``, ``_prep`` and BiCGStab.
Signature of every solver:

    solver(A, b, x0=None, tol=..., maxiter=..., pl=None)
        -> (x, iters, normalized_residual)

with ``tol`` on the normalized norm ||r|| / sqrt(n) and ``pl`` an
optional left-preconditioner diagonal.  The reference's
``lax.while_loop`` becomes a Python loop that reads ``_nn(r) > tol`` back
once per iteration; the arithmetic runs in the reference's order, so the
iteration counts match.  Only the float64 path is ported: the compensated
float32 dot of the reference comes with the two-float work.
"""

from __future__ import annotations

import math

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype != torch.float64:
        raise NotImplementedError(
            "only float64 Krylov solves are ported (the compensated float32 "
            "dot is not)")
    return torch.dot(a, b)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(v, v))


def _nn(v: torch.Tensor) -> torch.Tensor:
    return _norm(v) / math.sqrt(v.shape[0])


def _pl(pl, v):
    return v if pl is None else pl * v


def _prep(A, b, x0, pl):
    x = torch.zeros_like(b) if x0 is None else x0
    r = _pl(pl, b - A.mv(x))
    return x, r


def bicgstab(A, b, x0=None, tol=1e-8, maxiter=1000, pl=None):
    x, r = _prep(A, b, x0, pl)
    rt = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    i = 0
    while i < maxiter and float(_nn(r)) > tol:
        rho_new = _dot(rt, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = _pl(pl, A.mv(p))
        alpha = rho_new / _dot(rt, v)
        s = r - alpha * v
        t = _pl(pl, A.mv(s))
        omega = _dot(t, s) / _dot(t, t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        i += 1
    return x, i, _nn(r)
