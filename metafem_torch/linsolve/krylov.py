"""Matrix-free Krylov solvers, host-driven loops over device tensors.

The port of the reference's ``metafem/linsolve/krylov.py`` core: the
shared helpers ``_dot``, ``_norm``, ``_nn``, ``_prep``, BiCGStab and the
Chebyshev iteration.  Signature of every solver:

    solver(A, b, x0=None, tol=..., maxiter=..., pl=None)
        -> (x, iters, normalized_residual)

with ``tol`` on the normalized norm ||r|| / sqrt(n) and ``pl`` an
optional left-preconditioner diagonal.  The reference's
``lax.while_loop`` becomes a Python loop that reads ``_nn(r) > tol`` back
once per iteration; the arithmetic runs in the reference's order, so the
iteration counts match.  Chebyshev has a fixed trip count and reads
nothing back inside its loop.

float32 dots are compensated (the reference's dot2, ``_dot``): at ~1e6
DOF plain float32 dots cancel and the Krylov recurrences break down.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BLOCK = 1024
#: Veltkamp's split constant for the 24-bit float32 mantissa (2^12 + 1)
_SPLIT = 4097.0


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """Error-free product a*b = p + err in float32 (Dekker's splitting;
    the reference's ``twofloat.two_prod``).  Every step is its own eager
    op, so each product is rounded to float32 before the next
    subtraction: no compiler can contract ``ah*bh - p`` into an FMA,
    which would break the transform.  Do not wrap in torch.compile."""
    p = a * b
    ca = a * _SPLIT
    cb = b * _SPLIT
    ah = ca - (ca - a)
    bh = cb - (cb - b)
    al = a - ah
    bl = b - bh
    e = (((ah * bh) - p) + (ah * bl)) + (al * bh)
    e = e + al * bl
    return p, e


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


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product; float32 vectors accumulate as the reference's dot2
    (error-free elementwise products p + err, both block-summed with a
    float64 tail), returned as float32."""
    if a.dtype == torch.float64:
        return torch.dot(a, b)
    if a.dtype != torch.float32:
        raise NotImplementedError(
            f"Krylov solves run in float32 or float64, not {a.dtype}")
    p, err = _two_prod(a, b)
    return (_block_sum(p) + _block_sum(err)).to(torch.float32)


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
    carry = chebyshev_init(A, b, x0=x0, pl=pl, interval=interval)
    x, r, _, _ = chebyshev_steps(A, carry, maxiter, interval, pl=pl)
    return x, maxiter, _nn(r)


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
