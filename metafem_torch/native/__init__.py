"""Native (C++) host kernels for the setup pipeline, loaded via ctypes.

The compute path is PyTorch; this is the runtime around it: O(N)
counting-sort inversion of contribution->slot maps and pair dedup, which
numpy only offers as O(N log N) argsort/unique (minutes at 1e8-contribution
scale).  Compiled on demand with g++ -O3 -shared into metafem_torch/_build/;
every entry point has a pure-numpy fallback so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fastmap.cpp")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib() -> Optional[str]:
    """Path of the built helper library (metafem_torch/_build/), or None
    when no host compiler can build it (the numpy fallbacks then run).
    Built for the generic x86-64 target, so a build directory copied to
    another host still loads."""
    from ..buildlib import build_shared
    try:
        return build_shared(_SRC, "fastmap",
                            ["g++", "-O3", "-shared", "-fPIC"])
    except (OSError, subprocess.CalledProcessError):
        return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = _build_lib()
        if path is not None:
            lib = ctypes.CDLL(path)
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.count_slots.argtypes = [i64p, ctypes.c_int64,
                                        ctypes.c_int64, i64p]
            lib.fill_gather_map.argtypes = [
                i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                i32p, i64p, i32p, i32p]
            lib.fill_gather_map.restype = ctypes.c_int64
            lib.unique_pairs.argtypes = [i64p, i64p, ctypes.c_int64,
                                         ctypes.c_int64, i64p, i64p, i64p,
                                         i64p, i64p, i64p]
            lib.unique_pairs.restype = ctypes.c_int64
            lib.pair_radix_inv.argtypes = [
                i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                i64p, i64p, i32p]
            lib.pair_radix_inv.restype = ctypes.c_int64
            lib.pair_extract_uniq.argtypes = [i64p, i64p,
                                              ctypes.c_int64, i32p, i32p]
            _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def invert_map(slots: np.ndarray, num: int, cap: int
               ) -> Tuple[np.ndarray, Optional[np.ndarray],
                          Optional[np.ndarray], int]:
    """(gmap [num, k], overflow_src, overflow_dst, k) — the counting-sort
    inversion behind scatter.build_gather_reduce."""
    lib = _lib()
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    n = slots.size
    if lib is None:
        return _invert_map_numpy(slots, num, cap)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    counts = np.empty(num, np.int64)
    lib.count_slots(_ptr(slots, i64p), n, num, _ptr(counts, i64p))
    k = int(min(counts.max() if n else 0, cap))
    k = max(k, 1)
    n_over_bound = int(np.maximum(counts - k, 0).sum())
    gmap = np.empty((num, k), np.int32)
    cursor = np.empty(num, np.int64)
    of_src = np.empty(max(n_over_bound, 1), np.int32)
    of_dst = np.empty(max(n_over_bound, 1), np.int32)
    n_of = lib.fill_gather_map(_ptr(slots, i64p), n, num, k,
                               _ptr(gmap, i32p), _ptr(cursor, i64p),
                               _ptr(of_src, i32p), _ptr(of_dst, i32p))
    if n_of:
        return gmap, of_src[:n_of].copy(), of_dst[:n_of].copy(), k
    return gmap, None, None, k


def _invert_map_numpy(slots, num, cap):
    n = slots.size
    order = np.argsort(slots, kind="stable")
    sorted_slots = slots[order]
    counts = np.bincount(slots, minlength=num)
    starts = np.zeros(num + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    col = np.arange(n, dtype=np.int64) - starts[sorted_slots]
    k = int(min(counts.max() if n else 0, cap))
    k = max(k, 1)
    in_map = col < k
    gmap = np.full((num, k), n, dtype=np.int32)
    gmap[sorted_slots[in_map], col[in_map]] = order[in_map]
    of = ~in_map
    if of.any():
        return (gmap, order[of].astype(np.int32),
                sorted_slots[of].astype(np.int32), k)
    return gmap, None, None, k


_ARENA = {}


def _arena(name: str, n: int, dtype) -> np.ndarray:
    """Reusable scratch buffer: on this host, first-touch page faults
    dominate large allocations (~70-100 MB/s on fresh pages), so setup
    passes share grow-only arenas instead of re-allocating per call."""
    buf = _ARENA.get(name)
    if buf is None or buf.size < n or buf.dtype != np.dtype(dtype):
        buf = np.empty(int(n * 1.2) + 16, dtype)
        _ARENA[name] = buf
    return buf[:n]


def unique_pairs_elcp(el_cp: np.ndarray, n_cp: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedup of the all-pairs stream (el_cp[e,a], el_cp[e,b]) without
    materializing it: returns (uniq_ci, uniq_cj, inv[E,na,na]) int32,
    unique pairs sorted by (ci, cj) — same ordering contract as
    ``unique_pairs(repeat(el_cp,na), tile(el_cp,na), n_cp)`` but far
    cheaper at 3D 1M-DOF scale: no pair materialization, one packed-key
    scatter + contiguous per-row sort (fastmap.cpp pair_radix_inv), and
    exact-size outputs (no capacity-n uniq buffers / copies)."""
    lib = _lib()
    el_cp = np.ascontiguousarray(el_cp, dtype=np.int32)
    E, na = el_cp.shape
    n = E * na * na
    if lib is None or n == 0 or n >= 2 ** 31 or n_cp >= 2 ** 31:
        ci_all = np.repeat(el_cp, na, axis=1).ravel().astype(np.int64)
        cj_all = np.tile(el_cp, (1, na)).ravel().astype(np.int64)
        ci, cj, inv = unique_pairs(ci_all, cj_all, n_cp)
        return (ci.astype(np.int32), cj.astype(np.int32),
                inv.reshape(E, na, na).astype(np.int32))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    counts = _arena("pair_counts", n_cp + 1, np.int64)
    keys = _arena("pair_keys", n, np.int64)
    inv = np.empty(n, np.int32)
    n_uniq = lib.pair_radix_inv(_ptr(el_cp, i32p), E, na, n_cp,
                                _ptr(counts, i64p), _ptr(keys, i64p),
                                _ptr(inv, i32p))
    uniq_ci = np.empty(n_uniq, np.int32)
    uniq_cj = np.empty(n_uniq, np.int32)
    lib.pair_extract_uniq(_ptr(keys, i64p), _ptr(counts, i64p), n_cp,
                          _ptr(uniq_ci, i32p), _ptr(uniq_cj, i32p))
    return uniq_ci, uniq_cj, inv.reshape(E, na, na)


def unique_pairs(ci_all: np.ndarray, cj_all: np.ndarray, n_cp: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedup (ci, cj) pairs: returns (uniq_ci, uniq_cj, inverse) with the
    unique pairs sorted by (ci, cj) — the np.unique replacement for the
    sparsity pattern."""
    lib = _lib()
    ci_all = np.ascontiguousarray(ci_all, dtype=np.int64)
    cj_all = np.ascontiguousarray(cj_all, dtype=np.int64)
    n = ci_all.size
    if lib is None or n == 0:
        keys = ci_all * n_cp + cj_all
        uniq, inv = np.unique(keys, return_inverse=True)
        return uniq // n_cp, uniq % n_cp, inv
    i64p = ctypes.POINTER(ctypes.c_int64)
    row_counts = np.empty(n_cp + 1, np.int64)
    row_starts = np.empty(n_cp + 1, np.int64)
    scratch = np.empty(n, np.int64)
    uniq_ci = np.empty(n, np.int64)
    uniq_cj = np.empty(n, np.int64)
    inv = np.empty(n, np.int64)
    n_uniq = lib.unique_pairs(_ptr(ci_all, i64p), _ptr(cj_all, i64p),
                              n, n_cp, _ptr(row_counts, i64p),
                              _ptr(row_starts, i64p), _ptr(scratch, i64p),
                              _ptr(uniq_ci, i64p), _ptr(uniq_cj, i64p),
                              _ptr(inv, i64p))
    return uniq_ci[:n_uniq].copy(), uniq_cj[:n_uniq].copy(), inv
