"""Multi-rank dry run of the multi-device layer: every leg of the
reference's ``__graft_entry__.dryrun_multichip`` and of its
tests/test_parallel.py, each sharded step against the same step run
unsharded in the same rank.

Run with one process per rank:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m metafem_torch.parallel.dryrun --device cpu --out DIR

``--legs`` picks legs (default: the eight below, in the reference's
order); ``--backend`` is gloo (default) or nccl; ``--threads`` caps
torch's threads per rank.  The legs:

1. ``assembly``: ``_res_k`` and ``_k_linear`` of the element-sharded
   state within 1e-12 of the whole state's (the flagship's forms at
   nel=(N, 2), lattice_pad=N);
2. ``element_step``: the jitted step (BiCGStab(2)) on it;
3. ``row_step``: the row-sharded jitted step (BiCGStab, Jacobi);
4. ``mg_step``: the row-sharded multigrid step;
5. ``refined``: the row-sharded refined step (multigrid);
6. ``refined_df32``: its two-float twin on the float32 strip (72, 32);
7. ``auxmg``: the unstructured refined step with the auxiliary-space
   multigrid (smooth="sparse") on the jittered tet brick (6, 4, 4);
8. ``nested``: the refined step over a ("slice", "el") 2 x N/2 mesh.

Each step leg: both steps below 1e-9, the sharded x within 1e-8·max|x|
of the whole one, the iteration counts equal on every rank, the layout
split (the rank holds its window's rows of the residual pair b, the
refined A_td's window storage and the fine smoother diagonal where the
leg has them), and a repeat of the sharded step bitwise equal to the
first.  Rank 0 writes each leg's arrays to ``DIR/<leg>.npz`` and the
records to ``DIR/summary.json``.  Every failure raises.

Four more legs (``MENU_LEGS``, not run by default):

9. ``mg_fresh_step``: the row-sharded jitted step with its multigrid
   set up per step on the window, and that window setup against the
   whole setup of the same tangent (levels >= 1 bitwise);
10. ``whole_on_cut``: whole steps (multigrid jitted, refined, df32
    refined) on states cut to the windows, each bitwise the step on the
    state's uncut twin;
11. ``solver_menu``: IDR(s) original, LSQR, CGS2 and TFQMR on the
    row-sharded Jacobi-scaled tangent, shadows from ``--shadows FILE``
    (an .npz with the whole P, s0 and jitter);
12. ``mg_fresh_c2``: ``mg_fresh_step`` on the C=2 cantilever with block
    smoothing.

Four legs for one card (``chip_smoke.phase_multidevice``) run at full
width with ``--device cuda``: ``flagship`` (the refined multigrid step
with float64 residuals, then its df32 twin, on the flagship at
``--nel``), ``pikachu`` (the unstructured auxmg refined step on the
pikachu brick at ``--pikachu-nel``), ``flagship_jitted`` (the float64
flagship's jitted step with per-step multigrid setup, then a whole
``reuse_mg`` step on its cut state) and ``flagship_menu`` (the four
solvers above, 30 iterations each, on its tangent); each also holds
the window's kernels to their plain versions and a repeat, and records
per rank the window, launches, peak memory, collective bytes and
milliseconds.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import metafem_torch as mf
from metafem_torch import Bilinear, FEM_Domain
from metafem_torch.linsolve import bsr_tail, krylov, offset_spmv
from metafem_torch.parallel import comm, shard_domain_state
from metafem_torch.parallel.dataparallel import make_mesh
from metafem_torch.parallel.rowshard import row_window

LEGS = ("assembly", "element_step", "row_step", "mg_step", "refined",
        "refined_df32", "auxmg", "nested")
#: the legs of the solver menu, the per-step multigrid setup on a row
#: window and the whole steps on cut states
MENU_LEGS = ("mg_fresh_step", "whole_on_cut", "solver_menu", "mg_fresh_c2")
CHIP_LEGS = ("flagship", "pikachu", "flagship_jitted", "flagship_menu")
#: the solvers that read shadows from ``--shadows`` (keys P, s0, jitter)
MENU = ("idrs_original", "lsqr", "cgs2", "tfqmr")
SHADOW_KEY = {"idrs_original": "P", "cgs2": "s0", "tfqmr": "jitter"}
#: the card's menu: a fixed number of iterations at tol 0
MENU_CHIP_ITERS = 30
#: the reference's bars
TOL_ASSEMBLY = 1e-12
TOL_X = 1e-8
TOL_RES = 1e-9


# ---------------------------------------------------------------------------
# the reference's fixtures, built by the port
# ---------------------------------------------------------------------------

def strip_domain(nel, lattice_pad=1, dtype=torch.float64, device="cpu",
                 seed=1) -> FEM_Domain:
    """tests/test_parallel.py's ``_make_strip``: the order-2 serendipity
    thermal strip with a radiation boundary, random T and source."""
    L1, L2 = 0.02, 0.01
    vert, conn = mf.make_square((L1, L2), nel)
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(2, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    eps = 1e-9
    ends = mf.select_facets(geo, lambda c: (c[:, 0] < eps)
                            | (c[:, 0] > L1 - eps))
    bg = dom.add_boundary(wp, ends)
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    n = dom.sym("n")
    i = mf.index("i")
    dom.assign_workpiece_weakform(
        wp, -3.0 * Bilinear(T.d(i), T.d(i)) + Bilinear(T, s))
    dom.assign_boundary_weakform(
        wp, bg, 1000.0 * Bilinear(T, 1173.15 - T)
        + 3.0 * Bilinear(T, n[i] * T.d(i))
        + 0.7 * 5.669e-8 * Bilinear(T, 323.15 ** 4 - T ** 4))
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity",
                       lattice_pad=lattice_pad)
    dom.assemble_global_variables()
    dom.compile()
    mesh0 = dom.workpieces[wp].mesh
    rng = np.random.default_rng(seed)
    dom.set_field(wp, "T", 300 + 10 * rng.random(mesh0.n_cp))
    dom.set_field(wp, "s", rng.random(mesh0.n_cp))
    dom.refresh_fields()
    dom.assemble_x()
    return dom


def tet_arrays(nel=(6, 4, 4), seed=2):
    """tests/test_parallel.py's ``_make_tet_thermal`` mesh: a brick split
    into 5-tet cells with jittered interior vertices (numpy, so both
    packages build from the same numbers), and the generator that then
    draws the fields."""
    L = (1.0, 0.7, 0.7)
    vert, conn = mf.make_brick(L, nel, shape="SIMPLEX")
    vert = np.asarray(vert, np.float64)
    rng = np.random.default_rng(seed)
    h = min(L[d] / nel[d] for d in range(3))
    interior = np.ones(len(vert), bool)
    for d in range(3):
        interior &= (vert[:, d] > 1e-9) & (vert[:, d] < L[d] - 1e-9)
    vert = vert + 0.18 * h * interior[:, None] * (
        rng.random(vert.shape) - 0.5)
    return vert, np.asarray(conn), rng


def tet_domain(nel=(6, 4, 4), lattice_pad=1, dtype=torch.float64,
               device="cpu", seed=2, **layout_opts) -> FEM_Domain:
    """tests/test_parallel.py's ``_make_tet_thermal``: conduction with a
    source and a convective boundary on the jittered tet brick (order 2,
    Morton numbering, ghost control points from ``lattice_pad``)."""
    vert, conn, rng = tet_arrays(nel, seed)
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(3, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    bg = dom.add_boundary(wp, geo.boundary_facet_ids())
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    i = mf.index("i")
    dom.assign_workpiece_weakform(
        wp, -0.6 * Bilinear(T.d(i), T.d(i)) + Bilinear(T, s))
    dom.assign_boundary_weakform(wp, bg, 25.0 * Bilinear(T, 293.15 - T))
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=2, itg_order=2, lattice_pad=lattice_pad)
    dom.assemble_global_variables(**layout_opts)
    dom.compile()
    mesh0 = dom.workpieces[wp].mesh
    if mesh0.lattice_shape is not None:
        raise AssertionError("the tet fixture must be unstructured")
    occ = mesh0.is_occupied
    real = np.ones(mesh0.n_cp, bool) if occ is None else occ
    dom.set_field(wp, "T", np.where(real, 293.15 + 10 * rng.random(
        mesh0.n_cp), 0.0))
    dom.set_field(wp, "s", np.where(real, 1600.0 * rng.random(mesh0.n_cp),
                                    0.0))
    dom.refresh_fields()
    dom.assemble_x()
    return dom


def elastic_domain_2d(nel=(12, 4), lattice_pad=1, dtype=torch.float64,
                      device="cpu") -> FEM_Domain:
    """tests/test_multigrid.py's ``_elastic_domain_2d``: the plane-strain
    cantilever, two coupled displacement channels (C=2), clamped by a
    penalty on the left end and sheared on the right; ghost control
    points from ``lattice_pad``."""
    L, H = 4.0, 1.0
    vert, conn = mf.make_square((L, H), nel)
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(2, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    left = mf.select_facets(geo, lambda c: c[:, 0] < 1e-9)
    right = mf.select_facets(geo, lambda c: c[:, 0] > L - 1e-9)
    bg_fix = dom.add_boundary(wp, left)
    bg_load = dom.add_boundary(wp, right)
    E, nu = 1.0, 0.3
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    d = dom.internal_var("d")
    sl = dom.external_var("sl", "CONTROLPOINT_VAR", "SYMMETRIC_TENSOR")
    n = dom.sym("n")
    delta = dom.sym("delta")
    i, j, m = mf.indices("i j m")
    eps = dom.define("eps", [i, j], (d[i].d(j) + d[j].d(i)) / 2.0)
    sig = dom.define("sig", [i, j],
                     lam * delta[i, j] * eps[m, m] + 2.0 * mu * eps[i, j])
    dom.assign_workpiece_weakform(wp, -Bilinear(eps[i, j], sig[i, j]))
    dom.assign_boundary_weakform(wp, bg_fix, 1e3 * E * Bilinear(d[i], -d[i]))
    dom.assign_boundary_weakform(wp, bg_load,
                                 Bilinear(d[i], sl[i, j] * n[j]))
    dom.initialize_local_assembly()
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity",
                       lattice_pad=lattice_pad)
    dom.assemble_global_variables()
    dom.compile()
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "sl3", np.full(mesh.n_cp, 1e-3))   # shear sigma_xy
    dom.refresh_fields()
    dom.assemble_x()
    return dom


def graft_domain(n_ranks: int, device="cpu") -> FEM_Domain:
    """``__graft_entry__._build_domain(nel=(N, 2), lattice_pad=N)``: the
    flagship's forms (metafem_torch.bench) on a float64 domain."""
    from metafem_torch import bench
    dom = bench.build_domain(nel=(n_ranks, 2), device=device,
                             dtype=torch.float64, lattice_pad=n_ranks)
    dom.converge_tol = 1e-9
    return dom


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _f64(x) -> torch.Tensor:
    return x.detach().to("cpu", torch.float64)


def _max_rel(a, b) -> float:
    a, b = _f64(a), _f64(b)
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def same_on_all_ranks(value: int, mesh, what: str) -> list:
    """Every rank's value of an integer (an iteration count); raises
    unless all agree."""
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=mesh.device_type)
    got = comm.all_gather(t, mesh).view(-1).tolist()
    if len(set(got)) != 1:
        raise AssertionError(f"{what}: ranks disagree: {got}")
    return got


def check_window(sharded: dict, dom, rows, fine_inv_diag=True,
                 pair=("b", "A")) -> dict:
    """The layout really split: the rank holds its window's rows
    (n/N of them) of the residual vector, the window storage of the
    refined A_td, and the fine smoother diagonal's window."""
    n = dom.pattern.basicfield_size
    N = rows.size
    out = {"rows": rows.n_local, "n": n,
           "window": [list(c) for c in rows.mine.cps]}
    if rows.n_local * N != n or not rows.even:
        raise AssertionError(f"the window holds {rows.n_local} of {n} rows "
                             f"over {N} ranks")
    ref = sharded.get("refined")
    if ref is not None:
        b, A = ref[pair[0]], ref[pair[1]]
        if b.shape[-1] != n // N:
            raise AssertionError(f"refined {pair[0]} holds {b.shape[-1]} "
                                 f"rows, not {n // N}")
        if A.shape[-1] != rows.mine.n_storage or (
                N > 1 and A.shape[-1] >= dom.pattern.n_storage):
            raise AssertionError(f"refined {pair[1]} holds {A.shape[-1]} "
                                 f"values, not the window's "
                                 f"{rows.mine.n_storage}")
        out["storage"] = rows.mine.n_storage
        out["n_storage"] = dom.pattern.n_storage
    mg = sharded.get("mg_frozen")
    if fine_inv_diag and mg is not None:
        d = mg[0]["inv_diag"]
        if d.shape[-1] * d.shape[0] != n // N:
            raise AssertionError(f"fine inv_diag holds {tuple(d.shape)}, "
                                 f"not {n // N} rows")
        out["inv_diag"] = list(d.shape)
    return out


def _step_pair(step_sh, step0, sharded, state, x0, mesh, what):
    """(x_sh, res_sh, it_sh, x0, res0, it0, record): the sharded step
    twice (bitwise repeat), the whole step, the bars."""
    comm.reset_counts()
    t0 = time.perf_counter()
    x_sh, _, res_sh, it_sh = step_sh(sharded, x0, 0.0, 1.0)
    t_sh = time.perf_counter() - t0
    moved = comm.counts()
    x_rep, _, res_rep, it_rep = step_sh(sharded, x0, 0.0, 1.0)
    if not torch.equal(x_rep, x_sh) or it_rep != it_sh:
        raise AssertionError(f"{what}: the repeat of the sharded step is "
                             f"not bitwise equal to it")
    t0 = time.perf_counter()
    x_w, _, res_w, it_w = step0(state, x0, 0.0, 1.0)
    t_w = time.perf_counter() - t0
    its = same_on_all_ranks(it_sh, mesh, f"{what} iterations")
    if not (float(res_sh) < TOL_RES and float(res_w) < TOL_RES):
        raise AssertionError(f"{what}: residuals {float(res_sh):.3e} "
                             f"(sharded), {float(res_w):.3e} (whole)")
    err = _max_rel(x_sh, x_w)
    if not err <= TOL_X:
        raise AssertionError(f"{what}: sharded x off the whole step's by "
                             f"{err:.3e} of max|x|")
    rec = {"res": float(res_sh), "res_whole": float(res_w),
           "iters": int(it_sh), "iters_whole": int(it_w),
           "iters_all_ranks": its, "max_rel_vs_whole": err,
           "s": t_sh, "s_whole": t_w, "comm": moved}
    return x_sh, x_w, rec


def uncut_twin(sharded: dict, state: dict) -> dict:
    """The state ``shard_domain_state`` made, with its row-shaped caches
    whole (``K_linear_td``, the multigrid state, the refined A_td/b and
    their two-float pairs: as it leaves them where the windows do not
    divide) and the same element blocks: what a whole step on the cut
    state must reproduce bit for bit."""
    out = {k: v for k, v in sharded.items() if k != "uncut"}
    out["cut_to"] = None
    for k in ("K_linear_td", "mg_frozen"):
        if state.get(k) is not None:
            out[k] = state[k]
    if sharded.get("refined") is not None:
        ref = {k: v for k, v in sharded["refined"].items()
               if k not in ("uncut", "windows", "A_mats", "A_packed")}
        for k in ("A", "A_hi", "A_lo", "b", "b_hi", "b_lo"):
            if state["refined"].get(k) is not None:
                ref[k] = state["refined"][k]
        ref["cut_to"] = None
        out["refined"] = ref
    return out


def _cut_pair(dom, step, x0, mesh, what, pair_keys=()):
    """A whole ``step`` on the state cut to the windows, twice (the
    second on the gathered caches it kept), against the same step on its
    uncut twin: bitwise, both below 1e-9; the record (the first step's
    seconds, packed kernel launches, collective bytes and peak device
    memory: the gathers included) and (x, x_twin)."""
    state = dom._runtime_state()
    sharded = shard_domain_state(state, mesh)
    rows = row_window(dom.pattern.offset_layout, mesh)
    if sharded["cut_to"] is not rows:
        raise AssertionError(f"{what}: the windows did not divide")
    ref = sharded.get("refined") or {}
    cut = [k for k in ("K_linear_td",) if sharded.get(k) is not None
           and sharded[k].shape != state[k].shape] + [
        "refined." + k for k in ("A", "b") + tuple(pair_keys)
        if ref.get(k) is not None
        and ref[k].shape != state["refined"][k].shape]
    if sharded.get("mg_frozen") is not None:
        if sharded["mg_frozen"][0].get("rows") is not rows:
            raise AssertionError(f"{what}: the fine level was not cut")
        cut.append("mg_frozen")
    for k in pair_keys:
        if "refined." + k not in cut:
            raise AssertionError(f"{what}: {k} was not cut")
    twin = uncut_twin(sharded, state)
    device = x0.device
    offset_spmv.reset_launches()
    bsr_tail.reset_launches()
    comm.reset_counts()
    _peak_reset(device)
    _sync(device)
    t0 = time.perf_counter()
    x_c, _, res_c, it_c = step(sharded, x0, 0.0, 1.0)
    _sync(device)
    s_cut = time.perf_counter() - t0
    launches, moved, peak = _launches(), comm.counts(), _peak(device)
    gathered = sorted(sharded["uncut"]) + sorted(
        (sharded.get("refined") or {}).get("uncut", {}))
    x_c2 = step(sharded, x0, 0.0, 1.0)[0]
    x_t, _, res_t, it_t = step(twin, x0, 0.0, 1.0)
    if not (torch.equal(x_c, x_t) and torch.equal(x_c2, x_c)
            and it_c == it_t):
        raise AssertionError(f"{what}: the whole step on the cut state is "
                             f"not bitwise the step on the uncut twin "
                             f"({_max_rel(x_c, x_t):.3e})")
    if not (float(res_c) < TOL_RES):
        raise AssertionError(f"{what}: residual {float(res_c):.3e}")
    its = same_on_all_ranks(it_c, mesh, f"{what} iterations")
    return ({"res": float(res_c), "iters": int(it_c),
             "iters_all_ranks": its, "bitwise": True, "s": s_cut,
             "launches": launches, "comm": moved, "peak_bytes": peak,
             "gathered": gathered, "cut": cut}, (x_c, x_t))


def setup_vs_whole(dom, mesh, mg_opts, min_levels: int = 3) -> dict:
    """``multigrid.mg_setup`` on the window of the tangent at x
    (``assemble_tangent``; a ``RowShardedOp``) against the whole setup
    of the same tangent in the same rank: the fine level's window pieces
    bitwise those of the whole one, the level-0 damping factor within
    1e-12 (its power steps take the whole norm from the windows' norms),
    levels >= 1 and the coarsest inverse bitwise (the window products
    concatenate bitwise; the restriction runs on the gathered vector);
    the largest differences and the seconds of each setup."""
    from metafem_torch.linsolve import multigrid
    from metafem_torch.parallel.rowshard import RowShardedOp, local_mg_state
    hier = multigrid.hierarchy_for_domain(dom, **mg_opts)
    if hier.n_levels < min_levels:
        raise AssertionError(f"setup: {hier.n_levels} levels, not >= "
                             f"{min_levels}")
    A, _ = dom.assemble_tangent()
    rows = row_window(A.layout, mesh)
    mask = dom._runtime_state().get("mg_mask")
    _sync(A.vals.device)
    t0 = time.perf_counter()
    sh = multigrid.mg_setup(hier, RowShardedOp(A, rows), mask)
    _sync(A.vals.device)
    s_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = multigrid.mg_setup(hier, A, mask)
    _sync(A.vals.device)
    s_w = time.perf_counter() - t0
    w0 = local_mg_state(whole, rows)[0]
    for k in ("inv_diag", "mask", "inv_diag_blk"):
        if (k in w0) != (k in sh[0]) or (k in w0 and not torch.equal(
                sh[0][k], w0[k])):
            raise AssertionError(f"setup: the window's {k} is not the "
                                 f"whole setup's window")
    if not torch.equal(sh[0]["A"].vals, w0["A"].vals):
        raise AssertionError("setup: the window's operator differs")
    om = _max_rel(sh[0]["omega"], whole[0]["omega"])
    if not om <= 1e-12:
        raise AssertionError(f"setup: level-0 omega off by {om:.3e}")
    coarse = 0.0
    for lvl in range(1, hier.n_levels):
        for k, v in whole[lvl].items():
            coarse = max(coarse, float((_f64(sh[lvl][k])
                                        - _f64(v)).abs().max()))
    if coarse != 0.0:
        raise AssertionError(f"setup: levels >= 1 differ from the whole "
                             f"setup's by {coarse:.3e}")
    return {"n_levels": hier.n_levels, "channels": hier.channels,
            "omega0_rel_diff": om, "coarse_max_abs_diff": coarse,
            "s": s_sh, "s_whole": s_w}


class SplitRows:
    """A row window's reductions over whole vectors in one process: fn
    of each window's part (``WindowLayout.local``), as that window's rank
    forms it, the parts added in rank order as ``comm.all_reduce`` adds
    the ranks'.  The solvers' row window of ``SplitOp``."""

    def __init__(self, rows):
        self.windows, self.n = rows.windows, rows.n

    def local(self, v):
        return v

    def reduce(self, fn, *vs):
        return comm._sum_ranks(torch.stack(
            [fn(*(w.local(v) for v in vs)) for w in self.windows]))


class SplitOp:
    """The whole matrix A, with the additions of a solve on its row
    windows ``rows`` in the ranks' order: products whole (the window
    products concatenate bitwise to them), dots through ``SplitRows``,
    A.T x the windows' shares (``OffsetMatrix.tmv`` over each window)
    added in rank order, as ``RowShardedOp.tmv`` adds them.  A whole
    solve over it is what the row-sharded solve of A computes, bit for
    bit, without collectives."""

    def __init__(self, A, rows):
        from metafem_torch.linsolve.block_offset import OffsetMatrix
        self.A, self.row_window = A, SplitRows(rows)
        self._parts = [(w, OffsetMatrix.from_values(
            A.vals[torch.as_tensor(w.storage, device=A.vals.device)],
            A.layout, w)) for w in rows.windows]

    def mv(self, x):
        return self.A.mv(x)

    def tmv(self, x):
        return comm._sum_ranks(torch.stack(
            [P.tmv(w.local(x)) for w, P in self._parts]))

    @property
    def n(self):
        return self.A.n


def menu_solves(run, A, b, tol, maxiter, shadows, bar, solvers=MENU):
    """Each solver of ``solvers`` on the right-Jacobi scaled A
    (``pr_jacobi``) row-sharded (the window of A, the rank's rows of b)
    and whole in the same rank: its y gathered within ``bar`` x max|y|
    of the whole solve over ``SplitOp`` (the whole operator, its dots
    added in the ranks' order), and bitwise equal to it; the iteration
    counts equal on every rank.  Also recorded, held to no bar: how far
    y lies from the whole solve with ``torch.dot``'s own order
    (``max_rel_vs_plain``; a CGS-type iterate short of convergence
    magnifies a last-bit difference of its dots).  Shadows (whole
    arrays) from ``shadows``, else the solvers' own seeded draws.  The
    whole solves run one rank at a time.  Per solver: iterations,
    residuals, ms of the sharded and the plain whole solve, the packed
    kernel's launches and the collectives' bytes of the sharded one."""
    from metafem_torch.linsolve.precond import pr_jacobi
    from metafem_torch.parallel.rowshard import RowShardedOp
    device, mesh = run.device, run.mesh
    rows = row_window(A.layout, mesh)
    As_w, _ = pr_jacobi(RowShardedOp(A, rows))
    As, _ = pr_jacobi(A)
    As_split = SplitOp(As, rows)
    b_w = rows.local(b)
    rec, ys = {}, {}
    for name in solvers:
        fn = getattr(krylov, name)
        kw = ({SHADOW_KEY[name]: shadows[SHADOW_KEY[name]]}
              if name in SHADOW_KEY and SHADOW_KEY[name] in shadows else {})
        dist.barrier()
        offset_spmv.reset_launches()
        comm.reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        y_w, it, res = fn(As_w, b_w, tol=tol, maxiter=maxiter, **kw)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        launches, moved = offset_spmv.group_mv.launches, comm.counts()
        y = rows.gather(y_w)

        def whole():
            split = fn(As_split, b, tol=tol, maxiter=maxiter, **kw)
            _sync(device)
            t = time.perf_counter()
            plain = fn(As, b, tol=tol, maxiter=maxiter, **kw)
            _sync(device)
            return split, plain, (time.perf_counter() - t) * 1e3
        (y0, it0, res0), (y_p, it_p, _), ms0 = one_rank_at_a_time(whole,
                                                                  mesh)
        its = same_on_all_ranks(it, mesh, f"{name} iterations")
        err = _max_rel(y, y0)
        if not (err <= bar and torch.equal(y, y0) and it == it0):
            raise AssertionError(f"{name}: sharded y off the whole solve's "
                                 f"by {err:.3e} of max|y| (bar {bar:.0e}, "
                                 f"bitwise expected), {it} iterations "
                                 f"(whole {it0})")
        if device.type == "cuda" and launches <= 0:
            raise AssertionError(f"{name}: the sharded solve launched no "
                                 f"packed kernel")
        rec[name] = {"iters": int(it), "iters_whole": int(it0),
                     "iters_all_ranks": its, "res": float(res),
                     "res_whole": float(res0), "max_rel_vs_whole": err,
                     "bitwise": True, "iters_plain": int(it_p),
                     "max_rel_vs_plain": _max_rel(y, y_p),
                     "ms": ms, "ms_whole": ms0, "launches": launches,
                     "comm": moved}
        ys[name] = y
        ys[name + "_whole"] = y0
    return rec, ys


# ---------------------------------------------------------------------------
# the legs
# ---------------------------------------------------------------------------

class Run:
    """The legs' shared domains and outputs on one rank."""

    def __init__(self, mesh, device, out_dir, nel=(800, 400),
                 pikachu_nel=(24, 17, 17), shadows=None):
        self.mesh = mesh
        self.device = device
        self.out = out_dir
        self.nel, self.pikachu_nel = tuple(nel), tuple(pikachu_nel)
        _, self.rank, self.size = comm.row_group(mesh)
        self.records = {}
        self._graft = None
        self._flag64 = None
        #: whole shadow arrays of the menu's solvers (``--shadows``)
        self.shadows = {}
        if shadows:
            with np.load(shadows) as f:
                self.shadows = {k: f[k] for k in f.files}

    def save(self, leg: str, rec: dict, **arrays) -> None:
        self.records[leg] = rec
        if self.rank == 0 and self.out:
            np.savez(os.path.join(self.out, leg + ".npz"),
                     **{k: _f64(v).numpy() for k, v in arrays.items()})
            print(f"[dryrun] {leg}: " + json.dumps(rec), flush=True)

    def graft(self):
        if self._graft is None:
            self._graft = graft_domain(self.size, self.device)
        return self._graft

    # 1
    def assembly(self):
        dom = self.graft()
        state = dom._runtime_state()
        state["x_star"] = dom.x
        sharded = shard_domain_state(state, self.mesh)
        r1, K1 = dom._res_k(sharded)
        KL1 = dom._k_linear(sharded)
        r0, K0 = dom._res_k(state)
        KL0 = dom._k_linear(state)
        errs = {"residue": _max_rel(r1, r0), "K": _max_rel(K1, K0),
                "K_linear": _max_rel(KL1, KL0)}
        for k, e in errs.items():
            if not e <= TOL_ASSEMBLY:
                raise AssertionError(f"assembly: sharded {k} off by {e:.3e}")
        e0, e1 = sharded["wp"][0]["el_range"]
        n_el = state["wp"][0]["el"]["weights"].shape[0]
        if sharded["wp"][0]["el"]["weights"].shape[0] != e1 - e0 or (
                self.size > 1 and e1 - e0 >= n_el):
            raise AssertionError("assembly: the element tables did not "
                                 "split")
        self.save("assembly", {"max_rel": errs, "elements": [e0, e1, n_el]},
                  residue=r1, K=K1, K_linear=KL1)

    # 2
    def element_step(self):
        dom = self.graft()
        state = dom._runtime_state()
        sharded = shard_domain_state(state, self.mesh)
        step = dom.make_jitted_step(sv_func=krylov.bicgstabl, s=2,
                                    maxiter=400, max_newton=6, max_pass=2)
        x, xw, rec = _step_pair(step, step, sharded, state, dom.x,
                                self.mesh, "element_step")
        self.save("element_step", rec, x=x, x_whole=xw)

    # 3
    def row_step(self):
        dom = self.graft()
        state = dom._runtime_state()
        sharded = shard_domain_state(state, self.mesh)
        kw = dict(sv_func=krylov.bicgstab, maxiter=800, max_newton=6,
                  max_pass=2)
        step_sh = dom.make_jitted_step(rowshard_mesh=self.mesh, **kw)
        rows = row_window(dom.pattern.offset_layout, self.mesh)
        # the assembly lands on the window: n/N rows and the window storage
        st = {**sharded, "x_star": dom.x, "row_window": rows}
        st["K_linear"] = dom._k_linear(st)
        r, K = dom._res_k(st)
        if r.shape[0] * self.size != dom.pattern.basicfield_size or \
                K.shape[0] != rows.mine.n_storage:
            raise AssertionError("row_step: the assembly did not land on "
                                 "the window")
        x, xw, rec = _step_pair(step_sh, dom.make_jitted_step(**kw),
                                sharded, state, dom.x, self.mesh, "row_step")
        rec["layout"] = check_window(sharded, dom, rows)
        rec["bytes_per_reduction"] = rows.bytes_per_reduction(8)
        self.save("row_step", rec, x=x, x_whole=xw)

    # 4
    def mg_step(self):
        dom = self.graft()
        dom.freeze_linear_tangent()
        dom.setup_mg(tune=False)
        state = dom._runtime_state()
        sharded = shard_domain_state(state, self.mesh)
        rows = row_window(dom.pattern.offset_layout, self.mesh)
        kw = dict(sv_func=krylov.bicgstab, maxiter=200, max_newton=6,
                  max_pass=2, precond="mg", reuse_mg=True,
                  static_k_linear=True)
        x, xw, rec = _step_pair(
            dom.make_jitted_step(rowshard_mesh=self.mesh, **kw),
            dom.make_jitted_step(**kw), sharded, state, dom.x, self.mesh,
            "mg_step")
        rec["layout"] = check_window(sharded, dom, rows)
        self.save("mg_step", rec, x=x, x_whole=xw)

    # 5
    def refined(self):
        dom = self.graft()
        if dom._mg_frozen is None:
            dom.freeze_linear_tangent()
            dom.setup_mg(tune=False)
        dom.freeze_refined_residual()
        self._refined_leg("refined", dom, self.mesh, dict(
            sv_func=krylov.bicgstab, maxiter=200, max_refine=10,
            max_pass=1, precond="mg"))

    def _refined_leg(self, leg, dom, mesh, kw, pair=("b", "A")):
        state = dom._runtime_state()
        sharded = shard_domain_state(state, mesh)
        rows = row_window(dom.pattern.offset_layout, mesh)
        x0 = dom.x.to(torch.float64)
        x, xw, rec = _step_pair(
            dom.make_refined_step(rowshard_mesh=mesh, **kw),
            dom.make_refined_step(**kw), sharded, state, x0, mesh, leg)
        rec["layout"] = check_window(sharded, dom, rows, pair=pair)
        self.save(leg, rec, x=x, x_whole=xw)

    # 6
    def refined_df32(self):
        dom = strip_domain((72, 32), lattice_pad=8, dtype=torch.float32,
                           device=self.device)
        dom.converge_tol = 1e-9
        dom.freeze_linear_tangent()
        dom.setup_mg(tune=False)
        dom.freeze_refined_residual()
        self._refined_leg("refined_df32", dom, self.mesh, dict(
            sv_func=krylov.bicgstab, maxiter=100, max_refine=10,
            max_pass=1, precond="mg", residual_mode="df32"),
            pair=("b_hi", "A_hi"))

    # 7
    def auxmg(self):
        dom = tet_domain(lattice_pad=self.size, device=self.device)
        n = dom.pattern.basicfield_size
        if n % self.size or dom.pattern.offset_layout.n_storage % self.size:
            raise AssertionError("auxmg: the ghost-cp padding did not make "
                                 "n and n_storage divide the ranks")
        dom.converge_tol = 1e-9
        dom.freeze_linear_tangent()
        dom.freeze_refined_residual()
        dom.setup_auxmg(smooth="sparse")
        self._refined_leg("auxmg", dom, self.mesh, dict(
            sv_func=krylov.bicgstab, maxiter=80, max_refine=10,
            max_pass=1, precond="auxmg"))

    # 8
    def nested(self):
        from torch.distributed.device_mesh import DeviceMesh
        if self.size % 2 or self.size < 4:
            raise ValueError(f"the nested leg needs an even rank count >= 4, "
                             f"not {self.size}")
        nested = DeviceMesh(self.mesh.device_type,
                            torch.arange(self.size).view(2, self.size // 2),
                            mesh_dim_names=("slice", "el"))
        dom = strip_domain((72, 32), lattice_pad=8, device=self.device)
        dom.converge_tol = 1e-9
        dom.freeze_linear_tangent()
        dom.setup_mg(tune=False)
        dom.freeze_refined_residual()
        if comm.row_group(nested)[2] != self.size:
            raise AssertionError("nested: the row axes do not span the "
                                 "mesh")
        self._refined_leg("nested", dom, nested, dict(
            sv_func=krylov.bicgstab, maxiter=100, max_refine=10,
            max_pass=1, precond="mg"))

    # the menu legs
    def mg_fresh_step(self):
        """The row-sharded jitted step with its multigrid set up per step
        on the window (``mg_setup`` of a ``RowShardedOp``); beside it the
        window setup against the whole setup on the same tangent.  The
        graft lattice, (12, 5) on 4 ranks, coarsens once at any
        ``max_coarse``: its next level, (3, 2), falls under
        ``build_hierarchy``'s 3-point floor, so the hierarchy has 2
        levels here (3 in ``mg_fresh_c2``)."""
        dom = self.graft()
        if dom._k_linear_td is None:
            dom.freeze_linear_tangent()
        self._mg_fresh("mg_fresh_step", dom, {"max_coarse": 16}, 2)

    def mg_fresh_c2(self):
        """``mg_fresh_step`` on the C=2 plane-strain cantilever with
        block smoothing, nel=(12, 4), lattice_pad=N: 3 levels."""
        dom = elastic_domain_2d((12, 4), lattice_pad=self.size,
                                device=self.device)
        dom.converge_tol = 1e-9
        dom.freeze_linear_tangent()
        self._mg_fresh("mg_fresh_c2", dom,
                       {"max_coarse": 16, "block_smooth": True}, 3)

    def _mg_fresh(self, leg, dom, mg_opts, min_levels):
        state = dom._runtime_state()
        sharded = shard_domain_state(state, self.mesh)
        kw = dict(sv_func=krylov.bicgstab, maxiter=200, max_newton=6,
                  max_pass=2, precond="mg", mg_opts=mg_opts,
                  static_k_linear=True)
        x, xw, rec = _step_pair(
            dom.make_jitted_step(rowshard_mesh=self.mesh, **kw),
            dom.make_jitted_step(**kw), sharded, state, dom.x, self.mesh,
            leg)
        rec["setup"] = setup_vs_whole(dom, self.mesh, mg_opts, min_levels)
        self.save(leg, rec, x=x, x_whole=xw)

    def whole_on_cut(self):
        """Whole steps on states that ``shard_domain_state`` cut to the
        windows, each bitwise the whole step on the uncut twin
        (``uncut_twin``): the graft domain's multigrid jitted step
        (``reuse_mg``) and refined step, and the two-float refined step
        on the float32 strip (16, 8) with its A_hi/A_lo/b_hi/b_lo cut."""
        dom = self.graft()
        if dom._mg_frozen is None:
            if dom._k_linear_td is None:
                dom.freeze_linear_tangent()
            dom.setup_mg(tune=False)
        if dom._refined is None:
            dom.freeze_refined_residual()
        rec, arrays = {}, {}
        x0 = dom.x.to(torch.float64)
        for name, make, kw in (
                ("mg_step", dom.make_jitted_step, dict(
                    sv_func=krylov.bicgstab, maxiter=200, max_newton=6,
                    max_pass=2, precond="mg", reuse_mg=True,
                    static_k_linear=True)),
                ("refined", dom.make_refined_step, dict(
                    sv_func=krylov.bicgstab, maxiter=200, max_refine=10,
                    max_pass=1, precond="mg"))):
            rec[name], arrays[name] = _cut_pair(dom, make(**kw), x0,
                                                self.mesh, name)
        strip = strip_domain((16, 8), lattice_pad=4, dtype=torch.float32,
                             device=self.device)
        strip.converge_tol = 1e-9
        strip.freeze_linear_tangent()
        strip.setup_mg(tune=False)
        strip.freeze_refined_residual()
        step = strip.make_refined_step(
            sv_func=krylov.bicgstab, maxiter=100, max_refine=10,
            max_pass=1, precond="mg", residual_mode="df32")
        # a whole step splits the freeze into its two-float pairs, so
        # that shard_domain_state cuts them
        step(strip._runtime_state(), strip.x.to(torch.float64), 0.0, 1.0)
        rec["refined_df32"], arrays["refined_df32"] = _cut_pair(
            strip, step, strip.x.to(torch.float64), self.mesh,
            "refined_df32", pair_keys=("A_hi", "A_lo", "b_hi", "b_lo"))
        self.save("whole_on_cut", rec, **{
            f"{k}_{w}": v for k, (x, xt) in arrays.items()
            for w, v in (("x", x), ("x_twin", xt))})

    def solver_menu(self):
        """IDR(s) original, LSQR, CGS2 and TFQMR on the row-sharded,
        right-Jacobi scaled tangent of the graft domain at its x
        (``assemble_tangent``) against the whole operator, to tol 1e-10
        within 1000 iterations; shadows from ``--shadows``."""
        dom = self.graft()
        A, b = dom.assemble_tangent()
        rec, ys = menu_solves(self, A, b, tol=1e-10, maxiter=1000,
                              shadows=self.shadows, bar=TOL_X)
        self.save("solver_menu", rec, b=b, **ys)

    # for one card
    def flagship(self):
        _flagship_leg(self)

    def pikachu(self):
        _pikachu_leg(self)

    def flag64(self):
        """The float64 flagship at ``--nel`` with lattice_pad=N, linear
        tangent frozen, converge_tol 1e-9 (the card's menu legs)."""
        if self._flag64 is None:
            from metafem_torch import bench
            t0 = time.perf_counter()
            dom = bench.build_domain(self.nel, device=self.device,
                                     dtype=torch.float64,
                                     lattice_pad=self.size)
            dom.converge_tol = 1e-9
            dom.freeze_linear_tangent()
            self._flag64 = (dom, time.perf_counter() - t0)
        return self._flag64

    def flagship_jitted(self):
        _flagship_jitted_leg(self)

    def flagship_menu(self):
        _flagship_menu_leg(self)


# ---------------------------------------------------------------------------
# the legs for one card: full width, per-rank numbers
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event_ms(fn, device, reps: int = 10, graph: bool = False) -> float:
    """Milliseconds per call: CUDA events around ``reps`` calls after a
    warm call (``benchmarks.timing.cuda_time_ms``; with ``graph`` the
    replays of one CUDA graph of them, so that a kernel shorter than its
    launch is timed on the device alone); the host clock on the CPU."""
    if device.type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    from metafem_torch.benchmarks.timing import cuda_time_ms
    return cuda_time_ms(fn, reps=reps, warmup=1, graph=graph)


def _launches() -> dict:
    return {"packed": offset_spmv.group_mv.launches,
            "packed_df": offset_spmv.group_mv_df.launches,
            "tail": bsr_tail.tail_mv.launches,
            "tail_df": bsr_tail.tail_mv_df.launches}


def one_rank_at_a_time(fn, mesh):
    """fn() on each rank in turn, the others waiting at a barrier, so
    that ranks sharing a card time their work alone; fn's result on
    this rank.  fn must synchronise its device before it returns."""
    _, rank, size = comm.row_group(mesh)
    out = None
    for r in range(size):
        if r == rank:
            out = fn()
        dist.barrier()
    return out


def window_x_reads(grp, c0: int, c1: int) -> int:
    """The entries of x that the packed product of the rows [c0, c1) of
    a dense group reads: per column channel the window widened by the
    group's smallest and largest offsets, inside [0, n_cp)."""
    lo_c = max(0, c0 + min(grp.offsets))
    hi_c = min(grp.n_cp, c1 + max(grp.offsets))
    return len({pb for _pd, pb in grp.units}) * max(0, hi_c - lo_c)


def window_kernels(W, x: torch.Tensor, device, df=None) -> dict:
    """The window's kernels against their plain versions on the same
    plans and inputs, and against a repeat (bitwise): the dense group's
    packed product (``offset_spmv.group_mv``) and, with a BSR tail, the
    tail's (``bsr_tail.tail_mv``); with ``df`` (the window's two-float
    pair and its ``df_pack``) the two-float products, bitwise.  Errors at
    the window's rows, relative to the largest |y| there; milliseconds
    by CUDA graph replay (the plain versions by CUDA events); the plans'
    bytes per product, and the least bytes:
    each structural entry, each entry of x the plan reads
    (``window_x_reads``; the tail plan's distinct columns) and each row
    of y it writes, once."""
    lo = W.layout
    (grp,) = lo.pallas_groups
    (c0, c1) = W.window.cps[0]
    plan = W.pack_plans()[0]
    C, n_cp = grp.n_vars, grp.n_cp
    x_reads = window_x_reads(grp, c0, c1)
    xw = x[:C * n_cp].view(C, n_cp)
    pk = W.packed(0)
    out = {}

    def held(name, k, k2, p, itemsize, nbytes, min_bytes, kern, plain):
        if not torch.equal(k, k2):
            raise AssertionError(f"{name}: two launches differ")
        scale = float(p.abs().max()) or 1.0
        err = float((k.double() - p.double()).abs().max())
        tol = 1e-13 if itemsize == 8 else 2e-6
        if not err <= tol * scale:
            raise AssertionError(f"{name}: off its plain version by "
                                 f"{err / scale:.3e}")
        out[name] = {"max_abs_err": err, "max_rel_err": err / scale,
                     "ms": _event_ms(kern, device, reps=20, graph=True),
                     "plain_ms": _event_ms(plain, device, reps=3),
                     "bytes": nbytes, "min_bytes": min_bytes}

    def group(fn):
        y = torch.zeros((C, n_cp), dtype=x.dtype, device=device)
        fn(y)
        return y[:, c0:c1]
    k = group(lambda y: offset_spmv.group_mv(pk, xw, plan, out=y))
    k2 = group(lambda y: offset_spmv.group_mv(pk, xw, plan, out=y))
    p = group(lambda y: offset_spmv.group_mv_packed_plain(pk, xw, plan, y))
    y0 = torch.empty((C, n_cp), dtype=x.dtype, device=device)
    isz = x.element_size()
    n_w = C * (c1 - c0)
    held("packed", k, k2, p, isz, plan.bytes_per_product(isz),
         ((plan.n_entries - plan.n_fill) + x_reads + n_w) * isz,
         lambda: offset_spmv.group_mv(pk, xw, plan, out=y0),
         lambda: offset_spmv.group_mv_packed_plain(pk, xw, plan, y0))
    out["packed"]["rows"] = int(plan.rows.numel())
    out["packed"]["x_reads"] = x_reads
    if lo.blk_b:
        tp = W.tail_plan()
        tk = W.packed_tail()
        rows = W.window.tables(device)["rows"]

        def tail(fn):
            y = torch.zeros(lo.n, dtype=x.dtype, device=device)
            fn(y)
            return y[rows]
        k = tail(lambda y: bsr_tail.tail_mv(tk, x, y, tp))
        k2 = tail(lambda y: bsr_tail.tail_mv(tk, x, y, tp))
        p = tail(lambda y: bsr_tail.tail_mv_packed_plain(tk, x, y, tp))
        y1 = torch.zeros(lo.n, dtype=x.dtype, device=device)
        real = torch.ones(tp.n_packed, dtype=torch.bool, device=device)
        real[tp.pad] = False
        n_cols = int(torch.unique(tp.cols[real]).numel())
        held("tail", k, k2, p, isz, tp.bytes_per_product(isz),
             (tp.n_entries + n_cols + 2 * tp.n_touched) * isz,
             lambda: bsr_tail.tail_mv(tk, x, y1, tp),
             lambda: bsr_tail.tail_mv_packed_plain(tk, x, y1, tp))
        out["tail"]["touched_rows"] = int(tp.n_touched)
        out["tail"]["x_reads"] = n_cols
    if df is not None:
        from metafem_torch.linsolve import twofloat as tf
        pair, packed = df
        xdf = tf.df_from_f64(x.double())
        xh, xl = xdf.hi[:C * n_cp].view(C, n_cp), xdf.lo[:C * n_cp].view(
            C, n_cp)
        plan64 = W.window.pack_plans(device, offset_spmv.DF_VEC)[0]

        def dfg(fn):
            yh = torch.zeros((C, n_cp), dtype=torch.float32, device=device)
            yl = torch.zeros_like(yh)
            fn(yh, yl)
            return torch.cat([yh[:, c0:c1], yl[:, c0:c1]])
        k = dfg(lambda yh, yl: offset_spmv.group_mv_df(
            packed[0], xh, xl, plan64, out_hi=yh, out_lo=yl))
        k2 = dfg(lambda yh, yl: offset_spmv.group_mv_df(
            packed[0], xh, xl, plan64, out_hi=yh, out_lo=yl))
        p = dfg(lambda yh, yl: offset_spmv.group_mv_df_plain(
            packed[0], xh, xl, plan64, yh, yl))
        if not (torch.equal(k, k2) and torch.equal(k, p)):
            raise AssertionError("packed_df: not bitwise its plain version "
                                 "and a repeat")
        yh = torch.empty((C, n_cp), dtype=torch.float32, device=device)
        yl = torch.empty_like(yh)
        out["packed_df"] = {
            "max_abs_err": 0.0, "bitwise": True,
            "ms": _event_ms(lambda: offset_spmv.group_mv_df(
                packed[0], xh, xl, plan64, out_hi=yh, out_lo=yl), device,
                reps=20, graph=True),
            "plain_ms": _event_ms(lambda: offset_spmv.group_mv_df_plain(
                packed[0], xh, xl, plan64, yh, yl), device, reps=3),
            "bytes": plan64.bytes_per_product(8),
            "min_bytes": ((plan64.n_entries - plan64.n_fill) + x_reads
                          + n_w) * 8,
            "rows": int(plan64.rows.numel())}
    return out


def _peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def chip_pair(run, leg, dom, kw, kernels, jitted=False) -> dict:
    """One refined step (``jitted``: one ``make_jitted_step`` step, its
    Newton count under "refines" and the Krylov iterations of each pass
    under "krylov") of ``dom`` row-sharded and whole on this rank:
    each run once (plans, packs), then again timed (host clock,
    synchronised) with the peak device memory and, for the sharded one,
    the kernel launches and the bytes through the collectives of that
    step, bitwise equal to its first run; the bars; then
    ``kernels(sharded_state, rows)``, the window's kernels against their
    plain versions.  The sharded step runs on every rank at once (its
    collectives join them); the whole step and the kernels run one rank
    at a time (``one_rank_at_a_time``), so that ranks sharing a card
    are timed alone."""
    device, mesh = run.device, run.mesh
    state = dom._runtime_state()
    sharded = shard_domain_state(state, mesh)
    rows = row_window(dom.pattern.offset_layout, mesh)
    logs = ([], [])
    if jitted:
        step_sh = dom.make_jitted_step(rowshard_mesh=mesh, log=logs[0], **kw)
        step0 = dom.make_jitted_step(log=logs[1], **kw)
    else:
        step_sh = dom.make_refined_step(rowshard_mesh=mesh, **kw)
        step0 = dom.make_refined_step(**kw)
    x0 = dom.x.to(torch.float64)
    x_first = step_sh(sharded, x0, 0.0, 1.0)[0]    # plans, packs
    dist.barrier()
    logs[0].clear()
    offset_spmv.reset_launches()
    bsr_tail.reset_launches()
    comm.reset_counts()
    _peak_reset(device)
    _sync(device)
    t0 = time.perf_counter()
    x_sh, _, res_sh, it_sh = step_sh(sharded, x0, 0.0, 1.0)
    _sync(device)
    s_sh = time.perf_counter() - t0
    peak_sh = _peak(device)
    launches, moved = _launches(), comm.counts()
    if not torch.equal(x_first, x_sh):
        raise AssertionError(f"{leg}: the repeat of the sharded step is not "
                             f"bitwise equal to it")
    del x_first

    def whole():
        step0(state, x0, 0.0, 1.0)
        logs[1].clear()
        _peak_reset(device)
        _sync(device)
        t0 = time.perf_counter()
        out = step0(state, x0, 0.0, 1.0)
        _sync(device)
        return out, time.perf_counter() - t0, _peak(device)
    (x_w, _, res_w, it_w), s_w, peak_w = one_rank_at_a_time(whole, mesh)
    its = same_on_all_ranks(it_sh, mesh, f"{leg} refines")
    if not (res_sh < TOL_RES and res_w < TOL_RES):
        raise AssertionError(f"{leg}: residuals {res_sh:.3e} (sharded), "
                             f"{res_w:.3e} (whole)")
    err = _max_rel(x_sh, x_w)
    if not err <= TOL_X:
        raise AssertionError(f"{leg}: sharded x off the whole step's by "
                             f"{err:.3e} of max|x|")
    if device.type == "cuda" and launches["packed"] + launches[
            "packed_df"] <= 0:
        raise AssertionError(f"{leg}: the sharded step launched no packed "
                             f"kernel")
    rec = {"rank": run.rank, "window": [list(c) for c in rows.mine.cps],
           "rows": rows.n_local, "n": rows.n,
           "storage": rows.mine.n_storage,
           "n_storage": dom.pattern.n_storage,
           "res": res_sh, "res_whole": res_w, "refines": it_sh,
           "refines_whole": it_w, "refines_all_ranks": its,
           "max_rel_vs_whole": err, "ms": s_sh * 1e3, "ms_whole": s_w * 1e3,
           "peak_bytes": peak_sh, "peak_bytes_whole": peak_w,
           "launches": launches, "comm": moved,
           "bytes_per_reduction": rows.bytes_per_reduction(4),
           "layout": check_window(sharded, dom, rows, pair=(
               ("b_hi", "A_hi") if kw.get("residual_mode") == "df32"
               else ("b", "A")),
               fine_inv_diag=kw.get("precond", "mg") == "mg")}
    if jitted:
        rec["krylov"] = [int(k) for k, _ in logs[0]]
        rec["krylov_whole"] = [int(k) for k, _ in logs[1]]
        rec["krylov_all_ranks"] = same_on_all_ranks(
            sum(rec["krylov"]), mesh, f"{leg} Krylov iterations")
    rec["kernels"] = one_rank_at_a_time(lambda: kernels(sharded, rows),
                                        mesh)
    return rec


def _x_probe(n, dtype, device, seed=7) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(n, generator=g, dtype=torch.float64).to(
        device=device, dtype=dtype)


def _all_ranks(rec: dict, mesh) -> list:
    """Every rank's record (rank order), on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


def _flagship_leg(run):
    """The flagship (metafem_torch.bench) at ``--nel`` with lattice_pad
    = N on a float32 domain: the refined multigrid step with float64
    residuals, then its df32 twin, each row-sharded against whole, to
    the reference's dry-run bar (converge_tol 1e-9); the window's f32
    fine operator, f64 A_td and two-float A_td through their kernels."""
    from metafem_torch import bench
    from metafem_torch.linsolve import twofloat as tf
    from metafem_torch.parallel.rowshard import local_mg_state
    t0 = time.perf_counter()
    dom = bench.build_domain(run.nel, device=run.device,
                             lattice_pad=run.size)
    dom.freeze_linear_tangent()
    dom.setup_mg(tune=False)
    dom.freeze_refined_residual()
    dom.converge_tol = 1e-9
    setup_s = time.perf_counter() - t0
    kw = dict(sv_func=krylov.bicgstab, maxiter=60, max_refine=20,
              max_pass=1, precond="mg")

    def k64(sharded, rows):
        n = rows.n
        out = {"f64_A_td": window_kernels(
            sharded["refined"]["A_mats"][0],
            _x_probe(n, torch.float64, run.device), run.device)}
        fine = local_mg_state(sharded["mg_frozen"], rows)[0]["A"]
        out["f32_fine"] = window_kernels(
            fine, _x_probe(n, torch.float32, run.device), run.device)
        return out

    def kdf(sharded, rows):
        from metafem_torch.linsolve.block_offset import OffsetMatrix
        ref = sharded["refined"]
        pair = tf.DF(ref["A_hi"][0], ref["A_lo"][0])
        W = OffsetMatrix.from_values(pair.hi, rows.layout, rows.mine)
        return {"df_A_td": window_kernels(
            W, _x_probe(rows.n, torch.float32, run.device), run.device,
            df=(pair, ref["A_packed"][0]))}
    f64 = chip_pair(run, "flagship_f64", dom, kw, k64)
    df = chip_pair(run, "flagship_df32", dom,
                   {**kw, "residual_mode": "df32"}, kdf)
    rec = {"nel": list(run.nel), "dof": dom.pattern.basicfield_size,
           "setup_s": setup_s, "f64": f64, "df32": df}
    run.records["flagship"] = {"ranks": _all_ranks(rec, run.mesh)}
    if run.rank == 0:
        print("[dryrun] flagship: " + json.dumps(rec), flush=True)


def _pikachu_leg(run):
    """The pikachu brick (examples/pikachu_brick.py, BSR tail) at
    ``--pikachu-nel`` with ghost control points up to N: the refined
    step with the auxiliary-space multigrid, row-sharded against whole
    (converge_tol 1e-9); the window's f64 A_td (dense group and BSR
    tail) through its kernels."""
    from metafem_torch.examples import pikachu_brick
    t0 = time.perf_counter()
    dom, _ = pikachu_brick.build(run.pikachu_nel, device=run.device,
                                 lattice_pad=run.size)
    if dom.pattern.offset_layout.blk_b == 0:
        raise AssertionError("pikachu: no BSR tail")
    dom.freeze_linear_tangent()
    dom.freeze_refined_residual()
    dom.setup_auxmg()
    dom.converge_tol = 1e-9
    setup_s = time.perf_counter() - t0
    kw = dict(sv_func=krylov.bicgstab, maxiter=40, max_refine=20,
              max_pass=1, precond="auxmg")

    def k64(sharded, rows):
        return {"f64_A_td": window_kernels(
            sharded["refined"]["A_mats"][0],
            _x_probe(rows.n, torch.float64, run.device), run.device)}
    rec = {"nel": list(run.pikachu_nel),
           "dof": dom.pattern.basicfield_size, "setup_s": setup_s,
           "f64": chip_pair(run, "pikachu", dom, kw, k64)}
    run.records["pikachu"] = {"ranks": _all_ranks(rec, run.mesh)}
    if run.rank == 0:
        print("[dryrun] pikachu: " + json.dumps(rec), flush=True)


def _flagship_jitted_leg(run):
    """The float64 flagship (``Run.flag64``): the row-sharded jitted
    step with its multigrid set up per step on the window
    (``make_jitted_step(precond="mg", static_k_linear=True)``) against
    the same step whole, to 1e-9; the window setup against the whole
    one; then ``setup_mg`` and a whole ``reuse_mg`` step on the state
    cut to the windows, bitwise the step on its uncut twin.  The
    window's f64 tangent through the packed kernel."""
    from metafem_torch.parallel.rowshard import RowShardedOp
    dom, build_s = run.flag64()
    kw = dict(sv_func=krylov.bicgstab, maxiter=200, max_newton=6,
              max_pass=2, precond="mg", static_k_linear=True)
    A, _ = dom.assemble_tangent()

    def k64(sharded, rows):
        return {"f64_tangent": window_kernels(
            RowShardedOp(A, rows).inner,
            _x_probe(rows.n, torch.float64, run.device), run.device)}
    step = chip_pair(run, "flagship_jitted", dom, kw, k64, jitted=True)
    del A
    setup = setup_vs_whole(dom, run.mesh, {})
    t0 = time.perf_counter()
    dom.setup_mg(tune=False)
    setup_mg_s = time.perf_counter() - t0
    cut, _ = _cut_pair(dom, dom.make_jitted_step(reuse_mg=True, **kw),
                       dom.x, run.mesh, "flagship_jitted whole_on_cut")
    cut["setup_mg_s"] = setup_mg_s
    rec = {"nel": list(run.nel), "dof": dom.pattern.basicfield_size,
           "build_s": build_s, "step": step, "setup": setup,
           "whole_on_cut": cut}
    run.records["flagship_jitted"] = {"ranks": _all_ranks(rec, run.mesh)}
    if run.rank == 0:
        print("[dryrun] flagship_jitted: " + json.dumps(rec), flush=True)


def _flagship_menu_leg(run):
    """The four solvers of ``MENU`` on the float64 flagship's row-sharded,
    right-Jacobi scaled tangent at x, ``MENU_CHIP_ITERS`` iterations at
    tol 0, each against the whole operator in the same rank
    (``menu_solves``: within 1e-8 x max|y| and bitwise, the whole solve
    adding its dots in the ranks' order); the window's scaled tangent
    through the packed kernel."""
    from metafem_torch.linsolve.precond import pr_jacobi
    from metafem_torch.parallel.rowshard import RowShardedOp
    dom, build_s = run.flag64()
    A, b = dom.assemble_tangent()
    rows = row_window(A.layout, run.mesh)
    _peak_reset(run.device)
    solves, _ = menu_solves(run, A, b, tol=0.0, maxiter=MENU_CHIP_ITERS,
                            shadows={}, bar=TOL_X)
    for name, r in solves.items():
        if r["iters"] != MENU_CHIP_ITERS:
            raise AssertionError(f"{name}: {r['iters']} iterations, not "
                                 f"{MENU_CHIP_ITERS}")
    W = pr_jacobi(RowShardedOp(A, rows))[0].inner
    menu = {"rank": run.rank, "window": [list(c) for c in rows.mine.cps],
            "rows": rows.n_local, "n": rows.n,
            "storage": rows.mine.n_storage,
            "n_storage": dom.pattern.n_storage,
            "peak_bytes": _peak(run.device), "solvers": solves,
            "launches": {"packed": sum(r["launches"]
                                       for r in solves.values())},
            "kernels": one_rank_at_a_time(lambda: {
                "f64_scaled": window_kernels(
                    W, _x_probe(rows.n, torch.float64, run.device),
                    run.device)}, run.mesh)}
    rec = {"nel": list(run.nel), "dof": dom.pattern.basicfield_size,
           "build_s": build_s, "menu": menu}
    run.records["flagship_menu"] = {"ranks": _all_ranks(rec, run.mesh)}
    if run.rank == 0:
        print("[dryrun] flagship_menu: " + json.dumps(rec), flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--out", default="")
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--nel", type=int, nargs=2, default=(800, 400))
    ap.add_argument("--pikachu-nel", type=int, nargs=3, default=(24, 17, 17))
    ap.add_argument("--shadows", default="",
                    help="an .npz of the menu's whole shadow arrays "
                         "(keys P, s0, jitter)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("dryrun: --device cuda without CUDA")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(args.backend, rank=rank, world_size=world)
    try:
        mesh = make_mesh(device=device)
        run = Run(mesh, device, args.out, args.nel, args.pikachu_nel,
                  args.shadows)
        t_all = time.perf_counter()
        for leg in args.legs.split(","):
            if leg not in LEGS + MENU_LEGS + CHIP_LEGS:
                raise ValueError(f"unknown leg {leg!r}")
            t0 = time.perf_counter()
            getattr(run, leg)()
            run.records[leg]["leg_s"] = time.perf_counter() - t0
            if leg in CHIP_LEGS:
                # the leg's domain goes before the next one's peak
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        summary = {"ranks": world, "device": str(device),
                   "backend": args.backend, "legs": run.records,
                   "s": time.perf_counter() - t_all}
        if rank == 0:
            if args.out:
                with open(os.path.join(args.out, "summary.json"), "w") as f:
                    json.dump(summary, f, indent=1)
            print(f"[dryrun] OK on {world} ranks: "
                  + ", ".join(run.records), flush=True)
        dist.barrier()
        return summary
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
