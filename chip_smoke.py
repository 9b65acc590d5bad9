#!/usr/bin/env python3
"""Smoke run of the PyTorch port (metafem_torch) on one CUDA card.

    python3 chip_smoke.py

from the root of the repository.  Phases, one line or more each:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the three kernel sources compiled with nvcc, in parallel (the
   SpMV's and the BSR tail's each hold float64, float32 and two-float
   entry points), and ptxas's report of their registers and spills;
3. kernel parity: the packed block-offset SpMV against its plain
   PyTorch version and the dense formula on the README thermal operator
   (f64, f32) and a C=2 elastic one, with times from CUDA events (back
   to back and with L2 flushed) beside three bounds (structural entries,
   packed bytes, whole storage), a CSR library product, the pack plan's
   build time and the pack's cost; every two-float op on the card
   against float64 on the card;
4. the gather probe (``metafem_torch.benchmarks.gather_probe``) at the
   TPU probe's two sizes and the main path's counts (x of the 3D bar,
   541,059 values, read 89,057,289 times at uniform random): the
   device-memory variant and the cluster window at every cluster size
   tried, each bitwise equal to ``torch.take``, with times, M gathers/s,
   the launch floor, the bytes bound and ``torch.index_select``; the 3D
   phase runs both on the tangent's own read stream;
5. the README thermal Newton step at nel=(400,200) (321,201 DOF, f64)
   with the FEATool check and a bitwise repeat, and ``write_vtk`` of
   its mesh (its CELLS and POINT_DATA counts checked);
6. the ``bench.py`` flagship through ``metafem_torch.bench`` at
   nel=(800,400) (1,282,401 DOF, f32 domain, f64 residuals): each
   one-time phase, the converge-once pass, the Chebyshev tune, the
   timed step (final residual below 1e-6), SpMV launches per step split
   f32/f64, launches per V-cycle, where the step's time goes, a bitwise
   repeat, and the SpMV's parity and time at this size; then the same
   step in the two-float residual mode (``residual_mode="df32"``, x as a
   DF pair): 3 timed steps with the device-busy time, refines, residuals
   and launches of the two-float and f32 kernels, a bitwise repeat, its
   x against the f64 step's and its root's f64-mode residual, and the
   two-float SpMV kernel on A_td against its plain version and the f64
   kernel, timed beside them, CSR ``torch.mv`` and its bound, with the
   kernel's registers, spills and resident warps per SM; after
   the timed step, ``save_freezes`` of the cold domain;
7. persist (``phase_persist``): a fresh flagship domain warm-started
   from those freezes (``bench.prepare`` with its freeze cache) runs the
   timed step, bitwise equal to the cold one; ``free_volume_tables``
   and the bytes it frees, the step again bitwise equal, the refusal of
   ``update_one_step``; ``memory_report`` beside
   ``torch.cuda.memory_allocated``; a ``trace_profile`` of one step
   holding the SpMV's kernel events; ``freeze_linear_tangent(on_host=
   True)`` at nel=(400,200) against the device freeze.  The 3D phase
   adds its bar's memory report and the thermo-elastic path a
   checkpoint after step 1, resumed bitwise in a fresh domain;
8. the first 3D vector-valued path: ``hyperelastic_3d`` (Neo-Hookean,
   C=3) at nel=(160,16,16) (541,059 DOF, one dense group of 9 units and
   117 offsets, f64): the SpMV's parity and time on its tangent in f64
   and f32 beside the bounds, the plain version and CSR ``torch.mv``, a
   bitwise-repeated BiCGStab(4) solve, a profiled BiCGStab(4) cycle
   (device busy, the SpMV's share), load step 1 through
   ``update_one_step`` (its iterations beside the dense kernel's) and
   load step 2 through ``update_one_step_jit`` (residual below 1e-5,
   d1/L within 2% of the analytic curve), peak device memory;
9. the multi-field and history-variable paths: ``thermal_elasticity_3d``
   (temperature and displacement, C=4) at nel=(60,24,24) (595,300 DOF,
   one dense group of 117 offsets, f64): the SpMV's parity and time on
   its tangent in f64 and f32, the example's BiCGStab(4) solve twice
   (bitwise equal), three steps of dt=1 each below 1e-6; the same bar at
   e_number=1 stepped to steady state with the reference test's bending
   bars; ``cavity_2d`` (velocity and pressure, C=3) at 40 x 40, Re 100
   and Re 1000 each within 0.02 of Ghia et al.'s centreline minimum,
   and the SpMV on its tangent, then a float32 twin at the Re 100
   fields through one df32 refined step (residual below 1e-9, the f64
   domain's residual of its root below 5e-9; the two-float volume
   lowering of the convection on the card) and the two-float SpMV on
   its A_td; ``j2_plasticity``'s mixed-hardening
   sequence within 1.5e-3 of the analytic elongations, its history on
   the card;
10. the unstructured path (``phase_unstructured``): pikachu's weak form
    on a jittered order-2 tet brick at nel=(73,51,51) (1,369,650 DOF,
    f32 domain; ``examples/pikachu_brick.py``) through
    ``benchmarks/pikachu_scale.py``'s production path: each one-time
    phase's seconds (the host freezes, ``setup_auxmg`` by part); the
    packed BSR-tail kernel (one thread per row over the tail plan of its
    structural entries) on the f32 tangent and the f64 A_td against its
    plain version and the BSR storage's product (bitwise repeats), timed
    back to back and with L2 flushed beside three bounds (structural
    entries, the plan's bytes, the whole BSR storage), CSR ``torch.mv``
    over the tail's structural entries and ``torch.sparse_bsr_tensor``,
    with the plan's build time, padding and pack; the packed kernel on
    each tailless view; the whole product ``A.mv`` (dense group and
    tail) against CSR ``torch.mv`` over all its structural entries, f32
    and f64; 3 timed refined steps with f64 residuals (auxmg, BiCGStab)
    below 1e-6 with the launches of both kernels per step and the
    device-busy time, a bitwise repeat; the same step in the
    reference's own df32 residual mode (``residual_mode="df32"``, x as
    a DF pair): the pair split of the freeze, a converge from cold, 3
    timed warm steps below 1e-6 with every kernel's launches per step,
    the device-busy time and the two-float tail kernel's share, a
    bitwise repeat, its T within 1e-5 of the f64 step's root; the
    two-float tail kernel on that A_td, bitwise equal to its plain
    version and within 1e-12 of the f64 tail kernel, timed beside the
    f64 tail kernel, CSR f64 and its bounds; the two-float dense-group
    kernel on the same A_td's dense group (one C=1 group of 59 offsets,
    Morton numbering) within 2^-45 |A||x| per row of its plain version
    and of the f64 packed kernel, timed beside them and CSR f64, each
    two-float kernel with its registers and warps per SM; the
    sparse smoother with
    the exact inner operator (its root against the full smoother's) and
    with the sparsified one (reported); one ``update_one_step`` with
    ``make_iterative_solver(precond="auxmg")``, its T within 1e-5 of
    the refined root;
11. the mesh-reading examples (``phase_mesh_examples``), each through
    the port's own entry point on a mesh this script writes to a
    temporary directory in the format the example reads (``write_inp``,
    ``write_mphtxt``): ``stress_concentration_2d`` on a quarter-hole
    plate of 160 x 80 serendipity quads (77,762 DOF, C=2, GMRES(20)),
    ``stress_concentration_3d`` with ``solver="idrs"`` on a quarter-hole
    block of 16 x 20 x 14 serendipity hexes (61,479 DOF, C=3, IDR(8)),
    ``pikachu_3d`` on the jittered brick at nel=(18,13,13) in
    centimetres, refined once (174,637 DOF, C=1; steady, then 3
    transient steps) and ``cylinder_flow_3d`` on a jittered duct with a
    stepped cylinder at nel=(73,12,12) (323,884 DOF, C=4, SUPG, IDR(8)
    with left Jacobi), each held to its reference test's gates (the
    flow to the inflow's volume flux); per path the layout's tail,
    every kernel's launches, the seconds of its parts, its Newton
    updates and Krylov iterations, the packed kernel (and over a BSR
    tail the tail kernel) on its first tangent against its plain
    version (a few ulps apart: the kernels fuse each product with fma)
    and a bitwise repeat, timed beside CSR ``torch.mv`` and the bounds,
    A.mv against CSR, and one solve pass's device-busy ms;
12. the multi-device layer (``phase_multidevice``, run right after the
    flagship): (A) an NCCL group of one rank in this process, a 1-rank
    DeviceMesh, ``shard_domain_state`` and the flagship's timed step
    with ``rowshard_mesh``, bitwise equal to the unsharded step, its ms
    beside the unsharded step's in turns, the packed kernel's launches
    and the bytes through the collectives; (B) two gloo ranks on this
    one card (``torch.distributed.run``, ``metafem_torch.parallel.
    dryrun --device cuda``, under a time limit that kills the group):
    the flagship at nel=(800,400) with lattice_pad=2, the refined
    multigrid step with f64 residuals and its df32 twin, then the pikachu
    brick (BSR tail, auxmg) at nel=(24,17,17), each sharded step within
    1e-8·max|x| of the same step whole, refines equal on both ranks,
    and per rank its window, rows, launches, peak memory beside the whole
    step's, bytes staged and moved, ms, and the window's packed,
    two-float and BSR-tail kernels against their plain versions and a
    repeat;
13. the ``kernels`` JSON line, then the device JSON line last.

Each path (gather probe, README step, flagship, the df32 flagship, the
warm-started flagship, each 3D load step, each thermo-elastic step and
the resumed ones, each cavity Reynolds number, the df32 cavity, the
unstructured steps and their df32 twin, each mesh-reading example) runs
with the kernels' launch counts set to 0 just before it and read just
after; every path must have launched its kernel.  Every failure raises
and exits non-zero.
Without CUDA, or without the ``metafem_torch`` package beside this file,
the script exits non-zero and prints no result.  The phases are
functions of ``device`` and ``nel`` so that tests can run the slice
phase small on the CPU.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: the main path's mesh: the strip of examples/thermal_2d.py refined to
#: 321,201 DOF
NEL = (400, 200)
#: small plane-strain elastic operator with full 2x2 unit coupling (C=2);
#: 129 x 65 control points, above the dense-segment threshold of 4096
ELASTIC_NEL = (64, 32)
#: H100 data-sheet peaks: device memory bytes/s by part, and the SXM
#: part's float64 vector FLOP/s (the kernel uses no tensor cores; the
#: bound is taken for the float64 operator only)
PEAK_BYTES = {"H100 SXM": 3.35e12, "H100 PCIe": 2.0e12, "H100 NVL": 3.9e12}
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
#: the bench.py flagship mesh: 1,282,401 DOF
FLAGSHIP_NEL = (800, 400)
#: the 3D path: hyperelastic_3d at nel=(160,16,16), 541,059 DOF
E3D = 16
#: BiCGStab(4) iterations of the profiled run on the 3D tangent
PROF_ITERS = 40
#: iterations of load step 1's three solves at E3D with the dense kernel
#: of earlier versions (its chip runs on an H100); the packed kernel adds
#: the same products in the same order, so it should repeat them
DENSE_KERNEL_ITERS = (708, 696, 648)
#: the multi-field paths: thermal_elasticity_3d at nel=(60,24,24),
#: 595,300 DOF, and at e_number=1 to steady state; cavity_2d at 40 x 40
#: (the reference's own resolution); j2_plasticity at nel=(5,2,2)
TE_E = 24
TE_STEADY_E = 1
CAVITY_E = 40
J2_E = 2
#: the unstructured path: pikachu's weak form on a jittered order-2 tet
#: brick at nel=(73,51,51), 1,369,650 DOF (pikachu refine-2: 1,358,969)
UNSTRUCT_NEL = (73, 51, 51)
#: benchmarks/pikachu_scale.py's refined step
PIKACHU_STEP = dict(maxiter=12, max_refine=4, max_pass=1, forcing=0.3)
#: the unstructured roots that other paths are held to are converged to
#: this residual (float64 residuals reach it); two such roots of the same
#: problem, by two smoothers, agree within ROOT_REL * max|x|
ROOT_TOL = 1e-9
ROOT_REL = 1e-7
#: the numbers of each SpMV operator in the kernels line
SPMV_KEYS = ("ms", "cold_ms", "plain_ms", "library_ms", "bound_ms",
             "packed_bound_ms", "storage_bound_ms", "pack_ms", "plan_build_s",
             "padding_share", "n_packed", "nnz", "stored",
             "bytes_per_product", "plan_bytes", "max_abs_err")


def _import_port():
    if not os.path.isdir(os.path.join(HERE, "metafem_torch")):
        raise SystemExit("chip_smoke.py: metafem_torch/ not found beside "
                         "this script; run it from the repository root")
    if HERE not in sys.path:
        sys.path.insert(0, HERE)


def _peak_bytes(name: str) -> float:
    if "PCIe" in name:
        return PEAK_BYTES["H100 PCIe"]
    if "NVL" in name:
        return PEAK_BYTES["H100 NVL"]
    return PEAK_BYTES["H100 SXM"]


def _time_ms(fn, reps: int = 25, warmup: int = 3,
             graph: bool = False) -> float:
    """Device time of one call: the port's CUDA-event timer over
    back-to-back calls, or over replays of a CUDA graph of them
    (metafem_torch/benchmarks/timing.py)."""
    from metafem_torch.benchmarks.timing import cuda_time_ms
    return cuda_time_ms(fn, reps=reps, warmup=warmup, graph=graph)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_environment(device) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(device)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(smi)
    return {"name": name, "smi": smi}


def phase_build() -> float:
    """The kernels' sources compiled at once (one nvcc each), then
    loaded."""
    from concurrent.futures import ThreadPoolExecutor
    from metafem_torch import buildlib
    from metafem_torch.benchmarks import gather_probe
    from metafem_torch.linsolve import bsr_tail, offset_spmv
    t0 = time.perf_counter()
    sources = ("offset_spmv", "gather_probe", "bsr_tail")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(buildlib.build_cuda, sources))
    offset_spmv.load_library()
    gather_probe.load_library()
    bsr_tail.load_library()
    sec = time.perf_counter() - t0
    flags = " ".join(buildlib.NVCC_FLAGS)
    print(f"[build] offset_spmv.cu and bsr_tail.cu (float64, float32 and "
          f"two-float entry points each) and gather_probe.cu with nvcc "
          f"{flags}: {sec:.2f} s")
    for lib in libs:
        for line in buildlib.build_log(lib).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] ptxas {os.path.basename(lib)}: "
                      f"{line.strip()}")
    return sec


def elastic_domain(nel, device):
    """Plane-strain cantilever with two coupled displacement channels."""
    import metafem_torch as mf
    from metafem_torch import Bilinear, FEM_Domain
    L, H = 4.0, 1.0
    vert, conn = mf.make_square((L, H), nel)
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(2, device=device)
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
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity")
    dom.assemble_global_variables()
    dom.compile()
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "sl3", np.full(mesh.n_cp, 1e-3))
    dom.refresh_fields()
    dom.assemble_x()
    return dom


def _parity(A, x, dtype) -> tuple:
    """(max |kernel - plain| / max |plain|, max abs error) over every
    dense group of A at x in ``dtype``: the packed kernel against its
    plain version on the same packed values and against the dense
    formula (``group_mv_plain``) on the block-offset storage.  Two
    launches on one input must give the same bits."""
    from metafem_torch.linsolve import offset_spmv
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    B = (A if A.vals.dtype == dtype
         else OffsetMatrix.from_values(A.vals.to(dtype), A.layout))
    x = x.to(dtype)
    worst_rel, worst_abs = 0.0, 0.0
    for i, (grp, plan) in enumerate(zip(B.layout.pallas_groups,
                                        B.pack_plans())):
        sl = slice(grp.dof_offset, grp.dof_offset + grp.n_vars * grp.n_cp)
        xw = x[sl].view(grp.n_vars, grp.n_cp)
        packed = B.packed(i)
        y = offset_spmv.group_mv(packed, xw, plan)
        y2 = offset_spmv.group_mv(packed, xw, plan)
        torch.cuda.synchronize()
        if not torch.equal(y, y2):
            raise AssertionError("offset_spmv: two launches on one input "
                                 "differ")
        n_slab = len(grp.units) * grp.n_off * grp.n_cp
        slab = B.vals[grp.base:grp.base + n_slab].view(
            len(grp.units), grp.n_off, grp.n_cp)
        for ref in (offset_spmv.group_mv_packed_plain(packed, xw, plan,
                                                      torch.empty_like(y)),
                    offset_spmv.group_mv_plain(slab, xw, grp,
                                               torch.empty_like(y))):
            err = float((y - ref).abs().max())
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / float(ref.abs().max()))
        plan.columns = None
    return worst_rel, worst_abs


def phase_kernel(device, nel=NEL, elastic_nel=ELASTIC_NEL) -> dict:
    """The kernel against its plain version on the thermal operator of the
    main path (f64 and f32) and on a C=2 elastic operator (f64); then its
    time beside the plain version, a CSR library product and the bound."""
    from metafem_torch.examples import thermal_2d
    from metafem_torch.linsolve import offset_spmv
    t0 = time.perf_counter()
    dom, _ = thermal_2d.build(nel, device=device)
    A, _ = dom.assemble_tangent()
    rng = np.random.default_rng(20261017)
    x = torch.as_tensor(rng.standard_normal(A.n), device=device)
    rel64, abs64 = _parity(A, x, torch.float64)
    rel32, _ = _parity(A, x, torch.float32)
    dom_e = elastic_domain(elastic_nel, device)
    A_e, _ = dom_e.assemble_tangent()
    (g_e,) = A_e.layout.pallas_groups
    if g_e.n_vars != 2 or len(g_e.units) != 4:
        raise AssertionError(f"elastic group is not 2x2: {g_e}")
    x_e = torch.as_tensor(rng.standard_normal(A_e.n), device=device)
    rel_e, _ = _parity(A_e, x_e, torch.float64)
    print(f"[kernel] parity max|y-y_plain|/max|y|: thermal {nel} f64 "
          f"{rel64:.3e} (abs {abs64:.3e}), f32 {rel32:.3e}; elastic "
          f"{elastic_nel} C=2 G=4 n_off={g_e.n_off} f64 {rel_e:.3e}; "
          f"repeat launches bitwise equal")
    if not rel64 <= 1e-13 or not rel_e <= 1e-13:
        raise AssertionError(f"f64 kernel disagrees: {rel64}, {rel_e}")
    if not rel32 <= 1e-5:
        raise AssertionError(f"f32 kernel disagrees: {rel32}")

    t = _spmv_numbers(A, x, device)
    _print_spmv("kernel", f"thermal {nel}", A, t)
    df_worst = _df_ops_check(device)
    print(f"[kernel] two-float ops on the card against float64 on the "
          f"card: worst error {df_worst:.3f} of its bound; two_prod exact")
    print(f"[kernel] phase {time.perf_counter() - t0:.1f} s")
    return {**t, "max_abs_err": abs64, "max_rel_err_f64": max(rel64, rel_e),
            "max_rel_err_f32": rel32}


#: float32 operations of one entry of the two-float product: two_prod by
#: fma (2), the cross terms (4), df_add into the unit's pair (11)
DF_OPS_PER_ENTRY = 17
#: the two-float SpMV against its plain version and the float64 kernel:
#: |dy| <= DF_SPMV_BOUND * (|A||x|)_row
DF_SPMV_BOUND = 2.0 ** -45


def _df_ops_check(device, n: int = 1 << 20) -> float:
    """Every two-float op on ``device`` against float64 on the same
    device, each within its own error bound (tests/test_torch_twofloat.py
    holds the same ops to the reference on the CPU); returns the worst
    error over its bound."""
    from metafem_torch.linsolve import twofloat as tf
    g = torch.Generator(device="cpu").manual_seed(20261017)

    def vec():
        v = (torch.randn(n, generator=g, dtype=torch.float64)
             * 10.0 ** (6 * torch.rand(n, generator=g,
                                       dtype=torch.float64) - 3))
        return tf.df_from_f64(v.to(device))
    x, y = vec(), vec()
    x64, y64 = tf.df_to_f64(x), tf.df_to_f64(y)
    v32 = y.hi
    v64 = v32.double()
    cases = {
        "df_add": (tf.df_add(x, y), x64 + y64, x64.abs() + y64.abs(), -44),
        "df_sub": (tf.df_sub(x, y), x64 - y64, x64.abs() + y64.abs(), -44),
        "df_mul": (tf.df_mul(x, y), x64 * y64, (x64 * y64).abs(), -44),
        "df_div": (tf.df_div(x, y), x64 / y64, (x64 / y64).abs(), -44),
        "df_add_f32": (tf.df_add_f32(x, v32), x64 + v64,
                       x64.abs() + v64.abs(), -45),
        "df_scale": (tf.df_scale(x, v32), x64 * v64, (x64 * v64).abs(), -45),
        "df_dot2": (tf.df_dot2([(x, y), (y, x), (x, x)]),
                    2 * x64 * y64 + x64 * x64,
                    2 * (x64 * y64).abs() + x64 * x64, -44)}
    p, e = tf.two_prod(x.hi, y.hi)
    worst = 0.0
    for name, (got, want, mag, lg) in cases.items():
        err = float(((tf.df_to_f64(got) - want).abs()
                     / (2.0 ** lg * mag).clamp(min=1e-300)).max())
        if not err <= 1.0:
            raise AssertionError(f"{name} on {device} off by {err} of its "
                                 f"bound")
        worst = max(worst, err)
    if not torch.equal(p.double() + e.double(), x.hi.double() * y.hi.double()):
        raise AssertionError(f"two_prod on {device} is not exact")
    return worst


def _df_spmv(ref: dict, layout, rng, device, label: str, tag: str) -> dict:
    """The two-float SpMV kernel on each time level of the frozen pair
    (``ref`` after a df32 step: A_hi/A_lo and their packed pairs, the
    dense group's first) at a random x pair, held row by row within
    DF_SPMV_BOUND * (|A||x|)_row of its plain version (both on the card)
    and of the float64 packed kernel on (hi + lo), over the dense group
    alone (``dense_part``: a BSR tail has kernels of its own), and
    launched twice to the same bits; then the
    first level's kernel timed (CUDA graph replay, and with L2 flushed)
    beside its plain version, the float64 kernel and CSR ``torch.mv`` in
    float64 on the same entries, and the bound: the structural entries'
    8 bytes each, x's and y's pairs once, at the card's memory rate, or
    DF_OPS_PER_ENTRY float32 operations per entry, whichever is
    longer; and the kernel's registers and resident warps per SM."""
    from metafem_torch.linsolve import offset_spmv
    from metafem_torch.linsolve import twofloat as tf
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    (grp,) = layout.pallas_groups
    C, n_cp = grp.n_vars, grp.n_cp

    def dense(vals):
        return OffsetMatrix.from_values(vals, layout).dense_part()
    (plan,) = dense(ref["A_hi"][0]).pack_plans(vec=offset_spmv.DF_VEC)
    x = tf.df_from_f64(torch.as_tensor(
        rng.standard_normal(layout.n) * (1.0 + rng.random(layout.n)),
        device=device))
    xw = tf.DF(x.hi.view(C, n_cp), x.lo.view(C, n_cp))
    x64 = tf.df_to_f64(x)
    worst_plain, worst_f64, max_abs = 0.0, 0.0, 0.0
    for td in range(ref["A_hi"].shape[0]):
        packed = ref["A_packed"][td][0]
        a = tf.DF(ref["A_hi"][td], ref["A_lo"][td])
        y = offset_spmv.group_mv_df(packed, xw.hi, xw.lo, plan)
        y2 = offset_spmv.group_mv_df(packed, xw.hi, xw.lo, plan)
        torch.cuda.synchronize(device)
        if not (torch.equal(y[0], y2[0]) and torch.equal(y[1], y2[1])):
            raise AssertionError("offset_spmv_packed_df: two launches on "
                                 "one input differ")
        yk = tf.df_to_f64(tf.DF(*y)).view(-1)
        plain = offset_spmv.group_mv_df_plain(
            packed, xw.hi, xw.lo, plan, torch.empty_like(y[0]),
            torch.empty_like(y[1]))
        plan.columns = None
        A64 = dense(tf.df_to_f64(a))
        y64 = A64.mv(x64)
        ax = dense(A64.vals.abs()).mv(x64.abs())
        bound = DF_SPMV_BOUND * ax.clamp(min=1e-300)
        d_plain = (yk - tf.df_to_f64(tf.DF(*plain)).view(-1)).abs()
        d_f64 = (yk - y64).abs()
        worst_plain = max(worst_plain, float((d_plain / bound).max()))
        worst_f64 = max(worst_f64, float((d_f64 / bound).max()))
        max_abs = max(max_abs, float(d_plain.max()))
        del plain, y64, ax, bound, d_plain, d_f64
    if not (worst_plain <= 1.0 and worst_f64 <= 1.0):
        raise AssertionError(f"two-float SpMV on {label}: off by "
                             f"{worst_plain} (plain), {worst_f64} (f64 "
                             f"kernel) of 2^-45 |A||x|")
    packed = ref["A_packed"][0][0]
    out = (torch.empty_like(xw.hi), torch.empty_like(xw.lo))

    def kernel():
        offset_spmv.group_mv_df(packed, xw.hi, xw.lo, plan, *out)
    ms = _time_ms(kernel, graph=True)
    cold_ms = _time_cold_ms(kernel, device)
    offset_spmv.packed_columns(plan)
    plain_ms = _time_ms(lambda: offset_spmv.group_mv_df_plain(
        packed, xw.hi, xw.lo, plan, *out), reps=5, warmup=1)
    plan.columns = None
    A64 = dense(tf.df_to_f64(tf.DF(ref["A_hi"][0], ref["A_lo"][0])))
    (plan64,) = A64.pack_plans()
    packed64 = A64.packed(0)
    xw64 = x64.view(C, n_cp)
    out64 = torch.empty_like(xw64)
    f64_ms = _time_ms(lambda: offset_spmv.group_mv(packed64, xw64, plan64,
                                                   out64), graph=True)
    csr = A64.to_csr()
    nnz = csr.values().numel()
    csr_ms = _time_ms(lambda: torch.mv(csr, x64))
    del csr, A64, packed64
    rate = _peak_bytes(torch.cuda.get_device_name(device))
    t_bytes = (8 * nnz + 2 * 8 * layout.n) / rate
    t_ops = DF_OPS_PER_ENTRY * nnz / PEAK_FLOPS["float32"]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    occ = offset_spmv.df_occupancy(plan)
    print(f"[{tag}] offset_spmv_packed_df {label} ({ref['A_hi'].shape[0]} "
          f"time level(s), G={len(grp.units)}, n_off={grp.n_off}, C={C}, "
          f"n_cp={n_cp}, {nnz} structural entries): worst |dy| / (2^-45 "
          f"|A||x|)_row {worst_plain:.3e} against its plain version "
          f"(max abs {max_abs:.3e}), {worst_f64:.3e} against the float64 "
          f"kernel; repeat launches bitwise equal; kernel {ms:.4f} ms "
          f"(graph replay), {cold_ms:.4f} ms with L2 flushed; plain "
          f"{plain_ms:.4f} ms; float64 packed kernel {f64_ms:.4f} ms; CSR "
          f"torch.mv float64 {csr_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}; "
          f"{100 * bound_ms / ms:.0f}% of it); one row per thread, "
          f"{occ['registers']} registers, {occ['spill_bytes']} B spilled, "
          f"{occ['warps_per_sm']} warps/SM")
    return {"ms": ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
            "f64_kernel_ms": f64_ms, "csr_f64_ms": csr_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "nnz": nnz, "levels": int(ref["A_hi"].shape[0]),
            "max_abs_err": max_abs, "worst_vs_plain": worst_plain,
            "worst_vs_f64_kernel": worst_f64, **occ}


def phase_slice(device, nel=NEL) -> dict:
    """The README's thermal Newton step through the port's example
    (``thermal_2d.build`` then ``thermal_2d.step``, which make up
    ``thermal_2d.solve``), then the same step again from the same x,
    which must give the same x bit for bit."""
    from metafem_torch.examples import thermal_2d
    from metafem_torch.linsolve import offset_spmv

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    dom, mesh = thermal_2d.build(nel, device=device)
    sync()
    t1 = time.perf_counter()
    offset_spmv.reset_launches()
    res = thermal_2d.step(dom, verbose=True)
    sync()
    t2 = time.perf_counter()
    launches = offset_spmv.group_mv.launches
    err = thermal_2d.featool_error(mesh)
    iters = [it for it, _ in dom.solve_log]
    print(f"[slice] thermal nel={nel} dof={dom.pattern.basicfield_size} "
          f"{dom.dtype} on {device}: final residual {res:.3e}, BiCGStab "
          f"iterations per solve pass {iters}, setup {t1 - t0:.2f} s, "
          f"step {t2 - t1:.2f} s, offset_spmv launches {launches}, "
          f"FEATool max rel err {err:.2e}")
    if not res < 1e-6:
        raise AssertionError(f"Newton step did not converge: {res}")
    if not err < 0.01:
        raise AssertionError(f"FEATool midline error {err}")
    if device.type == "cuda" and launches <= 0:
        raise AssertionError("the step did not launch the SpMV kernel")
    vtk = _write_vtk_check(dom, mesh)
    # the same step again from the same initial x, with the assembly
    # calls and the linear solves timed (a synchronise around each)
    x1 = dom.x.clone()
    thermal_2d.initial_state(dom, mesh)
    dom.t -= dom.dt
    parts = {"assembly": 0.0, "solve": 0.0}

    def timed(fn, key):
        def call(*args):
            sync()
            t = time.perf_counter()
            out = fn(*args)
            sync()
            parts[key] += time.perf_counter() - t
            return out
        return call
    dom._k_linear = timed(dom._k_linear, "assembly")
    dom._res_k = timed(dom._res_k, "assembly")
    dom.linear_solver = timed(dom.linear_solver, "solve")
    n_log = len(dom.solve_log)
    t3 = time.perf_counter()
    thermal_2d.step(dom)
    sync()
    repeat_s = time.perf_counter() - t3
    if not torch.equal(x1, dom.x):
        raise AssertionError("two runs of the Newton step differ")
    n_it = sum(it for it, _ in dom.solve_log[n_log:])
    print(f"[slice] repeat step: {repeat_s:.2f} s (assembly "
          f"{parts['assembly']:.3f} s, linear solves {parts['solve']:.3f} s "
          f"= {1e3 * parts['solve'] / max(n_it, 1):.3f} ms per BiCGStab "
          f"iteration over {n_it}), x bitwise equal")
    return {"launches": launches, "residual": res, "featool_err": err,
            "setup_s": t1 - t0, "step_s": t2 - t1, "repeat_s": repeat_s,
            "vtk": vtk}


def _write_vtk_check(dom, mesh) -> dict:
    """The persist phase's step (f): ``write_vtk`` of the stepped mesh
    into a temporary directory; its CELLS and POINT_DATA counts must be
    the mesh's elements and occupied control points."""
    from metafem_torch.io import write_vtk
    tmp = tempfile.mkdtemp(prefix="metafem_vtk_")
    try:
        path = os.path.join(tmp, "thermal.vtk")
        t = time.perf_counter()
        write_vtk(path, mesh, dom.workpieces[0].disc.element_type)
        vtk_s = time.perf_counter() - t
        counts = {}
        with open(path) as f:
            for line in f:
                word = line.split(" ", 1)[0]
                if word in ("CELLS", "POINT_DATA", "SCALARS"):
                    counts.setdefault(word, []).append(line.split()[1])
        mb = os.path.getsize(path) / 2 ** 20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_pts = int(np.asarray(mesh.is_occupied).sum()
                if mesh.is_occupied is not None else mesh.n_cp)
    cells, points = int(counts["CELLS"][0]), int(counts["POINT_DATA"][0])
    print(f"[persist] write_vtk of the stepped mesh: {vtk_s:.2f} s, "
          f"{mb:.1f} MB, CELLS {cells}, POINT_DATA {points}, scalars "
          f"{counts.get('SCALARS', [])}")
    if (cells, points) != (mesh.n_el, n_pts):
        raise AssertionError(f"VTK counts {cells}, {points} != mesh "
                             f"{mesh.n_el}, {n_pts}")
    return {"s": vtk_s, "cells": cells, "points": points}


def _check_gather_rows(rows, refusable) -> None:
    """Every row of the gather probe bitwise equal to ``torch.take``; a
    refusal only of the window and only at a shape ``refusable`` admits,
    with the card's reason printed."""
    for r in rows:
        size = (r["n_win"], r["n_idx"])
        if "error" in r:
            if not refusable(size) or r["variant"] != "window" or \
                    not r["error"]:
                raise AssertionError(f"unexpected gather refusal: {r}")
            print(f"[gather] window k={r['cluster']} at {size} "
                  f"({r['indices']}) refused by the card: {r['error']}")
        elif r["max_abs_err"] != 0.0:
            raise AssertionError(f"gather differs from torch.take: {r}")
    if not any(r["variant"] == "global" and "ms" in r for r in rows):
        raise AssertionError(f"no device-memory gather ran: {rows}")


def phase_gather(device) -> dict:
    """The gather probe's own entry point (``gather_probe.run``) with its
    launch count set to 0 before and read after: every size with the
    device-memory variant and the window at each cluster size tried, each
    bitwise equal to the plain version.  Only the main path's window may
    be refused, and only with the card's reason.  The kernel line's
    numbers are the window's at the TPU probe's first size (its fastest
    cluster), as in earlier versions; the main path's rows stand apart
    (``main_path``, to which the 3D phase adds the tangent's own read
    stream)."""
    from metafem_torch.benchmarks import gather_probe
    t0 = time.perf_counter()
    gather_probe.gather.launches = 0
    rows = gather_probe.run(device)
    launches = gather_probe.gather.launches
    if launches <= 0:
        raise AssertionError("the gather probe launched no kernel")
    main_size = gather_probe.MAIN_PATH_SIZE
    _check_gather_rows(rows, lambda size: size == main_size)
    for size in gather_probe.TPU_SIZES:
        got = {r["variant"] for r in rows
               if (r["n_win"], r["n_idx"]) == size and "ms" in r}
        if got != set(gather_probe.VARIANTS):
            raise AssertionError(f"gather probe rows missing at {size}: "
                                 f"{rows}")
    first = gather_probe.TPU_SIZES[0]
    top = next(r for r in rows if (r["n_win"], r["n_idx"]) == first
               and r.get("chosen"))
    main = [r for r in rows if (r["n_win"], r["n_idx"]) == main_size]
    chosen = {f"{r['n_win']}x{r['n_idx']}": r["cluster"]
              for r in rows if r.get("chosen")}
    floor = rows[0]["floor_ms"]
    print(f"[gather] {launches} launches, floor {floor * 1e3:.3f} us, "
          f"fastest window cluster per size {chosen}, window at {first} "
          f"{top['ms'] * 1e3:.3f} us, index_select "
          f"{top['library_ms'] * 1e3:.3f} us, "
          f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "rows": rows, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "library_ms": top["library_ms"],
            "bound_ms": top["bound_ms"], "floor_ms": floor,
            "max_abs_err": max(r["max_abs_err"] for r in rows if "ms" in r),
            "shape": first, "cluster": top["cluster"],
            "chosen_cluster": chosen, "main_path": main}


def _time_cold_ms(fn, device, reps: int = 20) -> float:
    """Device time of one call with the L2 cache flushed before it: a
    256 MiB buffer (five times the H100's 50 MB L2) is read before each
    call (read, not written, so that L2 holds no dirty lines for the call
    to write back), and CUDA events bracket the call alone; the
    median."""
    flush = torch.ones(64 * 2 ** 20, dtype=torch.float32, device=device)
    fn()
    events = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(device)
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def _spmv_numbers(A, x, device, plain_reps: int = 25) -> dict:
    """The packed kernel on A's one dense group at x, timed over replays
    of a CUDA graph of back-to-back launches (``ms``: the device alone;
    the README operator's eager launches are shorter than their host
    dispatch) and with L2 flushed before each launch (``cold_ms``), beside
    its plain version and CSR ``torch.mv`` (the library product, built
    on the card from the structural entries and checked against the
    kernel), with three bounds at the card's memory rate.  ``bound_ms``
    counts what the product needs: the values of the structural entries
    (``OffsetMatrix.structural_mask``), x read once and y written once,
    two operations per entry.  ``packed_bound_ms`` counts what the packed
    layout makes the kernel move: its values with their padding, the
    codes, the row tables, x and y (``PackPlan.bytes_per_product``).
    ``storage_bound_ms`` counts the whole block-offset storage, stored
    zeros included (what the dense kernel of earlier versions streamed).
    The one-time costs: the pack plan's build (host clock, once per
    layout, device and float width) and the pack (CUDA events, once per
    matrix)."""
    from metafem_torch.linsolve import offset_spmv
    dtype = A.vals.dtype
    (grp,) = A.layout.pallas_groups
    (plan,) = A.pack_plans()
    G, n_off, C, n_cp = len(grp.units), grp.n_off, grp.n_vars, grp.n_cp
    xw = x.view(C, n_cp)
    out = torch.empty_like(xw)
    slab = A.vals[grp.base:grp.base + G * n_off * n_cp]
    packed = A.packed(0)
    pack_ms = _time_ms(lambda: offset_spmv.pack(slab, plan), reps=5,
                       warmup=1)

    def kernel():
        offset_spmv.group_mv(packed, xw, plan, out=out)
    kernel_ms = _time_ms(kernel, graph=True)
    cold_ms = _time_cold_ms(kernel, device)
    offset_spmv.packed_columns(plan)
    plain_ms = _time_ms(lambda: offset_spmv.group_mv_packed_plain(
        packed, xw, plan, out), reps=plain_reps)
    plan.columns = None
    A_csr = A.to_csr()
    nnz = A_csr.values().numel()
    y = A.mv(x)
    lib_err = float((torch.mv(A_csr, x) - y).abs().max() / y.abs().max())
    if not lib_err <= (1e-12 if dtype == torch.float64 else 1e-5):
        raise AssertionError(f"CSR yardstick disagrees: {lib_err}")
    del y
    library_ms = _time_ms(lambda: torch.mv(A_csr, x))
    del A_csr
    rate = _peak_bytes(torch.cuda.get_device_name(device))
    peak = PEAK_FLOPS[str(dtype).split(".")[1]]

    def bound(n_vals):
        t_bytes = (n_vals + 2 * C * n_cp) * A.vals.element_size() / rate
        t_ops = 2 * n_vals / peak
        return 1e3 * max(t_bytes, t_ops), (
            "bytes" if t_bytes >= t_ops else "operations")
    bound_ms, bound_by = bound(nnz)
    storage_bound_ms, _ = bound(G * n_off * n_cp)
    moved = plan.bytes_per_product(A.vals.element_size())
    plan_bytes = sum(t.numel() * t.element_size() for t in (
        plan.rows, plan.meta, plan.codes, plan.list_len, plan.positions,
        plan.pad))
    return {"ms": kernel_ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "packed_bound_ms": 1e3 * moved / rate,
            "storage_bound_ms": storage_bound_ms, "pack_ms": pack_ms,
            "plan_build_s": plan.build_s,
            "padding_share": plan.padding_share, "n_packed": plan.n_packed,
            "bytes_per_product": moved, "plan_bytes": plan_bytes,
            "nnz": nnz, "stored": G * n_off * n_cp}


def _print_spmv(tag, label, A, t, rel=None, err=None) -> None:
    (grp,) = A.layout.pallas_groups
    parity = ("" if rel is None else f"parity max|y-y_plain|/max|y| "
              f"{rel:.3e} (abs {err:.3e}); ")
    print(f"[{tag}] offset_spmv {label} {A.vals.dtype} (G={len(grp.units)}, "
          f"n_off={grp.n_off}, C={grp.n_vars}, n_cp={grp.n_cp}): {parity}"
          f"packed kernel {t['ms']:.4f} ms (graph replay), {t['cold_ms']:.4f} "
          f"ms with L2 flushed; plain {t['plain_ms']:.4f} ms; CSR torch.mv "
          f"{t['library_ms']:.4f} ms; structural bound {t['bound_ms']:.4f} "
          f"ms from {t['nnz']} entries ({100 * t['bound_ms'] / t['ms']:.0f}%"
          f" of it, {100 * t['bound_ms'] / t['cold_ms']:.0f}% cold); "
          f"packed-bytes bound {t['packed_bound_ms']:.4f} ms "
          f"({t['bytes_per_product']} B per product, "
          f"{100 * t['packed_bound_ms'] / t['ms']:.0f}%); whole-storage "
          f"bound {t['storage_bound_ms']:.4f} ms from {t['stored']} stored; "
          f"{t['n_packed']} packed slots, padding "
          f"{100 * t['padding_share']:.2f}%; plan {t['plan_bytes'] / 1e6:.1f} "
          f"MB built in {t['plan_build_s']:.3f} s; pack {t['pack_ms']:.3f} ms")


def _spmv_at_size(A, rng, device, label, tag="flagship") -> dict:
    """The SpMV kernel on the operator A (its own float type): parity
    against the plain versions, then ``_spmv_numbers``."""
    dtype = A.vals.dtype
    x = torch.as_tensor(rng.standard_normal(A.n), dtype=dtype,
                        device=device)
    rel, err = _parity(A, x, dtype)
    t = _spmv_numbers(A, x, device, plain_reps=10)
    _print_spmv(tag, label, A, t, rel, err)
    return {"rel": rel, "max_abs_err": err, **t}


def _kernel_profile(fn, device) -> tuple:
    """(CUDA kernel launches, {kernel name: device ms}) of one call of
    ``fn`` under torch.profiler; (None, {}) when the profiler records
    no device activity on this machine."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    times, count = {}, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name
        if name.startswith("Memcpy") or name.startswith("Memset"):
            continue
        count += 1
        times[name] = times.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return (count or None), times


def _top_kernels(kernels: dict, k: int = 6) -> str:
    """The ``k`` kernels of a ``_kernel_profile`` that took the most
    device time, as "name ms" (names cut to their function)."""
    def short(name):
        name = name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0]
        return name.split("<")[0].split("::")[-1][:48]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:k]
    return ", ".join(f"{short(n)} {v:.2f} ms" for n, v in top)


class _Parts:
    """Host time of the step's parts, each call synchronised at both
    ends; a part called inside another counts toward the outer one."""

    def __init__(self, device):
        self.device, self.s, self.depth = device, {}, 0

    def wrap(self, fn, key_of):
        def call(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            torch.cuda.synchronize(self.device)
            t = time.perf_counter()
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize(self.device)
            finally:
                self.depth -= 1
            key = key_of(*args)
            self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t
            return out
        return call


def phase_flagship(device, nel=FLAGSHIP_NEL) -> dict:
    """The bench.py flagship through metafem_torch.bench's functions."""
    from metafem_torch import bench
    from metafem_torch.linsolve import krylov, multigrid, offset_spmv
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    t_all = time.perf_counter()
    offset_spmv.reset_launches()
    t0 = time.perf_counter()
    dom = bench.build_domain(nel, device=device)
    torch.cuda.synchronize(device)
    phases = bench.Phases(dom)
    phases.s["setup"] = time.perf_counter() - t0
    x0, (res_c, it_c), step, label = bench.prepare(dom, phases)
    dt, results, x_f64 = bench.measure(dom, step, x0)
    path_launches = dict(offset_spmv.group_mv.launches_by_dtype)
    n_dof = dom.pattern.basicfield_size
    for k, v in phases.s.items():
        print(f"[flagship] one-time {k}: {v:.3f} s")
    cold = _save_flagship_freezes(dom, x0, phases.s, dt, results, x_f64)
    print(f"[flagship] nel={nel} dof={n_dof} {dom.dtype} domain: converge "
          f"once residual {res_c:.3e} in {it_c} refines; tuned interval "
          f"{dom._mg_cheb and list(map(float, dom._mg_cheb[0]))} rate "
          f"{dom._mg_cheb and float(dom._mg_cheb[1])}; spectrum "
          f"{dom._mg_spectrum}; inner solver {label}, trip count "
          f"{step.inner_maxiter}; hierarchy {dom._mg_hier.shapes}")
    final = results[-1][1]
    print(f"[flagship] step median {dt * 1e3:.2f} ms over "
          f"{len(results)} trials {[round(r[0] * 1e3, 2) for r in results]}"
          f" ms, {n_dof / dt:.4e} DOF/s, refines "
          f"{[r[2] for r in results]}, final_residual {final:.3e}")
    if not final < 1e-6:
        raise AssertionError(f"flagship step did not converge: {final}")
    if sum(path_launches.values()) <= 0:
        raise AssertionError("the flagship path launched no SpMV kernel")

    # SpMV launches of one step, split by type; bitwise repeat
    state = dom._runtime_state()
    x1 = bench.perturbed(x0, 2)
    offset_spmv.reset_launches()
    xa, _, res_a, it_a = step(state, x1, 0.0, 1.0)
    per_step = {str(k).split(".")[1]: v for k, v in
                offset_spmv.group_mv.launches_by_dtype.items()}
    xb, _, res_b, _ = step(state, x1, 0.0, 1.0)
    torch.cuda.synchronize(device)
    if not torch.equal(xa, xb):
        raise AssertionError("two runs of the flagship step differ")
    print(f"[flagship] offset_spmv launches per step: {per_step} "
          f"({it_a} refines); two steps from one x bitwise equal "
          f"(residual {res_a:.3e})")

    # launches per V-cycle and where the step's device time goes
    op = multigrid.MGOperator(dom._mg_frozen[0]["A"], dom._mg_frozen,
                              dom._mg_hier)
    r = torch.ones(n_dof, dtype=dom.dtype, device=device)
    vc_launches, vc_kernels = _kernel_profile(lambda: op.apply_m(r), device)
    vc_ms = _time_ms(lambda: op.apply_m(r), reps=10)
    mv_ms = _time_ms(lambda: op.mv(r), reps=10)
    st_launches, st_kernels = _kernel_profile(
        lambda: step(state, x1, 0.0, 1.0), device)
    print(f"[flagship] V-cycle: {vc_launches if vc_launches else 'not measured'}"
          f" kernel launches, {vc_ms:.3f} ms (CUDA events); A.M apply "
          f"{mv_ms:.3f} ms; step: "
          f"{st_launches if st_launches else 'not measured'} kernel launches")
    if st_kernels:
        top = sorted(st_kernels.items(), key=lambda kv: -kv[1])[:8]
        total = sum(st_kernels.values())
        print(f"[flagship] step device time by kernel (profiler, "
              f"{total:.2f} ms in all): " + "; ".join(
                  f"{n[:60]} {ms:.2f}" for n, ms in top))

    parts = _Parts(device)
    mv = OffsetMatrix.mv
    vc = multigrid.vcycle
    rp = dom._run_phase
    try:
        OffsetMatrix.mv = parts.wrap(
            mv, lambda A, x: f"spmv_{str(x.dtype).split('.')[1]}")
        multigrid.vcycle = parts.wrap(vc, lambda *a: "vcycle")
        dom._run_phase = parts.wrap(rp, lambda st, ph: f"assembly_{ph}")
        step_t = dom.make_refined_step(sv_func=getattr(krylov, label),
                                       **bench.STEP_KW)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        step_t(state, x1, 0.0, 1.0)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    finally:
        OffsetMatrix.mv = mv
        multigrid.vcycle = vc
        dom._run_phase = rp
    rest = wall - sum(parts.s.values())
    print(f"[flagship] step parts (host clock, synchronised around each "
          f"part; {wall * 1e3:.2f} ms in all): " + ", ".join(
              f"{k} {v * 1e3:.2f} ms" for k, v in sorted(parts.s.items()))
          + f", rest (combine, axpys, norms, casts) {rest * 1e3:.2f} ms")

    rng = np.random.default_rng(20261017)
    spmv32 = _spmv_at_size(dom._mg_frozen[0]["A"], rng, device, "fine f32")
    spmv64 = _spmv_at_size(
        OffsetMatrix.from_values(dom._refined["A"][0],
                                 dom.pattern.offset_layout),
        rng, device, "A_td f64")
    if not spmv64["rel"] <= 1e-14:
        raise AssertionError(f"f64 kernel disagrees: {spmv64['rel']}")
    if not spmv32["rel"] <= 1e-6:
        raise AssertionError(f"f32 kernel disagrees: {spmv32['rel']}")
    df32 = _flagship_df32(dom, state, x0, x_f64, label, step, device)
    df_spmv = _df_spmv(dom._refined, dom.pattern.offset_layout, rng, device,
                       "A_td", "flagship")
    print(f"[flagship] phase {time.perf_counter() - t_all:.1f} s")
    return {"launches": sum(path_launches.values()),
            "path_launches": {str(k).split(".")[1]: v
                              for k, v in path_launches.items()},
            "per_step": per_step, "vcycle_launches": vc_launches,
            "step_ms": dt * 1e3, "final_residual": final,
            "spmv32": spmv32, "spmv64": spmv64, "df32": df32,
            "df_spmv": df_spmv, "cold": cold,
            # the domain, the inner solver and the start of the timed
            # step, for the multi-device phase's leg A
            "multidevice": (dom, label, x1)}


def _flagship_df32(dom, state, x0, x_f64, label, step64, device) -> dict:
    """The flagship's refined step in the two-float residual mode: the
    reference bench's own step (``bench.STEP_KW``, the tuned inner
    solver), x carried as a DF pair, 3 timed steps from ``df_from_f64``
    of the f64 step's perturbed starts, with the launch counts set to 0
    before them and read after.  Beside each, the f64 step ``step64``
    from the same start, in turns (f64 first, df32 first, f64 first),
    since host speed drifts within a call.  Each step below 1e-6; the
    last step's x within 2e-5 * max|x| of the f64 step's from the same
    start, and its float64-mode residual (the port's f64 path, no
    refine) below 1e-6; two steps from one x equal bit for bit."""
    from metafem_torch import bench
    from metafem_torch.linsolve import krylov, multigrid, offset_spmv
    from metafem_torch.linsolve import twofloat as tf
    t0 = time.perf_counter()
    step = dom.make_refined_step(sv_func=getattr(krylov, label),
                                 residual_mode="df32", **bench.STEP_KW)
    counts = offset_spmv.group_mv.launches_by_dtype

    def timed(fn, x):
        """(ms, launches of the two-float, f32 and f64 kernels, result)"""
        before = (offset_spmv.group_mv_df.launches,
                  counts[torch.float32], counts[torch.float64])
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = fn(state, x, 0.0, 1.0)
        torch.cuda.synchronize(device)
        ms = 1e3 * (time.perf_counter() - t)
        after = (offset_spmv.group_mv_df.launches,
                 counts[torch.float32], counts[torch.float64])
        return ms, [a - b for a, b in zip(after, before)], out

    offset_spmv.reset_launches()
    # warm: the DF split of A_td and b, their pack
    _, path, _ = timed(step, tf.df_from_f64(bench.perturbed(x0, -1)))
    warm_s = time.perf_counter() - t0
    trials, f64_ms = [], []
    for trial in range(3):
        x64_start = bench.perturbed(x0, trial)
        x1 = tf.df_from_f64(x64_start)
        if trial != 1:
            f64_ms.append(timed(step64, x64_start)[0])
        ms, n, (xd, _, res, it) = timed(step, x1)
        path = [a + b for a, b in zip(path, n)]
        trials.append({"ms": ms, "residual": res, "refines": it,
                       "df_launches": n[0], "f32_launches": n[1]})
        if trial == 1:
            f64_ms.append(timed(step64, x64_start)[0])
    launches, launches32, launches64 = path
    if launches <= 0 or launches32 <= 0:
        raise AssertionError(f"the df32 flagship path launched the "
                             f"two-float kernel {launches} and the f32 "
                             f"kernel {launches32} times")
    if launches64:
        raise AssertionError("the df32 step launched the float64 kernel")
    if not all(t["residual"] < 1e-6 for t in trials):
        raise AssertionError(f"df32 flagship steps: {trials}")
    n_prof, kernels = _kernel_profile(lambda: step(state, x1, 0.0, 1.0),
                                      device)
    busy = sum(kernels.values())
    xb, _, _, _ = step(state, x1, 0.0, 1.0)
    if not (torch.equal(xd.hi, xb.hi) and torch.equal(xd.lo, xb.lo)):
        raise AssertionError("two runs of the df32 flagship step differ")
    # where the step's time goes, as for the f64 step
    parts = _Parts(device)
    mv, vc, rp = tf.df_offset_mv, multigrid.vcycle, dom._run_phase
    try:
        tf.df_offset_mv = parts.wrap(mv, lambda *a: "df_offset_mv")
        multigrid.vcycle = parts.wrap(vc, lambda *a: "vcycle")
        dom._run_phase = parts.wrap(rp, lambda st, ph: f"assembly_{ph}")
        step_t = dom.make_refined_step(sv_func=getattr(krylov, label),
                                       residual_mode="df32",
                                       **bench.STEP_KW)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        step_t(state, x1, 0.0, 1.0)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    finally:
        tf.df_offset_mv, multigrid.vcycle, dom._run_phase = mv, vc, rp
    rest = wall - sum(parts.s.values())
    print(f"[flagship] df32 step parts (host clock, synchronised around "
          f"each part; {wall * 1e3:.2f} ms in all): " + ", ".join(
              f"{k} {v * 1e3:.2f} ms" for k, v in sorted(parts.s.items()))
          + f", rest (df ops, combine, fine SpMV, axpys, norms) "
          f"{rest * 1e3:.2f} ms")
    x64 = tf.df_to_f64(xd)
    rel = float((x64 - x_f64).abs().max() / x_f64.abs().max())
    check = dom.make_refined_step(sv_func=krylov.bicgstab, max_refine=0)
    _, _, res64, _ = check(state, x64, 0.0, 1.0)
    ms = float(np.median([t["ms"] for t in trials]))
    ms64 = float(np.median(f64_ms))
    df_k = sum(v for k, v in kernels.items() if "packed_df" in k)
    finals = [float(f"{t['residual']:.3e}") for t in trials]
    print(f"[flagship] df32 step (residual_mode='df32', x as a DF pair): "
          f"median {ms:.2f} ms over {[round(t['ms'], 2) for t in trials]} "
          f"ms, beside the f64 step from the same starts in turns "
          f"{ms64:.2f} ms over {[round(v, 2) for v in f64_ms]} ms "
          f"({ms / ms64:.2f}x), device busy {busy:.2f} ms (torch.profiler; "
          f"the two-float SpMV {df_k:.3f} ms; {n_prof or 'not measured'} "
          f"kernel launches); refines {[t['refines'] for t in trials]}, final "
          f"residuals {finals}; "
          f"two-float SpMV launches per step "
          f"{[t['df_launches'] for t in trials]}, f32 SpMV launches per "
          f"step {[t['f32_launches'] for t in trials]}; path launches "
          f"{launches} two-float, {launches32} f32; warm step (DF split, "
          f"pack) {warm_s:.2f} s; x within {rel:.3e} * max|x| of the f64 "
          f"step's from the same start; its f64-mode residual "
          f"{res64:.3e}; two steps from one x bitwise equal")
    if not rel <= 2e-5:
        raise AssertionError(f"df32 flagship x off the f64 step's: {rel}")
    if not res64 < 1e-6:
        raise AssertionError(f"df32 flagship root's f64 residual: {res64}")
    return {"step_ms": ms, "f64_step_ms": ms64, "f64_trials_ms": f64_ms,
            "busy_ms": busy, "trials": trials,
            "launches": launches, "launches_f32": launches32,
            "rel_to_f64": rel, "f64_residual": res64, "warm_s": warm_s,
            "parts_ms": {k: 1e3 * v for k, v in parts.s.items()}}


def _save_flagship_freezes(dom, x0, one_time_s, dt, results, x) -> dict:
    """The persist phase's step (a.1): ``bench.save_cache`` of the cold
    flagship domain (its freezes and converged x) into a new temporary
    directory, after the timed step; returns what the warm start is
    held to."""
    from metafem_torch import bench
    tmp = tempfile.mkdtemp(prefix="metafem_persist_")
    path = os.path.join(tmp, "flagship_freezes.pkl")
    torch.cuda.synchronize()
    t = time.perf_counter()
    bench.save_cache(dom, path, x0)
    save_s = time.perf_counter() - t
    mb = os.path.getsize(path) / 2 ** 20
    cold_s = sum(v for k, v in one_time_s.items() if k != "setup")
    print(f"[persist] save_freezes of the cold flagship after its timed "
          f"step: {mb:.1f} MB pickle (+ {os.path.getsize(path + '.x') / 2 ** 20:.1f}"
          f" MB converged x) in {save_s:.2f} s; the freezes it replaces "
          f"took {cold_s:.2f} s cold ({', '.join(f'{k} {v:.2f}' for k, v in one_time_s.items() if k != 'setup')})")
    return {"dir": tmp, "path": path, "save_s": save_s, "mb": mb,
            "cold_s": cold_s, "x0": x0, "x": x, "step_ms": dt * 1e3,
            "residual": results[-1][1],
            "refines": [r[2] for r in results]}


def _memory_line(dom, device, tag: str) -> dict:
    """``memory_report``'s TOTAL beside ``torch.cuda.memory_allocated``:
    the gap is what the report does not see (frozen operators, pack
    plans, multigrid levels, gather maps) and whatever else the process
    holds on the card."""
    from metafem_torch.utils import memory_report
    rep = memory_report(dom, unit="MB")
    alloc = (torch.cuda.memory_allocated(device) / 2 ** 20
             if device.type == "cuda" else 0.0)
    total = rep["TOTAL (MB)"]
    print(f"[{tag}] memory_report TOTAL {total:.1f} MB ("
          + ", ".join(f"{k} {v:.1f}" for k, v in rep.items()
                      if not k.startswith("TOTAL"))
          + f") beside torch.cuda.memory_allocated {alloc:.1f} MB: "
          f"{alloc - total:.1f} MB the report does not see")
    return {"report_mb": total, "allocated_mb": alloc}


def phase_persist(device, cold: dict, nel=FLAGSHIP_NEL,
                  host_nel=NEL) -> dict:
    """Freeze persistence and profiling on the flagship (the thermo-
    elastic checkpoint resume runs in ``_te_path``, the VTK file in
    ``phase_slice``, the 3D bar's memory report in ``phase_3d``):

    a. a fresh flagship domain (``bench.build_domain``) loads the cold
       domain's freezes and converged x through ``bench.prepare`` with
       its freeze cache, and runs the timed step from the same starts:
       x and the final residual bitwise equal to the cold domain's,
       the SpMV kernel launched;
    b. ``free_volume_tables`` on it: the bytes freed, the step again
       bitwise equal, ``update_one_step`` refused;
    c. ``memory_report`` before and after, beside the allocator;
    g. ``trace_profile`` around one step: its Chrome trace holds the
       SpMV kernel's events;
    d. ``freeze_linear_tangent(on_host=True)`` on the flagship physics
       at ``host_nel`` against the device freeze."""
    from metafem_torch import bench
    from metafem_torch.linsolve import offset_spmv
    from metafem_torch.utils import trace_profile
    t_all = time.perf_counter()
    try:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dom = bench.build_domain(nel, device=device)
        torch.cuda.synchronize(device)
        phases = bench.Phases(dom)
        phases.s["setup"] = time.perf_counter() - t0
        offset_spmv.reset_launches()
        x0, converged, step, label = bench.prepare(dom, phases,
                                                   cold["path"])
        if converged is not None or "load_freezes" not in phases.s:
            raise AssertionError(f"the warm start computed its freezes: "
                                 f"{phases.s}")
        if not torch.equal(x0, cold["x0"]):
            raise AssertionError("the loaded converged x differs")
        dt, results, x = bench.measure(dom, step, x0)
        launches = offset_spmv.group_mv.launches
        res = results[-1][1]
        print(f"[persist] warm start nel={nel}: setup "
              f"{phases.s['setup']:.2f} s, load_freezes "
              f"{phases.s['load_freezes']:.2f} s against the cold freezes' "
              f"{cold['cold_s']:.2f} s; inner solver {label}; step median "
              f"{dt * 1e3:.2f} ms (cold {cold['step_ms']:.2f} ms), refines "
              f"{[r[2] for r in results]} (cold {cold['refines']}), final "
              f"residual {res:.6e} (cold {cold['residual']:.6e}); "
              f"offset_spmv launches {launches}")
        if launches <= 0:
            raise AssertionError("the warm-started step launched no SpMV "
                                 "kernel")
        if not (torch.equal(x, cold["x"]) and res == cold["residual"]):
            raise AssertionError("the warm-started step differs from the "
                                 "cold one")
        print("[persist] warm-started step: x and final residual bitwise "
              "equal to the cold domain's")

        mem_full = _memory_line(dom, device, "persist")
        gc.collect()
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        dom.free_volume_tables()
        gc.collect()
        after = torch.cuda.memory_allocated(device)
        state = dom._runtime_state()
        x1 = bench.perturbed(x0, 2)        # the last timed trial's start
        offset_spmv.reset_launches()
        xb, _, res_b, _ = step(state, x1, 0.0, 1.0)
        torch.cuda.synchronize(device)
        launches_b = offset_spmv.group_mv.launches
        print(f"[persist] free_volume_tables: "
              f"torch.cuda.memory_allocated {before / 2 ** 20:.1f} -> "
              f"{after / 2 ** 20:.1f} MB, {(before - after) / 2 ** 20:.1f} "
              f"MB freed; the step again: residual {res_b:.6e}, "
              f"offset_spmv launches {launches_b}")
        if not (torch.equal(xb, x) and res_b == res and launches_b > 0):
            raise AssertionError("the step after free_volume_tables "
                                 "differs")
        try:
            dom.update_one_step()
        except RuntimeError as e:
            if "free_volume_tables" not in str(e):
                raise
        else:
            raise AssertionError("update_one_step ran on freed tables")
        print("[persist] the step after free_volume_tables bitwise equal; "
              "update_one_step refused")
        mem_freed = _memory_line(dom, device, "persist")

        logdir = os.path.join(cold["dir"], "trace")
        with trace_profile(logdir) as prof:
            step(state, x1, 0.0, 1.0)
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [ev for ev in events if ev.get("cat") == "kernel"]
        spmv = [ev for ev in kernels if "offset_spmv" in ev.get("name", "")]
        spmv_ms = sum(ev.get("dur", 0) for ev in spmv) / 1e3
        busy_ms = sum(ev.get("dur", 0) for ev in kernels) / 1e3
        print(f"[persist] trace_profile of one step: "
              f"{os.path.getsize(prof.trace_path) / 2 ** 20:.1f} MB Chrome "
              f"trace, {len(events)} events, {len(kernels)} kernel events "
              f"({busy_ms:.2f} ms), {len(spmv)} offset_spmv kernel events "
              f"({spmv_ms:.3f} ms)")
        if device.type == "cuda" and not spmv:
            cats = sorted({str(ev.get("cat")) for ev in events})
            raise AssertionError(f"the trace holds no offset_spmv kernel "
                                 f"event (categories {cats})")
        del dom, state, step, prof, events
        gc.collect()
        torch.cuda.empty_cache()

        host = {str(dt).split(".")[1]: _host_freeze(bench, host_nel, dt,
                                                     device)
                for dt in (torch.float64, torch.float32)}
    finally:
        shutil.rmtree(cold["dir"], ignore_errors=True)
    print(f"[persist] phase {time.perf_counter() - t_all:.1f} s")
    return {"load_s": phases.s["load_freezes"], "save_s": cold["save_s"],
            "mb": cold["mb"], "cold_s": cold["cold_s"],
            "warm_setup_s": phases.s["setup"], "step_ms": dt * 1e3,
            "freed_bytes": before - after, "memory_full": mem_full,
            "memory_freed": mem_freed, "trace_spmv_events": len(spmv),
            "host_freeze": host}


#: the float32 device freeze's own error on the flagship physics: its
#: geometry is float32 at an element size ~1/400 of the strip's length,
#: so each entry carries ~2^-24 x 400 x (a few) of rounding (9.0e-5 on
#: the CPU at nel=(400,200)); the float64 freezes differ by summation
#: order only
HOST_FREEZE_TOL = {torch.float64: 1e-12, torch.float32: 1e-3}


def _host_freeze(bench, nel, dtype, device) -> dict:
    """The persist phase's step (d): ``freeze_linear_tangent`` on the
    card, then ``on_host=True`` (float64 on the CPU, moved to the card
    in the domain's dtype), on the flagship physics at ``nel``."""
    dom = bench.build_domain(nel, device=device, dtype=dtype)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    dom.freeze_linear_tangent()
    torch.cuda.synchronize(device)
    dev_s = time.perf_counter() - t
    K_dev = dom._k_linear_td.double()
    t = time.perf_counter()
    dom.freeze_linear_tangent(on_host=True)
    torch.cuda.synchronize(device)
    host_s = time.perf_counter() - t
    K_host = dom._k_linear_td.double()
    rel = float((K_host - K_dev).abs().max() / K_dev.abs().max())
    print(f"[persist] freeze_linear_tangent nel={nel} "
          f"({dom.pattern.basicfield_size} DOF, {dtype} domain): on the "
          f"host (float64 on the CPU, {torch.get_num_threads()} threads) "
          f"{host_s:.2f} s against {dev_s:.3f} s on the card; components "
          f"within {rel:.3e} of the largest entry")
    if not rel <= HOST_FREEZE_TOL[dtype]:
        raise AssertionError(f"host and device freezes differ: {rel}")
    del dom, K_dev, K_host
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"host_s": host_s, "device_s": dev_s, "rel": rel}


def _solve_twice(dom, A, residue, device) -> tuple:
    """The domain's linear solver on (A, residue) twice from one state:
    the two solutions must be equal bit for bit.  Returns the first
    solve's passes (iterations, true residual) and its seconds; the
    passes stay out of ``dom.solve_log``."""
    n_log = len(dom.solve_log)
    xs = []
    for _ in range(2):
        t = time.perf_counter()
        xs.append(dom.linear_solver(A, residue))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t
    rep_log = dom.solve_log[n_log:]
    del dom.solve_log[n_log:]
    if not torch.equal(xs[0], xs[1]):
        raise AssertionError("two solves of one tangent differ")
    return ([(it, float(f"{r:.3e}")) for it, r in rep_log[:len(rep_log) // 2]],
            solve_s)


def _cycle_profile(As, residue, device, tag) -> dict:
    """Where a BiCGStab(4) cycle's time goes on the right-Jacobi scaled
    matrix ``As``: PROF_ITERS iterations (tol 0, so all of them run)
    under the profiler and timed alone on the host clock; {} off the
    card."""
    from metafem_torch.linsolve import krylov
    if device.type != "cuda":
        return {}

    def cycles():
        return krylov.bicgstabl(As, residue, tol=0.0, maxiter=PROF_ITERS,
                                s=4)
    n_launch, kernels = _kernel_profile(cycles, device)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    cycles()
    torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t) * 1e3
    n_cyc = PROF_ITERS // 4
    busy = sum(kernels.values())
    spmv = sum(v for k, v in kernels.items() if "offset_spmv" in k)
    print(f"[{tag}] BiCGStab(4) cycle ({n_cyc} cycles, torch.profiler "
          f"and host clock): {wall_ms / n_cyc:.3f} ms wall, device "
          f"busy {busy / n_cyc:.3f} ms (idle share "
          f"{1 - busy / wall_ms:.1%}), of it the SpMV kernel "
          f"{spmv / n_cyc:.3f} ms ({spmv / max(busy, 1e-12):.1%} of the "
          f"busy time); {(n_launch or 0) / n_cyc:.1f} kernel launches "
          f"per cycle")
    return {"wall_ms_per_cycle": wall_ms / n_cyc,
            "busy_ms_per_cycle": busy / n_cyc,
            "spmv_ms_per_cycle": spmv / n_cyc,
            "launches_per_cycle": (n_launch or 0) / n_cyc}


def phase_3d(device, e_number=E3D) -> dict:
    """The Neo-Hookean bar of ``metafem_torch.examples.hyperelastic_3d``
    at nel=(10e, e, e) in float64, the example's own configuration
    (order-2 serendipity, itg_order 5, right-Jacobi BiCGStab(4)): the
    SpMV kernel and a bitwise-repeated BiCGStab(4) solve on the first
    Newton tangent, then load step 1 (4e5) through ``update_one_step``
    and load step 2 (8e5) through ``update_one_step_jit``, each below
    the residual bar and within 2% of the analytic uniaxial curve."""
    from metafem_torch.examples import hyperelastic_3d as he
    from metafem_torch.linsolve import krylov, offset_spmv
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    from metafem_torch.linsolve.precond import pr_jacobi

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_all = time.perf_counter()
    gc.collect()                      # the earlier phases' domains
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    dom, wp, _ = he.build(e_number=e_number, device=device)
    sync()
    setup_s = time.perf_counter() - t0
    lo = dom.pattern.offset_layout
    (grp,) = lo.pallas_groups
    G, n_off, C, n_cp = len(grp.units), grp.n_off, grp.n_vars, grp.n_cp
    mesh = dom.workpieces[wp].mesh
    dof = C * int(mesh.is_occupied.sum())
    mu, lam = 1e6, 1e6
    he.set_material(dom, mu, lam)
    print(f"[3d] hyperelastic_3d e_number={e_number} nel="
          f"{(10 * e_number, e_number, e_number)} lattice "
          f"{mesh.lattice_shape}: n_cp {n_cp}, DOF {dof}, solve vector "
          f"{lo.n}, G={G}, n_off={n_off}, C={C}, COO tail {lo.n_coo}, "
          f"storage {lo.n_storage} values = {lo.n_storage * 8 / 1e9:.3f} GB "
          f"per float64 tangent; setup {setup_s:.2f} s")
    if lo.n_coo or (G, n_off, C) != (9, 117, 3):
        raise AssertionError(f"unexpected 3D layout: {lo.n_coo}, {G}, "
                             f"{n_off}, {C}")

    # the first Newton tangent of load step 1 (x at rest, 4e5 applied):
    # the kernel on it in f64 and f32, and one BiCGStab(4) solve twice
    sigma1, sigma2 = 4e5, 8e5
    dom.set_field(wp, "Pl", np.full(mesh.n_cp, sigma1))
    dom.refresh_fields()
    A, residue = dom.assemble_tangent()
    rng = np.random.default_rng(20261017)
    spmv64 = _spmv_at_size(A, rng, device, "tangent", tag="3d")
    A32 = OffsetMatrix.from_values(A.vals.float(), lo)
    spmv32 = _spmv_at_size(A32, rng, device, "tangent", tag="3d")
    gather = _gather_stream(A32, mesh, device) if device.type == "cuda" \
        else []
    del A32
    if not spmv64["rel"] <= 1e-14:
        raise AssertionError(f"f64 kernel disagrees: {spmv64['rel']}")
    if not spmv32["rel"] <= 1e-6:
        raise AssertionError(f"f32 kernel disagrees: {spmv32['rel']}")
    # the example's own solve (right-Jacobi BiCGStab(4) passes to the
    # example's tolerance) on this tangent, twice from one state
    rep_log, solve_s = _solve_twice(dom, A, residue, device)
    print(f"[3d] the example's solve of the first Newton tangent, twice: "
          f"passes (iterations, true residual) {rep_log}, x bitwise equal "
          f"({solve_s:.2f} s each)")
    As, _ = pr_jacobi(A)
    del A
    profile = _cycle_profile(As, residue, device, "3d")
    del As, residue

    # load step 1: update_one_step, assembly and solves timed apart
    parts = {"assembly": 0.0, "solve": 0.0}

    def timed(fn, key):
        def call(*args):
            sync()
            t = time.perf_counter()
            out = fn(*args)
            sync()
            parts[key] += time.perf_counter() - t
            return out
        return call
    k_lin, res_k, solver = dom._k_linear, dom._res_k, dom.linear_solver
    dom._k_linear = timed(k_lin, "assembly")
    dom._res_k = timed(res_k, "assembly")
    dom.linear_solver = timed(solver, "solve")
    n_log = len(dom.solve_log)
    offset_spmv.reset_launches()
    t = time.perf_counter()
    res1, d1 = he.load_step(
        dom, wp, sigma1, lambda: dom.update_one_step(max_iter=7,
                                                     verbose=True))
    sync()
    step1_s = time.perf_counter() - t
    launches1 = offset_spmv.group_mv.launches
    dom._k_linear, dom._res_k, dom.linear_solver = k_lin, res_k, solver
    log1 = dom.solve_log[n_log:]
    it1 = sum(it for it, _ in log1)
    ana1 = he.analytic_uniaxial_nh(sigma1, mu, lam)
    err1 = abs(d1 - ana1) / abs(ana1)
    its1 = [it for it, _ in log1]
    print(f"[3d] load step 1 (P={sigma1:g}, update_one_step): final "
          f"residual {res1:.3e}, d1/L {d1:.6f} vs analytic {ana1:.6f} "
          f"(rel err {err1:.2e}); solver passes (iterations, true "
          f"residual) {[(it, float(f'{r:.3e}')) for it, r in log1]}; "
          f"{step1_s:.2f} s (assembly {parts['assembly']:.2f} s, solves "
          f"{parts['solve']:.2f} s); offset_spmv launches {launches1} "
          f"= {launches1 / max(it1 / 4, 1):.2f} per BiCGStab(4) cycle")
    print(f"[3d] load step 1 iterations per solve {its1}; with the dense "
          f"kernel of earlier versions {list(DENSE_KERNEL_ITERS)} "
          f"({'the same' if tuple(its1) == DENSE_KERNEL_ITERS else 'differ'})")
    if not (res1 < 1e-5 and err1 < 0.02):
        raise AssertionError(f"load step 1: residual {res1}, error {err1}")
    if device.type == "cuda" and launches1 <= 0:
        raise AssertionError("load step 1 launched no SpMV kernel")

    # load step 2: update_one_step_jit, right-Jacobi BiCGStab(4)
    n_log = len(dom.solve_log)
    offset_spmv.reset_launches()
    t = time.perf_counter()
    res2, d2 = he.load_step(
        dom, wp, sigma2, lambda: dom.update_one_step_jit(
            max_iter=7, sv_func=krylov.bicgstabl, s=4, precond="jacobi"))
    sync()
    step2_s = time.perf_counter() - t
    launches2 = offset_spmv.group_mv.launches
    log2 = dom.solve_log[n_log:]
    ana2 = he.analytic_uniaxial_nh(sigma2, mu, lam)
    err2 = abs(d2 - ana2) / abs(ana2)
    print(f"[3d] load step 2 (P={sigma2:g}, update_one_step_jit): final "
          f"residual {res2:.3e}, d1/L {d2:.6f} vs analytic {ana2:.6f} "
          f"(rel err {err2:.2e}); solver passes {[(it, float(f'{r:.3e}')) for it, r in log2]}; "
          f"{step2_s:.2f} s; offset_spmv launches {launches2}")
    if not (res2 < 1e-5 and err2 < 0.02):
        raise AssertionError(f"load step 2: residual {res2}, error {err2}")
    if device.type == "cuda" and launches2 <= 0:
        raise AssertionError("load step 2 launched no SpMV kernel")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    memory = _memory_line(dom, device, "persist")
    phase_s = time.perf_counter() - t_all
    print(f"[3d] peak device memory {peak / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); phase {phase_s:.1f} s")
    return {"n_cp": n_cp, "dof": dof, "G": G, "n_off": n_off, "C": C,
            "launches": launches1 + launches2, "launches1": launches1,
            "launches2": launches2, "step1_s": step1_s,
            "step2_s": step2_s, "iters1": its1, "peak_bytes": peak,
            "spmv64": spmv64, "spmv32": spmv32, "profile": profile,
            "gather": gather, "memory": memory}


def _gather_stream(A, mesh, device) -> list:
    """The gather probe on the tangent's own x reads (``spmv_stream`` of
    its f32 pack plan: the occupied DOF, in the packed kernel's order),
    both variants, each bitwise equal to ``torch.take``; a window the
    card refuses only with its reason."""
    from metafem_torch.benchmarks import gather_probe
    (plan,) = A.pack_plans()
    occupied = torch.as_tensor(np.asarray(mesh.is_occupied, bool),
                               device=device)
    n_win, idx = gather_probe.spmv_stream(plan, occupied)
    x, _ = gather_probe.probe_inputs(n_win, 0, device)
    floor = gather_probe.launch_floor_ms(device)
    rows = gather_probe.probe_rows(x, idx, floor, indices="tangent")
    _check_gather_rows(rows, lambda size: True)
    del x, idx
    torch.cuda.empty_cache()
    return rows


def _te_path(device, e_number) -> dict:
    """``thermal_elasticity_3d`` at nel=(10e/4, e, e) in float64 with the
    example's solver (right-Jacobi BiCGStab(4), maxiter 2000, 20 passes,
    converge_tol 1e-6): the SpMV's parity and time on the first step's
    tangent in f64 and f32, the example's solve of that tangent twice
    (bitwise equal), then three steps of dt=1 through ``run_steps``
    (``update_one_step(max_iter=3)``), each below 1e-6, with the SpMV's
    launch count set to 0 before them and read after."""
    from metafem_torch.examples import thermal_elasticity_3d as te
    from metafem_torch.io import save_checkpoint
    from metafem_torch.linsolve import offset_spmv
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    from metafem_torch.linsolve.precond import pr_jacobi

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    dom, wp = te.build(e_number=e_number, device=device)
    sync()
    setup_s = time.perf_counter() - t0
    lo = dom.pattern.offset_layout
    if lo.n_coo or len(lo.pallas_groups) != 1:
        raise AssertionError(f"thermo-elastic layout is not one dense "
                             f"group: {lo.n_coo} COO, {lo.pallas_groups}")
    (grp,) = lo.pallas_groups
    G, n_off, C, n_cp = len(grp.units), grp.n_off, grp.n_vars, grp.n_cp
    mesh = dom.workpieces[wp].mesh
    dof = C * int(mesh.is_occupied.sum())
    if (n_off, C) != (117, 4):
        raise AssertionError(f"unexpected thermo-elastic group: G={G}, "
                             f"n_off={n_off}, C={C}")
    te.heat_front(dom, wp)
    A, residue = dom.assemble_tangent()
    rng = np.random.default_rng(20261017)
    spmv64 = _spmv_at_size(A, rng, device, "thermo-elastic tangent",
                           tag="multifield")
    A32 = OffsetMatrix.from_values(A.vals.float(), lo)
    spmv32 = _spmv_at_size(A32, rng, device, "thermo-elastic tangent",
                           tag="multifield")
    del A32
    if not spmv64["rel"] <= 1e-14:
        raise AssertionError(f"f64 kernel disagrees: {spmv64['rel']}")
    if not spmv32["rel"] <= 1e-6:
        raise AssertionError(f"f32 kernel disagrees: {spmv32['rel']}")
    print(f"[multifield] thermal_elasticity_3d e_number={e_number} nel="
          f"{(10 * e_number // 4, e_number, e_number)} lattice "
          f"{mesh.lattice_shape}: occupied control points "
          f"{int(mesh.is_occupied.sum())}, DOF {dof}, n_cp {n_cp}, G={G}, "
          f"n_off={n_off}, C={C}, units {list(grp.units)}, structural "
          f"entries {spmv64['nnz']}, stored values {lo.n_storage} = "
          f"{lo.n_storage * 8 / 1e9:.3f} GB per float64 tangent; setup "
          f"{setup_s:.2f} s")
    rep_log, solve_s = _solve_twice(dom, A, residue, device)
    print(f"[multifield] the example's solve of the first tangent, twice: "
          f"passes (iterations, true residual) {rep_log}, x bitwise equal "
          f"({solve_s:.2f} s each)")
    As, _ = pr_jacobi(A)
    del A
    profile = _cycle_profile(As, residue, device, "multifield")
    del As, residue

    steps = []
    ckpt_dir = tempfile.mkdtemp(prefix="metafem_checkpoint_")
    ckpt = os.path.join(ckpt_dir, "te_step1.npz")
    for k in range(3):
        n_log = len(dom.solve_log)
        offset_spmv.reset_launches()
        t = time.perf_counter()
        (res,) = te.run_steps(dom, wp, 1)
        sync()
        wall = time.perf_counter() - t
        if k == 0:
            t = time.perf_counter()
            save_checkpoint(dom, ckpt)
            ckpt_s = time.perf_counter() - t
        launches = offset_spmv.group_mv.launches
        its = [it for it, _ in dom.solve_log[n_log:]]
        steps.append({"residual": res, "s": wall, "launches": launches,
                      "iters": its})
        print(f"[multifield] thermo-elastic step {k + 1} (dt=1, "
              f"update_one_step(max_iter=3)): final residual {res:.3e}, "
              f"{wall:.2f} s, BiCGStab(4) iterations per solve {its}, "
              f"offset_spmv launches {launches}")
        if not res < 1e-6:
            raise AssertionError(f"thermo-elastic step {k + 1} did not "
                                 f"converge: {res}")
        if device.type == "cuda" and launches <= 0:
            raise AssertionError("the thermo-elastic step launched no SpMV "
                                 "kernel")
    for name in ("T", "d1", "d2", "d3", "T_t", "d2_t"):
        if not np.isfinite(mesh.fields[name]).all():
            raise AssertionError(f"thermo-elastic field {name} not finite")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    print(f"[multifield] thermo-elastic T range [{mesh.fields['T'].min():.3f}"
          f", {mesh.fields['T'].max():.3f}], max|d2| "
          f"{np.abs(mesh.fields['d2']).max():.3e} after 3 steps; peak device "
          f"memory {peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)")
    x3 = dom.x.clone()
    del dom, mesh
    try:
        resume = _te_resume(device, e_number, ckpt, ckpt_s, x3)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"G": G, "n_off": n_off, "C": C, "n_cp": n_cp, "dof": dof,
            "e_number": e_number, "setup_s": setup_s, "steps": steps,
            "profile": profile, "resume": resume,
            "launches": sum(s["launches"] for s in steps),
            "peak_bytes": peak, "spmv64": spmv64, "spmv32": spmv32}


def _te_resume(device, e_number, ckpt, save_s, x3) -> dict:
    """The persist phase's step (e): a freshly built thermo-elastic
    domain loads the checkpoint written after step 1 and runs steps 2-3;
    its x must equal the uninterrupted run's ``x3`` bit for bit."""
    from metafem_torch.examples import thermal_elasticity_3d as te
    from metafem_torch.io import load_checkpoint
    from metafem_torch.linsolve import offset_spmv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    dom, wp = te.build(e_number=e_number, device=device)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    meta = load_checkpoint(dom, ckpt)
    load_s = time.perf_counter() - t
    offset_spmv.reset_launches()
    t = time.perf_counter()
    res = te.run_steps(dom, wp, 2)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    steps_s = time.perf_counter() - t
    launches = offset_spmv.group_mv.launches
    print(f"[persist] thermo-elastic checkpoint after step 1 "
          f"({os.path.getsize(ckpt) / 2 ** 20:.1f} MB .npz, saved in "
          f"{save_s:.2f} s): a fresh domain (built in {build_s:.2f} s) "
          f"loaded it in {load_s:.2f} s at t={meta['t']:g} and ran steps "
          f"2-3 in {steps_s:.2f} s, residuals "
          f"{[float(f'{r:.3e}') for r in res]}, offset_spmv launches "
          f"{launches}")
    if device.type == "cuda" and launches <= 0:
        raise AssertionError("the resumed steps launched no SpMV kernel")
    if not torch.equal(dom.x, x3):
        raise AssertionError("the resumed thermo-elastic run differs from "
                             "the uninterrupted one")
    print("[persist] resumed steps 2-3: x bitwise equal to the "
          "uninterrupted run's")
    return {"save_s": save_s, "load_s": load_s, "steps_s": steps_s,
            "launches": launches, "residuals": res}


def _te_steady(device, e_number) -> dict:
    """``run_to_steady`` of the thermo-elastic bar with the bars of the
    reference's test: fewer than 120 steps, tip d2 above 0.01, curvature
    within 25% of alpha dT / h."""
    from metafem_torch.examples import thermal_elasticity_3d as te
    from metafem_torch.linsolve import offset_spmv
    t = time.perf_counter()
    dom, wp = te.build(e_number=e_number, device=device)
    n_dense = len(dom.pattern.offset_layout.pallas_groups)
    offset_spmv.reset_launches()
    steps = te.run_to_steady(dom, wp)
    launches = offset_spmv.group_mv.launches
    d2_tip, kappa, kappa_th = te.bending(dom, wp)
    rel = abs(kappa - kappa_th) / abs(kappa_th)
    wall = time.perf_counter() - t
    print(f"[multifield] thermo-elastic steady state at e_number="
          f"{e_number}: {steps} steps, tip d2 {d2_tip:.4f}, curvature "
          f"{kappa:.4e} against alpha dT / h {kappa_th:.4e} ({rel:.1%} off); "
          f"offset_spmv launches {launches} ({n_dense} dense groups; "
          f"the rest is the COO tail); {wall:.1f} s")
    if not (steps < 120 and d2_tip > 0.01 and rel < 0.25):
        raise AssertionError(f"thermo-elastic steady state: {steps} steps, "
                             f"d2_tip {d2_tip}, curvature off by {rel}")
    return {"steps": steps, "d2_tip": d2_tip, "curvature_rel_err": rel,
            "s": wall}


def _cavity_path(device, e_number) -> dict:
    """``cavity_2d`` at e_number x e_number (the reference's own
    resolution at 40): Re 100 and Re 1000 through ``run_re`` with
    right-Jacobi BiCGStab(4), each continuation step below 1e-5, the
    centreline minimum of u/U within 0.02 of Ghia et al.'s; then the SpMV
    on the converged Re 1000 tangent (C=3) in f64 and f32."""
    from metafem_torch.examples import cavity_2d as cv
    from metafem_torch.linsolve import offset_spmv
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    from metafem_torch.linsolve.precond import pr_jacobi
    t0 = time.perf_counter()
    dom, _, wp, params = cv.build(e_number=e_number, device=device)
    setup_s = time.perf_counter() - t0
    lo = dom.pattern.offset_layout
    if lo.n_coo or len(lo.pallas_groups) != 1:
        raise AssertionError(f"cavity layout is not one dense group: "
                             f"{lo.n_coo} COO, {lo.pallas_groups}")
    (grp,) = lo.pallas_groups
    mesh = dom.workpieces[wp].mesh
    dof = grp.n_vars * int(mesh.is_occupied.sum())
    out = {"G": len(grp.units), "n_off": grp.n_off, "C": grp.n_vars,
           "n_cp": grp.n_cp, "dof": dof, "setup_s": setup_s, "re": {}}
    print(f"[multifield] cavity_2d e_number={e_number}: lattice "
          f"{mesh.lattice_shape}, occupied control points "
          f"{int(mesh.is_occupied.sum())}, DOF {dof}, G={out['G']}, "
          f"n_off={grp.n_off}, C={grp.n_vars}; setup {setup_s:.2f} s")
    if grp.n_vars != 3:
        raise AssertionError(f"cavity group is not C=3: {grp}")
    for Re in (100, 1000):
        n_log = len(dom.solve_log)
        res = []
        offset_spmv.reset_launches()
        t = time.perf_counter()
        u_st = cv.run_re(dom, wp, Re, params, solver="bicgstabl",
                         residuals=res)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        launches = offset_spmv.group_mv.launches
        ys, us = cv.centerline_u(dom, wp, u_st, params)
        i_min = int(np.argmin(us))
        g_min, g_y = cv.GHIA_MIN[Re]
        its = [it for it, _ in dom.solve_log[n_log:]]
        print(f"[multifield] cavity Re {Re}: {len(res)} continuation steps, "
              f"final residuals {[float(f'{r:.3e}') for r in res]}, "
              f"centreline min u/U {us[i_min]:.5f} at y {ys[i_min]:.4f} "
              f"(Ghia et al. {g_min} at {g_y}; off by "
              f"{abs(us[i_min] - g_min):.5f}); BiCGStab(4) iterations "
              f"{sum(its)} over {len(its)} passes; offset_spmv launches "
              f"{launches}; {wall:.2f} s")
        if not all(r < 1e-5 for r in res):
            raise AssertionError(f"cavity Re {Re}: residuals {res}")
        if not abs(us[i_min] - g_min) < 0.02:
            raise AssertionError(f"cavity Re {Re}: centreline minimum "
                                 f"{us[i_min]} against {g_min}")
        if not np.isfinite(mesh.fields["p"]).all():
            raise AssertionError(f"cavity Re {Re}: pressure not finite")
        if device.type == "cuda" and launches <= 0:
            raise AssertionError(f"cavity Re {Re} launched no SpMV kernel")
        out["re"][Re] = {"u_min": float(us[i_min]), "y_min": float(ys[i_min]),
                         "residuals": res, "s": wall, "launches": launches,
                         "iters": sum(its)}
        if Re == 100:
            fields100 = {k: np.array(v) for k, v in mesh.fields.items()}
    A, residue = dom.assemble_tangent()
    out["profile"] = _cycle_profile(pr_jacobi(A)[0], residue, device,
                                    "multifield")
    rng = np.random.default_rng(20261017)
    spmv64 = _spmv_at_size(A, rng, device, "cavity Re 1000 tangent",
                           tag="multifield")
    spmv32 = _spmv_at_size(OffsetMatrix.from_values(A.vals.float(), lo),
                           rng, device, "cavity Re 1000 tangent",
                           tag="multifield")
    if not spmv64["rel"] <= 1e-14:
        raise AssertionError(f"f64 kernel disagrees: {spmv64['rel']}")
    if not spmv32["rel"] <= 1e-6:
        raise AssertionError(f"f32 kernel disagrees: {spmv32['rel']}")
    out.update(spmv64=spmv64, spmv32=spmv32,
               launches=sum(r["launches"] for r in out["re"].values()))
    out["df32"] = _cavity_df32(dom, wp, fields100, e_number, device, rng)
    return out


def _cavity_df32(dom, wp, fields, e_number, device, rng) -> dict:
    """tests/test_refined.py's df32 cavity at the example's own mesh: a
    float32 twin seeded with the float64 domain's Re 100 fields (the
    taus included), frozen, then one df32 refined step with the
    reference test's settings (right-Jacobi BiCGStab(4), maxiter 1500,
    max_refine 20, max_pass 3) and launch counts set to 0 before it and
    read after: residual below 1e-9, and the float64 domain's own
    residual of the df32 root (at the same fields) below 5e-9.  Then
    the two-float SpMV on the twin's A_td."""
    from metafem_torch.examples import cavity_2d as cv
    from metafem_torch.linsolve import krylov, offset_spmv
    t0 = time.perf_counter()
    dom32, _, wp32, _ = cv.build(e_number=e_number, device=device,
                                 dtype=torch.float32)
    for name, col in fields.items():
        dom32.set_field(wp32, name, col)
    dom32.refresh_fields()
    dom32.assemble_x()
    dom32.converge_tol = 1e-9
    dom32.freeze_linear_tangent()
    dom32.freeze_refined_residual()
    if dom32._refined["wp_df"] is None:
        raise AssertionError("the cavity's convection is not nonaffine")
    step = dom32.make_refined_step(sv_func=krylov.bicgstabl, s=4,
                                   maxiter=1500, max_refine=20, max_pass=3,
                                   precond="jacobi", residual_mode="df32")
    setup_s = time.perf_counter() - t0
    offset_spmv.reset_launches()
    t = time.perf_counter()
    x1, _, res, it = step(dom32._runtime_state(),
                          dom32.x.to(torch.float64), 0.0, 1.0)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t
    launches = offset_spmv.group_mv_df.launches
    launches32 = offset_spmv.group_mv.launches_by_dtype[torch.float32]
    for name, col in fields.items():
        dom.set_field(wp, name, col)
    dom.refresh_fields()
    dom.time_discretization.update_time(1.0, dom.pattern.max_time_level)
    st = dom._runtime_state()
    st["x_star"] = x1
    st["K_linear"] = dom._k_linear(st)
    r_cross, _ = dom._res_k(st)
    res_cross = float(torch.linalg.norm(r_cross)) / np.sqrt(
        dom.pattern.basicfield_size)
    print(f"[multifield] cavity df32 refined step at e_number={e_number} "
          f"(float32 twin with the Re 100 fields): residual {res:.3e} in "
          f"{it} refines, {wall:.2f} s (setup and freezes {setup_s:.2f} "
          f"s); float64 domain's residual of the df32 root "
          f"{res_cross:.3e}; two-float SpMV launches {launches}, f32 "
          f"{launches32}")
    if not res < 1e-9:
        raise AssertionError(f"cavity df32 step: residual {res}")
    if not res_cross < 5e-9:
        raise AssertionError(f"cavity df32 root's f64 residual {res_cross}")
    if launches <= 0 or launches32 <= 0:
        raise AssertionError("the cavity df32 step launched no two-float "
                             "or f32 SpMV kernel")
    df_spmv = _df_spmv(dom32._refined, dom32.pattern.offset_layout, rng,
                       device, "cavity A_td", "multifield")
    return {"residual": res, "refines": it, "s": wall,
            "f64_residual": res_cross, "launches": launches,
            "launches_f32": launches32, "df_spmv": df_spmv}


def _j2_path(device, e_number) -> dict:
    """``j2_plasticity``'s mixed-hardening sequence (``SEQUENCES[1]``)
    against the analytic elongations at atol 1.5e-3: the return map, the
    history and ``evaluate_at_itg`` on the card, the LU solves on the
    host, as in the reference; and the time of one ``commit_history``."""
    from metafem_torch.examples import j2_plasticity as j2
    t = time.perf_counter()
    dom, wp, p = j2.build(e_number=e_number, device=device)
    grp = j2.SEQUENCES[1]
    d1s = j2.run_load_sequence(dom, wp, p, grp["s"], Y_initial=100,
                               Eb=grp["Eb"], Ep=grp["Ep"])
    wall = time.perf_counter() - t
    err = float(np.abs(d1s - grp["d1"]).max())
    on_device = all(v.device == device for v in dom.user_state.values()
                    if torch.is_tensor(v))
    commit_ms = []
    for _ in range(5):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        j2.commit_history(dom, wp, p)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        commit_ms.append(1e3 * (time.perf_counter() - t))
    print(f"[multifield] j2_plasticity e_number={e_number}, mixed hardening "
          f"(Eb={grp['Eb']:g}, Ep={grp['Ep']:g}), {len(d1s)} load levels: "
          f"max |d1 - analytic| {err:.3e} (bar 1.5e-3); history on "
          f"{device if on_device else 'the host'}; commit_history "
          f"{np.median(commit_ms):.3f} ms (median of 5, synchronised); "
          f"{wall:.2f} s")
    if not err < 1.5e-3:
        raise AssertionError(f"J2 mixed sequence off by {err}")
    if not on_device:
        raise AssertionError("the J2 history left the device")
    return {"max_err": err, "commit_ms": float(np.median(commit_ms)),
            "s": wall}


# ---------------------------------------------------------------------------
# the unstructured path: BSR tail, auxiliary-space multigrid, pikachu step
# ---------------------------------------------------------------------------

def _tail_csr(A):
    """CSR of A's BSR-tail structural entries on vals' device: the
    library product that the tail kernels are timed against."""
    import warnings
    lo = A.layout
    keep = A.structural_mask()
    keep[:lo.n_dense] = False
    rows, cols, pos = A._triplets(keep)
    del keep
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols]), A.vals[pos], (lo.n, lo.n),
            check_invariants=False).coalesce().to_sparse_csr()


def _bsr_library(A, x, y_ref, scale, tol, device) -> tuple:
    """``torch.sparse_bsr_tensor``'s product over A's tail blocks: its
    time (None where PyTorch does not run it) and what happened."""
    import warnings
    lo = A.layout
    b, nb, n = lo.blk_b, lo.n_coo, lo.n
    try:
        crow = torch.searchsorted(A.coo_rows, torch.arange(
            lo.n_block_rows + 1, device=device))
        blocks = A.vals[lo.n_dense:].view(b, b, nb).permute(
            2, 0, 1).contiguous()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            Ab = torch.sparse_bsr_tensor(
                crow, A.coo_cols, blocks, size=(lo.n_block_rows * b,) * 2)
        xp = torch.zeros(lo.n_block_rows * b, dtype=x.dtype, device=device)
        xp[:n] = x
        b_err = float((torch.mv(Ab, xp)[:n] - y_ref).abs().max()) / scale
        if not b_err <= tol:
            raise AssertionError(f"torch.sparse_bsr_tensor product of the "
                                 f"tail disagrees: {b_err}")
        return _time_ms(lambda: torch.mv(Ab, xp)), "ran"
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"did not run: {str(e).splitlines()[0][:160]}"


def _tail_storage_bound_ms(A, rate, peak) -> float:
    """What the BSR storage made the kernel of earlier versions move: the
    64 nb stored values (93% of them zeros on the brick), the nb column
    ids and the run tables once, each distinct x block once, and the
    touched y rows read and written once."""
    lo = A.layout
    b, nb = lo.blk_b, lo.n_coo
    isz = A.vals.element_size()
    n_runs = A._tables()["run_row"].numel()
    x_blocks = int(torch.unique(A.coo_cols).numel())
    return 1e3 * max(
        (b * b * nb * isz + nb * 8 + (2 * n_runs + 1) * 8
         + 2 * n_runs * b * isz + x_blocks * b * isz) / rate,
        2 * b * b * nb / peak)


def _far_share(plan) -> float:
    """Share of the tail plan's entries whose column lies 2^15 or more
    from their row: those a 16-bit column delta could not reach."""
    from metafem_torch.linsolve import bsr_tail
    q = bsr_tail.slot_rows(plan.ptr, plan.vec)
    far = (plan.cols.long() - plan.rows.long()[q]).abs() >= 2 ** 15
    far[plan.pad] = False
    return int(far.sum()) / plan.n_entries


def _bsr_numbers(A, rng, device, label, tag="unstructured") -> dict:
    """The packed BSR-tail kernel on A's tail (its own float type) against
    its plain version on the same plan and against the BSR storage's
    product (``bsr_tail_mv_plain``), both on the card (max error relative
    to max|y|, a bitwise repeat), timed over replays of a CUDA graph of
    back-to-back launches (``ms``) and with L2 flushed (``cold_ms``),
    beside the plain version, CSR ``torch.mv`` over the tail's structural
    entries (``library_ms``) and, where PyTorch runs it,
    ``torch.sparse_bsr_tensor``'s product over the tail's blocks.
    ``bound_ms`` counts what the product needs, as ``_spmv_numbers``
    does: the values of the tail's structural entries, x read once and y
    written once, two operations per entry.  ``packed_bound_ms`` counts
    what the tail plan makes the kernel move
    (``TailPlan.bytes_per_product``: the packed values with their
    padding and their column ids, the row ids, x once, the touched rows
    of y read and written).  ``storage_bound_ms``: the whole BSR storage
    (``_tail_storage_bound_ms``).  The one-time costs: the plan's build
    (host clock, once per layout, device and float width) and the pack
    (CUDA events, once per matrix)."""
    from metafem_torch.linsolve import bsr_tail, offset_spmv
    lo = A.layout
    dtype = A.vals.dtype
    b, nb, n = lo.blk_b, lo.n_coo, lo.n
    t = A._tables()
    tail = A.vals[lo.n_dense:]
    plan = A.tail_plan()
    packed = A.packed_tail()
    pack_ms = _time_ms(lambda: offset_spmv.pack(tail, plan), reps=5,
                       warmup=1)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=device)

    def fresh():
        return torch.zeros(n, dtype=dtype, device=device)
    y1 = bsr_tail.tail_mv(packed, x, fresh(), plan)
    y2 = bsr_tail.tail_mv(packed, x, fresh(), plan)
    _sync(device)
    bitwise = bool(torch.equal(y1, y2))
    yp = bsr_tail.tail_mv_packed_plain(packed, x, fresh(), plan)
    ys = bsr_tail.bsr_tail_mv_plain(tail, x, fresh(), A.coo_cols,
                                    t["run_start"], t["run_row"], b)
    scale = float(ys.abs().max())
    err = float((y1 - yp).abs().max())
    rel = err / scale
    rel_storage = float((y1 - ys).abs().max()) / scale
    del yp, y2
    y = fresh()

    def kernel():
        bsr_tail.tail_mv(packed, x, y, plan)
    ms = _time_ms(kernel, graph=True)
    cold_ms = _time_cold_ms(kernel, device)
    plain_ms = _time_ms(lambda: bsr_tail.tail_mv_packed_plain(
        packed, x, y, plan), reps=5, warmup=1)
    csr = _tail_csr(A)
    nnz = csr.values().numel()
    lib_err = float((torch.mv(csr, x) - ys).abs().max()) / scale
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    if not lib_err <= tol:
        raise AssertionError(f"CSR yardstick of the tail disagrees: "
                             f"{lib_err}")
    library_ms = _time_ms(lambda: torch.mv(csr, x))
    del csr
    bsr_ms, bsr_note = _bsr_library(A, x, ys, scale, tol, device)
    rate = _peak_bytes(torch.cuda.get_device_name(device))
    peak = PEAK_FLOPS[str(dtype).split(".")[1]]
    isz = A.vals.element_size()
    t_bytes = (nnz + 2 * n) * isz / rate
    t_ops = 2 * nnz / peak
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    moved = plan.bytes_per_product(isz)
    packed_bound_ms = 1e3 * max(moved / rate, 2 * plan.n_packed / peak)
    storage_bound_ms = _tail_storage_bound_ms(A, rate, peak)
    plan_bytes = sum(v.numel() * v.element_size() for v in (
        plan.rows, plan.cols, plan.ptr, plan.positions, plan.pad))
    out = {"ms": ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bsr_library_ms": bsr_ms,
           "bsr_library": bsr_note, "bound_ms": bound_ms,
           "bound_by": bound_by, "packed_bound_ms": packed_bound_ms,
           "storage_bound_ms": storage_bound_ms, "max_abs_err": err,
           "rel": rel, "rel_storage": rel_storage, "bitwise": bitwise,
           "nb": nb, "nnz": nnz, "fill": nnz / (b * b * nb),
           "n_packed": plan.n_packed, "padding_share": plan.padding_share,
           "n_touched": plan.n_touched, "bytes_per_product": moved,
           "plan_bytes": plan_bytes, "plan_build_s": plan.build_s,
           "pack_ms": pack_ms, "tail_bytes": b * b * nb * isz,
           "far_share": _far_share(plan)}
    print(f"[{tag}] bsr_tail_packed {label} {dtype} (nb={nb}, {nnz} "
          f"structural entries = {100 * out['fill']:.2f}% of the 64 nb "
          f"stored, {plan.n_touched} rows, {plan.n_packed} packed slots, "
          f"padding {100 * plan.padding_share:.2f}%): max|y-y_plain|/max|y|"
          f" {rel:.3e} (abs {err:.3e}), against the BSR storage's product "
          f"{rel_storage:.3e}, repeat "
          f"{'bitwise equal' if bitwise else 'DIFFERS'}; kernel {ms:.4f} ms "
          f"(graph replay), {cold_ms:.4f} ms with L2 flushed; plain "
          f"{plain_ms:.4f} ms; CSR torch.mv {library_ms:.4f} ms; "
          f"torch.sparse_bsr_tensor mv "
          f"{'%.4f ms' % bsr_ms if bsr_ms is not None else bsr_note}; "
          f"structural bound {bound_ms:.4f} ms ({bound_by}; "
          f"{100 * bound_ms / ms:.1f}% of it, {100 * bound_ms / cold_ms:.1f}%"
          f" cold; CSR torch.mv {100 * bound_ms / library_ms:.1f}%); "
          f"packed bound {packed_bound_ms:.4f} ms ({moved} B per product, "
          f"{100 * packed_bound_ms / ms:.1f}%); whole-storage bound "
          f"{storage_bound_ms:.4f} ms; plan {plan_bytes / 1e6:.1f} MB built "
          f"in {plan.build_s:.3f} s; pack {pack_ms:.3f} ms; "
          f"{100 * out['far_share']:.2f}% of the entries 2^15 or more "
          f"from their row")
    tol_k = 1e-12 if dtype == torch.float64 else 1e-6
    if not (rel <= tol_k and rel_storage <= tol_k and bitwise):
        raise AssertionError(f"bsr_tail_packed {label} {dtype}: rel {rel}, "
                             f"against the storage {rel_storage}, bitwise "
                             f"{bitwise}")
    return out


def _df_tail_numbers(ref: dict, layout, rng, device) -> dict:
    """The two-float tail kernel on the df32 step's frozen A_td pair
    (``ref`` after a df32 step: A_hi/A_lo and their packed pairs, the
    tail's last) at a random x pair: bitwise equal to its plain version
    on the card and to a repeat, and within 1e-12 of max|y| of the
    float64 tail kernel on (hi + lo); then timed (graph replay, and with
    L2 flushed) beside its plain version, the float64 tail kernel and
    CSR ``torch.mv`` in float64 over the tail's structural entries (no
    PyTorch call computes a two-float product), against the structural
    bound (8 bytes per entry, x's and y's pairs once, or
    DF_OPS_PER_ENTRY float32 operations per entry) and the packed bound
    (``TailPlan.bytes_per_product(8)``); and the kernel's registers and
    resident warps per SM."""
    from metafem_torch.linsolve import bsr_tail, offset_spmv
    from metafem_torch.linsolve import twofloat as tf
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    n = layout.n
    plan = OffsetMatrix.from_values(ref["A_hi"][0], layout).tail_plan(
        offset_spmv.DF_VEC)
    packed = ref["A_packed"][0][-1]
    x = tf.df_from_f64(torch.as_tensor(
        rng.standard_normal(n) * (1.0 + rng.random(n)), device=device))

    def fresh():
        return (torch.zeros(n, dtype=torch.float32, device=device),
                torch.zeros(n, dtype=torch.float32, device=device))
    y = bsr_tail.tail_mv_df(packed, x.hi, x.lo, *fresh(), plan)
    y2 = bsr_tail.tail_mv_df(packed, x.hi, x.lo, *fresh(), plan)
    yp = bsr_tail.tail_mv_df_plain(packed, x.hi, x.lo, *fresh(), plan)
    _sync(device)
    repeat = all(torch.equal(a, b) for a, b in zip(y, y2))
    vs_plain = all(torch.equal(a, b) for a, b in zip(y, yp))
    max_abs = max(float((a - b).abs().max()) for a, b in zip(y, yp))
    A64 = OffsetMatrix.from_values(tf.df_to_f64(
        tf.DF(ref["A_hi"][0], ref["A_lo"][0])), layout)
    plan64, packed64 = A64.tail_plan(), A64.packed_tail()
    x64 = tf.df_to_f64(x)
    y64 = bsr_tail.tail_mv(packed64, x64, torch.zeros_like(x64), plan64)
    scale = float(y64.abs().max())
    rel_f64 = float((tf.df_to_f64(tf.DF(*y)) - y64).abs().max()) / scale
    del y2, yp
    out = fresh()

    def kernel():
        bsr_tail.tail_mv_df(packed, x.hi, x.lo, *out, plan)
    ms = _time_ms(kernel, graph=True)
    cold_ms = _time_cold_ms(kernel, device)
    plain_ms = _time_ms(lambda: bsr_tail.tail_mv_df_plain(
        packed, x.hi, x.lo, *out, plan), reps=3, warmup=1)
    y64o = torch.zeros_like(x64)
    f64_ms = _time_ms(lambda: bsr_tail.tail_mv(packed64, x64, y64o, plan64),
                      graph=True)
    csr = _tail_csr(A64)
    nnz = csr.values().numel()
    csr_ms = _time_ms(lambda: torch.mv(csr, x64))
    del csr, A64, packed64
    rate = _peak_bytes(torch.cuda.get_device_name(device))
    t_bytes = (8 * nnz + 2 * 8 * n) / rate
    t_ops = DF_OPS_PER_ENTRY * nnz / PEAK_FLOPS["float32"]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    moved = plan.bytes_per_product(8)
    packed_bound_ms = 1e3 * max(moved / rate, DF_OPS_PER_ENTRY
                                * plan.n_packed / PEAK_FLOPS["float32"])
    res = {"ms": ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
           "f64_kernel_ms": f64_ms, "csr_f64_ms": csr_ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "packed_bound_ms": packed_bound_ms, "bytes_per_product": moved,
           "nnz": nnz, "n_packed": plan.n_packed,
           "padding_share": plan.padding_share, "max_abs_err": max_abs,
           "bitwise_vs_plain": vs_plain, "bitwise_repeat": repeat,
           "rel_to_f64_kernel": rel_f64, **bsr_tail.df_occupancy(plan)}
    print(f"[unstructured] bsr_tail_packed_df A_td ({nnz} structural "
          f"entries, {plan.n_packed} packed slots over the float64 plan): "
          f"against its plain version "
          f"{'bitwise equal' if vs_plain else 'DIFFERS (max abs %.3e)' % max_abs}"
          f", repeat {'bitwise equal' if repeat else 'DIFFERS'}, against "
          f"the float64 tail kernel on (hi + lo) {rel_f64:.3e} of max|y|; "
          f"kernel {ms:.4f} ms (graph replay), {cold_ms:.4f} ms with L2 "
          f"flushed; plain {plain_ms:.4f} ms; float64 tail kernel "
          f"{f64_ms:.4f} ms; CSR torch.mv float64 {csr_ms:.4f} ms; "
          f"structural bound {bound_ms:.4f} ms ({res['bound_by']}; "
          f"{100 * bound_ms / ms:.1f}% of it); packed bound "
          f"{packed_bound_ms:.4f} ms ({moved} B per product, "
          f"{100 * packed_bound_ms / ms:.1f}%); one row per thread, "
          f"{res['registers']} registers, {res['spill_bytes']} B spilled, "
          f"{res['warps_per_sm']} warps/SM")
    if not (vs_plain and repeat and rel_f64 <= 1e-12):
        raise AssertionError(f"two-float tail kernel: plain {vs_plain}, "
                             f"repeat {repeat}, f64 {rel_f64}")
    return res


def _whole_mv_numbers(A, rng, device, label, tag="unstructured",
                      graph=True) -> dict:
    """The whole unstructured product ``A.mv`` (the packed kernel on the
    dense group, then the packed tail kernel adding into y) against CSR
    ``torch.mv`` over all of A's structural entries: both timed (graph
    replay for A.mv), the two within 1e-12 (f64) or 1e-5 (f32) of max|y|,
    beside the structural bound (entries, x and y once).  ``graph=False``
    times A.mv over back-to-back eager calls (a scalar COO tail's segment
    sum is not captured in a graph)."""
    dtype = A.vals.dtype
    x = torch.as_tensor(rng.standard_normal(A.n), dtype=dtype,
                        device=device)
    y = A.mv(x)
    csr = A.to_csr()
    nnz = csr.values().numel()
    rel = float((torch.mv(csr, x) - y).abs().max() / y.abs().max())
    if not rel <= (1e-12 if dtype == torch.float64 else 1e-5):
        raise AssertionError(f"A.mv and CSR disagree on the {label}: {rel}")
    ms = _time_ms(lambda: A.mv(x), graph=graph)
    library_ms = _time_ms(lambda: torch.mv(csr, x))
    del csr
    rate = _peak_bytes(torch.cuda.get_device_name(device))
    bound_ms = 1e3 * max((nnz + 2 * A.n) * A.vals.element_size() / rate,
                         2 * nnz / PEAK_FLOPS[str(dtype).split(".")[1]])
    tail = ("packed tail" if A.layout.blk_b else
            "scalar COO tail" if A.layout.n_coo else "no tail")
    print(f"[{tag}] whole A.mv {label} {dtype} (dense group + {tail}, "
          f"{nnz} structural entries): {ms:.4f} ms "
          f"({'graph replay' if graph else 'eager'}); "
          f"CSR torch.mv {library_ms:.4f} ms ({library_ms / ms:.2f}x the "
          f"kernels' time); structural bound {bound_ms:.4f} ms "
          f"({100 * bound_ms / ms:.1f}% of A.mv, "
          f"{100 * bound_ms / library_ms:.1f}% of CSR); max rel {rel:.3e}")
    return {"ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "nnz": nnz, "rel": rel}


def _sparse_smooth_check(A, dom, rng, device, label) -> dict:
    """The sparsified smoothing operator of setup_auxmg(smooth='sparse')
    (``auxmg.SparseSmoothOp``, built on A as the refined step builds it)
    held on the card to (1) the lumping invariant, S 1 = A 1, and (2) a
    plain product at random x: the dense formula (``group_mv_plain``) on
    the block-offset storage, plus the lumped row sums, plus the tail's
    diagonal blocks (``coo_rows == coo_cols``) through
    ``bsr_tail_mv_plain``.  Each error is relative to the scale of its
    sums' rounding, max_i sum_j |a_ij| |x_j| (x = 1, then the random
    x); the gates are 1e-6 (f32) and 1e-12 (f64)."""
    from metafem_torch.linsolve import auxmg, bsr_tail, offset_spmv
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    tree, (desc, hier) = dom._auxmg
    lo = A.layout
    dtype = A.vals.dtype
    S = auxmg.AuxMGOperator(A, auxmg.refresh_tangent(A, tree, desc), hier,
                            desc)._smoother()
    if not isinstance(S, auxmg.SparseSmoothOp):
        raise AssertionError(f"smooth='sparse' built {type(S).__name__}")
    ones = torch.ones(lo.n, dtype=dtype, device=device)
    x = torch.as_tensor(rng.standard_normal(lo.n), dtype=dtype,
                        device=device)
    A_abs = OffsetMatrix.from_values(A.vals.abs(), lo)
    scale, scale_x = (float(A_abs.mv(v).max()) for v in (ones, x.abs()))
    del A_abs
    lump_rel = float((S.mv(ones) - A.mv(ones)).abs().max()) / scale
    (grp,) = lo.pallas_groups
    slab = A.vals[grp.base:grp.base + len(grp.units) * grp.n_off
                  * grp.n_cp].view(len(grp.units), grp.n_off, grp.n_cp)
    y = offset_spmv.group_mv_plain(
        slab, x.view(grp.n_vars, grp.n_cp), grp,
        torch.empty(grp.n_vars, grp.n_cp, dtype=dtype,
                    device=device)).reshape(-1) + S.lump * x
    b, nb = lo.blk_b, lo.n_coo
    sel = torch.as_tensor(np.flatnonzero(lo.coo_rows == lo.coo_cols),
                          dtype=torch.int64, device=device)
    diag_tail = A.vals[lo.n_dense:].view(b, b, nb)[:, :, sel].reshape(-1)
    bsr_tail.bsr_tail_mv_plain(
        diag_tail.contiguous(), x, y, A.coo_cols[sel],
        torch.arange(sel.numel() + 1, device=device), A.coo_rows[sel], b)
    mv_rel = float((S.mv(x) - y).abs().max()) / scale_x
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    print(f"[unstructured] SparseSmoothOp on the {label} ({dtype}): "
          f"|S 1 - A 1| {lump_rel:.3e}, |S x - plain| {mv_rel:.3e} "
          f"(scales max |A| 1 {scale:.4e}, max |A| |x| {scale_x:.4e}; "
          f"{sel.numel()} diagonal blocks of {nb}); gate {tol:g}")
    if not (lump_rel <= tol and mv_rel <= tol):
        raise AssertionError(f"SparseSmoothOp {label} {dtype}: lumping "
                             f"{lump_rel}, product {mv_rel}")
    return {"lump_rel": lump_rel, "mv_rel": mv_rel, "scale": scale,
            "scale_x": scale_x, "n_diag_blocks": int(sel.numel())}


def _kernel_counts() -> tuple:
    """(packed SpMV launches by float type, BSR-tail launches by float
    type, two-float packed SpMV launches, two-float tail launches), as
    plain dicts."""
    from metafem_torch.linsolve import bsr_tail, offset_spmv
    return (dict(offset_spmv.group_mv.launches_by_dtype),
            dict(bsr_tail.tail_mv.launches_by_dtype),
            {"df32": offset_spmv.group_mv_df.launches},
            {"df32": bsr_tail.tail_mv_df.launches})


KERNEL_NAMES = ("packed", "bsr_tail", "packed_df", "bsr_tail_df")


def _count_diff(after, before) -> dict:
    return {name: {str(k).replace("torch.", ""): a[k] - b[k] for k in a}
            for name, a, b in zip(KERNEL_NAMES, after, before)}


def _converge(step, state, x, tol, device, max_calls=40) -> tuple:
    """benchmarks/pikachu_scale.py's converge: calls of the refined step
    (at most max_refine refines each) until the residual is below tol or
    falls by less than 15%; (seconds, residual, refines, x)."""
    _sync(device)
    t = time.perf_counter()
    r_prev, refines = np.inf, 0
    for _ in range(max_calls):
        x, _, res, it = step(state, x, 0.0, 1.0)
        refines += it
        if res < tol or res >= 0.85 * r_prev:
            break
        r_prev = res
    _sync(device)
    return time.perf_counter() - t, res, refines, x


def _tight_root(dom, x, device, **step_kw) -> tuple:
    """x converged further by the refined step (auxmg, pikachu's inner
    solve) to a residual of ROOT_TOL (float64 residuals reach it):
    (root, its residual, refines)."""
    from metafem_torch.linsolve import krylov
    tol = dom.converge_tol
    dom.converge_tol = ROOT_TOL
    try:
        step = dom.make_refined_step(sv_func=krylov.bicgstab,
                                     precond="auxmg",
                                     **{**PIKACHU_STEP, **step_kw})
    finally:
        dom.converge_tol = tol
    _, res, it, root = _converge(step, dom._runtime_state(), x, ROOT_TOL,
                                 device)
    if not res < ROOT_TOL:
        raise AssertionError(f"the unstructured root stalled at {res}")
    return root, res, it


def _unstructured_df32(dom, state, root, tol, device) -> dict:
    """The unstructured step in the reference's own residual mode
    (``benchmarks/pikachu_scale.py:109-116``: ``residual_mode="df32"``,
    x as ``df_from_f64``): the split of the refined residual's freeze into
    pairs and their pack, a converge from cold, 3 timed warm steps (each
    below ``tol``, each launching the f32 packed and tail kernels and the
    two-float packed and tail kernels, and no float64 kernel), the
    device-busy ms of one step and of it the two-float tail kernel's, two
    steps from one x bitwise equal, and the last x's T within 1e-5 *
    max|T| of the f64 step's root.  Launch counts are set to 0 before the
    path and read after."""
    from metafem_torch.linsolve import bsr_tail, krylov, offset_spmv
    from metafem_torch.linsolve import twofloat as tf
    from metafem_torch.solver.jit_step import _df_operator
    lo = dom.pattern.offset_layout
    step = dom.make_refined_step(sv_func=krylov.bicgstab, precond="auxmg",
                                 residual_mode="df32", **PIKACHU_STEP)
    offset_spmv.reset_launches()
    bsr_tail.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    _df_operator(dom._refined, lo)
    _sync(device)
    split_s = time.perf_counter() - t0
    cold_s, res_c, it_c, xd = _converge(
        step, state, tf.df_from_f64(dom.x.to(torch.float64)), tol, device)
    trials = []
    for k in range(3):
        x1 = tf.df_from_f64(tf.df_to_f64(xd) * (1.0 + 1e-4 * (k + 1)))
        before = _kernel_counts()
        s, res, it, xd = _converge(step, state, x1, tol, device)
        trials.append({"ms": 1e3 * s, "residual": res, "refines": it,
                       "launches": _count_diff(_kernel_counts(), before)})
    counts = _kernel_counts()
    path = _count_diff(counts, [{k: 0 for k in c} for c in counts])
    used = {"packed": "float32", "bsr_tail": "float32",
            "packed_df": "df32", "bsr_tail_df": "df32"}
    if not all(t["launches"][k][w] > 0 for t in trials
               for k, w in used.items()) or any(
                   path[k]["float64"] for k in ("packed", "bsr_tail")):
        raise AssertionError(f"the df32 unstructured path launched {path}, "
                             f"per step {[t['launches'] for t in trials]}")
    if not (res_c < tol and all(t["residual"] < tol for t in trials)):
        raise AssertionError(f"df32 unstructured steps: cold {res_c}, "
                             f"{trials}")
    n_prof, kernels = _kernel_profile(
        lambda: _converge(step, state, x1, tol, device), device)
    busy = sum(kernels.values())
    df_tail_busy = sum(v for k_, v in kernels.items()
                       if "bsr_tail_packed_df" in k_)
    tail_busy = sum(v for k_, v in kernels.items() if "bsr_tail" in k_)
    xa = _converge(step, state, x1, tol, device)[3]
    xb = _converge(step, state, x1, tol, device)[3]
    if not (torch.equal(xa.hi, xb.hi) and torch.equal(xa.lo, xb.lo)):
        raise AssertionError("two df32 unstructured steps from one x differ")
    rel = float((tf.df_to_f64(xd) - root).abs().max() / root.abs().max())
    ms = float(np.median([t["ms"] for t in trials]))
    finals = [float(f"{t['residual']:.3e}") for t in trials]
    print(f"[unstructured] df32 step (residual_mode='df32', x as a DF "
          f"pair): A_td and b split into pairs and packed {split_s:.2f} s; "
          f"converge from cold {cold_s:.2f} s, residual {res_c:.3e} in "
          f"{it_c} refines; 3 warm steps median {ms:.2f} ms over "
          f"{[round(t['ms'], 2) for t in trials]} ms, refines "
          f"{[t['refines'] for t in trials]}, final residuals "
          f"{finals}; "
          f"device busy {busy:.2f} ms per step (torch.profiler; the "
          f"two-float tail {df_tail_busy:.3f} ms, both tail kernels "
          f"{tail_busy:.3f} ms; {n_prof or 'not measured'} kernel "
          f"launches; the most: {_top_kernels(kernels)}); launches per step "
          f"{[t['launches'] for t in trials]}; "
          f"two steps from one x bitwise equal; T within {rel:.3e} * "
          f"max|T| of the f64 step's root")
    if not rel <= 1e-5:
        raise AssertionError(f"df32 unstructured T off the root: {rel}")
    return {"step_ms": ms, "busy_ms": busy, "df_tail_busy_ms": df_tail_busy,
            "tail_busy_ms": tail_busy, "trials": trials,
            "path_launches": path, "cold_s": cold_s, "split_s": split_s,
            "rel_to_root": rel}


def phase_unstructured(device, nel=UNSTRUCT_NEL, layout_opts=None) -> dict:
    """The unstructured production path (benchmarks/pikachu_scale.py) on
    pikachu's weak form over a jittered order-2 tet brick
    (metafem_torch/examples/pikachu_brick.py), float32 domain, float64
    residuals: the one-time phases, the packed BSR-tail kernel and the
    whole product A.mv on the f32 tangent and the f64 A_td, 3 timed
    refined steps (auxmg with smooth='full', BiCGStab, maxiter 12,
    forcing 0.3) with launches per step and device-busy time, a bitwise
    repeat; their df32 twin (``_unstructured_df32``) and the two-float
    tail and dense-group kernels on its A_td (``_df_tail_numbers``,
    ``_df_spmv``); one step with
    smooth='sparse' and inner_operator='sparse'; one update_one_step
    with make_iterative_solver(precond='auxmg'), its T within 1e-5 of
    the refined step's root."""
    from metafem_torch.examples import pikachu_brick
    from metafem_torch.linsolve import bsr_tail, krylov, offset_spmv
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    from metafem_torch.solver.jit_step import combine_klin
    t_all = time.perf_counter()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    once = {}

    def tick(key, t0):
        _sync(device)
        once[key] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    dom, mesh = pikachu_brick.build(nel, device=device,
                                    **(layout_opts or {}))
    t0 = tick("build", t0)
    lo = dom.pattern.offset_layout
    n = dom.pattern.basicfield_size
    n_struct_tail = int((lo.storage_of_slot >= lo.n_dense).sum())
    (grp,) = lo.pallas_groups
    print(f"[unstructured] pikachu_brick nel={tuple(nel)}: "
          f"{len(mesh.el_cp)} tets, {n} DOF, {dom.dtype} domain; layout "
          f"blk_b={lo.blk_b}, lattice_shape={mesh.lattice_shape}, n_dense="
          f"{lo.n_dense} ({grp.n_off} dense offsets), nb={lo.n_coo} tail "
          f"blocks in {lo.n_block_rows} block rows, tail fill "
          f"{n_struct_tail / max(64 * lo.n_coo, 1):.4f} (structural "
          f"entries / 64 nb), n_storage {lo.n_storage}")
    if lo.blk_b != 8 or mesh.lattice_shape is not None:
        raise AssertionError(f"unexpected unstructured layout: blk_b "
                             f"{lo.blk_b}, lattice {mesh.lattice_shape}")
    dom.freeze_linear_tangent()
    t0 = tick("freeze_linear_tangent", t0)
    dom.freeze_refined_residual()
    t0 = tick("freeze_refined_residual", t0)
    dom.setup_auxmg(smooth="full", verbose=True)
    aux_s = dom._auxmg_timings
    t0 = tick("setup_auxmg", t0)
    dom.free_volume_tables()
    tick("free_volume_tables", t0)
    print("[unstructured] one-time " + ", ".join(
        f"{k} {v:.2f} s" for k, v in once.items()) + " (setup_auxmg: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in aux_s.items()) + ")")

    # the BSR-tail kernel, then the packed dense-group kernel (the
    # matrix's tailless view), on the f32 tangent and on the f64 A_td
    state = dom._runtime_state()
    rng = np.random.default_rng(20261017)
    K_params = np.asarray(dom.time_discretization.K_params, np.float32)

    def tangent32():
        return OffsetMatrix.from_values(combine_klin(state, K_params), lo)
    A32 = tangent32()
    bsr32 = _bsr_numbers(A32, rng, device, "tangent")
    spmv32 = _spmv_at_size(A32.dense_part(), rng, device,
                           "tangent's dense part", tag="unstructured")
    whole = {"f32": _whole_mv_numbers(A32, rng, device, "tangent")}
    del A32
    A64 = OffsetMatrix.from_values(dom._refined["A"][0], lo)
    bsr64 = _bsr_numbers(A64, rng, device, "A_td")
    spmv64 = _spmv_at_size(A64.dense_part(), rng, device,
                           "A_td's dense part", tag="unstructured")
    whole["f64"] = _whole_mv_numbers(A64, rng, device, "A_td")
    del A64
    gc.collect()
    if not spmv64["rel"] <= 1e-14:
        raise AssertionError(f"f64 kernel disagrees: {spmv64['rel']}")
    if not spmv32["rel"] <= 1e-6:
        raise AssertionError(f"f32 kernel disagrees: {spmv32['rel']}")

    # the refined step as pikachu_scale.py runs it
    step = dom.make_refined_step(sv_func=krylov.bicgstab, precond="auxmg",
                                 **PIKACHU_STEP)
    x0 = dom.x
    tol = dom.converge_tol
    offset_spmv.reset_launches()
    bsr_tail.reset_launches()
    cold_s, res_c, it_c, x_new = _converge(step, state, x0, tol, device)
    trials = []
    for k in range(3):
        x1 = x_new * (1.0 + 1e-4 * (k + 1))
        before = _kernel_counts()
        s, res, it, x_new = _converge(step, state, x1, tol, device)
        trials.append({"ms": 1e3 * s, "residual": res, "refines": it,
                       "launches": _count_diff(_kernel_counts(), before)})
    counts = _kernel_counts()
    path = {"packed": sum(counts[0].values()),
            "bsr_tail": sum(counts[1].values())}
    path_by_type = _count_diff(counts, [{k: 0 for k in c} for c in counts])
    if path["packed"] <= 0 or path["bsr_tail"] <= 0 or not all(
            min(sum(t["launches"][k].values())
                for k in ("packed", "bsr_tail")) > 0 for t in trials):
        raise AssertionError(f"the unstructured path launched {path}, per "
                             f"step {[t['launches'] for t in trials]}")
    if not (res_c < tol and all(t["residual"] < tol for t in trials)):
        raise AssertionError(f"unstructured steps: cold {res_c}, {trials}")
    n_prof, kernels = _kernel_profile(
        lambda: _converge(step, state, x1, tol, device), device)
    busy = sum(kernels.values())
    bsr_busy = sum(v for k_, v in kernels.items() if "bsr_tail" in k_)
    xa = _converge(step, state, x1, tol, device)[3]
    xb = _converge(step, state, x1, tol, device)[3]
    if not torch.equal(xa, xb):
        raise AssertionError("two unstructured steps from one x differ")
    root, res_root, it_root = _tight_root(dom, x_new, device)
    ms = float(np.median([t["ms"] for t in trials]))
    finals = [float(f"{t['residual']:.3e}") for t in trials]
    print(f"[unstructured] refined step (bicgstab, precond='auxmg', "
          f"{PIKACHU_STEP}): converge from cold {cold_s:.2f} s, residual "
          f"{res_c:.3e} in {it_c} refines; 3 warm steps median {ms:.2f} ms "
          f"over {[round(t['ms'], 2) for t in trials]} ms, refines "
          f"{[t['refines'] for t in trials]}, final residuals "
          f"{finals}; "
          f"device busy {busy:.2f} ms per step (torch.profiler; the BSR "
          f"tail {bsr_busy:.2f} ms; {n_prof or 'not measured'} kernel "
          f"launches; the most: {_top_kernels(kernels)}); launches per "
          f"step {[t['launches'] for t in trials]}; "
          f"path launches {path}; two steps from one x bitwise equal; "
          f"the root, converged further: residual {res_root:.3e} after "
          f"{it_root} more refines")
    df32 = _unstructured_df32(dom, state, root, tol, device)
    df_tail = _df_tail_numbers(dom._refined, lo, rng, device)
    df_dense = _df_spmv(dom._refined, lo, rng, device,
                        "the df32 A_td's dense group", tag="unstructured")

    # smooth='sparse': the sparsified smoother with the exact inner
    # operator, then with the sparsified inner operator as well
    t0 = time.perf_counter()
    dom.setup_auxmg(smooth="sparse")
    sp_setup_s = time.perf_counter() - t0
    aux_sp = dom._auxmg_timings
    smooth_check = {
        "tangent": _sparse_smooth_check(tangent32(), dom, rng, device,
                                        "tangent"),
        "A_td": _sparse_smooth_check(OffsetMatrix.from_values(
            dom._refined["A"][0], lo), dom, rng, device, "A_td")}
    sparse = {}
    for inner in ("exact", "sparse"):
        step_sp = dom.make_refined_step(sv_func=krylov.bicgstab,
                                        precond="auxmg",
                                        inner_operator=inner, **PIKACHU_STEP)
        sp_s, res_sp, it_sp, x_sp = _converge(step_sp, dom._runtime_state(),
                                              x0, tol, device)
        sparse[inner] = {"residual": res_sp, "refines": it_sp, "s": sp_s,
                         "rel_to_full": float((x_sp - root).abs().max()
                                              / root.abs().max())}
        if inner == "exact" and res_sp < tol:
            # its own root, converged as far as the full smoother's
            x_t, res_t, _ = _tight_root(dom, x_sp, device)
            sparse[inner].update(
                root_residual=res_t, root_rel=float(
                    (x_t - root).abs().max() / root.abs().max()))
    print(f"[unstructured] smooth='sparse': setup {sp_setup_s:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in aux_sp.items())}); "
          f"spectrum {dom._auxmg_spectrum}; " + "; ".join(
              f"inner_operator='{k}': converge from cold {v['s']:.2f} s, "
              f"residual {v['residual']:.3e} in {v['refines']} refines, x "
              f"within {v['rel_to_full']:.3e} * max|x| of the full "
              f"smoother's root" + (
                  f" (its own root at {v['root_residual']:.3e} within "
                  f"{v['root_rel']:.3e})" if "root_rel" in v else "")
              for k, v in sparse.items()))

    # update_one_step through make_iterative_solver(precond='auxmg')
    dom.update_mesh()
    dom.linear_solver = dom.make_iterative_solver(precond="auxmg")
    n_log = len(dom.solve_log)
    t0 = time.perf_counter()
    res_u = dom.update_one_step(max_iter=4)
    _sync(device)
    uos_s = time.perf_counter() - t0
    x_u = dom.x.to(root.dtype)
    rel_u = float((x_u - root).abs().max() / root.abs().max())
    # its exact (float64) residual: the refined step with no refine
    check = dom.make_refined_step(sv_func=krylov.bicgstab, precond="auxmg",
                                  **{**PIKACHU_STEP, "max_refine": 0})
    res_u64 = check(dom._runtime_state(), x_u, 0.0, 1.0)[2]
    passes = [(it, float(f"{r:.3e}")) for it, r in dom.solve_log[n_log:]]
    print(f"[unstructured] update_one_step with make_iterative_solver("
          f"precond='auxmg', smooth='sparse' freeze): residual {res_u:.3e} "
          f"(assembled in {dom.dtype}), its float64 residual "
          f"{res_u64:.3e}; solver passes {passes}, {uos_s:.2f} s; T within "
          f"{rel_u:.3e} * max|T| of the refined step's root")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    phase_s = time.perf_counter() - t_all
    print(f"[unstructured] peak device memory {peak / 2 ** 30:.2f} GiB; "
          f"phase {phase_s:.1f} s")
    ex = sparse["exact"]
    if not (ex["residual"] < tol and ex["root_rel"] <= ROOT_REL):
        raise AssertionError(f"sparse smoother: {ex}")
    if not np.isfinite(sparse["sparse"]["residual"]):
        raise AssertionError(f"sparse inner operator: {sparse['sparse']}")
    if not (res_u < tol and rel_u <= 1e-5):
        raise AssertionError(f"update_one_step: residual {res_u}, T off "
                             f"{rel_u}")
    return {"dof": n, "nel": list(nel), "n_dense": lo.n_dense,
            "nb": lo.n_coo, "one_time_s": once, "setup_auxmg_s": aux_s,
            "bsr32": bsr32, "bsr64": bsr64, "spmv32": spmv32,
            "spmv64": spmv64, "whole_mv": whole, "df32": df32,
            "df_tail": df_tail, "df_dense": df_dense, "step_ms": ms,
            "busy_ms": busy, "bsr_busy_ms": bsr_busy, "trials": trials,
            "path_launches": path, "path_launches_by_type": path_by_type,
            "cold_s": cold_s, "sparse": sparse, "sparse_setup_s": aux_sp,
            "sparse_smooth_check": smooth_check,
            "update_one_step": {"residual": res_u, "residual_f64": res_u64,
                                "s": uos_s, "rel_to_refined": rel_u},
            "peak_bytes": peak, "s": phase_s}


# ---------------------------------------------------------------------------
# the mesh-reading examples: mesh writers and generators
# ---------------------------------------------------------------------------

#: Abaqus element names by (dimension, vertices per element)
INP_TYPES = {(2, 3): "CPS3", (2, 4): "CPS4", (3, 4): "C3D4",
             (3, 8): "C3D8"}


def write_inp(path, vert, conn) -> None:
    """An Abaqus .inp of (vertices, elements), as both packages'
    ``read_mesh`` read it: a *Node block with 1-based ids, one *Element
    block (its type from the dimension and the vertices per element)
    and an *Nset of every node, which the readers skip."""
    vert = np.asarray(vert, np.float64)
    conn = np.asarray(conn, np.int64)
    dim, nv = vert.shape[1], conn.shape[1]
    ids = np.arange(1, len(vert) + 1)
    with open(path, "w") as f:
        f.write("*Heading\n** metafem_torch mesh, written by "
                "chip_smoke.write_inp\n*Part, name=PART-1\n*Node\n")
        f.write("\n".join(f"{i}, " + ", ".join(f"{v:.17g}" for v in row)
                          for i, row in zip(ids, vert)) + "\n")
        f.write(f"*Element, type={INP_TYPES[(dim, nv)]}\n")
        f.write("\n".join(f"{e}, " + ", ".join(str(v) for v in row)
                          for e, row in zip(
                              range(1, len(conn) + 1), conn + 1)) + "\n")
        f.write("*Nset, nset=ALL, generate\n"
                f"1, {len(vert)}, 1\n*End Part\n")


def _boundary_faces(conn) -> np.ndarray:
    """The faces of a tet mesh that belong to one tet only."""
    faces = np.concatenate([conn[:, [0, 1, 2]], conn[:, [0, 1, 3]],
                            conn[:, [0, 2, 3]], conn[:, [1, 2, 3]]])
    key = np.sort(faces, axis=1)
    _, first, count = np.unique(key, axis=0, return_index=True,
                                return_counts=True)
    return faces[first[count == 1]]


def write_mphtxt(path, vert, conn) -> None:
    """A COMSOL .mphtxt of a tet mesh, as both packages' ``read_mesh``
    read it: the mesh points (lowest index 0), then a ``tri`` block of
    the boundary faces before the ``tet`` block, each with its
    geometric entity indices, so that the readers must choose the volume
    block."""
    vert = np.asarray(vert, np.float64)
    conn = np.asarray(conn, np.int64)
    blocks = (("tri", _boundary_faces(conn)), ("tet", conn))
    with open(path, "w") as f:
        f.write("# Created by chip_smoke.write_mphtxt (metafem_torch)\n\n"
                "# Major & minor version\n0 1\n1 # number of tags\n"
                "# Tags\n5 mesh1\n1 # number of types\n# Types\n3 obj\n"
                "\n# --------- Object 0 ----------\n\n0 0 1\n"
                "4 Mesh # class\n4 # version\n3 # sdim\n"
                f"{len(vert)} # number of mesh points\n"
                "0 # lowest mesh point index\n\n"
                "# Mesh point coordinates\n")
        f.write("\n".join(" ".join(f"{v:.17g}" for v in row)
                          for row in vert) + "\n\n")
        f.write(f"{len(blocks)} # number of element types\n\n")
        for k, (name, rows) in enumerate(blocks):
            f.write(f"# Type #{k}\n\n3 {name} # type name\n\n\n"
                    f"{rows.shape[1]} # number of vertices per element\n"
                    f"{len(rows)} # number of elements\n# Elements\n")
            f.write("\n".join(" ".join(str(v) for v in row)
                              for row in rows) + "\n\n")
            f.write(f"{len(rows)} # number of geometric entity indices\n"
                    "# Geometric entity indices\n"
                    + "1\n" * len(rows) + "\n")


#: the stress plates' meshes: quads (hexes) structured in (angle,
#: radius), the radial spacing growing geometrically from the hole to
#: the far edges by this ratio of the last spacing to the first
PLATE_GRADE = 10.0
#: the 2D plate's mesh on the card: 160 angular x 80 radial quads,
#: serendipity order 2, 77,762 DOF
PLATE_2D = (160, 80)
#: the 3D block's mesh on the card: 16 angular x 20 radial x 14 axial
#: hexes, serendipity order 2, 61,479 DOF (the reference's mesh: ~60k,
#: examples/stress_concentration_3d.py:26-27).  No more than 16 angular
#: cells: the example's facet tests take every boundary face whose centre
#: lies within 0.05 of x = 0 (or y = 0), and the z = 0 face's quads in
#: the angular sector next to that plane have their centres at about
#: r sin(pi / (2 n_ang)) / 2 from it; at 24 cells those up to r = 1.5
#: fall in the penalty, which pins d2 (d1) on a strip of the z = 0 face
#: and turns S22 at (1.25, 0, 0) negative (-0.357, host and card alike)
BLOCK_3D = (16, 20, 14)


def _radii(n_rad) -> np.ndarray:
    """n_rad + 1 radial stations from 0 (the hole) to 1 (the far edge),
    spaced geometrically by PLATE_GRADE."""
    if n_rad < 2:
        return np.linspace(0.0, 1.0, n_rad + 1)
    q = PLATE_GRADE ** (1.0 / (n_rad - 1))
    t = q ** np.arange(n_rad + 1) - 1.0
    return t / t[-1]


def _quarter_ring(n_ang, n_rad, center, theta0, far) -> np.ndarray:
    """[n_ang + 1, n_rad + 1, 2] points between the unit circle's arc
    from ``theta0`` to ``theta0 + pi / 2`` about ``center`` and the far
    edges: ``far(s)`` for s in [0, 1], the corner of the two edges at
    s = 1/2 (the middle angle)."""
    s = np.arange(n_ang + 1) / n_ang
    th = theta0 + 0.5 * np.pi * s
    inner = np.asarray(center) + np.stack([np.cos(th), np.sin(th)], 1)
    outer = np.stack([far(v) for v in s])
    t = _radii(n_rad)
    return inner[:, None] + t[None, :, None] * (outer - inner)[:, None]


def _ccw_quads(ring) -> np.ndarray:
    """The (n_ang x n_rad) quads of a point grid, as vertex ids of
    ``ring.reshape(-1, 2)``, each counter-clockwise."""
    na, nr = ring.shape[0] - 1, ring.shape[1] - 1
    ij = np.arange((na + 1) * (nr + 1)).reshape(na + 1, nr + 1)
    quads = np.stack([ij[:-1, :-1], ij[1:, :-1], ij[1:, 1:], ij[:-1, 1:]],
                     -1).reshape(-1, 4)
    p = ring.reshape(-1, 2)[quads]
    area = np.sum(p[:, :, 0] * np.roll(p[:, :, 1], -1, 1)
                  - np.roll(p[:, :, 0], -1, 1) * p[:, :, 1], axis=1)
    return np.where((area < 0)[:, None], quads[:, ::-1], quads)


def plate_2d(n_ang=PLATE_2D[0], n_rad=PLATE_2D[1]) -> tuple:
    """(vertices, quads) of examples/stress_concentration_2d.py's plate:
    the 5 x 5 square less the quarter disc of radius 1 about (5, 0).  The
    hole's arc (angles pi/2 to pi) maps onto the far edges y = 5 and x =
    0, their corner (0, 5) at the middle angle; the radial lines at the
    arc's ends run along x = 5 and y = 0.  Deterministic (no seed
    needed: nothing is random)."""
    if n_ang % 2:
        raise ValueError("n_ang must be even: the corner sits on a line")

    def far(s):
        return (np.array([5.0 - 10.0 * s, 5.0]) if s <= 0.5
                else np.array([0.0, 5.0 - 10.0 * (s - 0.5)]))
    ring = _quarter_ring(n_ang, n_rad, (5.0, 0.0), 0.5 * np.pi, far)
    return ring.reshape(-1, 2), _ccw_quads(ring)


def block_3d(n_ang=BLOCK_3D[0], n_rad=BLOCK_3D[1],
             n_z=BLOCK_3D[2]) -> tuple:
    """(vertices, hexes) of examples/stress_concentration_3d.py's block:
    the 5 x 5 x 5 cube less the quarter cylinder of radius 1 along its
    (0, 0, z) edge.  In each z plane the mesh of ``plate_2d``'s kind:
    the arc (angles 0 to pi/2) maps onto the far faces x = 5 and y = 5,
    their corner (5, 5) at the middle angle; extruded in z over n_z
    equal layers into hexes (bottom quad, then top quad, both
    counter-clockwise seen from +z)."""
    if n_ang % 2:
        raise ValueError("n_ang must be even: the corner sits on a line")

    def far(s):
        return (np.array([5.0, 10.0 * s]) if s <= 0.5
                else np.array([5.0 - 10.0 * (s - 0.5), 5.0]))
    grid = _quarter_ring(n_ang, n_rad, (0.0, 0.0), 0.0, far)
    quads = _ccw_quads(grid)
    ring = grid.reshape(-1, 2)
    z = np.linspace(0.0, 5.0, n_z + 1)
    nv = len(ring)
    vert = np.concatenate([np.column_stack([ring, np.full(nv, zk)])
                           for zk in z])
    hexes = np.concatenate([np.concatenate([quads + k * nv,
                                            quads + (k + 1) * nv], 1)
                            for k in range(n_z)])
    return vert, hexes


#: the pikachu path's stand-in mesh on the card: the jittered 5-tet
#: brick at this nel, refined once by the example (refine=1): 174,637
#: DOF at order 2 (121,680 tets)
PIKACHU_NEL = (18, 13, 13)


def pikachu_brick_cm(nel=PIKACHU_NEL) -> tuple:
    """(vertices in centimetres, tets): ``pikachu_brick.brick_arrays``
    (the jittered brick, numpy seeded 2) times 100, so that
    examples/pikachu_3d.py's division by 100 gives back the brick in
    metres, as it does for the COMSOL mesh."""
    from metafem_torch.examples import pikachu_brick
    vert, conn = pikachu_brick.brick_arrays(nel)
    return vert * 100.0, conn


#: the duct's mesh on the card: nel=(73, 12, 12) 5-tet cells, the
#: order-2 node spacing ~0.017 (examples/cylinder_flow_3d.py's DX =
#: 0.02); 52,140 tets after the cylinder's cut, 323,884 DOF at order 2
DUCT_NEL = (73, 12, 12)
#: examples/cylinder_flow_3d.py's duct and the cylinder of the
#: reference's COMSOL mesh (3D_MetaFEM_Script.jl): axis along z through
#: (0.5, 0.2), radius 0.05
DUCT_SIZE = (2.5, 0.41, 0.41)
CYLINDER = ((0.5, 0.2), 0.05)


def duct(nel=DUCT_NEL, seed=5) -> tuple:
    """(vertices, tets) of the 2.5 x 0.41 x 0.41 duct with a stepped
    cylinder: ``make_brick(DUCT_SIZE, nel, shape="SIMPLEX")`` less the
    tets whose centre lies within the cylinder's radius of its axis,
    unused vertices dropped and the rest renumbered in order; the
    vertices off the duct's six faces (those of the stepped cylinder
    among them) moved by up to 0.09 h per axis (uniform, numpy seeded
    ``seed``; h the smallest cell size), so that the control points
    land on no lattice, as on the reference's COMSOL mesh."""
    import metafem_torch as mf
    vert, conn = mf.make_brick(DUCT_SIZE, tuple(nel), shape="SIMPLEX")
    vert, conn = np.asarray(vert, np.float64), np.asarray(conn)
    (cx, cy), r = CYLINDER
    mid = vert[conn].mean(axis=1)
    conn = conn[np.hypot(mid[:, 0] - cx, mid[:, 1] - cy) >= r]
    used = np.unique(conn)
    renum = np.full(len(vert), -1, np.int64)
    renum[used] = np.arange(len(used))
    vert, conn = vert[used], renum[conn]
    h = min(DUCT_SIZE[d] / nel[d] for d in range(3))
    inner = np.ones(len(vert), bool)
    for d in range(3):
        inner &= (vert[:, d] > 1e-9) & (vert[:, d] < DUCT_SIZE[d] - 1e-9)
    rng = np.random.default_rng(seed)
    vert = vert + 0.18 * h * inner[:, None] * (rng.random(vert.shape) - 0.5)
    return vert, conn


#: the Krylov iterations of the profiled solve pass (``_solve_profile``)
PASS_PROFILE_ITERS = 400
#: the reference tests' probe points (tests/test_stress_concentration.py:
#: 35, tests/test_stress_concentration_3d.py:48-49)
S22_PTS_2D = ((3.92, 0.0), (3.8, 0.0), (3.6, 0.0))
S22_PTS_3D = ((1.25, 0.0, 0.0), (1.75, 0.0, 0.0), (2.5, 0.0, 0.0))


def _kirsch_s22(r: float) -> float:
    """sigma_yy / S on the line through a circular hole's centre normal to
    a remote uniaxial stress S, at r hole radii, in an infinite plate
    (Kirsch 1898): 1 + 1 / (2 r^2) + 3 / (2 r^4)."""
    return 1.0 + 0.5 / r ** 2 + 1.5 / r ** 4


def _timed(fn, key, secs, device):
    """fn, adding its seconds (synchronised at both ends) to secs[key]."""
    def call(*args, **kwargs):
        _sync(device)
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _sync(device)
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t
    return call


def _run_example(device, run) -> dict:
    """``run()``, a port example's entry point, with the packed SpMV and
    BSR-tail kernels' launch counts set to 0 just before it and read just
    after: its seconds in all and in its mesh reads, its steps
    (``update_one_step``) and its linear solves (``iterative_solve``),
    its Newton updates (linear solves) and the Krylov iterations of each
    solve's passes.  The first solve's operator, right-hand side and
    options are kept (``first``) for ``_solve_profile`` and the SpMV
    numbers of the path's operator."""
    from unittest import mock
    import metafem_torch as mf
    from metafem_torch.linsolve import bsr_tail, offset_spmv
    from metafem_torch.solver import domain as domain_mod
    secs, first, passes = {}, {}, []
    solve_fn = domain_mod.iterative_solve

    def solve(A, b, *args, **kwargs):
        if not first:
            first.update(A=A, b=b, args=args, kwargs=kwargs)
        log = kwargs.get("log")
        n0 = len(log) if log is not None else 0
        x = solve_fn(A, b, *args, **kwargs)
        if log is not None:
            passes.append([int(it) for it, _ in log[n0:]])
        return x
    step = domain_mod.FEM_Domain.update_one_step
    with mock.patch.object(mf, "read_mesh",
                           _timed(mf.read_mesh, "read", secs, device)), \
            mock.patch.object(domain_mod.FEM_Domain, "update_one_step",
                              _timed(step, "steps", secs, device)), \
            mock.patch.object(domain_mod, "iterative_solve",
                              _timed(solve, "solves", secs, device)):
        offset_spmv.reset_launches()
        bsr_tail.reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        total = time.perf_counter() - t0
        counts = _kernel_counts()
    launches = {"packed": sum(counts[0].values()),
                "bsr_tail": sum(counts[1].values()),
                "by_type": _count_diff(counts, [{k: 0 for k in c}
                                                for c in counts])}
    return {"out": out, "s": total, "parts_s": secs, "first": first,
            "passes": passes, "newton_updates": len(passes),
            "launches": launches}


def _layout_line(dom) -> dict:
    """What the domain's layout holds: its one dense group's units,
    offsets and control points, and its tail (BSR blocks, or scalar COO
    entries) with the tail's structural entries."""
    lo = dom.pattern.offset_layout
    (grp,) = lo.pallas_groups
    n_tail = int((np.asarray(lo.storage_of_slot) >= lo.n_dense).sum())
    kind = "bsr" if lo.blk_b else ("coo" if lo.n_coo else "none")
    return {"dof": int(lo.n), "C": grp.n_vars, "G": len(grp.units),
            "n_off": grp.n_off, "n_cp": grp.n_cp, "tail": kind,
            "tail_blocks": int(lo.n_coo) if lo.blk_b else 0,
            "tail_entries": int(lo.n_coo) if kind == "coo" else 0,
            "tail_structural": n_tail, "n_dense": int(lo.n_dense)}


def _solve_profile(first, device) -> dict:
    """One pass of the path's Krylov solver on its first linear solve
    (the first Newton update's tangent and residual), at most
    PASS_PROFILE_ITERS iterations: its host seconds, then the same pass
    under torch.profiler: device-busy ms, of it the packed SpMV kernel's
    and the BSR-tail kernel's, kernel launches."""
    from metafem_torch.linsolve.driver import iterative_solve
    kw = dict(first["kwargs"])
    kw.update(max_pass=1, maxiter=min(kw.get("maxiter", 2000),
                                      PASS_PROFILE_ITERS))

    def one():
        log = []
        iterative_solve(first["A"], first["b"], *first["args"],
                        **{**kw, "log": log})
        return log
    _sync(device)
    t0 = time.perf_counter()
    log = one()
    _sync(device)
    wall = time.perf_counter() - t0
    n_prof, kernels = _kernel_profile(one, device)
    busy = sum(kernels.values())
    spmv = sum(v for k, v in kernels.items() if "offset_spmv_packed" in k)
    tail = sum(v for k, v in kernels.items() if "bsr_tail_packed" in k)
    its = int(log[0][0])
    return {"iterations": its, "wall_ms": 1e3 * wall, "busy_ms": busy,
            "spmv_ms": spmv, "tail_kernel_ms": tail,
            "busy_per_iteration_ms": busy / max(its, 1),
            "launches": n_prof, "top": _top_kernels(kernels)}


def _example_numbers(device, tag, run, rng) -> dict:
    """The path's layout, kernel launches, seconds, Newton updates and
    Krylov iterations, printed; the packed kernel on its first tangent
    (the dense group: ``_spmv_at_size``), with a BSR tail the tail kernel
    (``_bsr_numbers``), the whole product A.mv against CSR
    (``_whole_mv_numbers``) and one profiled solve pass
    (``_solve_profile``).
    Raises where the path launched no packed kernel, or no tail kernel
    over a BSR tail."""
    dom = run["dom"]
    lay = _layout_line(dom)
    L = run["launches"]
    parts = run["parts_s"]
    build_s = run["s"] - parts.get("read", 0.0) - parts.get("steps", 0.0)
    tail = {"bsr": f"a BSR tail of {lay['tail_blocks']} 8 x 8 blocks",
            "coo": f"a scalar COO tail of {lay['tail_entries']} entries",
            "none": "no tail"}[lay["tail"]]
    print(f"[{tag}] {lay['dof']} DOF, C={lay['C']}, one dense group of "
          f"{lay['G']} units x {lay['n_off']} offsets over {lay['n_cp']} "
          f"control points; {tail} ({lay['tail_structural']} structural "
          f"entries); launches: packed SpMV {L['packed']}, BSR tail "
          f"{L['bsr_tail']} ({L['by_type']}); seconds: mesh write "
          f"{run['write_s']:.2f}, mesh read {parts.get('read', 0.0):.2f}, "
          f"build {build_s:.2f}, steps {parts.get('steps', 0.0):.2f} (of "
          f"them linear solves {parts.get('solves', 0.0):.2f}), in all "
          f"{run['s']:.2f}; Newton updates {run['newton_updates']}, Krylov "
          f"iterations per pass (per solve) {run['passes']}")
    if L["packed"] <= 0 or (lay["tail"] == "bsr" and L["bsr_tail"] <= 0):
        raise AssertionError(f"[{tag}] the path launched {L} over "
                             f"{lay['tail']} tail")
    A = run["first"]["A"]
    dense = A.dense_part() if lay["tail"] != "none" else A
    out = {"layout": lay, "launches": L, "s": run["s"],
           "parts_s": {**parts, "write": run["write_s"], "build": build_s},
           "newton_updates": run["newton_updates"],
           "passes": run["passes"]}
    out["spmv64"] = _spmv_at_size(dense, rng, device, "first tangent's "
                                  "dense group", tag=tag)
    if not (out["spmv64"]["rel"] <= 1e-14):
        raise AssertionError(f"[{tag}] f64 kernel disagrees: "
                             f"{out['spmv64']['rel']}")
    if lay["tail"] == "bsr":
        out["bsr64"] = _bsr_numbers(A, rng, device, "first tangent",
                                    tag=tag)
    out["whole_mv"] = _whole_mv_numbers(A, rng, device, "first tangent",
                                        tag=tag,
                                        graph=lay["tail"] != "coo")
    out["pass"] = pp = _solve_profile(run["first"], device)
    print(f"[{tag}] one solve pass (the first Newton update, at most "
          f"{PASS_PROFILE_ITERS} iterations): {pp['iterations']} "
          f"iterations, {pp['wall_ms']:.1f} ms host; device busy "
          f"{pp['busy_ms']:.2f} ms ({pp['busy_per_iteration_ms']:.4f} ms "
          f"per iteration; {100 * pp['busy_ms'] / pp['wall_ms']:.1f}% of "
          f"the host time), of it the packed SpMV {pp['spmv_ms']:.2f} ms "
          f"and the BSR-tail kernel {pp['tail_kernel_ms']:.2f} ms; "
          f"{pp['launches'] or 'not measured'} kernel launches; the most: "
          f"{pp['top']}")
    return out


def _stress_2d_path(device, tmp, rng, nel=PLATE_2D) -> dict:
    """examples/stress_concentration_2d.py through the port's ``solve`` on
    the quarter-hole plate written as .inp (GMRES(20), C=2): residual
    below 1e-8; S22 at the reference test's points, the first above 2.0
    and strictly decreasing (tests/test_stress_concentration.py:33-39)."""
    from metafem_torch.examples import stress_concentration_2d as sc
    t0 = time.perf_counter()
    write_inp(os.path.join(tmp, sc.MESH_NAME), *plate_2d(*nel))
    write_s = time.perf_counter() - t0
    run = _run_example(device, lambda: sc.solve(ref_dir=tmp,
                                                 device=device))
    dom, geo, wp, p = run["out"]
    run.update(dom=dom, write_s=write_s)
    t0 = time.perf_counter()
    s22 = sc.s22_at(dom, geo, wp, np.array(S22_PTS_2D), p)
    probe_s = time.perf_counter() - t0
    out = _example_numbers(device, "stress_2d", run, rng)
    res = p["residual"]
    print(f"[stress_2d] plate {nel[0]} x {nel[1]} quads: residual {res:.3e}"
          f" (gate 1e-8); S22 at {list(S22_PTS_2D)}: "
          f"{[round(float(v), 4) for v in s22]} (gates: the first above "
          f"2.0, strictly decreasing); probe {probe_s:.2f} s")
    out.update(residual=res, s22=[float(v) for v in s22], probe_s=probe_s,
               nel=list(nel))
    if not (res < 1e-8 and s22[0] > 2.0 and s22[0] > s22[1] > s22[2]):
        raise AssertionError(f"stress 2D: residual {res}, S22 {s22}")
    return out


def _stress_3d_path(device, tmp, rng, nel=BLOCK_3D) -> dict:
    """examples/stress_concentration_3d.py through the port's ``solve``
    with ``solver="idrs"`` (IDR(8), C=3) on the quarter-hole block written
    as .inp: residual below 1e-8; S22 at the reference test's points
    (tests/test_stress_concentration_3d.py:46-54), the first above 1.25,
    strictly decreasing.  The test's third bar, the last within 0.1 of
    the nominal 1.0, is printed, not gated: on the 5 x 5 x 5 block that
    its docstring describes the ligament x in [1, 5] must carry a mean
    S22 of 1.25, and the infinite plate already gives 1.118 at x = 2.5
    (Kirsch); the last is gated within 0.1 of that value instead."""
    from metafem_torch.examples import stress_concentration_3d as sc
    t0 = time.perf_counter()
    write_inp(os.path.join(tmp, sc.MESH_NAME), *block_3d(*nel))
    write_s = time.perf_counter() - t0
    run = _run_example(device, lambda: sc.solve(solver="idrs", ref_dir=tmp,
                                                 device=device))
    dom, geo, wp, p = run["out"]
    run.update(dom=dom, write_s=write_s)
    t0 = time.perf_counter()
    s22 = sc.s22_at(dom, geo, wp, np.array(S22_PTS_3D), p)
    probe_s = time.perf_counter() - t0
    out = _example_numbers(device, "stress_3d", run, rng)
    res = p["residual"]
    kirsch = _kirsch_s22(S22_PTS_3D[2][0])
    print(f"[stress_3d] block {nel[0]} x {nel[1]} x {nel[2]} hexes: "
          f"residual {res:.3e} (gate 1e-8); S22 at {list(S22_PTS_3D)}: "
          f"{[round(float(v), 4) for v in s22]} (gates: the first above "
          f"1.25, strictly decreasing, the last within 0.1 of Kirsch's "
          f"{kirsch:.4f}; the reference test's |last - 1| < 0.1: "
          f"{abs(s22[2] - 1.0):.4f}); probe {probe_s:.2f} s")
    out.update(residual=res, s22=[float(v) for v in s22], probe_s=probe_s,
               nel=list(nel), kirsch=kirsch)
    if not (res < 1e-8 and s22[0] > 1.25 and s22[0] > s22[1] > s22[2]
            and abs(s22[2] - kirsch) < 0.1):
        raise AssertionError(f"stress 3D: residual {res}, S22 {s22}")
    return out


def _pikachu_path(device, tmp, rng, nel=PIKACHU_NEL) -> dict:
    """examples/pikachu_3d.py through the port on the jittered brick
    written as .mphtxt in centimetres, refine=1, order 2, C=1, float64:
    ``solve_static`` (right-Jacobi BiCGStab; residual below 1e-6), then
    ``build(dynamic=True, C=4.184e3)`` with ``GeneralAlpha.dissipative()``
    and dt=200 for 3 steps: maxima strictly increasing, the last below
    the steady maximum + 0.05 K and above T_ENV + 1 K
    (tests/test_pikachu.py:43-60).  Each of the two runs has its launch
    counts set to 0 before it and read after."""
    from metafem_torch.examples import pikachu_3d as pk
    path = os.path.join(tmp, "brick.mphtxt")
    t0 = time.perf_counter()
    write_mphtxt(path, *pikachu_brick_cm(nel))
    write_s = time.perf_counter() - t0
    run = _run_example(device, lambda: pk.solve_static(
        refine=1, mesh_path=path, device=device))
    dom, geo, mesh, res = run["out"]
    run.update(dom=dom, write_s=write_s)
    steady = _example_numbers(device, "pikachu_3d", run, rng)
    t_steady = float(mesh.fields["T"].max())
    del run, dom, geo, mesh
    _free(device)

    def transient():
        dom, _, mesh = pk.build(dynamic=True, C=4.184e3, refine=1,
                                mesh_path=path, device=device)
        dom.time_discretization = pk.GeneralAlpha.dissipative()
        dom.dt = 200.0
        maxima = [float(mesh.fields["T"].max())]
        for _ in range(3):
            dom.update_one_step(max_iter=3)
            dom.dessemble_x()
            maxima.append(float(mesh.fields["T"].max()))
        return dom, maxima
    run_t = _run_example(device, transient)
    dom_t, maxima = run_t["out"]
    run_t.update(dom=dom_t, write_s=0.0)
    lay = _layout_line(dom_t)
    L = run_t["launches"]
    parts = run_t["parts_s"]
    print(f"[pikachu_3d] transient (C=4.184e3, dissipative, dt=200, 3 "
          f"steps): launches packed SpMV {L['packed']}, BSR tail "
          f"{L['bsr_tail']}; seconds: build "
          f"{run_t['s'] - parts.get('read', 0) - parts.get('steps', 0):.2f}"
          f", steps {parts.get('steps', 0.0):.2f} (linear solves "
          f"{parts.get('solves', 0.0):.2f}); Newton updates "
          f"{run_t['newton_updates']}, Krylov iterations per pass (per "
          f"solve) {run_t['passes']}")
    if L["packed"] <= 0 or (lay["tail"] == "bsr" and L["bsr_tail"] <= 0):
        raise AssertionError(f"[pikachu_3d] the transient launched {L}")
    pp = _solve_profile(run_t["first"], device)
    print(f"[pikachu_3d] transient: one solve pass {pp['iterations']} "
          f"iterations, {pp['wall_ms']:.1f} ms host, device busy "
          f"{pp['busy_ms']:.2f} ms; steady residual {res:.3e} (gate 1e-6), "
          f"steady max T {t_steady:.4f} K; transient maxima "
          f"{[round(m, 4) for m in maxima]} K (gates: strictly "
          f"increasing, the last below {t_steady + 0.05:.4f} and above "
          f"{pk.T_ENV + 1.0:.2f})")
    ok = (res < 1e-6 and all(b > a for a, b in zip(maxima, maxima[1:]))
          and pk.T_ENV + 1.0 < maxima[-1] < t_steady + 0.05)
    out = {**steady, "residual": res, "t_steady_max": t_steady,
           "maxima": maxima, "nel": list(nel),
           "transient": {"launches": L, "s": run_t["s"], "parts_s": parts,
                         "newton_updates": run_t["newton_updates"],
                         "passes": run_t["passes"], "pass": pp}}
    if not ok:
        raise AssertionError(f"pikachu: residual {res}, steady max "
                             f"{t_steady}, maxima {maxima}")
    return out


def _flux_x(geo, mesh, et, x, n=41) -> float:
    """The volume flux of u1 through the duct's cross-section at x: u1 by
    ``probe_field`` on an n x n grid over [0, H]^2, the trapezoid rule."""
    from metafem_torch.mesh.probe import probe_field
    H = DUCT_SIZE[1]
    g = np.linspace(0.0, H, n)
    Y, Z = np.meshgrid(g, g, indexing="ij")
    pts = np.column_stack([np.full(n * n, x), Y.ravel(), Z.ravel()])
    u = probe_field(geo, mesh, et, "u1", pts).reshape(n, n)
    if np.isnan(u).any():
        raise AssertionError(f"{int(np.isnan(u).sum())} probe points at "
                             f"x={x} fell outside the duct")
    w = np.full(n, g[1] - g[0])
    w[[0, -1]] *= 0.5
    return float(w @ u @ w)


def _cylinder_path(device, tmp, rng, nel=DUCT_NEL) -> dict:
    """examples/cylinder_flow_3d.py through the port (``build``, then
    ``solve``: IDR(8) with left Jacobi, 6 Newton iterations at most) on
    the duct written as .mphtxt, order 2, C=4: residual below 1e-6; the
    volume flux through x = 2.0 within 10% of the inflow's 4 UM H^2 / 9."""
    from metafem_torch.examples import cylinder_flow_3d as cf
    path = os.path.join(tmp, "duct.mphtxt")
    t0 = time.perf_counter()
    write_mphtxt(path, *duct(nel))
    write_s = time.perf_counter() - t0

    def run():
        dom, geo, wp = cf.build(mesh_path=path, device=device)
        return dom, geo, wp, cf.solve(dom, geo, wp)
    run_c = _run_example(device, run)
    dom, geo, wp, res = run_c["out"]
    run_c.update(dom=dom, write_s=write_s)
    out = _example_numbers(device, "cylinder_flow_3d", run_c, rng)
    mesh = dom.workpieces[wp].mesh
    t0 = time.perf_counter()
    flux = _flux_x(geo, mesh, dom.workpieces[wp].disc.element_type, 2.0)
    probe_s = time.perf_counter() - t0
    inflow = 4 * cf.UM * cf.H ** 2 / 9
    u1 = mesh.fields["u1"]
    print(f"[cylinder_flow_3d] duct nel={tuple(nel)}: residual {res:.3e} "
          f"(gate 1e-6); u1 in [{u1.min():.4f}, {u1.max():.4f}]; flux "
          f"through x=2.0 {flux:.6f} m^3/s against the inflow's "
          f"{inflow:.6f} ({100 * (flux / inflow - 1):+.2f}%, gate 10%); "
          f"probe {probe_s:.2f} s")
    out.update(residual=res, flux=flux, inflow=inflow, probe_s=probe_s,
               nel=list(nel))
    if not (res < 1e-6 and abs(flux / inflow - 1) < 0.1):
        raise AssertionError(f"cylinder flow: residual {res}, flux {flux} "
                             f"against {inflow}")
    return out


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def phase_mesh_examples(device, plate=PLATE_2D, block=BLOCK_3D,
                        pikachu=PIKACHU_NEL, duct_nel=DUCT_NEL) -> dict:
    """The four mesh-reading examples of metafem_torch/examples/, each
    through its own entry point on a mesh that this script writes to a
    temporary directory in the format the example reads (``write_inp``,
    ``write_mphtxt``): the stress plate (C=2, GMRES(20)), the stress block
    (C=3, IDR(8)), pikachu steady and transient (C=1, BiCGStab) and the
    cylinder flow (C=4, IDR(8) with left Jacobi).  Each path's gates,
    layout, launches, seconds and Krylov iterations
    (``_example_numbers``); the packed kernel (and the tail kernel over a
    BSR tail) on each path's first tangent against its plain version
    (within 1e-14 and 1e-12 of max|y|: the kernels fuse each product into
    the row's sum with fma, the plain versions round it first), a
    bitwise repeat, and timed."""
    t_all = time.perf_counter()
    rng = np.random.default_rng(20261018)
    out = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    paths = (("stress_2d", _stress_2d_path, plate),
             ("stress_3d", _stress_3d_path, block),
             ("pikachu_3d", _pikachu_path, pikachu),
             ("cylinder_flow_3d", _cylinder_path, duct_nel))
    for key, path, nel in paths:
        _free(device)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            out[key] = path(device, tmp, rng, nel)
        out[key]["path_s"] = time.perf_counter() - t0
    _free(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out["s"] = time.perf_counter() - t_all
    print(f"[mesh] paths " + ", ".join(
        f"{k} {out[k]['path_s']:.1f} s" for k, *_ in paths)
        + f"; phase {out['s']:.1f} s; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    out["peak_bytes"] = peak
    return out


def phase_multifield(device, te_e=TE_E, steady_e=TE_STEADY_E,
                     cavity_e=CAVITY_E, j2_e=J2_E) -> dict:
    """The multi-field and history-variable paths: thermo-elasticity at
    full size (``_te_path``) and to steady state (``_te_steady``), the
    lid-driven cavity (``_cavity_path``) and J2 plasticity
    (``_j2_path``)."""
    t0 = time.perf_counter()
    out = {"te": _te_path(device, te_e)}
    out["te"]["s"] = time.perf_counter() - t0
    out["steady"] = _te_steady(device, steady_e)
    out["cavity"] = _cavity_path(device, cavity_e)
    out["j2"] = _j2_path(device, j2_e)
    print(f"[multifield] phase {time.perf_counter() - t0:.1f} s "
          f"(thermo-elastic full size {out['te']['s']:.1f} s)")
    return out


#: the multi-device phase's leg B: ranks on the one card, the pikachu
#: brick's cut (the full (73,51,51) spends 107-112 s in host setup), and
#: the time limit of its process group
MD_RANKS = 2
MD_PIKACHU_NEL = (24, 17, 17)
MD_TIMEOUT_S = 420


def _multidevice_leg_a(device, flag_md, backend="nccl") -> dict:
    """Leg A: NCCL with one rank in this process, the flagship's own
    domain and timed step, sharded over a 1-rank DeviceMesh: x bitwise
    equal to the unsharded step's (every collective is an identity), the
    steps' ms in turns (whole, sharded, sharded, whole), the packed
    kernel's launches and the collectives' bytes of one sharded step."""
    import torch.distributed as dist
    from metafem_torch import bench
    from metafem_torch.linsolve import krylov, offset_spmv
    from metafem_torch.parallel import comm, shard_domain_state
    from metafem_torch.parallel.dataparallel import make_mesh
    dom, label, x1 = flag_md
    kw = dict(sv_func=getattr(krylov, label), **bench.STEP_KW)
    state = dom._runtime_state()
    step = dom.make_refined_step(**kw)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(device=device)
        # the group's own transport, once: with one rank comm.py's
        # collectives are identities and call none
        one = torch.ones(1, device=device)
        dist.all_reduce(one)
        if float(one) != 1.0:
            raise AssertionError(f"{backend} all_reduce on one rank: {one}")
        sharded = shard_domain_state(state, mesh)
        step_sh = dom.make_refined_step(rowshard_mesh=mesh, **kw)

        def timed(fn, st):
            _sync(device)
            t = time.perf_counter()
            out = fn(st, x1, 0.0, 1.0)
            _sync(device)
            return out, (time.perf_counter() - t) * 1e3
        timed(step_sh, sharded)                  # window plans, packs
        (xw, _, res_w, it_w), ms_w1 = timed(step, state)
        offset_spmv.reset_launches()
        comm.reset_counts()
        (xs, _, res_s, it_s), ms_s1 = timed(step_sh, sharded)
        launches = offset_spmv.group_mv.launches
        moved = comm.counts()
        (xs2, _, _, _), ms_s2 = timed(step_sh, sharded)
        (_, _, _, _), ms_w2 = timed(step, state)
    finally:
        dist.destroy_process_group()
    if not (torch.equal(xs, xw) and torch.equal(xs2, xs)):
        raise AssertionError("multidevice leg A: the 1-rank sharded step is "
                             "not bitwise the unsharded one")
    if launches <= 0:
        raise AssertionError("multidevice leg A: no packed kernel launch")
    out = {"ranks": 1, "backend": backend,
           "dof": dom.pattern.basicfield_size,
           "bitwise": True, "res": res_s, "refines": it_s,
           "refines_whole": it_w, "ms": [ms_s1, ms_s2],
           "ms_whole": [ms_w1, ms_w2], "launches": launches, "comm": moved}
    print(f"[multidevice] A: {backend} 1 rank, {out['dof']} DOF: sharded "
          f"step "
          f"x bitwise equal to the unsharded step's ({it_s} refines, "
          f"residual {res_s:.3e}); ms sharded {ms_s1:.2f} {ms_s2:.2f}, "
          f"whole {ms_w1:.2f} {ms_w2:.2f} (in turns); packed launches "
          f"{launches}; collective bytes {moved}")
    return out


def _run_group(cmd, timeout_s) -> subprocess.CompletedProcess:
    """Run a process group (torch.distributed.run) under a time limit;
    on the limit kill the whole group and raise."""
    import signal
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"multidevice: the rank group passed its "
                             f"{timeout_s} s limit and was killed")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _md_kernel(rank_recs, leg, mode, which, name, peak) -> dict:
    """One kernel's window numbers on every rank of leg B, with its
    bounds at the card's memory rate: ``bound_ms`` the structural
    entries, the entries of x the window's plan reads and the window's
    y once (``dryrun.window_kernels``' ``min_bytes``);
    ``packed_bound_ms`` the plan's bytes.  The ranks timed their
    kernels one at a time."""
    out = []
    for r in rank_recs:
        k = r[mode]["kernels"][which][name]
        out.append({**k, "rank": r[mode]["rank"],
                    "window": r[mode]["window"],
                    "bound_ms": k["min_bytes"] / peak * 1e3,
                    "packed_bound_ms": k["bytes"] / peak * 1e3,
                    "launches": r[mode]["launches"][name]})
    return {"leg": leg, "mode": mode, "operator": which, "ranks": out}


def _gib(n) -> str:
    return "not measured" if n is None else f"{n / 2**30:.2f}"


def phase_multidevice(device, flag_md, nel=FLAGSHIP_NEL,
                      pikachu_nel=MD_PIKACHU_NEL, backend_a="nccl") -> dict:
    """The multi-device layer on the card: leg A (NCCL, one rank, in
    process, bitwise) and leg B (two gloo ranks on this card through
    ``metafem_torch.parallel.dryrun``: the flagship's refined steps, the
    pikachu brick's auxmg step, the float64 flagship's jitted step with
    per-step multigrid setup and a whole step on its cut state, and the
    solver menu on its tangent).  NCCL across several GPUs is not
    run here: the machine has one card.  ``backend_a`` and a CPU
    ``device`` serve a rehearsal on the CPU."""
    t0 = time.perf_counter()
    out = {"A": _multidevice_leg_a(device, flag_md, backend_a)}
    del flag_md
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(MD_RANKS), "-m",
               "metafem_torch.parallel.dryrun", "--device", device.type,
               "--backend", "gloo", "--legs",
               "flagship,pikachu,flagship_jitted,flagship_menu",
               "--nel", *map(str, nel),
               "--pikachu-nel", *map(str, pikachu_nel), "--out", tmp]
        p = _run_group(cmd, MD_TIMEOUT_S)
        for line in p.stdout.splitlines():
            if line.startswith("[dryrun]"):
                print("[multidevice] B " + line[len("[dryrun] "):][:4000])
        if p.returncode != 0:
            raise AssertionError(f"multidevice leg B failed "
                                 f"(rc {p.returncode}):\n{p.stderr[-6000:]}")
        with open(os.path.join(tmp, "summary.json")) as f:
            summary = json.load(f)
    peak = _peak_bytes(torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "")
    fl = [r for r in summary["legs"]["flagship"]["ranks"]]
    pk = [r for r in summary["legs"]["pikachu"]["ranks"]]
    fj = [r for r in summary["legs"]["flagship_jitted"]["ranks"]]
    fm = [r for r in summary["legs"]["flagship_menu"]["ranks"]]
    out["B"] = {"ranks": summary["ranks"], "backend": summary["backend"],
                "s": time.perf_counter() - t_b, "flagship": fl,
                "pikachu": pk, "flagship_jitted": fj, "flagship_menu": fm,
                "leg_s": {k: v["leg_s"] for k, v in summary["legs"].items()},
                "jitted_f64": _md_kernel(fj, "flagship_jitted", "step",
                                         "f64_tangent", "packed", peak),
                "menu_f64": _md_kernel(fm, "flagship_menu", "menu",
                                       "f64_scaled", "packed", peak),
                "packed_f32": _md_kernel(fl, "flagship", "f64", "f32_fine",
                                         "packed", peak),
                "packed_f64": _md_kernel(fl, "flagship", "f64", "f64_A_td",
                                         "packed", peak),
                "packed_df": _md_kernel(fl, "flagship", "df32", "df_A_td",
                                        "packed_df", peak),
                "tail_f64": _md_kernel(pk, "pikachu", "f64", "f64_A_td",
                                       "tail", peak),
                "pikachu_packed_f64": _md_kernel(pk, "pikachu", "f64",
                                                 "f64_A_td", "packed", peak)}
    for leg, recs in (("flagship", fl), ("pikachu", pk)):
        for r in recs:
            for mode in ("f64", "df32"):
                if mode not in r:
                    continue
                m = r[mode]
                print(f"[multidevice] B {leg} {mode} rank {m['rank']}: "
                      f"window {m['window']} ({m['rows']} of {m['n']} rows, "
                      f"{m['storage']} of {m['n_storage']} stored values); "
                      f"{m['refines']} refines {m['refines_all_ranks']}, "
                      f"residual {m['res']:.3e}, x within "
                      f"{m['max_rel_vs_whole']:.3e} of the whole step's; "
                      f"ms {m['ms']:.1f} (whole {m['ms_whole']:.1f}); peak "
                      f"{_gib(m['peak_bytes'])} GiB (whole "
                      f"{_gib(m['peak_bytes_whole'])}); launches "
                      f"{m['launches']}; collectives {m['comm']}")
    for r in fj:
        m, c, su = r["step"], r["whole_on_cut"], r["setup"]
        print(f"[multidevice] B flagship_jitted f64 rank {m['rank']}: "
              f"{r['dof']} DOF, window {m['window']} ({m['rows']} rows, "
              f"{m['storage']} stored values); Newton {m['refines']} "
              f"{m['refines_all_ranks']} (whole {m['refines_whole']}), "
              f"Krylov {m['krylov']} {m['krylov_all_ranks']} (whole "
              f"{m['krylov_whole']}), residual {m['res']:.3e}, x within "
              f"{m['max_rel_vs_whole']:.3e} of the whole step's; ms "
              f"{m['ms']:.1f} (whole {m['ms_whole']:.1f}); per-step setup "
              f"{su['s']:.3f} s on the window, {su['s_whole']:.3f} s "
              f"whole, {su['n_levels']} levels, level-0 omega "
              f"{su['omega0_rel_diff']:.3e} apart, levels >= 1 "
              f"{su['coarse_max_abs_diff']:.3e} apart; peak "
              f"{_gib(m['peak_bytes'])} GiB (whole "
              f"{_gib(m['peak_bytes_whole'])}); launches {m['launches']}; "
              f"collectives {m['comm']}")
        print(f"[multidevice] B flagship_jitted whole step on the cut state "
              f"rank {m['rank']}: bitwise the uncut twin's, "
              f"{c['iters']} Newton, residual {c['res']:.3e}; its first "
              f"step (gathering {c['gathered']} back) {c['s'] * 1e3:.1f} "
              f"ms, peak {_gib(c['peak_bytes'])} GiB, launches "
              f"{c['launches']}, collectives {c['comm']}; setup_mg "
              f"{c['setup_mg_s']:.2f} s")
    for r in fm:
        m = r["menu"]
        for name, v in m["solvers"].items():
            print(f"[multidevice] B flagship_menu {name} rank {m['rank']}: "
                  f"{v['iters']} iterations {v['iters_all_ranks']}, "
                  f"residual {v['res']:.3e} (whole {v['res_whole']:.3e}), "
                  f"y bitwise the whole solve's with the ranks' order "
                  f"of additions, {v['max_rel_vs_plain']:.3e} of max|y| "
                  f"from the whole solve with torch.dot's order; "
                  f"ms {v['ms']:.1f} (whole {v['ms_whole']:.1f}); "
                  f"launches {v['launches']}; collectives {v['comm']}")
        print(f"[multidevice] B flagship_menu rank {m['rank']}: peak "
              f"{_gib(m['peak_bytes'])} GiB")
    print(f"[multidevice] phase {time.perf_counter() - t0:.1f} s (leg B "
          f"{out['B']['s']:.1f} s; legs "
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["B"]["leg_s"].items())
          + ")")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    _import_port()
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    env = phase_environment(device)
    times = {"build": phase_build()}

    def run(key, phase):
        t = time.perf_counter()
        out = phase(device)
        times[key] = time.perf_counter() - t
        return out
    kern = run("kernel", phase_kernel)
    gat = run("gather", phase_gather)
    sl = run("slice", phase_slice)
    flag = run("flagship", phase_flagship)
    mdp = run("multidevice", lambda dev: phase_multidevice(
        dev, flag.pop("multidevice")))
    run("persist", lambda dev: phase_persist(dev, flag.pop("cold")))
    p3d = run("3d", phase_3d)
    mfp = run("multifield", phase_multifield)
    uns = run("unstructured", phase_unstructured)
    mex = run("mesh_examples", phase_mesh_examples)
    print("[time] " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
          + f", total {time.perf_counter() - t_start:.2f} s on {env['smi']}")
    s32 = flag["spmv32"]
    dfs = flag["df_spmv"]

    def numbers(t):
        return {k: t[k] for k in SPMV_KEYS}

    def example_numbers(p):
        return {**numbers(p["spmv64"]), "max_rel_err_f64": p["spmv64"]["rel"],
                "launches": p["launches"]["packed"],
                "launches_by_type": p["launches"]["by_type"]["packed"],
                **p["layout"], "whole_mv": p["whole_mv"],
                "solve_pass": p["pass"]}

    def example_tail(p):
        return {**p["bsr64"], "launches": p["launches"]["bsr_tail"],
                "dof": p["layout"]["dof"], "C": p["layout"]["C"]}
    examples = [k for k in mex if isinstance(mex[k], dict)]

    def multifield_numbers(p):
        return {**numbers(p["spmv64"]),
                "max_rel_err_f64": p["spmv64"]["rel"],
                "max_rel_err_f32": p["spmv32"]["rel"],
                "G": p["G"], "n_off": p["n_off"], "C": p["C"],
                "dof": p["dof"], "launches": p["launches"],
                "f32": numbers(p["spmv32"])}
    print(json.dumps({"kernels": [{
        "name": "offset_spmv", "route": "cuda",
        "source": "metafem_torch/csrc/offset_spmv.cu",
        "replaces": "metafem/linsolve/pallas_spmv.py:111",
        # the main path is the flagship: its launches and its f32 fine
        # operator at 1,282,401 rows
        "launches": flag["launches"],
        "max_abs_err": s32["max_abs_err"],
        "ms": s32["ms"], "plain_ms": s32["plain_ms"],
        "bound_ms": s32["bound_ms"], "bound_by": s32["bound_by"],
        "library_ms": s32["library_ms"],
        # bound_ms counts the structural entries, packed_bound_ms what
        # the packed layout moves, storage_bound_ms all the stored values
        # (see _spmv_numbers)
        "flagship_f32": numbers(s32),
        "launches_by_type": flag["path_launches"],
        "launches_per_step": flag["per_step"],
        "f64_flagship": numbers(flag["spmv64"]),
        "readme_step_launches": sl["launches"],
        "readme_f64": numbers(kern),
        "hyperelastic_3d": {
            **numbers(p3d["spmv64"]),
            "max_rel_err_f64": p3d["spmv64"]["rel"],
            "max_rel_err_f32": p3d["spmv32"]["rel"],
            "launches": p3d["launches"], "launches_step1": p3d["launches1"],
            "launches_step2": p3d["launches2"],
            "iters_step1": p3d["iters1"],
            "G": p3d["G"], "n_off": p3d["n_off"], "C": p3d["C"],
            "n_cp": p3d["n_cp"], "dof": p3d["dof"],
            "f32": numbers(p3d["spmv32"])},
        "thermal_elasticity_3d": multifield_numbers(mfp["te"]),
        "cavity_2d": multifield_numbers(mfp["cavity"]),
        # the unstructured path's one dense group (59 offsets, Morton
        # numbering), the tangent's and A_td's tailless views
        "unstructured": {
            **numbers(uns["spmv64"]),
            "max_rel_err_f64": uns["spmv64"]["rel"],
            "max_rel_err_f32": uns["spmv32"]["rel"],
            "launches": uns["path_launches"]["packed"],
            "launches_by_type": uns["path_launches_by_type"]["packed"],
            "launches_per_step": [t["launches"]["packed"]
                                  for t in uns["trials"]],
            "dof": uns["dof"], "n_dense": uns["n_dense"],
            "f32": numbers(uns["spmv32"])},
        # the mesh-reading examples' first tangents (f64; the dense group
        # of an operator with a tail), their paths' launches
        **{k: example_numbers(mex[k]) for k in examples},
        # the multi-device phase: leg A's 1-rank sharded flagship step,
        # leg B's windows (2 gloo ranks on this card): each rank's f32
        # fine operator and f64 A_td of the flagship, the pikachu
        # brick's f64 A_td, its launches in the sharded step
        "multidevice": {"leg_a": mdp["A"],
                        "f32_fine": mdp["B"]["packed_f32"],
                        "f64_A_td": mdp["B"]["packed_f64"],
                        "pikachu_f64_A_td": mdp["B"]["pikachu_packed_f64"],
                        # the float64 flagship's jitted step with per-step
                        # multigrid setup (its tangent's window), and the
                        # solver menu (the Jacobi-scaled tangent's window)
                        "flagship_jitted_f64": mdp["B"]["jitted_f64"],
                        "flagship_menu_f64": mdp["B"]["menu_f64"]},
        "max_rel_err_f64": max(kern["max_rel_err_f64"], flag["spmv64"]["rel"],
                               p3d["spmv64"]["rel"],
                               mfp["te"]["spmv64"]["rel"],
                               mfp["cavity"]["spmv64"]["rel"],
                               uns["spmv64"]["rel"],
                               *(mex[k]["spmv64"]["rel"] for k in examples)),
        "max_rel_err_f32": max(kern["max_rel_err_f32"], s32["rel"],
                               p3d["spmv32"]["rel"],
                               mfp["te"]["spmv32"]["rel"],
                               mfp["cavity"]["spmv32"]["rel"],
                               uns["spmv32"]["rel"])}, {
        "name": "gather_probe", "route": "cuda",
        "source": "metafem_torch/csrc/gather_probe.cu",
        "replaces": "benchmarks/pallas_gather_probe.py:25",
        "launches": gat["launches"], "max_abs_err": gat["max_abs_err"],
        "ms": gat["ms"], "plain_ms": gat["plain_ms"],
        "bound_ms": gat["bound_ms"], "bound_by": "bytes",
        "library_ms": gat["library_ms"], "shape": gat["shape"],
        "variant": "window", "cluster": gat["cluster"],
        "floor_ms": gat["floor_ms"],
        "chosen_cluster": gat["chosen_cluster"],
        # the main path's counts with uniform indices, then the 3D
        # tangent's own read stream
        "main_path": gat["main_path"] + p3d["gather"],
        "rows": gat["rows"]}, {
        "name": "df_offset_spmv", "route": "cuda",
        "source": "metafem_torch/csrc/offset_spmv.cu",
        "replaces": ("metafem/linsolve/twofloat.py:236 (XLA-fused, no "
                     "Pallas kernel)"),
        # the df32 flagship path's launches; the numbers of its A_td
        "launches": flag["df32"]["launches"],
        "max_abs_err": dfs["max_abs_err"], "ms": dfs["ms"],
        "plain_ms": dfs["plain_ms"], "bound_ms": dfs["bound_ms"],
        "bound_by": dfs["bound_by"],
        # no PyTorch call computes a two-float product: the float64
        # kernel and CSR torch.mv in float64 on the same entries stand
        # beside it
        "library_ms": None, "f64_kernel_ms": dfs["f64_kernel_ms"],
        "csr_f64_ms": dfs["csr_f64_ms"], "cold_ms": dfs["cold_ms"],
        "nnz": dfs["nnz"], "worst_vs_plain": dfs["worst_vs_plain"],
        "worst_vs_f64_kernel": dfs["worst_vs_f64_kernel"],
        # the kernel's registers and occupancy
        **{k: dfs[k] for k in ("registers", "spill_bytes", "blocks_per_sm",
                               "warps_per_sm")},
        "launches_per_step": [t["df_launches"]
                              for t in flag["df32"]["trials"]],
        "df32_flagship": {k: v for k, v in flag["df32"].items()
                          if k != "trials"},
        # leg B's df32 flagship step: each rank's window of A_td
        "multidevice": mdp["B"]["packed_df"],
        "cavity_2d": {**{k: v for k, v in mfp["cavity"]["df32"].items()
                         if k != "df_spmv"},
                      **mfp["cavity"]["df32"]["df_spmv"]},
        # the df32 unstructured path's one dense group (59 offsets,
        # Morton numbering): its launches there, its A_td's numbers
        "unstructured": {
            **uns["df_dense"],
            "launches": uns["df32"]["path_launches"]["packed_df"]["df32"],
            "launches_per_step": [t["launches"]["packed_df"]["df32"]
                                  for t in uns["df32"]["trials"]]}}, {
        "name": "bsr_tail_spmv", "route": "cuda",
        "source": "metafem_torch/csrc/bsr_tail.cu",
        "replaces": ("metafem/linsolve/block_offset.py:372 (_blk_tail_mv, "
                     "XLA; no Pallas kernel)"),
        # the f64-residual unstructured path's launches; the numbers of
        # its f32 tangent's tail at 1,369,650 DOF
        "launches": uns["path_launches"]["bsr_tail"],
        "max_abs_err": uns["bsr32"]["max_abs_err"],
        "ms": uns["bsr32"]["ms"], "plain_ms": uns["bsr32"]["plain_ms"],
        "bound_ms": uns["bsr32"]["bound_ms"],
        "bound_by": uns["bsr32"]["bound_by"],
        # CSR torch.mv over the tail's structural entries; bound_ms
        # counts those entries, packed_bound_ms the tail plan's bytes,
        # storage_bound_ms the whole BSR storage (see _bsr_numbers)
        "library_ms": uns["bsr32"]["library_ms"],
        "f32_tangent": uns["bsr32"], "f64_A_td": uns["bsr64"],
        "launches_per_step": [t["launches"] for t in uns["trials"]],
        # the whole product A.mv (dense group + tail) against CSR
        "whole_mv": uns["whole_mv"],
        # the mesh-reading examples whose first tangent has a BSR tail
        **{k: example_tail(mex[k]) for k in examples if "bsr64" in mex[k]},
        # leg B's pikachu step: each rank's window of the f64 A_td's tail
        "multidevice": mdp["B"]["tail_f64"],
        "unstructured": {k: v for k, v in uns.items()
                         if k not in ("bsr32", "bsr64", "spmv32", "spmv64",
                                      "trials", "whole_mv", "df32",
                                      "df_tail", "df_dense")},
        "steps": uns["trials"]}, {
        "name": "df_bsr_tail_spmv", "route": "cuda",
        "source": "metafem_torch/csrc/bsr_tail.cu",
        "replaces": ("metafem/linsolve/twofloat.py:236 (df_offset_mv, its "
                     "BSR branch :276-300; XLA, no Pallas kernel)"),
        # the df32 unstructured path's launches; the numbers of its A_td
        "launches": uns["df32"]["path_launches"]["bsr_tail_df"]["df32"],
        "max_abs_err": uns["df_tail"]["max_abs_err"],
        "ms": uns["df_tail"]["ms"], "plain_ms": uns["df_tail"]["plain_ms"],
        "bound_ms": uns["df_tail"]["bound_ms"],
        "bound_by": uns["df_tail"]["bound_by"],
        # no PyTorch call computes a two-float product: the float64 tail
        # kernel and CSR torch.mv in float64 on the same entries stand
        # beside it
        "library_ms": None, **{k: v for k, v in uns["df_tail"].items()
                               if k not in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "max_abs_err")},
        "launches_per_step": [t["launches"] for t in uns["df32"]["trials"]],
        "df32_unstructured": {k: v for k, v in uns["df32"].items()
                              if k != "trials"},
        "steps": uns["df32"]["trials"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
