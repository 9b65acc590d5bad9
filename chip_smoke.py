#!/usr/bin/env python3
"""Smoke run of the PyTorch port (metafem_torch) on one CUDA card.

    python3 chip_smoke.py

from the root of the repository.  Phases, one line or more each:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: both hand-written kernels compiled with nvcc, in parallel;
3. kernel parity: the block-offset SpMV against its plain PyTorch
   version on the README thermal operator (f64, f32) and a C=2 elastic
   one, with times from CUDA events beside the bound and a CSR library
   product;
4. the gather probe (``metafem_torch.benchmarks.gather_probe``) at the
   TPU probe's two sizes: both variants (or the refused shared window),
   bitwise parity, times, M gathers/s, bound and ``torch.index_select``;
5. the README thermal Newton step at nel=(400,200) (321,201 DOF, f64)
   with the FEATool check and a bitwise repeat;
6. the ``bench.py`` flagship through ``metafem_torch.bench`` at
   nel=(800,400) (1,282,401 DOF, f32 domain, f64 residuals): each
   one-time phase, the converge-once pass, the Chebyshev tune, the
   timed step (final residual below 1e-6), SpMV launches per step split
   f32/f64, launches per V-cycle, where the step's time goes, a bitwise
   repeat, and the SpMV's parity and time at this size;
7. the ``kernels`` JSON line, then the device JSON line last.

Each path (gather probe, README step, flagship) runs with the kernels'
launch counts set to 0 just before it and read just after; every path
must have launched its kernel.  Every failure raises and exits non-zero.
Without CUDA, or without the ``metafem_torch`` package beside this file,
the script exits non-zero and prints no result.  The phases are
functions of ``device`` and ``nel`` so that tests can run the slice
phase small on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

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


def _time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Device time of one call: the port's CUDA-event timer over
    back-to-back calls (metafem_torch/benchmarks/timing.py)."""
    from metafem_torch.benchmarks.timing import cuda_time_ms
    return cuda_time_ms(fn, reps=reps, warmup=warmup)


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
    """Both kernels' sources compiled at once (one nvcc each), then
    loaded."""
    from concurrent.futures import ThreadPoolExecutor
    from metafem_torch import buildlib
    from metafem_torch.benchmarks import gather_probe
    from metafem_torch.linsolve import offset_spmv
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(buildlib.build_cuda, ("offset_spmv", "gather_probe")))
    offset_spmv.load_library()
    gather_probe.load_library()
    sec = time.perf_counter() - t0
    flags = " ".join(buildlib.NVCC_FLAGS)
    print(f"[build] offset_spmv.cu and gather_probe.cu with nvcc {flags}: "
          f"{sec:.2f} s")
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
    """(max |kernel - plain| / max |plain|, max abs error, y) for every
    dense group of A at x, kernel and plain version on the same inputs."""
    from metafem_torch.linsolve import offset_spmv
    vals = A.vals.to(dtype)
    x = x.to(dtype)
    worst_rel, worst_abs = 0.0, 0.0
    for grp in A.layout.pallas_groups:
        sl = slice(grp.dof_offset, grp.dof_offset + grp.n_vars * grp.n_cp)
        xw = x[sl].view(grp.n_vars, grp.n_cp)
        y = offset_spmv.group_mv(vals, xw, grp)
        y2 = offset_spmv.group_mv(vals, xw, grp)
        torch.cuda.synchronize()
        if not torch.equal(y, y2):
            raise AssertionError("offset_spmv: two launches on one input "
                                 "differ")
        n_slab = len(grp.units) * grp.n_off * grp.n_cp
        slab = vals[grp.base:grp.base + n_slab].view(
            len(grp.units), grp.n_off, grp.n_cp)
        ref = offset_spmv.group_mv_plain(slab, xw, grp, torch.empty_like(y))
        err = float((y - ref).abs().max())
        scale = float(ref.abs().max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
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

    (grp,) = A.layout.pallas_groups
    G, n_off, C, n_cp = len(grp.units), grp.n_off, grp.n_vars, grp.n_cp
    xw = x.view(C, n_cp)
    out = torch.empty_like(xw)
    slab = A.vals[grp.base:grp.base + G * n_off * n_cp].view(G, n_off, n_cp)
    kernel_ms = _time_ms(lambda: offset_spmv.group_mv(A.vals, xw, grp,
                                                      out=out))
    plain_ms = _time_ms(lambda: offset_spmv.group_mv_plain(slab, xw, grp,
                                                           out))
    csr = A.to_scipy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # "beta state"
        A_csr = torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr, dtype=torch.int64),
            torch.as_tensor(csr.indices, dtype=torch.int64),
            torch.as_tensor(csr.data), size=csr.shape,
            check_invariants=True).to(device)
    y_lib = torch.mv(A_csr, x)
    y_ker = A.mv(x)
    lib_err = float((y_lib - y_ker).abs().max() / y_ker.abs().max())
    if not lib_err <= 1e-12:
        raise AssertionError(f"CSR yardstick disagrees: {lib_err}")
    library_ms = _time_ms(lambda: torch.mv(A_csr, x))
    n_bytes = (G * n_off + 2 * C) * n_cp * A.vals.element_size()
    n_flops = 2 * G * n_off * n_cp
    t_bytes = n_bytes / _peak_bytes(torch.cuda.get_device_name(device)) * 1e3
    t_ops = n_flops / PEAK_FLOPS["float64"] * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[kernel] offset_spmv thermal {nel} f64 (G={G}, n_off={n_off}, "
          f"C={C}, n_cp={n_cp}): kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, CSR torch.mv {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB), "
          f"{time.perf_counter() - t0:.1f} s")
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": abs64, "max_rel_err_f64": max(rel64, rel_e),
            "max_rel_err_f32": rel32}


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
            "setup_s": t1 - t0, "step_s": t2 - t1, "repeat_s": repeat_s}


def phase_gather(device) -> dict:
    """The gather probe's own entry point (``gather_probe.run``) with its
    launch count set to 0 before and read after; each variant bitwise
    equal to the plain version, or the window refused above the
    shared-memory limit."""
    from metafem_torch.benchmarks import gather_probe
    t0 = time.perf_counter()
    gather_probe.gather.launches = 0
    rows = gather_probe.run(device)
    launches = gather_probe.gather.launches
    if launches <= 0:
        raise AssertionError("the gather probe launched no kernel")
    ran = [r for r in rows if "ms" in r]
    refused = [r for r in rows if "error" in r]
    if len(ran) < 3 or [(r["n_win"], r["variant"]) for r in refused] \
            not in ([], [(65536, "window")]):
        raise AssertionError(f"unexpected gather probe rows: {rows}")
    first = next(r for r in ran if r["variant"] == "window")
    print(f"[gather] {launches} launches, {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "rows": rows, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "library_ms": first["library_ms"],
            "bound_ms": first["bound_ms"],
            "max_abs_err": max(r["max_abs_err"] for r in ran),
            "shape": (first["n_win"], first["n_idx"])}


def _spmv_at_size(A, rng, device, label) -> dict:
    """The SpMV kernel on the operator A (its own float type) against
    the plain version and a CSR library product, with its bound."""
    from metafem_torch.linsolve import offset_spmv
    dtype = A.vals.dtype
    x = torch.as_tensor(rng.standard_normal(A.n), dtype=dtype,
                        device=device)
    rel, err = _parity(A, x, dtype)
    (grp,) = A.layout.pallas_groups
    G, n_off, C, n_cp = len(grp.units), grp.n_off, grp.n_vars, grp.n_cp
    xw = x.view(C, n_cp)
    out = torch.empty_like(xw)
    slab = A.vals[grp.base:grp.base + G * n_off * n_cp].view(G, n_off, n_cp)
    kernel_ms = _time_ms(lambda: offset_spmv.group_mv(A.vals, xw, grp,
                                                      out=out))
    plain_ms = _time_ms(lambda: offset_spmv.group_mv_plain(slab, xw, grp,
                                                           out), reps=10)
    csr = A.to_scipy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # "beta state"
        A_csr = torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr, dtype=torch.int64),
            torch.as_tensor(csr.indices, dtype=torch.int64),
            torch.as_tensor(csr.data, dtype=dtype), size=csr.shape,
            check_invariants=True).to(device)
    del csr
    library_ms = _time_ms(lambda: torch.mv(A_csr, x))
    del A_csr
    size = A.vals.element_size()
    n_bytes = (G * n_off + 2 * C) * n_cp * size
    n_flops = 2 * G * n_off * n_cp
    t_bytes = n_bytes / _peak_bytes(torch.cuda.get_device_name(device)) * 1e3
    t_ops = n_flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[flagship] offset_spmv {label} {dtype} (G={G}, n_off={n_off}, "
          f"C={C}, n_cp={n_cp}): parity max|y-y_plain|/max|y| {rel:.3e} "
          f"(abs {err:.3e}); kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, CSR torch.mv {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB, "
          f"{100 * bound_ms / kernel_ms:.0f}% of the memory roofline)")
    return {"rel": rel, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    dt, results, _ = bench.measure(dom, step, x0)
    path_launches = dict(offset_spmv.group_mv.launches_by_dtype)
    n_dof = dom.pattern.basicfield_size
    for k, v in phases.s.items():
        print(f"[flagship] one-time {k}: {v:.3f} s")
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
    print(f"[flagship] phase {time.perf_counter() - t_all:.1f} s")
    return {"launches": sum(path_launches.values()),
            "path_launches": {str(k).split(".")[1]: v
                              for k, v in path_launches.items()},
            "per_step": per_step, "vcycle_launches": vc_launches,
            "step_ms": dt * 1e3, "final_residual": final,
            "spmv32": spmv32, "spmv64": spmv64}


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
    print("[time] " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
          + f", total {time.perf_counter() - t_start:.2f} s on {env['smi']}")
    s32 = flag["spmv32"]
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
        "launches_by_type": flag["path_launches"],
        "launches_per_step": flag["per_step"],
        "f64_flagship": {k: flag["spmv64"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "library_ms",
                          "max_abs_err")},
        "readme_step_launches": sl["launches"],
        "readme_f64": {"ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
                       "bound_ms": kern["bound_ms"],
                       "library_ms": kern["library_ms"]},
        "max_rel_err_f64": max(kern["max_rel_err_f64"], flag["spmv64"]["rel"]),
        "max_rel_err_f32": max(kern["max_rel_err_f32"], s32["rel"])}, {
        "name": "gather_probe", "route": "cuda",
        "source": "metafem_torch/csrc/gather_probe.cu",
        "replaces": "benchmarks/pallas_gather_probe.py:25",
        "launches": gat["launches"], "max_abs_err": gat["max_abs_err"],
        "ms": gat["ms"], "plain_ms": gat["plain_ms"],
        "bound_ms": gat["bound_ms"], "bound_by": "bytes",
        "library_ms": gat["library_ms"], "shape": gat["shape"],
        "variant": "window",
        "rows": gat["rows"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
