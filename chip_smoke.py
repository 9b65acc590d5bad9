#!/usr/bin/env python3
"""Smoke run of the PyTorch port (metafem_torch) on one CUDA card.

    python3 chip_smoke.py

from the root of the repository.  Phases, one line or more each:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the hand-written kernels are compiled with nvcc (timed);
3. kernel parity: each kernel against its plain PyTorch version on the
   card, on the operators the main path gives it, with times from CUDA
   events beside the bound and a library call computing the same thing;
4. the slice: the README's thermal Newton step at nel=(400,200) (321,201
   DOF, f64) through ``metafem_torch.examples.thermal_2d.solve`` on the
   card, with the kernels' launch counts, the FEATool midline check and a
   bitwise repeat of the step;
5. the ``kernels`` JSON line, then the device JSON line last.

Every failure raises and exits non-zero.  Without CUDA, or without the
``metafem_torch`` package beside this file, the script exits non-zero
and prints no result.  The phases are functions of ``device`` and
``nel`` so that tests can run the slice phase small on the CPU.
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
PEAK_FLOPS_F64 = 34e12


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
    """Median device time of one call, from CUDA events around each of
    ``reps`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


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
    from metafem_torch.linsolve import offset_spmv
    t0 = time.perf_counter()
    offset_spmv.load_library()
    sec = time.perf_counter() - t0
    flags = " ".join(offset_spmv.NVCC_FLAGS)
    print(f"[build] offset_spmv.cu with nvcc {flags}: {sec:.2f} s")
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
    t_ops = n_flops / PEAK_FLOPS_F64 * 1e3
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
    offset_spmv.group_mv.launches = 0
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    _import_port()
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    env = phase_environment(device)
    build_s = phase_build()
    t = time.perf_counter()
    kern = phase_kernel(device)
    kernel_s = time.perf_counter() - t
    t = time.perf_counter()
    sl = phase_slice(device)
    slice_s = time.perf_counter() - t
    print(f"[time] build {build_s:.2f} s, kernel parity {kernel_s:.2f} s, "
          f"slice {slice_s:.2f} s, total {time.perf_counter() - t_start:.2f}"
          f" s on {env['smi']}")
    print(json.dumps({"kernels": [{
        "name": "offset_spmv", "route": "cuda",
        "source": "metafem_torch/csrc/offset_spmv.cu",
        "replaces": "metafem/linsolve/pallas_spmv.py:53",
        "launches": sl["launches"],
        "max_abs_err": kern["max_abs_err"],
        # one measurement under two keys: "ms" is the common kernels-line
        # schema's name, "kernel_ms" the name this slice's records use
        "ms": kern["kernel_ms"], "kernel_ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "max_rel_err_f64": kern["max_rel_err_f64"],
        "max_rel_err_f32": kern["max_rel_err_f32"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
