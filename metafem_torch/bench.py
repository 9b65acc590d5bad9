"""The flagship benchmark of the port: one refined Newton step of the
1.28M-DOF thermal strip, converged to 1e-6, on the card.

    python3 -m metafem_torch.bench                 # nel=(800,400), CUDA
    python3 -m metafem_torch.bench --nel 40 20 --device cpu

The counterpart of the repository's ``bench.py`` (the JAX package's,
which stays as it is), with the same configuration and metric name:
MetaFEM.jl's 2D thermal strip (examples/thermal_conduction/2D_Script.jl
geometry: conduction, fixed-temperature ends, convection and T^4
radiation on the top) at nel=(800,400), order-2 serendipity, 1,282,401
DOF, float32 domain.  The production path:

1. ``freeze_linear_tangent``, ``setup_mg(tune=False)``,
   ``freeze_refined_residual``;
2. one converge-once refined step with BiCGStab inner solves;
3. ``setup_mg()`` again at the converged state, with the Chebyshev tune;
4. the timed step: Chebyshev inner solves (BiCGStab when the tune
   certifies no enclosure), 3 trials from perturbed states
   ``x0 * (1 + 1e-4 * (t + 2))``, each timed on the host clock around
   the step and a ``torch.cuda.synchronize()``; the median is reported.

Prints one JSON line: the metric ``newton_step_dofs_per_sec_1mdof_tol1e-6``
with ``step_ms``, ``final_residual``, ``step_refines``,
``inner_solver``, ``cheb_interval``, ``cheb_rate``, ``one_time_s`` per
phase and ``timing: "single_dispatch"``.  No freeze cache and no chained
measurement: both exist in ``bench.py`` for the TPU's compile and
dispatch costs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.linsolve import krylov
from metafem_torch.solver.domain import FEM_Domain

METRIC = "newton_step_dofs_per_sec_1mdof_tol1e-6"
#: the flagship mesh: 1,282,401 DOF (bench.py:134)
NEL = (800, 400)
#: the fixed nominal that bench.py reports ``vs_baseline`` against
NOMINAL_DOF_PER_S = 1e6
STEP_KW = dict(maxiter=60, max_refine=10, max_pass=1)


def build_domain(nel=NEL, device=None,
                 dtype=torch.float32) -> FEM_Domain:
    """The compiled flagship domain (bench.py:132-173), T at the ambient
    temperature."""
    L1, L2 = 0.02, 0.01
    vert, conn = mf.make_square((L1, L2), nel)
    geo = mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(2, dtype=dtype, device=device)
    wp = dom.add_workpiece(geo)
    eps = 1e-9
    ends = mf.select_facets(geo, lambda c: (c[:, 0] < eps)
                            | (c[:, 0] > L1 - eps))
    top = mf.select_facets(geo, lambda c: c[:, 1] > L2 - eps)
    bg_fix = dom.add_boundary(wp, ends)
    bg_top = dom.add_boundary(wp, top)

    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    n = dom.sym("n")
    i = mf.index("i")
    T0 = 273.15
    k, h, Tw, h_pen = 3.0, 50.0, 900.0 + T0, 1000.0
    Tenv, em, sb = 50.0 + T0, 0.7, 5.669e-8
    dom.assign_workpiece_weakform(
        wp, -k * Bilinear(T.d(i), T.d(i)) + Bilinear(T, s))
    dom.assign_boundary_weakform(
        wp, bg_fix, h_pen * Bilinear(T, Tw - T)
        + k * Bilinear(T, n[i] * T.d(i)))
    dom.assign_boundary_weakform(
        wp, bg_top, h * Bilinear(T, Tenv - T)
        + em * sb * Bilinear(T, Tenv ** 4 - T ** 4))
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    dom.mesh_classical(itp_order=2, itg_order=5, itp_type="Serendipity")
    dom.assemble_global_variables()
    dom.compile()
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "T", np.full(mesh.n_cp, Tenv))
    dom.refresh_fields()
    dom.assemble_x()
    # the reference's convergence bar (pikachu.jl:106)
    dom.converge_tol = 1e-6
    return dom


def _sync(dom) -> None:
    if dom.device.type == "cuda":
        torch.cuda.synchronize(dom.device)


class Phases:
    """Seconds of each one-time phase, on the host clock with the device
    synchronised at both ends."""

    def __init__(self, dom, log=None):
        self.dom, self.log, self.s = dom, log, {}

    def run(self, key: str, fn, *args, **kwargs):
        _sync(self.dom)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(self.dom)
        self.s[key] = time.perf_counter() - t0
        if self.log is not None:
            print(f"[bench] {key}: {self.s[key]:.3f} s", file=self.log,
                  flush=True)
        return out


def prepare(dom: FEM_Domain, phases: Phases):
    """The freezes, the converge-once pass and the tune at the converged
    state.  Returns (x0 in float64, (converge-once residual, refines),
    the step to time, its inner solver's name)."""
    phases.run("freeze_linear_tangent", dom.freeze_linear_tangent)
    phases.run("setup_mg", dom.setup_mg, tune=False)
    phases.run("freeze_refined_residual", dom.freeze_refined_residual)
    step_c = dom.make_refined_step(sv_func=krylov.bicgstab, **STEP_KW)
    x_c, _, res_c, it_c = phases.run(
        "converge_once", step_c, dom._runtime_state(),
        dom.x.to(torch.float64), 0.0, 1.0)
    dom.x = x_c
    phases.run("tune_mg", dom.setup_mg)
    sv = krylov.chebyshev if dom._mg_cheb is not None else krylov.bicgstab
    step = dom.make_refined_step(sv_func=sv, **STEP_KW)
    return x_c, (res_c, it_c), step, sv.__name__


def perturbed(x0: torch.Tensor, trial: int) -> torch.Tensor:
    """The start of timed trial ``trial``: x0 * (1 + 1e-4 * (trial + 2))."""
    return x0 * (1.0 + 1e-4 * (trial + 2))


def measure(dom: FEM_Domain, step, x0: torch.Tensor, n_trials: int = 3):
    """Warm the step once, then time ``n_trials`` steps from perturbed
    states.  Returns (median seconds, [(seconds, residual, refines)],
    the last trial's x)."""
    state = dom._runtime_state()

    def timed(x1):
        _sync(dom)
        t0 = time.perf_counter()
        x, _, res, it = step(state, x1, 0.0, 1.0)
        _sync(dom)
        return time.perf_counter() - t0, res, it, x

    timed(perturbed(x0, -1))                   # warm: first launches
    results = [timed(perturbed(x0, t)) for t in range(n_trials)]
    med = float(np.median([r[0] for r in results]))
    return med, [r[:3] for r in results], results[-1][3]


def run(nel=NEL, device=None, log=sys.stderr) -> dict:
    """Build, freeze, converge once, tune and time the flagship step;
    returns the JSON record, plus the last trial's x under ``_x``."""
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    dom = build_domain(nel, device=device)
    _sync(dom)
    phases = Phases(dom, log)
    phases.s["setup"] = time.perf_counter() - t0
    x0, (res_c, it_c), step, label = prepare(dom, phases)
    if log is not None:
        print(f"[bench] converge once: residual {res_c:.3e} in {it_c} "
              f"refines; inner solver {label}", file=log, flush=True)
    dt, results, x = measure(dom, step, x0)
    n_dof = dom.pattern.basicfield_size
    cheb = dom._mg_cheb
    return {
        "metric": METRIC,
        "value": n_dof / dt,
        "unit": "DOF/s",
        "vs_baseline": n_dof / dt / NOMINAL_DOF_PER_S,
        "step_ms": dt * 1e3,
        "timing": "single_dispatch",
        "final_residual": results[-1][1],
        "inner_solver": label,
        "step_refines": [it for _, _, it in results],
        "cheb_tuned": cheb is not None,
        "cheb_interval": list(map(float, cheb[0])) if cheb else None,
        "cheb_rate": float(cheb[1]) if cheb else None,
        "converge_once_residual": res_c,
        "converge_once_refines": it_c,
        "n_dof": n_dof,
        "device": (torch.cuda.get_device_name(dom.device)
                   if dom.device.type == "cuda" else "cpu"),
        "one_time_s": phases.s,
        "one_time_total_s": time.perf_counter() - t_all,
        "_x": x}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nel", type=int, nargs=2, default=list(NEL))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    record = run(tuple(args.nel), device=args.device)
    print(json.dumps({k: v for k, v in record.items()
                      if not k.startswith("_")}), flush=True)
    return record


if __name__ == "__main__":
    main()
