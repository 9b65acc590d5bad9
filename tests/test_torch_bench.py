"""The port's flagship benchmark (``python3 -m metafem_torch.bench``) on
the CPU at nel=(16,8), against the reference's flagship flow.

The reference flow is bench.py's production path (freeze_linear_tangent,
setup_mg(tune=False), freeze_refined_residual, a converge-once BiCGStab
refined step, setup_mg() at the converged state, then the Chebyshev step
from x * (1 + 1e-4 * (t + 2))), written out here with bench.py's
configuration because bench.py itself runs only at nel=(800,400) and
rewrites its caches.  The port must print one JSON line with the
metric's name and a final residual below the reference's 1e-6 bar, and
its last trial's x must agree with the reference's step from the same
perturbation within 1e-10 * max|x|: both converge far below 1e-6 (to
~1e-8), from multigrid states whose random start vectors differ.
"""

import json

import numpy as np
import torch

import jax.numpy as jnp

import metafem as ref_mf
from metafem import Bilinear
from metafem.linsolve import krylov as ref_krylov
from metafem.solver.domain import FEM_Domain
from metafem_torch import bench

torch.set_num_threads(2)

NEL = (16, 8)


def _reference_flagship(nel):
    """bench.py:132-173 at ``nel``."""
    L1, L2 = 0.02, 0.01
    vert, conn = ref_mf.make_square((L1, L2), nel)
    geo = ref_mf.construct_total_mesh(vert, conn)
    dom = FEM_Domain(2, dtype=jnp.float32)
    wp = dom.add_workpiece(geo)
    eps = 1e-9
    ends = ref_mf.select_facets(geo, lambda c: (c[:, 0] < eps)
                                | (c[:, 0] > L1 - eps))
    top = ref_mf.select_facets(geo, lambda c: c[:, 1] > L2 - eps)
    bg_fix = dom.add_boundary(wp, ends)
    bg_top = dom.add_boundary(wp, top)
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    n = dom.sym("n")
    i = ref_mf.index("i")
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
    dom.converge_tol = 1e-6
    return dom


def _reference_step_x(nel, trial):
    dom = _reference_flagship(nel)
    dom.freeze_linear_tangent()
    dom.setup_mg(tune=False)
    dom.freeze_refined_residual()
    kw = dict(maxiter=60, max_refine=10, max_pass=1)
    step_c = dom.make_refined_step(sv_func=ref_krylov.bicgstab, **kw)
    x_c, _, res_c, _ = step_c(dom._runtime_state(),
                              dom.x.astype(jnp.float64),
                              jnp.float64(0.0), jnp.float64(1.0))
    dom.x = np.asarray(x_c)
    dom.setup_mg()
    assert dom._mg_cheb is not None
    step = dom.make_refined_step(sv_func=ref_krylov.chebyshev, **kw)
    x, _, res, _ = step(dom._runtime_state(),
                        x_c * (1.0 + 1e-4 * (trial + 2)),
                        jnp.float64(0.0), jnp.float64(1.0))
    assert float(res) < 1e-6
    return np.asarray(x)


def test_bench_emits_one_json_line_and_matches_reference(capsys):
    record = bench.main(["--nel", str(NEL[0]), str(NEL[1]),
                         "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "newton_step_dofs_per_sec_1mdof_tol1e-6"
    assert out["final_residual"] < 1e-6
    assert out["timing"] == "single_dispatch"
    assert out["inner_solver"] == "chebyshev"
    assert len(out["step_refines"]) == 3 and out["cheb_rate"] < 0.93
    assert set(out["one_time_s"]) == {
        "setup", "freeze_linear_tangent", "setup_mg",
        "freeze_refined_residual", "converge_once", "tune_mg"}
    # the lattice numbering keeps the serendipity centre slots as ghosts
    assert out["n_dof"] == (2 * NEL[0] + 1) * (2 * NEL[1] + 1)
    x_ref = _reference_step_x(NEL, trial=2)
    x = record["_x"].numpy()
    np.testing.assert_allclose(x, x_ref, rtol=0,
                               atol=1e-10 * np.abs(x_ref).max())
