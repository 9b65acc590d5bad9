"""The rest of the multi-device layer of the PyTorch port against the
reference package: the per-step multigrid setup of a row-sharded step,
the solvers that the row-sharded path lacked (IDR(s) original, LSQR with
its windowed transposed product, CGS2, TFQMR) and whole steps on states
that ``shard_domain_state`` cut to the row windows.

One run of ``parallel.dryrun`` on 4 gloo ranks on the CPU
(``torch.distributed.run --standalone``, one torch thread per rank, a
300 s limit) of its legs ``mg_fresh_step``, ``whole_on_cut``,
``solver_menu`` and ``mg_fresh_c2``.  The dry run has held each sharded
result to the port's unsharded one in the same rank (1e-8 x max|x|,
iteration counts equal on every rank, the window setup's levels >= 1
bitwise the whole setup's, each whole step on a cut state bitwise the
same step on the state's uncut twin); its records are checked here, and
its x are held to the reference's single-device results on the same
domain and inputs at tests/test_parallel.py's bar, 1e-8 x max|x|:

- ``mg_fresh_step``: ``make_jitted_step(precond="mg", mg_opts=
  {"max_coarse": 16}, static_k_linear=True)`` on the graft domain
  (``__graft_entry__._build_domain(nel=(4, 2), lattice_pad=4)``; its
  lattice (12, 5) coarsens once, so 2 levels);
- ``whole_on_cut``: the multigrid jitted step (``reuse_mg``) and the
  refined step on the graft domain, against the reference's;
- ``solver_menu``: each solver (tol 1e-10, maxiter 1000) on the
  right-Jacobi scaled tangent at x, its shadows drawn from the
  reference's keys (``test_torch_krylov_menu._shadows``) and handed to
  the dry run as a file;
- ``mg_fresh_c2``: the C=2 cantilever with block smoothing, 3 levels,
  sharded against whole in the same rank only (the reference's helper
  has no ``lattice_pad``; the whole setup's parity at C=2 is
  test_torch_multigrid.py's).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from metafem.linsolve import krylov as ref_krylov
from metafem.linsolve.precond import pr_jacobi as ref_pr_jacobi
from metafem_torch.parallel import dryrun
from test_multigrid import _tangent
from test_torch_krylov_menu import _shadows
from test_torch_parallel import RANKS, run_dryrun

torch.set_num_threads(2)

LEGS = ("mg_fresh_step", "whole_on_cut", "solver_menu", "mg_fresh_c2")
TOL_X = 1e-8


@functools.lru_cache(maxsize=None)
def reference() -> dict:
    """The reference's single-device results on the graft domain: the
    tangent at x and the menu's solves of its right-Jacobi scaling, the
    per-step multigrid jitted step, the frozen multigrid jitted step and
    the refined step."""
    f64 = jnp.float64
    dom = graft._build_domain(nel=(RANKS, 2), lattice_pad=RANKS)
    dom.converge_tol = 1e-9
    A, residue = _tangent(dom)
    As, _ = ref_pr_jacobi(A, None)
    n = residue.shape[0]
    out = {"n": n, "menu": {}, "shadows": {}}
    for name in dryrun.MENU:
        kw = _shadows(name, n)
        out["shadows"].update(kw)
        x, it, _ = getattr(ref_krylov, name)(As, residue, tol=1e-10,
                                             maxiter=1000)
        out["menu"][name] = (np.asarray(x), int(it))
    args = (dom.x, f64(0.0), f64(1.0))
    dom.freeze_linear_tangent()
    out["mg_fresh_step"] = dom.make_jitted_step(
        sv_func=ref_krylov.bicgstab, maxiter=200, max_newton=6, max_pass=2,
        precond="mg", mg_opts={"max_coarse": 16}, static_k_linear=True)(
            dom._runtime_state(), *args)[0]
    dom.setup_mg(tune=False)
    out["mg_step"] = dom.make_jitted_step(
        sv_func=ref_krylov.bicgstab, maxiter=200, max_newton=6, max_pass=2,
        precond="mg", reuse_mg=True, static_k_linear=True)(
            dom._runtime_state(), *args)[0]
    dom.freeze_refined_residual()
    out["refined"] = dom.make_refined_step(
        sv_func=ref_krylov.bicgstab, maxiter=200, max_refine=10, max_pass=1,
        precond="mg")(dom._runtime_state(), jnp.asarray(dom.x),
                      f64(0.0), f64(1.0))[0]
    return out


@pytest.fixture(scope="module")
def menu_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_menu")
    ref = reference()
    shadows = os.path.join(out, "shadows.npz")
    np.savez(shadows, **ref["shadows"])
    return out, run_dryrun(out, LEGS, ["--shadows", shadows])


def _close(x, x_ref):
    x_ref = np.asarray(x_ref, np.float64)
    assert x.shape == x_ref.shape
    np.testing.assert_allclose(x, x_ref, rtol=0,
                               atol=TOL_X * np.abs(x_ref).max())


def test_mg_fresh_step_matches_reference(menu_run):
    out, summary = menu_run
    rec = summary["legs"]["mg_fresh_step"]
    assert summary["ranks"] == RANKS
    assert rec["res"] < 1e-9 and rec["res_whole"] < 1e-9
    assert rec["max_rel_vs_whole"] <= TOL_X
    assert rec["iters_all_ranks"] == [rec["iters"]] * RANKS
    setup = rec["setup"]
    assert setup["n_levels"] == 2 and setup["coarse_max_abs_diff"] == 0.0
    assert setup["omega0_rel_diff"] <= 1e-12
    # the window probes and the fine level ran on the row windows
    assert rec["comm"]["all_gather_calls"] > 0
    x = np.load(os.path.join(out, "mg_fresh_step.npz"))["x"]
    _close(x, reference()["mg_fresh_step"])


@pytest.mark.parametrize("step", ["mg_step", "refined", "refined_df32"])
def test_whole_step_on_cut_state(menu_run, step):
    """Bitwise the whole step on the uncut twin (the dry run raised
    otherwise; the arrays are compared again here), every cut cache
    gathered back; the graft steps within 1e-8 x max|x| of the
    reference's."""
    out, summary = menu_run
    rec = summary["legs"]["whole_on_cut"][step]
    assert rec["bitwise"] and rec["res"] < 1e-9
    assert rec["iters_all_ranks"] == [rec["iters"]] * RANKS
    assert {"K_linear_td", "mg_frozen"} <= set(rec["gathered"])
    want = {"mg_step": set(),
            "refined": {"A", "b"},
            "refined_df32": {"A_hi", "A_lo", "b_hi", "b_lo"}}[step]
    assert want <= set(rec["gathered"])
    assert {"refined." + k for k in want} <= set(rec["cut"])
    got = np.load(os.path.join(out, "whole_on_cut.npz"))
    np.testing.assert_array_equal(got[step + "_x"], got[step + "_x_twin"])
    if step != "refined_df32":
        _close(got[step + "_x"], reference()[step])


@pytest.mark.parametrize("name", dryrun.MENU)
def test_solver_menu_matches_reference(menu_run, name):
    out, summary = menu_run
    rec = summary["legs"]["solver_menu"][name]
    assert rec["iters_all_ranks"] == [rec["iters"]] * RANKS
    assert rec["max_rel_vs_whole"] <= TOL_X
    assert rec["res"] <= 1e-10
    if name == "lsqr":
        # the windowed transposed products summed onto the windows
        assert rec["comm"]["reduce_scatter_calls"] > 0
    y = np.load(os.path.join(out, "solver_menu.npz"))[name]
    _close(y, reference()["menu"][name][0])


def test_mg_fresh_c2_sharded_matches_whole(menu_run):
    out, summary = menu_run
    rec = summary["legs"]["mg_fresh_c2"]
    assert rec["res"] < 1e-9 and rec["res_whole"] < 1e-9
    assert rec["max_rel_vs_whole"] <= TOL_X
    assert rec["iters_all_ranks"] == [rec["iters"]] * RANKS
    setup = rec["setup"]
    assert setup["n_levels"] >= 3 and setup["channels"] == 2
    assert setup["coarse_max_abs_diff"] == 0.0
    got = np.load(os.path.join(out, "mg_fresh_c2.npz"))
    np.testing.assert_allclose(got["x"], got["x_whole"], rtol=0,
                               atol=TOL_X * np.abs(got["x_whole"]).max())
