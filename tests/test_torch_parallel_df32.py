"""The two-float leg of ``parallel.dryrun`` (see test_torch_parallel.py)
against the reference package, on 4 gloo ranks on the CPU: the refined
multigrid step with two-float residuals on the float32 strip (72, 32),
lattice_pad=8 (tests/test_parallel.py's test_refined_rowshard_df32_mode).
Its nonlinear tangent blocks are assembled on the ranks' element blocks
and land on their row windows by reduce-scatter.  The sharded x within
1e-8·max|x| of the reference's single-device step (the reference test's
bar), after the dry run's own checks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metafem.linsolve import krylov as ref_krylov
from metafem.linsolve import twofloat as ref_tf
from test_parallel import _make_strip
from test_torch_parallel import RANKS, check_leg, run_dryrun

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_df32")
    return out, run_dryrun(out, ("refined_df32",))


def reference_df32():
    dom = _make_strip((72, 32), lattice_pad=8, dtype=jnp.float32)
    dom.converge_tol = 1e-9
    dom.freeze_linear_tangent()
    dom.setup_mg(tune=False)
    dom.freeze_refined_residual()
    step = dom.make_refined_step(sv_func=ref_krylov.bicgstab, maxiter=100,
                                 max_refine=10, max_pass=1, precond="mg",
                                 residual_mode="df32")
    x0 = ref_tf.df_from_f64(np.asarray(dom.x, np.float64))
    x, _, res, _ = step(dom._runtime_state(), x0, jnp.float64(0.0),
                        jnp.float64(1.0))
    assert float(res) < 1e-9
    return np.asarray(ref_tf.df_to_f64(x))


def test_sharded_df32_step_matches_reference(sharded_run):
    out, summary = sharded_run
    check_leg(out, summary, "refined_df32", reference_df32())
    rec = summary["legs"]["refined_df32"]
    lay = rec["layout"]
    assert lay["rows"] * RANKS == lay["n"]
    assert lay["storage"] < lay["n_storage"]
    assert lay["inv_diag"][-1] * RANKS == lay["n"]
    assert rec["comm"]["reduce_scatter_calls"] > 0
