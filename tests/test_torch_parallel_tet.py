"""The unstructured leg of ``parallel.dryrun`` (see
test_torch_parallel.py) against the reference package, on 4 gloo ranks
on the CPU: the refined step with the auxiliary-space multigrid
(smooth="sparse") on the jittered tet brick (6, 4, 4) with ghost control
points padding it to the rank count (tests/test_parallel.py's
test_refined_rowshard_auxmg_tet); its scalar COO tail runs on the ranks'
windows.  The sharded x within 1e-8·max|x| of the reference's
single-device step (the reference test's bar), after the dry run's own
checks.  The reference's auxiliary-space setup draws its start vectors
from jax.random and the port's from its own seeds: both steps converge
below 1e-9, so the bar holds on the converged x.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metafem.linsolve import krylov as ref_krylov
from test_parallel import _make_tet_thermal
from test_torch_parallel import RANKS, check_leg, run_dryrun

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_tet")
    return out, run_dryrun(out, ("auxmg",))


def reference_auxmg():
    dom = _make_tet_thermal(lattice_pad=RANKS)
    dom.converge_tol = 1e-9
    dom.freeze_linear_tangent()
    dom.freeze_refined_residual()
    dom.setup_auxmg(smooth="sparse")
    step = dom.make_refined_step(sv_func=ref_krylov.bicgstab, maxiter=80,
                                 max_refine=10, max_pass=1, precond="auxmg")
    x, _, res, _ = step(dom._runtime_state(), jnp.asarray(dom.x),
                        jnp.float64(0.0), jnp.float64(1.0))
    assert float(res) < 1e-9
    return np.asarray(x)


def test_sharded_auxmg_step_matches_reference(sharded_run):
    out, summary = sharded_run
    check_leg(out, summary, "auxmg", reference_auxmg())
    lay = summary["legs"]["auxmg"]["layout"]
    assert lay["rows"] * RANKS == lay["n"]
    assert lay["storage"] < lay["n_storage"]
