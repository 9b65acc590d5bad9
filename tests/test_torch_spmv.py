"""Block-offset SpMV of the PyTorch port against the reference package.

The port's ``OffsetMatrix.mv`` on a CPU tensor runs the plain version of
the CUDA kernel (metafem_torch/linsolve/offset_spmv.py).  It is held to
the contract of tests/test_pallas_spmv.py: within 1e-14 * max|y| of both
reference forms (the XLA shifted-add path, FORCE=False, and the Pallas
kernel in interpret mode, FORCE=True) on the same storage values, and
within 1e-12 * max|y| of scipy.  The small meshes of the reference
fixtures fall below the dense-segment threshold (n_cp < 4096), so each
case also runs on a layout built with ``dense_min_n=0``, whose dense
groups carry every stencil offset.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metafem.linsolve import pallas_spmv
from metafem.solver.domain import FEM_Domain as RefDomain
from metafem_torch import interop

from test_multigrid import _thermal_domain, _elastic_domain_2d, _tangent

torch.set_num_threads(2)

CASES = {"thermal": (_thermal_domain, (12, 6)),
         "elastic": (_elastic_domain_2d, (8, 4))}


@pytest.fixture(autouse=True)
def _restore_force():
    prev = pallas_spmv.FORCE
    yield
    pallas_spmv.FORCE = prev


@functools.lru_cache(maxsize=None)
def _reference_operator(name, dense):
    """(reference OffsetMatrix, residue) of a fixture's tangent; with
    ``dense`` on a layout without the dense-segment size threshold."""
    builder, nel = CASES[name]
    with pytest.MonkeyPatch.context() as mp:
        if dense:
            orig = RefDomain.assemble_global_variables

            def dense_layout(self, **opts):
                return orig(self, dense_min_n=0, **opts)
            mp.setattr(RefDomain, "assemble_global_variables", dense_layout)
        dom = builder(nel=nel)
    A, residue = _tangent(dom)
    return A, np.array(residue)


@pytest.mark.parametrize("dense", [False, True], ids=["default", "dense"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mv_matches_reference(name, dense):
    A, residue = _reference_operator(name, dense)
    (grp,) = A.layout.pallas_groups
    if dense:
        assert grp.n_off > 1 and A.layout.n_coo == 0
    if name == "elastic":
        assert grp.n_vars == 2 and len(grp.units) == 4
    At = interop.offset_matrix_from_numpy(np.asarray(A.vals), A.layout,
                                          device="cpu")
    rng = np.random.default_rng(7)
    csr = A.to_scipy()
    for x in (rng.standard_normal(A.n), residue):
        y = At.mv(torch.as_tensor(x)).numpy()
        for force in (False, True):
            pallas_spmv.FORCE = force
            y_ref = np.asarray(A.mv(jnp.asarray(x)))
            scale = np.abs(y_ref).max()
            np.testing.assert_allclose(y, y_ref, rtol=1e-14,
                                       atol=1e-14 * scale)
        y_sp = csr @ x
        np.testing.assert_allclose(y, y_sp, rtol=1e-12,
                                   atol=1e-12 * np.abs(y_sp).max())
        np.testing.assert_allclose(At.to_scipy() @ x, y_sp, rtol=1e-12,
                                   atol=1e-12 * np.abs(y_sp).max())


def test_layout_copy_and_matrix_helpers():
    """interop copies the layout field for field; diag, scale_rows and
    scale_cols agree with the reference on the same values."""
    from metafem.linsolve.block_offset import OffsetMatrix as RefMatrix
    A, _ = _reference_operator("elastic", True)
    At = interop.offset_matrix_from_numpy(np.asarray(A.vals), A.layout,
                                          device="cpu")
    assert At.layout.segments == A.layout.segments
    assert (At.layout.pallas_groups[0].units
            == A.layout.pallas_groups[0].units)
    np.testing.assert_array_equal(At.diag().numpy(), np.asarray(A.diag()))
    s = np.random.default_rng(3).uniform(0.5, 2.0, A.n)
    for op in ("scale_rows", "scale_cols"):
        ref = getattr(RefMatrix.from_values(A.vals, A.layout), op)(
            jnp.asarray(s))
        got = getattr(At, op)(torch.as_tensor(s))
        np.testing.assert_array_equal(got.vals.numpy(), np.asarray(ref.vals))


def test_coo_tail_segment_sum_repeats_bitwise():
    """The default small layouts spill to the COO tail, which the port
    reduces by a sorted segment sum: the same input gives the same bits."""
    A, residue = _reference_operator("thermal", False)
    assert A.layout.n_coo > 0
    At = interop.offset_matrix_from_numpy(np.asarray(A.vals), A.layout,
                                          device="cpu")
    x = torch.as_tensor(residue)
    assert torch.equal(At.mv(x), At.mv(x))


def test_group_mv_has_no_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel (CUDA) or raises."""
    from metafem_torch.linsolve import offset_spmv
    from metafem_torch.linsolve.block_offset import PallasGroup
    grp = PallasGroup(dof_offset=0, n_cp=8, n_vars=1, n_off=3,
                      offsets=(-1, 0, 1), units=((0, 0),), base=0)
    vals = torch.empty(24, dtype=torch.float64, device="meta")
    x = torch.empty((1, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        offset_spmv.group_mv(vals, x, grp)
    assert offset_spmv.group_mv.launches == 0
