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
    """(reference OffsetMatrix, residue, occupied control points) of a
    fixture's tangent; with ``dense`` on a layout without the
    dense-segment size threshold."""
    builder, nel = CASES[name]
    with pytest.MonkeyPatch.context() as mp:
        if dense:
            orig = RefDomain.assemble_global_variables

            def dense_layout(self, **opts):
                return orig(self, dense_min_n=0, **opts)
            mp.setattr(RefDomain, "assemble_global_variables", dense_layout)
        dom = builder(nel=nel)
    A, residue = _tangent(dom)
    occupied = dom.workpieces[0].mesh.is_occupied
    return A, np.array(residue), np.asarray(occupied, bool)


@pytest.mark.parametrize("dense", [False, True], ids=["default", "dense"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mv_matches_reference(name, dense):
    A, residue, _ = _reference_operator(name, dense)
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
    A, _, _ = _reference_operator("elastic", True)
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
    A, residue, _ = _reference_operator("thermal", False)
    assert A.layout.n_coo > 0
    At = interop.offset_matrix_from_numpy(np.asarray(A.vals), A.layout,
                                          device="cpu")
    x = torch.as_tensor(residue)
    assert torch.equal(At.mv(x), At.mv(x))


def _tiny_plan():
    """The pack plan of a one-unit group of 8 rows and 3 offsets, every
    in-range entry structural."""
    from metafem_torch.linsolve import offset_spmv
    from metafem_torch.linsolve.block_offset import PallasGroup
    grp = PallasGroup(dof_offset=0, n_cp=8, n_vars=1, n_off=3,
                      offsets=(-1, 0, 1), units=((0, 0),), base=0)
    keep = torch.ones((1, 3, 8), dtype=torch.bool)
    keep[0, 0, 0] = keep[0, 2, 7] = False
    return offset_spmv.build_pack_plan(keep, grp, vec=2)


def test_group_mv_has_no_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel (CUDA) or raises."""
    from metafem_torch.linsolve import offset_spmv
    plan = _tiny_plan()
    assert plan.n_entries == 22
    vals = torch.empty(plan.n_packed, dtype=torch.float64, device="meta")
    x = torch.empty((1, 8), dtype=torch.float64, device="meta")
    offset_spmv.reset_launches()
    with pytest.raises(ValueError, match="cuda or cpu"):
        offset_spmv.group_mv(vals, x, plan)
    assert offset_spmv.group_mv.launches == 0


@pytest.mark.parametrize("dense", [False, True], ids=["default", "dense"])
def test_to_csr_matches_scipy(dense):
    """``to_csr`` (the operand of the library product that the kernel is
    timed against) gives scipy's product within 1e-12 * max|y|, with
    sorted rows and columns.  It holds exactly the entries that the
    assembly writes and the diagonal; every stored entry it leaves out
    is a zero."""
    A, _, _ = _reference_operator("elastic", dense)
    lo = A.layout
    At = interop.offset_matrix_from_numpy(np.asarray(A.vals), lo,
                                          device="cpu")
    C = At.to_csr()
    crow, col = C.crow_indices().numpy(), C.col_indices().numpy()
    assert crow[0] == 0 and crow[-1] == col.size and (np.diff(crow) >= 0).all()
    row = np.repeat(np.arange(A.n), np.diff(crow))
    assert (np.diff(row.astype(np.int64) * A.n + col) >= 0).all()
    x = np.random.default_rng(11).standard_normal(A.n)
    y_sp = A.to_scipy() @ x
    np.testing.assert_allclose(torch.mv(C, torch.as_tensor(x)).numpy(),
                               y_sp, rtol=1e-12,
                               atol=1e-12 * np.abs(y_sp).max())
    written = np.union1d(lo.storage_of_slot,
                         lo.diag_storage[lo.diag_storage >= 0])
    assert col.size == written.size
    if dense:
        n_stored = sum(min(n_cp, n_cp - d) - max(0, -d)
                       for (_r, _c, n_cp, d, _b) in lo.segments)
        assert written.size < n_stored      # the dense layout stores zeros
    left_out = np.setdiff1d(np.arange(lo.n_storage), written)
    assert (np.asarray(A.vals)[left_out] == 0).all()


# ---------------------------------------------------------------------------
# the packed product (offset_spmv.PackPlan): on the CPU ``OffsetMatrix.mv``
# packs each dense group's structural values and runs the kernel's plain
# version over the plan
# ---------------------------------------------------------------------------

PACK_CASES = pytest.mark.parametrize(
    "name,dense", [(n, d) for n in sorted(CASES) for d in (False, True)],
    ids=[f"{n}-{'dense' if d else 'default'}" for n in sorted(CASES)
         for d in (False, True)])


def _port_operator(name, dense):
    """(reference matrix, port matrix on the CPU, residue, occupied)."""
    A, residue, occupied = _reference_operator(name, dense)
    At = interop.offset_matrix_from_numpy(np.asarray(A.vals), A.layout,
                                          device="cpu")
    return A, At, residue, occupied


def _inputs(A, residue):
    return (np.random.default_rng(17).standard_normal(A.n), residue)


@PACK_CASES
def test_packed_product_matches_reference_group_mv(name, dense):
    """The packed plain product of the dense group against the
    reference's: the XLA form (FORCE=False) and the Pallas kernel in
    interpret mode (FORCE=True), on the same storage with the COO tail
    zeroed, within 1e-14 * max|y|."""
    from metafem.linsolve.block_offset import OffsetMatrix as RefMatrix
    from metafem_torch.linsolve import offset_spmv
    A, At, residue, _ = _port_operator(name, dense)
    lo = A.layout
    (grp,) = lo.pallas_groups
    C, n_cp = grp.n_vars, grp.n_cp
    vals = np.array(A.vals)
    vals[lo.n_dense:] = 0.0
    A_dense = RefMatrix.from_values(jnp.asarray(vals), lo)
    (plan,) = At.pack_plans()
    sl = slice(grp.dof_offset, grp.dof_offset + C * n_cp)
    for x in _inputs(A, residue):
        xw = torch.as_tensor(x[sl]).view(C, n_cp)
        y = offset_spmv.group_mv(At.packed(0), xw, plan).numpy().ravel()
        for force in (False, True):
            pallas_spmv.FORCE = force
            y_ref = np.asarray(A_dense.mv(jnp.asarray(x)))[sl]
            np.testing.assert_allclose(
                y, y_ref, rtol=1e-14, atol=1e-14 * np.abs(y_ref).max())


@PACK_CASES
def test_packed_product_equals_dense_formula(name, dense):
    """Bitwise equal to ``group_mv_plain``, the dense formula over the
    block-offset storage: each row adds the same products in the same
    order, and the stored zeros the plan leaves out add nothing."""
    from metafem_torch.linsolve import offset_spmv
    A, At, residue, _ = _port_operator(name, dense)
    (grp,) = A.layout.pallas_groups
    G, n_off, C, n_cp = len(grp.units), grp.n_off, grp.n_vars, grp.n_cp
    (plan,) = At.pack_plans()
    slab = At.vals[grp.base:grp.base + G * n_off * n_cp].view(G, n_off, n_cp)
    sl = slice(grp.dof_offset, grp.dof_offset + C * n_cp)
    for x in _inputs(A, residue):
        xw = torch.as_tensor(x[sl]).view(C, n_cp)
        y = offset_spmv.group_mv(At.packed(0), xw, plan)
        ref = offset_spmv.group_mv_plain(slab, xw, grp, torch.empty_like(y))
        assert torch.equal(y, ref)


@PACK_CASES
def test_pack_plan_holds_exactly_the_structural_entries(name, dense):
    """The plan reads every structural entry of the group once and no
    other stored value; a ghost control point's rows hold only their
    diagonal."""
    A, At, _, occupied = _port_operator(name, dense)
    (grp,) = A.layout.pallas_groups
    G, n_off, C, n_cp = len(grp.units), grp.n_off, grp.n_vars, grp.n_cp
    n_slab = G * n_off * n_cp
    keep = At.structural_mask()[grp.base:grp.base + n_slab]
    (plan,) = At.pack_plans()
    assert plan.n_fill == 0
    assert plan.n_entries == int(keep.sum())
    real = torch.ones(plan.n_packed, dtype=torch.bool)
    real[plan.pad] = False
    assert int(real.sum()) == plan.n_entries
    got = torch.sort(plan.positions[real].long()).values
    assert torch.equal(got, keep.nonzero().view(-1))
    # packed values: the structural values, zeros at the padding
    packed = At.packed(0)
    assert torch.equal(packed[real], At.vals[grp.base + plan.positions[real]
                                             .long()])
    assert not packed[~real].any()
    # ghost rows: one code, the offset 0, one unit, the diagonal one
    rows = plan.rows.long()
    meta = plan.meta.long()
    mask, lst = meta & 0xFF, meta >> 8
    L = plan.list_len.long()[lst]
    ghost = (rows >= 0) & ~torch.as_tensor(occupied)[rows.clamp(min=0) % n_cp]
    assert int(ghost.sum()) == C * int((~occupied).sum()) > 0
    q = ghost.nonzero().view(-1)
    assert (L[q] == 1).all()
    first = plan.codes[lst[q] * 4 * plan.words].long()
    assert (plan.dk[first] == 0).all()
    # rows with the same offsets share a code list: a handful on a lattice
    assert plan.n_lists <= 64
    pd = rows[q] // n_cp
    bit = torch.log2(mask[q].double()).long()
    assert (mask[q] == 2 ** bit).all()
    assert torch.equal(plan.chan_pb[pd, bit].long(), pd)
    assert 0.0 <= plan.padding_share < 1.0


@PACK_CASES
def test_scaled_products_match_scipy(name, dense):
    """``scale_rows`` and ``scale_cols`` make new matrices whose packed
    products agree with scipy's within 1e-12 * max|y|."""
    import scipy.sparse as sp
    A, At, residue, _ = _port_operator(name, dense)
    csr = A.to_scipy()
    s = np.random.default_rng(5).uniform(0.5, 2.0, A.n)
    for op, want in (("scale_rows", sp.diags(s) @ csr),
                     ("scale_cols", csr @ sp.diags(s))):
        B = getattr(At, op)(torch.as_tensor(s))
        for x in _inputs(A, residue):
            y = B.mv(torch.as_tensor(x)).numpy()
            y_sp = want @ x
            np.testing.assert_allclose(y, y_sp, rtol=1e-12,
                                       atol=1e-12 * np.abs(y_sp).max())


@PACK_CASES
def test_packed_products_repeat_bitwise(name, dense):
    """Two products on one matrix, and one on a new matrix from the same
    values (packed anew through the cached plan), give the same bits."""
    A, At, residue, _ = _port_operator(name, dense)
    for x in _inputs(A, residue):
        x = torch.as_tensor(x)
        y = At.mv(x)
        assert torch.equal(y, At.mv(x))
        again = type(At).from_values(At.vals.clone(), At.layout)
        assert torch.equal(y, again.mv(x))
        assert again.pack_plans() is At.pack_plans()


def test_cuda_typed_call_without_card_raises():
    """A call on CUDA-typed tensors where there is no card takes no
    plain path: it raises and counts no launch."""
    import dataclasses
    from torch._subclasses.fake_tensor import FakeTensorMode
    from metafem_torch.linsolve import offset_spmv
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel would launch")
    plan = _tiny_plan()
    offset_spmv.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        def fake(t):
            return torch.empty(t.shape, dtype=t.dtype, device="cuda")
        plan_c = dataclasses.replace(plan, **{
            f.name: fake(getattr(plan, f.name))
            for f in dataclasses.fields(plan)
            if isinstance(getattr(plan, f.name), torch.Tensor)})
        vals = torch.empty(plan.n_packed, dtype=torch.float64, device="cuda")
        x = torch.empty((1, 8), dtype=torch.float64, device="cuda")
        with pytest.raises(RuntimeError):
            offset_spmv.group_mv(vals, x, plan_c)
    assert offset_spmv.group_mv.launches == 0
