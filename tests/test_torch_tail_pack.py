"""The BSR tail's pack plan and its packed products in the PyTorch port,
against the BSR storage's own product and the reference package.

Meshes: tests/test_torch_blocktail.py's ``MESHES`` (the reference's
jittered triangle square and a jittered tet brick, each built by both
packages from the same numpy vertices with the BSR tail forced) and the
port's ``pikachu_brick`` at nel=(4, 3, 3) (float32).  On a CPU tensor the
wrappers run their kernels' plain versions over the same plan, so these
tests hold the plan and the kernels' arithmetic; ``chip_smoke.py`` holds
the kernels to the same plain versions on the card.  Tolerances:

- the plan's invariants exactly (each structural tail entry once, zero
  padding with valid columns, rows sorted by length within each window,
  output rows a bijection onto the touched rows);
- the packed product (f64) within 1e-12 of the scale max|y| of the BSR
  storage's product (``bsr_tail_mv_plain``) and of the reference's
  ``_blk_tail_mv`` (the same entries summed in another order); f32
  within 1e-6 of it;
- the two-float tail within 1e-12 of scale of the reference's two-float
  BSR branch and of the float64 product
  (tests/test_blocktail.py::test_df_offset_mv_blocked's bar), and bit
  for bit equal to the exact product where each row holds one entry
  (the FMA canary: two_prod's error must be exact);
- a converged df32 refined step within 1e-6 * max|T| of the f64 step's
  root and of the reference's df32 step.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from metafem.linsolve import krylov as ref_krylov
from metafem.linsolve import twofloat as ref_tf
from metafem.linsolve.block_offset import OffsetMatrix as RefOffsetMatrix
from metafem.solver.domain import FEM_Domain as RefDomain
import metafem as ref_mf

from metafem_torch.examples import pikachu_brick
from metafem_torch.linsolve import bsr_tail, krylov, offset_spmv
from metafem_torch.linsolve import twofloat as tf
from metafem_torch.linsolve.block_offset import OffsetMatrix

from test_torch_blocktail import (MESHES, _finish, _physics, _ref,
                                  _tangents, build_port)

torch.set_num_threads(2)

CASES = sorted(MESHES) + ["pikachu"]


@functools.lru_cache(maxsize=None)
def _pikachu():
    dom, _ = pikachu_brick.build((4, 3, 3), device="cpu")
    A, _ = dom.assemble_tangent()
    return A


def _matrix(case, dtype=torch.float64) -> OffsetMatrix:
    A = _pikachu() if case == "pikachu" else _tangents(case)[0]
    return OffsetMatrix.from_values(A.vals.to(dtype), A.layout)


def _x(n, seed=5):
    return np.random.default_rng(seed).standard_normal(n)


def _tail_entries(A):
    """(row, col, storage position in the tail) of every structural tail
    entry, from the BSR storage's own indexing."""
    lo = A.layout
    keep = A.structural_mask()[lo.n_dense:]
    pos = keep.nonzero().view(-1)
    comp, k = pos // lo.n_coo, pos % lo.n_coo
    r = A.coo_rows[k] * lo.blk_b + comp // lo.blk_b
    c = A.coo_cols[k] * lo.blk_b + comp % lo.blk_b
    return r, c, pos


def _slots(plan):
    """(packed row, rank in the row) of every slot, from the plan's
    addressing: slot group m of packed row q at ptr[m] + q*vec."""
    v = plan.vec
    q, rank = [], []
    for m in range(plan.n_groups):
        n_m = (plan.ptr_host[m + 1] - plan.ptr_host[m])
        s = torch.arange(n_m)
        q.append(s // v)
        rank.append(m * v + s % v)
    return torch.cat(q), torch.cat(rank)


@pytest.mark.parametrize("vec", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_plan_invariants(case, vec):
    A = _matrix(case)
    lo = A.layout
    plan = A.tail_plan(vec)
    r, c, pos = _tail_entries(A)
    n_e = pos.numel()
    assert plan.n_entries == n_e > 0
    real = torch.ones(plan.n_packed, dtype=torch.bool)
    real[plan.pad] = False
    # each structural tail entry exactly once
    got = plan.positions[real].long()
    assert got.numel() == n_e
    assert torch.equal(torch.sort(got).values, pos)
    # padding: zero values and valid columns
    packed = offset_spmv.pack(A.vals[lo.n_dense:], plan)
    assert torch.all(packed[plan.pad] == 0)
    assert int(plan.cols.min()) >= 0 and int(plan.cols.max()) < lo.n
    # each packed slot's (row, column) is its entry's; a row's entries
    # run in ascending column and come first
    q_of, rank = _slots(plan)
    rows = plan.rows.long()
    key = torch.full((lo.n * lo.n,), -1, dtype=torch.int64)
    key[r * lo.n + c] = pos
    slot_row = rows[q_of]
    assert torch.all(slot_row[real] >= 0)
    assert torch.equal(key[slot_row[real] * lo.n + plan.cols[real].long()],
                       plan.positions[real].long())
    L = torch.bincount(q_of[real], minlength=rows.numel())
    order = torch.argsort(q_of[real] * plan.n_packed + rank[real])
    qr, rr = q_of[real][order], rank[real][order]
    start = torch.cumsum(L, 0) - L
    assert torch.equal(rr, torch.arange(n_e) - start[qr])
    cr = plan.cols[real].long()[order]
    same = qr[1:] == qr[:-1]
    assert torch.all(cr[1:][same] > cr[:-1][same])
    # output rows: a bijection onto the rows that hold tail entries
    assert torch.equal(torch.sort(rows[rows >= 0]).values, torch.unique(r))
    assert plan.n_touched == torch.unique(r).numel()
    # rows sorted by length within each window of WINDOW touched rows,
    # slices of 32 rows each inside one window
    touched = torch.unique(r)
    win = torch.full((lo.n,), -1, dtype=torch.int64)
    win[touched] = torch.arange(touched.numel()) // offset_spmv.WINDOW
    S = offset_spmv.SLICE
    slices = rows.view(-1, S)
    Ls = L.view(-1, S)
    for w in range(int(win.max()) + 1):
        mine = [s for s in range(slices.shape[0])
                if win[slices[s][slices[s] >= 0]].eq(w).any()]
        for s in mine:
            live = slices[s] >= 0
            assert torch.all(win[slices[s][live]] == w)
            assert torch.all(Ls[s][live][1:] <= Ls[s][live][:-1])
        spans = sorted(((int(Ls[s][slices[s] >= 0].max()),
                         int(Ls[s][slices[s] >= 0].min())) for s in mine),
                       reverse=True)
        assert all(a[1] >= b[0] for a, b in zip(spans, spans[1:]))


def test_plan_refuses_2_31_rows():
    A = _matrix("tri2d")
    lo = A.layout
    keep = A.structural_mask()[lo.n_dense:]
    with pytest.raises(NotImplementedError, match="2\\^31"):
        bsr_tail.build_tail_plan(dataclasses.replace(lo, n=2 ** 31), keep, 2)
    with pytest.raises(ValueError):
        bsr_tail.build_tail_plan(lo, keep[:-1], 2)


def _storage_product(A, x):
    lo = A.layout
    t = A._tables()
    return bsr_tail.bsr_tail_mv_plain(
        A.vals[lo.n_dense:], x, torch.zeros(lo.n, dtype=x.dtype),
        A.coo_cols, t["run_start"], t["run_row"], lo.blk_b)


@pytest.mark.parametrize("case", CASES)
def test_packed_product_matches_storage_product_and_reference(case):
    A = _matrix(case)
    lo = A.layout
    x_np = _x(lo.n)
    x = torch.tensor(x_np)
    want = _storage_product(A, x)
    scale = float(want.abs().max())
    y = bsr_tail.tail_mv_packed_plain(A.packed_tail(), x,
                                      torch.zeros(lo.n, dtype=torch.float64),
                                      A.tail_plan())
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * scale)
    if case != "pikachu":
        A_ref = RefOffsetMatrix.from_values(jnp.asarray(A.vals.numpy()),
                                            _ref(case)[0].pattern.offset_layout)
        np.testing.assert_allclose(
            y.numpy(), np.asarray(A_ref._blk_tail_mv(jnp.asarray(x_np))),
            rtol=0, atol=1e-12 * scale)
    # float32: its own plan (4 slots per load), within 1e-6 of scale
    A32 = _matrix(case, torch.float32)
    y32 = bsr_tail.tail_mv(A32.packed_tail(), x.float(),
                           torch.zeros(lo.n), A32.tail_plan())
    want32 = _storage_product(A32, x.float()).double()
    np.testing.assert_allclose(y32.double().numpy(), want32.numpy(), rtol=0,
                               atol=1e-6 * float(want32.abs().max()))
    # the wrapper adds into y, and A.mv runs dense part plus packed tail
    y0 = torch.tensor(_x(lo.n, 6))
    y1 = bsr_tail.tail_mv(A.packed_tail(), x, y0.clone(), A.tail_plan())
    np.testing.assert_allclose((y1 - y0).numpy(), y.numpy(), rtol=0,
                               atol=1e-12 * scale)
    dense = A.dense_part().mv(x)
    np.testing.assert_allclose(A.mv(x).numpy(), (dense + want).numpy(),
                               rtol=0, atol=1e-12 * float(
                                   (dense + want).abs().max()))


def _tail_only(vals: torch.Tensor, lo) -> torch.Tensor:
    """vals with the dense part zeroed: the product is the tail's."""
    v = vals.clone()
    v[:lo.n_dense] = 0
    return v


@pytest.mark.parametrize("case", CASES)
def test_df_tail_matches_reference_and_f64(case):
    A32 = _matrix(case, torch.float32)
    lo = A32.layout
    rng = np.random.default_rng(8)
    x64 = rng.standard_normal(lo.n) * (1.0 + rng.random(lo.n))
    vals = tf.df_from_f64(_tail_only(A32.vals.double(), lo) * (
        1.0 + 1e-7 * torch.tensor(rng.standard_normal(lo.n_storage))))
    plan = OffsetMatrix.from_values(vals.hi, lo).tail_plan(offset_spmv.DF_VEC)
    assert plan.vec == 2
    packed = offset_spmv.pack_df(vals.hi[lo.n_dense:], vals.lo[lo.n_dense:],
                                 plan)
    x = tf.df_from_f64(x64)
    y_hi, y_lo = torch.zeros(lo.n), torch.zeros(lo.n)
    bsr_tail.tail_mv_df(packed, x.hi, x.lo, y_hi, y_lo, plan)
    y = tf.df_to_f64(tf.DF(y_hi, y_lo)).numpy()
    v64 = tf.df_to_f64(vals)
    want64 = _storage_product(OffsetMatrix.from_values(v64, lo),
                              tf.df_to_f64(x)).numpy()
    scale = np.abs(want64).max()
    np.testing.assert_allclose(y, want64, rtol=0, atol=1e-12 * scale)
    # the whole two-float product (dense part zero) through df_offset_mv
    yd = tf.df_to_f64(tf.df_offset_mv(vals, lo, x)).numpy()
    np.testing.assert_array_equal(yd, y)
    if case != "pikachu":
        ref_lo = _ref(case)[0].pattern.offset_layout
        y_ref = ref_tf.df_to_f64(ref_tf.df_offset_mv(
            ref_tf.DF(jnp.asarray(vals.hi.numpy()),
                      jnp.asarray(vals.lo.numpy())), ref_lo,
            ref_tf.DF(jnp.asarray(x.hi.numpy()), jnp.asarray(x.lo.numpy()))))
        np.testing.assert_allclose(y, np.asarray(y_ref), rtol=0,
                                   atol=1e-12 * scale)


def test_df_tail_fma_canary():
    """Rows of one entry each: the row's pair is two_prod's (p, e), so
    hi + lo must be the exact float64 product v * x.  An FMA contracted
    into two_prod, or into the e update, would give another error term."""
    A32 = _matrix("tet3d", torch.float32)
    lo = A32.layout
    r, _, pos = _tail_entries(A32)
    order = torch.argsort(r, stable=True)
    r, pos = r[order], pos[order]
    first = torch.ones(r.numel(), dtype=torch.bool)
    first[1:] = r[1:] != r[:-1]           # one entry of each row
    keep = torch.zeros(64 * lo.n_coo, dtype=torch.bool)
    keep[pos[first]] = True
    plan = bsr_tail.build_tail_plan(lo, keep, 2)
    assert plan.n_entries == plan.n_touched
    rng = np.random.default_rng(12)
    v = torch.tensor(rng.standard_normal(64 * lo.n_coo), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal(lo.n), dtype=torch.float32)
    packed = offset_spmv.pack_df(v, torch.zeros_like(v), plan)
    y_hi, y_lo = torch.zeros(lo.n), torch.zeros(lo.n)
    bsr_tail.tail_mv_df(packed, x, torch.zeros_like(x), y_hi, y_lo, plan)
    q_of, _ = _slots(plan)
    real = torch.ones(plan.n_packed, dtype=torch.bool)
    real[plan.pad] = False
    rows = plan.rows.long()[q_of[real]]
    exact = torch.zeros(lo.n, dtype=torch.float64)
    exact[rows] = (v[plan.positions[real].long()].double()
                   * x[plan.cols[real].long()].double())
    got = y_hi.double() + y_lo.double()
    assert torch.equal(got[rows], exact[rows])
    assert int((y_lo != 0).sum()) > rows.numel() // 2


def test_wrappers_raise_on_cuda_tensors_without_card():
    """The packed products on CUDA-typed tensors where there is no card
    take no plain path: each raises and counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernels would launch")
    A = _matrix("tri2d")
    plans = {v: A.tail_plan(v) for v in (2, 4)}
    bsr_tail.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        def cu(shape, dtype=torch.float64):
            return torch.empty(shape, dtype=dtype, device="cuda")

        def on_card(plan):
            return dataclasses.replace(
                plan, rows=cu(plan.rows.shape, torch.int32),
                cols=cu(plan.cols.shape, torch.int32),
                ptr=cu(plan.ptr.shape, torch.int64))
        p64, p32 = on_card(plans[2]), on_card(plans[4])
        n = A.n
        with pytest.raises(RuntimeError):
            bsr_tail.tail_mv(cu((p64.n_packed,)), cu((n,)), cu((n,)), p64)
        f32 = torch.float32
        with pytest.raises(RuntimeError):
            bsr_tail.tail_mv(cu((p32.n_packed,), f32), cu((n,), f32),
                             cu((n,), f32), p32)
        with pytest.raises(RuntimeError):
            bsr_tail.tail_mv_df(cu((p64.n_packed, 2), f32), cu((n,), f32),
                                cu((n,), f32), cu((n,), f32), cu((n,), f32),
                                p64)
    assert bsr_tail.tail_mv.launches == 0
    assert bsr_tail.tail_mv_df.launches == 0
    # a plan of the wrong width, and float64 words, are refused anywhere
    x = torch.zeros(A.n)
    with pytest.raises(TypeError):
        bsr_tail.tail_mv(torch.zeros(plans[2].n_packed, dtype=torch.float32),
                         x, x.clone(), plans[2])
    with pytest.raises(TypeError):
        x64 = x.double()
        bsr_tail.tail_mv_df(torch.zeros((plans[2].n_packed, 2)).double(),
                            x64, x64, x64.clone(), x64.clone(), plans[2])
    with pytest.raises(ValueError):
        bsr_tail.tail_mv(torch.zeros(plans[2].n_packed).double(),
                         torch.zeros(A.n + 1).double(),
                         torch.zeros(A.n + 1).double(), plans[2])


# ---------------------------------------------------------------------------
# the df32 refined step over a BSR tail
# ---------------------------------------------------------------------------

STEP = dict(maxiter=60, max_refine=16, precond="jacobi")


def _ref_f32(name):
    arrays, k, hc, t_env, src = MESHES[name]
    vert, conn = arrays()
    dom = RefDomain(vert.shape[1], dtype=jnp.float32)
    geo = ref_mf.construct_total_mesh(vert, conn)
    wp = _physics(ref_mf, dom, geo, k, hc, t_env)
    return _finish(dom, wp, t_env, src, dict(blk_min_tail=1))


def _frozen(dom, tol):
    dom.converge_tol = tol
    dom.freeze_linear_tangent()
    dom.freeze_refined_residual()
    return dom


@functools.lru_cache(maxsize=None)
def _df32_steps():
    """(port df32 x, reference df32 x, port f64-mode root) on the tet
    brick, f32 domains for the df32 steps, f64 for the root."""
    dom, _ = build_port("tet3d", dtype=torch.float32)
    _frozen(dom, 1e-8)
    step = dom.make_refined_step(sv_func=krylov.bicgstab,
                                 residual_mode="df32", **STEP)
    x, _, res, it = step(dom._runtime_state(),
                         tf.df_from_f64(dom.x.to(torch.float64)), 0.0, 1.0)
    assert isinstance(x, tf.DF)
    assert res < 1e-8, res
    ref, _ = _ref_f32("tet3d")
    _frozen(ref, 1e-8)
    step_r = ref.make_refined_step(sv_func=ref_krylov.bicgstab,
                                   residual_mode="df32", **STEP)
    x_r, _, res_r, _ = step_r(ref._runtime_state(),
                              ref.x.astype(jnp.float64), jnp.float64(0.0),
                              jnp.float64(1.0))
    assert float(res_r) < 1e-8
    dom64, _ = build_port("tet3d")
    _frozen(dom64, 1e-11)
    x64, _, res64, _ = dom64.make_refined_step(
        sv_func=krylov.bicgstab, **STEP)(dom64._runtime_state(), dom64.x,
                                         0.0, 1.0)
    assert res64 < 1e-11, res64
    return tf.df_to_f64(x).numpy(), np.asarray(x_r, np.float64), x64.numpy()


def test_df32_refined_step_over_the_tail():
    """A df32 refined step on the tet brick's BSR tail: its T within
    1e-6 * max|T| of the f64 step's root and of the reference's df32
    step."""
    x, x_r, x64 = _df32_steps()
    scale = np.abs(x64).max()
    np.testing.assert_allclose(x, x64, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(x, x_r, rtol=0, atol=1e-6 * scale)


def test_f64_residual_packs_a_td_once(monkeypatch):
    """The f64 residual mode keeps the frozen A_td's matrices in the
    freeze's record: their dense group and tail are packed at the first
    step's first residual and never again, a second step from the same x
    gives the same bits, and ``save_freezes`` leaves the matrices out."""
    dom, _ = build_port("tet3d", dtype=torch.float32)
    _frozen(dom, 1e-8)
    step = dom.make_refined_step(sv_func=krylov.bicgstab, **STEP)
    packs = []
    pack = offset_spmv.pack
    monkeypatch.setattr(offset_spmv, "pack", lambda v, plan: (
        packs.append(v.dtype), pack(v, plan))[1])
    x0 = dom.x.to(torch.float64)
    x1, _, res, it = step(dom._runtime_state(), x0, 0.0, 1.0)
    assert res < 1e-8 and it > 0, (res, it)
    mats = dom._refined["A_mats"]
    assert packs.count(torch.float64) == 2 * len(mats)
    assert all(set(A._packed) == {0, "tail"} for A in mats)
    del packs[:]
    x2 = step(dom._runtime_state(), x0, 0.0, 1.0)[0]
    assert packs.count(torch.float64) == 0 and torch.float32 in packs
    assert torch.equal(x1, x2)
    assert "A_mats" not in dom._refined_to_save(dom._refined)
