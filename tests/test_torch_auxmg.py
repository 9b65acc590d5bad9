"""Auxiliary-space multigrid of the PyTorch port against the reference
package, on the unstructured path of the pikachu-class workload.

The mesh is tests/test_torch_blocktail.py's jittered tet brick at
nel=(4, 3, 3), order 2, with pikachu's conduction constants
(examples/pikachu_3d.py:20) and its BSR tail forced, built by both
packages from the same numpy vertices.  The reference draws its start
vectors from ``jax.random``; the port takes them as arguments
(``auxmg.setup(starts=...)``), so both start alike.  Tolerances:

- the host transfer (spacing, cells, weights) equal exactly (the same
  numpy);
- the Galerkin stencil to 1e-12 of its largest entry (scipy's product
  on the same matrix; only the torch conversion differs), its mask
  exactly, the dropped share to 1e-12;
- the lattice state of ``mg_setup_from_stencil`` to 1e-10 of each
  entry's scale (probing and calibration sum in another order, the
  coarsest inverse is another LAPACK call);
- refresh_tangent to 1e-12 and the sparsified operator's row sums to
  1e-10 of A's (the lumping identity of the reference test);
- apply_m and mv on the reference's tree carried across to 1e-10;
- setup_auxmg's omega, spectrum and Chebyshev enclosure to 1e-8 (12 + 48
  + 64 preconditioned applies, each drifting ~1e-15);
- the refined step's x to 1e-8 of max|x| on the reference's tree (the
  same operator, preconditioner and Krylov method, so the two runs part
  only by rounding: the linear solver is held fixed across packages).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from metafem.linsolve import auxmg as ref_aux
from metafem.linsolve import krylov as ref_krylov

from metafem_torch import interop
from metafem_torch.linsolve import auxmg, krylov

from test_torch_blocktail import build_port, build_ref, ref_tangent

torch.set_num_threads(2)

STEP = dict(maxiter=12, max_refine=8, max_pass=1, forcing=0.3)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda v: None if v is None else np.asarray(v), tree)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _ref_starts(dom_ref, hier):
    """The reference's start vectors of auxmg.setup: the damped-Jacobi
    calibration (PRNGKey(7)), the lattice calibrations (3 + level), the
    spectrum (11) and the Chebyshev tune (5)."""
    n = dom_ref.pattern.basicfield_size

    def normal(key, shape):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(key), shape,
                                            jnp.float64))
    return {"omega": normal(7, (n,)), "spectrum": normal(11, (n,)),
            "tune": normal(5, (n,)),
            "levels": [normal(3 + lvl, (hier.channels,) + hier.shapes[lvl])
                       for lvl in range(hier.n_levels - 1)]}


def _frozen(dom):
    dom.converge_tol = 1e-6
    dom.freeze_linear_tangent()
    dom.freeze_refined_residual()
    return dom


@functools.lru_cache(maxsize=None)
def _ref(smooth):
    """The reference tet domain with its freezes and setup_auxmg(smooth),
    and its refined step's (x, residual, refines)."""
    dom, wp = build_ref("tet3d")
    _frozen(dom)
    dom.setup_auxmg(smooth=smooth)
    step = dom.make_refined_step(sv_func=ref_krylov.bicgstab,
                                 precond="auxmg", **STEP)
    x, _, res, it = step(dom._runtime_state(), jnp.asarray(dom.x),
                         jnp.float64(0.0), jnp.float64(1.0))
    return dom, (np.asarray(x), float(res), int(it))


@functools.lru_cache(maxsize=None)
def _port(smooth):
    """The port's tet domain with its own setup_auxmg(smooth) from the
    reference's start vectors."""
    dom, wp = build_port("tet3d")
    _frozen(dom)
    dom_ref, _ = _ref(smooth)
    hier = dom_ref._auxmg[1][1]
    dom.setup_auxmg(smooth=smooth, starts=_ref_starts(dom_ref, hier))
    return dom


def _carried(smooth):
    """A port domain running on the reference's aux tree (interop)."""
    dom_ref, _ = _ref(smooth)
    dom, _ = build_port("tet3d")
    _frozen(dom)
    tree, static = dom_ref._auxmg
    interop.load_reference_freezes(
        dom, auxmg=(_np(tree), static),
        auxmg_spectrum=dom_ref._auxmg_spectrum,
        auxmg_cheb=dom_ref._auxmg_cheb)
    return dom


def test_transfer_matches_reference():
    dom = _port("full")
    mesh = dom.workpieces[0].mesh
    sp = auxmg.estimate_spacing(mesh.cp_coords, mesh.el_cp)
    assert sp == ref_aux.estimate_spacing(mesh.cp_coords, mesh.el_cp)
    h = max(2.0 * sp[0], sp[1] / 2)
    got = auxmg.build_transfer(mesh.cp_coords, h)
    want = ref_aux.build_transfer(mesh.cp_coords, h)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
    desc = dom._auxmg[1][0]
    assert desc.aux_shape == _ref("full")[0]._auxmg[1][0].aux_shape


@pytest.mark.parametrize("lump", [True, False])
def test_galerkin_stencil_matches_reference(lump):
    """On the same scipy matrix, with a lattice fine enough (h = the fine
    spacing, radius 1) that couplings leave the stencil radius."""
    dom = _port("full")
    mesh = dom.workpieces[0].mesh
    lo = dom.pattern.offset_layout
    A = dom.assemble_tangent()[0].to_scipy()
    h = auxmg.estimate_spacing(mesh.cp_coords, mesh.el_cp)[0]
    cell, w, shape, _ = auxmg.build_transfer(mesh.cp_coords, h)
    coefs, mask, dropped = auxmg.galerkin_stencil(A, cell, w, shape, 1, 1,
                                                  lump=lump)
    with jax.default_device(jax.devices("cpu")[0]):
        c_ref, m_ref, d_ref = ref_aux.galerkin_stencil(
            A, cell, w, shape, 1, 1, jnp.float64, lump=lump)
    assert dropped > 1e-3 and lo.blk_b == 8
    _close(coefs, c_ref, 1e-12)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(m_ref))
    np.testing.assert_allclose(dropped, d_ref, rtol=1e-12)


def test_mg_setup_from_stencil_matches_reference():
    dom_ref, _ = _ref("full")
    tree_ref, (desc, hier_ref) = dom_ref._auxmg
    dom = _port("full")
    hier = dom._auxmg[1][1]
    assert dataclasses.asdict(hier) == dataclasses.asdict(hier_ref)
    lat, lat_ref = dom._auxmg[0]["lat"], tree_ref["lat"]
    assert len(lat) == len(lat_ref) == hier.n_levels
    for lvl, lvl_ref in zip(lat, lat_ref):
        assert set(lvl) == {k for k, v in lvl_ref.items() if v is not None}
        for key in lvl:
            _close(lvl[key], lvl_ref[key], 1e-10)


def test_setup_auxmg_matches_reference():
    """omega, the preconditioned spectrum and the Chebyshev enclosure of
    the port's own setup against the reference's, from the same start
    vectors; the index leaves exactly."""
    for smooth in ("full", "sparse"):
        dom_ref, _ = _ref(smooth)
        dom = _port(smooth)
        tree, tree_ref = dom._auxmg[0], dom_ref._auxmg[0]
        _close(tree["omega"], tree_ref["omega"], 1e-8)
        np.testing.assert_allclose(dom._auxmg_spectrum,
                                   dom_ref._auxmg_spectrum, rtol=1e-8)
        (iv, rate), (iv_ref, rate_ref) = (dom._auxmg_cheb,
                                          dom_ref._auxmg_cheb)
        np.testing.assert_allclose(iv, iv_ref, rtol=1e-8)
        np.testing.assert_allclose(rate, rate_ref, rtol=1e-8)
        _close(tree["w"], tree_ref["w"], 0.0)
        keys = ["cell"] + (["bd_sel", "bd_rows"] if smooth == "sparse"
                           else [])
        for key in keys:
            np.testing.assert_array_equal(tree[key].numpy(),
                                          np.asarray(tree_ref[key]))
        assert dataclasses.asdict(dom._auxmg[1][0]) == \
            dataclasses.asdict(dom_ref._auxmg[1][0])


@pytest.mark.parametrize("smooth", ["full", "sparse"])
def test_refresh_tangent_and_operator_match_reference(smooth):
    """refresh_tangent on the same tangent, then apply_m and mv of
    AuxMGOperator on the reference's tree carried across."""
    dom_ref, _ = _ref(smooth)
    A_ref, _ = ref_tangent(dom_ref)
    tree_ref, (desc_ref, hier_ref) = dom_ref._auxmg
    t_ref = ref_aux.refresh_tangent(A_ref, tree_ref, desc_ref)
    op_ref = ref_aux.AuxMGOperator(A_ref, t_ref, hier_ref, desc_ref)

    dom = _carried(smooth)
    A = interop.offset_matrix_from_numpy(np.asarray(A_ref.vals), A_ref.layout,
                                         device="cpu")
    tree, (desc, hier) = dom._auxmg
    t = auxmg.refresh_tangent(A, tree, desc)
    for key in ("inv_diag", "smooth_lump", "smooth_bd"):
        if t_ref.get(key) is None:
            assert t.get(key) is None
            continue
        _close(t[key], t_ref[key], 1e-12)
    op = auxmg.AuxMGOperator(A, t, hier, desc)
    v = np.random.default_rng(5).standard_normal(A.n)
    _close(op.apply_m(torch.tensor(v)), op_ref.apply_m(jnp.asarray(v)),
           1e-10)
    _close(op.mv(torch.tensor(v)), op_ref.mv(jnp.asarray(v)), 1e-10)
    # the transfers are adjoint
    r = torch.tensor(np.random.default_rng(6).standard_normal(A.n))
    xc = torch.tensor(np.random.default_rng(7).standard_normal(
        (desc.channels,) + desc.aux_shape))
    np.testing.assert_allclose(float(torch.vdot(op._p(xc), r)),
                               float(torch.vdot(xc.reshape(-1),
                                                op._pt(r).reshape(-1))),
                               rtol=1e-12)
    if smooth == "sparse":
        S = op._smoother()
        assert isinstance(S, auxmg.SparseSmoothOp)
        assert S.dense._packed is A._packed
        ones = torch.ones(A.n, dtype=torch.float64)
        _close(S.mv(ones), A.mv(ones).numpy(), 1e-10)
        assert float(torch.linalg.norm(S.mv(r) - A.mv(r))) > 0


def test_transfers_repeat_bitwise():
    """Pᵀ is a sorted segment sum over the plan built at setup: two calls
    give the same bits."""
    dom = _port("full")
    tree, (desc, hier) = dom._auxmg
    A, _ = dom.assemble_tangent()
    op = auxmg.AuxMGOperator(A, auxmg.refresh_tangent(A, tree, desc), hier,
                             desc)
    r = torch.tensor(np.random.default_rng(8).standard_normal(A.n))
    assert torch.equal(op._pt(r), op._pt(r))
    assert torch.equal(op.apply_m(r), op.apply_m(r))


@pytest.mark.parametrize("smooth", ["full", "sparse"])
def test_refined_step_matches_reference(smooth):
    """The float64 refined step with precond='auxmg' on the reference's
    tree reaches the tolerance, with x within 1e-8 max|x| of the
    reference's step and in as many refines."""
    _, (x_ref, res_ref, it_ref) = _ref(smooth)
    dom = _carried(smooth)
    step = dom.make_refined_step(sv_func=krylov.bicgstab, precond="auxmg",
                                 **STEP)
    x, _, res, it = step(dom._runtime_state(), dom.x, 0.0, 1.0)
    assert res < 1e-6 and res_ref < 1e-6, (res, res_ref)
    assert it == it_ref
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0,
                               atol=1e-8 * np.abs(x_ref).max())


def test_sparse_inner_operator_matches_reference():
    """inner_operator='sparse' (with smooth='sparse'): the inner Krylov
    operator Ã∘M (SparseInnerOp) against the reference's on its tree, to
    1e-10.  The refined step accepts it and refuses it without the
    sparse smoother.  On a tet brick this small the sparsified tangent
    keeps too little of the tail (it is near singular), so the outer
    iteration with it does not contract in either package; the refined
    step's convergence with it is checked at full size on the card."""
    dom_ref, _ = _ref("sparse")
    A_ref, _ = ref_tangent(dom_ref)
    tree_ref, (desc_ref, hier_ref) = dom_ref._auxmg
    op_ref = ref_aux.SparseInnerOp(ref_aux.AuxMGOperator(
        A_ref, ref_aux.refresh_tangent(A_ref, tree_ref, desc_ref),
        hier_ref, desc_ref))
    dom = _carried("sparse")
    A = interop.offset_matrix_from_numpy(np.asarray(A_ref.vals),
                                         A_ref.layout, device="cpu")
    tree, (desc, hier) = dom._auxmg
    op = auxmg.SparseInnerOp(auxmg.AuxMGOperator(
        A, auxmg.refresh_tangent(A, tree, desc), hier, desc))
    v = np.random.default_rng(9).standard_normal(A.n)
    _close(op.mv(torch.tensor(v)), op_ref.mv(jnp.asarray(v)), 1e-10)
    _close(op.apply_m(torch.tensor(v)), op_ref.apply_m(jnp.asarray(v)),
           1e-10)
    step = dom.make_refined_step(sv_func=krylov.bicgstab, precond="auxmg",
                                 inner_operator="sparse",
                                 **{**STEP, "max_refine": 1})
    x, _, res, it = step(dom._runtime_state(), dom.x, 0.0, 1.0)
    assert it == 1 and np.isfinite(res)
    with pytest.raises(ValueError, match="smooth='sparse'"):
        _carried("full").make_refined_step(
            sv_func=krylov.bicgstab, precond="auxmg",
            inner_operator="sparse", **STEP)


def test_own_setup_refined_step_converges():
    """The port's own setup (its own start vectors, the card's default
    path): the refined step with the exact inner operator converges for
    both smoothers."""
    for smooth in ("full", "sparse"):
        dom, _ = build_port("tet3d")
        _frozen(dom)
        dom.setup_auxmg(smooth=smooth)
        step = dom.make_refined_step(sv_func=krylov.bicgstab,
                                     precond="auxmg", **STEP)
        _, _, res, _ = step(dom._runtime_state(), dom.x, 0.0, 1.0)
        assert res < 1e-6, (smooth, res)


def test_iterative_solver_auxmg_update_one_step():
    """make_iterative_solver(precond='auxmg') through update_one_step
    converges below 1e-6, to the refined step's root."""
    dom, wp = build_port("tet3d")
    _frozen(dom)
    dom.setup_auxmg()
    step = dom.make_refined_step(sv_func=krylov.bicgstab, precond="auxmg",
                                 **STEP)
    x_ref, _, res_ref, _ = step(dom._runtime_state(), dom.x, 0.0, 1.0)
    dom.linear_solver = dom.make_iterative_solver(precond="auxmg",
                                                  maxiter=200)
    res = dom.update_one_step(max_iter=4)
    assert res < 1e-6 and res_ref < 1e-6, (res, res_ref)
    np.testing.assert_allclose(dom.x.numpy(), x_ref.numpy(), rtol=0,
                               atol=1e-5 * float(x_ref.abs().max()))


def test_save_load_auxmg_round_trip(tmp_path):
    dom = _port("sparse")
    path = str(tmp_path / "fz.pkl")
    dom.save_freezes(path)
    dom2, _ = build_port("tet3d")
    dom2.load_freezes(path)
    tree, static = dom._auxmg
    tree2, static2 = dom2._auxmg
    assert static2 == static
    assert dom2._auxmg_spectrum == dom._auxmg_spectrum
    assert dom2._auxmg_cheb == dom._auxmg_cheb
    flat = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))
    flat2 = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree2))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, tree)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, tree2))
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert dom2._runtime_state()["auxmg_tree"] is tree2
