"""The BSR tail of the block-offset storage in the PyTorch port, against
the reference package on the same meshes.

Unstructured meshes (no lattice numbering, Morton control-point order)
spill their rare offsets into a tail of 8 x 8 blocks stored
component-major.  Two meshes, each built by both packages from the same
numpy vertices: the reference's jittered triangle square of
tests/test_blocktail.py (order 2) and a small jittered tet brick (the
recipe of tests/test_parallel.py's unstructured fixture) with pikachu's
conduction constants, both with the BSR tail forced
(``blk_min_tail=1``).  The scalar COO tail (``blk_min_tail=10**12``)
of the same physics is the port's own oracle.  Tolerances:

- layouts equal exactly (build_offset_layout is a copy of the
  reference's);
- the assembled residual and tangent to 1e-12 of their largest entry
  (the same float64 arithmetic summed in another order);
- mv, tmv, diag and the scalings to rtol 1e-12 with an absolute floor
  of 1e-12 of the product's scale (the reference test's bar), against
  the reference's BSR products and the port's scalar-tail products;
- the tail's plain product against the reference's ``_blk_tail_mv`` to
  1e-12 relative (the block sums run in another order);
- the two-float product through the tail to 1e-12 of the float64
  product's scale (tests/test_blocktail.py's bar);
- a converged Newton step (residual below 1e-10) to 1e-6 in T.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import metafem as ref_mf
from metafem.linsolve import twofloat as ref_tf
from metafem.linsolve.block_offset import OffsetMatrix as RefOffsetMatrix
from metafem.linsolve.block_offset import tail_runs as ref_tail_runs
from metafem.solver.domain import FEM_Domain as RefDomain

import metafem_torch as mf
from metafem_torch import FEM_Domain
from metafem_torch.examples import pikachu_brick
from metafem_torch.linsolve import bsr_tail
from metafem_torch.linsolve import twofloat as tf
from metafem_torch.linsolve.block_offset import OffsetMatrix, tail_runs

torch.set_num_threads(2)


def tri_arrays(seed=0):
    """tests/test_blocktail.py's _unstructured_geo: a jittered 10 x 10
    triangle square."""
    vert, conn = mf.make_square((1.0, 1.0), (10, 10), shape="SIMPLEX")
    vert = np.array(vert)
    rng = np.random.default_rng(seed)
    inner = (vert[:, 0] > 1e-9) & (vert[:, 0] < 1 - 1e-9) \
        & (vert[:, 1] > 1e-9) & (vert[:, 1] < 1 - 1e-9)
    vert[inner] += rng.uniform(-0.02, 0.02, size=(inner.sum(), 2))
    return vert, np.asarray(conn)


def tet_arrays():
    """metafem_torch/examples/pikachu_brick.py's jittered tet brick (the
    recipe of tests/test_parallel.py's _make_tet_thermal) at
    nel=(4, 3, 3)."""
    return pikachu_brick.brick_arrays((4, 3, 3))


#: per mesh: (vertex arrays, conduction, convection, ambient, source)
MESHES = {"tri2d": (tri_arrays, 2.0, 30.0, 300.0, 500.0),
          "tet3d": (tet_arrays, pikachu_brick.K_COND, pikachu_brick.H_CONV,
                    pikachu_brick.T_ENV, pikachu_brick.SOURCE)}


def _physics(pkg, dom, geo, k, hc, t_env):
    wp = dom.add_workpiece(geo)
    bg = dom.add_boundary(wp, geo.boundary_facet_ids())
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    i = pkg.index("i")
    dom.assign_workpiece_weakform(
        wp, -k * pkg.Bilinear(T.d(i), T.d(i)) + pkg.Bilinear(T, s))
    dom.assign_boundary_weakform(wp, bg,
                                 hc * pkg.Bilinear(T, t_env - T))
    dom.initialize_local_assembly(explicit_max_sd_order=1)
    return wp


def _finish(dom, wp, t0, src, layout_opts):
    dom.mesh_classical(itp_order=2, itg_order=5)
    dom.assemble_global_variables(**layout_opts)
    dom.compile()
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "T", np.full(mesh.n_cp, t0))
    dom.set_field(wp, "s", np.full(mesh.n_cp, src))
    dom.refresh_fields()
    dom.assemble_x()
    dom.converge_tol = 1e-10
    return dom, wp


def build_port(name, blk_min_tail=1, dtype=torch.float64, **layout_opts):
    arrays, k, hc, t_env, src = MESHES[name]
    vert, conn = arrays()
    dim = vert.shape[1]
    dom = FEM_Domain(dim, dtype=dtype, device="cpu")
    geo = mf.construct_total_mesh(vert, conn)
    wp = _physics(mf, dom, geo, k, hc, t_env)
    return _finish(dom, wp, t_env, src,
                   dict(blk_min_tail=blk_min_tail, **layout_opts))


def build_ref(name, blk_min_tail=1, **layout_opts):
    arrays, k, hc, t_env, src = MESHES[name]
    vert, conn = arrays()
    dom = RefDomain(vert.shape[1])
    geo = ref_mf.construct_total_mesh(vert, conn)
    wp = _physics(ref_mf, dom, geo, k, hc, t_env)
    return _finish(dom, wp, t_env, src,
                   dict(blk_min_tail=blk_min_tail, **layout_opts))


@functools.lru_cache(maxsize=None)
def _port(name, blk_min_tail=1):
    return build_port(name, blk_min_tail)


@functools.lru_cache(maxsize=None)
def _ref(name):
    return build_ref(name)


def ref_tangent(dom):
    """The reference domain's (tangent, residue) at its x, as in
    tests/test_blocktail.py."""
    dom.time_discretization.update_time(1.0, dom.pattern.max_time_level)
    state = dom._runtime_state()
    state["K_linear"] = dom._k_linear(state)
    state["x_star"] = dom.x
    residue, K_total = dom._res_k(state)
    return (RefOffsetMatrix.from_values(K_total, dom.pattern.offset_layout),
            residue)


@functools.lru_cache(maxsize=None)
def _tangents(name):
    A_ref, r_ref = ref_tangent(_ref(name)[0])
    A, r = _port(name)[0].assemble_tangent()
    A_s, _ = _port(name, 10 ** 12)[0].assemble_tangent()
    return A, r, A_s, A_ref, np.asarray(r_ref)


def _close(got, want, rtol, scale=None):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_layout_matches_reference(name):
    lo = _port(name)[0].pattern.offset_layout
    ref = _ref(name)[0].pattern.offset_layout
    assert lo.blk_b == ref.blk_b == 8
    assert _port(name, 10 ** 12)[0].pattern.offset_layout.blk_b == 0
    assert lo.n_coo > 0
    assert _port(name)[0].workpieces[0].mesh.lattice_shape is None
    for f in ("n", "n_storage", "n_dense"):
        assert getattr(lo, f) == getattr(ref, f), f
    for f in ("coo_rows", "coo_cols", "storage_of_slot", "diag_storage"):
        np.testing.assert_array_equal(getattr(lo, f), getattr(ref, f))
    run_start, run_row = tail_runs(lo)
    starts, rows, _ = ref_tail_runs(ref)
    np.testing.assert_array_equal(run_start[:-1], starts)
    assert run_start[-1] == lo.n_coo
    np.testing.assert_array_equal(run_row, rows)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_tangent_and_residual_match_reference(name):
    A, r, _, A_ref, r_ref = _tangents(name)
    _close(r, r_ref, 1e-12)
    _close(A.vals, A_ref.vals, 1e-12)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_products_match_reference_and_scalar_tail(name):
    """mv, tmv, diag and both scalings over the BSR tail against the
    reference's BSR matrix on the same values and against the port's
    scalar-tail matrix of the same physics."""
    A, _, A_s, _, _ = _tangents(name)
    A_ref = RefOffsetMatrix.from_values(jnp.asarray(A.vals.numpy()),
                                        _ref(name)[0].pattern.offset_layout)
    rng = np.random.default_rng(1)
    x_np = rng.standard_normal(A.n)
    s_np = rng.uniform(0.5, 2.0, A.n)
    x, s = torch.tensor(x_np), torch.tensor(s_np)
    xj, sj = jnp.asarray(x_np), jnp.asarray(s_np)
    scale = float(A_s.mv(x).abs().max())
    cases = [("mv", A.mv(x), A_s.mv(x), A_ref.mv(xj)),
             ("tmv", A.tmv(x), A_s.tmv(x), A_ref.tmv(xj)),
             ("scale_cols", A.scale_cols(s).mv(x), A_s.scale_cols(s).mv(x),
              A_ref.scale_cols(sj).mv(xj)),
             ("scale_rows", A.scale_rows(s).mv(x), A_s.scale_rows(s).mv(x),
              A_ref.scale_rows(sj).mv(xj))]
    for label, got, scalar, ref in cases:
        _close(got, scalar.numpy(), 1e-12, scale)
        _close(got, ref, 1e-12, scale)
    _close(A.diag(), A_s.diag().numpy(), 1e-14)
    _close(A.diag(), A_ref.diag(), 1e-14)
    # the CSR library operand covers the tail's structural entries
    _close(torch.mv(A.to_csr(), x), A.mv(x).numpy(), 1e-12, scale)
    np.testing.assert_allclose(A.to_scipy().toarray(),
                               A_s.to_scipy().toarray(), rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_tail_plain_matches_reference_blk_tail_mv(name):
    A, _, _, _, _ = _tangents(name)
    lo = A.layout
    A_ref = RefOffsetMatrix.from_values(jnp.asarray(A.vals.numpy()),
                                        _ref(name)[0].pattern.offset_layout)
    x_np = np.random.default_rng(3).standard_normal(A.n)
    t = A._tables()
    y = bsr_tail.bsr_tail_mv_plain(A.vals[lo.n_dense:], torch.tensor(x_np),
                                   torch.zeros(A.n, dtype=torch.float64),
                                   A.coo_cols, t["run_start"], t["run_row"],
                                   lo.blk_b)
    _close(y, A_ref._blk_tail_mv(jnp.asarray(x_np)), 1e-12)
    # the wrapper on CPU tensors is the packed plain version, adding
    # into y
    y0 = torch.tensor(np.random.default_rng(4).standard_normal(A.n))
    y1 = bsr_tail.tail_mv(A.packed_tail(), torch.tensor(x_np), y0.clone(),
                          A.tail_plan())
    _close(y1 - y0, y.numpy(), 1e-12)


def test_df_offset_mv_blocked():
    """The two-float product through the BSR tail keeps ~2^-48 of the
    float64 product (tests/test_blocktail.py::test_df_offset_mv_blocked's
    bar), and agrees with the reference's two-float product."""
    A, _, _, _, _ = _tangents("tri2d")
    lo = A.layout
    x64 = np.random.default_rng(2).standard_normal(lo.n)
    vals32 = A.vals.to(torch.float32)
    y = tf.df_to_f64(tf.df_offset_mv(
        tf.DF(vals32, torch.zeros_like(vals32)), lo, tf.df_from_f64(x64)))
    ref = (OffsetMatrix.from_values(vals32, lo).to_scipy()
           .astype(np.float64) @ x64)
    scale = np.abs(ref).max()
    _close(y, ref, 1e-12, scale)
    v_ref = jnp.asarray(vals32.numpy())
    y_ref = ref_tf.df_to_f64(ref_tf.df_offset_mv(
        ref_tf.DF(v_ref, jnp.zeros_like(v_ref)),
        _ref("tri2d")[0].pattern.offset_layout,
        ref_tf.df_from_f64(x64)))
    _close(y, y_ref, 1e-12, scale)


def test_converged_solve_matches():
    """A converged Newton step with the BSR tail gives T within 1e-6 of
    the scalar tail's and of the reference's."""
    results = []
    for dom, wp in (build_port("tri2d"), build_port("tri2d", 10 ** 12),
                    build_ref("tri2d")):
        res = dom.update_one_step(max_iter=5)
        assert res < 1e-10, res
        dom.dessemble_x()
        results.append(np.asarray(dom.workpieces[wp].mesh.fields["T"]))
    np.testing.assert_allclose(results[0], results[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(results[0], results[2], rtol=0, atol=1e-6)


def test_cuda_typed_tail_without_card_raises():
    """The tail product on CUDA-typed tensors where there is no card takes
    no plain path: it raises and counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel would launch")
    A, _, _, _, _ = _tangents("tri2d")
    plan = A.tail_plan()
    bsr_tail.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        def cu(shape, dtype=torch.float64):
            return torch.empty(shape, dtype=dtype, device="cuda")
        on_card = dataclasses.replace(
            plan, rows=cu(plan.rows.shape, torch.int32),
            cols=cu(plan.cols.shape, torch.int32),
            ptr=cu(plan.ptr.shape, torch.int64))
        with pytest.raises(RuntimeError):
            bsr_tail.tail_mv(cu((plan.n_packed,)), cu((A.n,)), cu((A.n,)),
                             on_card)
    assert bsr_tail.tail_mv.launches == 0
