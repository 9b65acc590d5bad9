"""Two-float ("double-f32") arithmetic of the PyTorch port against the
reference package (metafem/linsolve/twofloat.py, df_lowering.py), on the
CPU, where the reference pins its transforms (``_pin``) and the port runs
each step as its own eager op.  Inputs come from numpy seeds.
Tolerances:

- two_sum, fast_two_sum and two_prod are defined exactly: bitwise equal
  to the reference's on 10^5 random float32 pairs, and s + e == a + b,
  p + e == a * b exactly in float64;
- every DF op within 2^-46 * |value| of the reference's, and within its
  own error bound of the float64 result on the device it runs on (the
  CPU here; ``chip_smoke.py`` runs the same bounds on the card);
- the two-float SpMV (plain version, packed over the float64 plan) on the
  README thermal layout (C=1; dense, and with its COO tail), a C=2
  elastic layout and the C=4 thermo-elastic layout: within 2^-46 * (|A||x|)_row of the reference's
  df_offset_mv, within 2^-45 * (|A||x|)_row of the exact product
  (math.fsum of exact float64 terms; the two-float sum's error grows
  with the row's length, in both packages), within that plus the
  float64 product's own rounding (n_row * 2^-53 * (|A||x|)_row) of the
  float64 product, and bitwise equal to the
  reference's formula over the unpacked storage (the same df_adds in
  the same order; zeros add nothing to a normalized pair);
- the compensated gather-map sum and the ``nonaff_res_df`` phase (the
  k(T) strip and the cavity at e_number=8) within 1e-13 * max|r| of the
  reference's.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metafem.linsolve import twofloat as rtf
from metafem_torch.linsolve import offset_spmv
from metafem_torch.linsolve import twofloat as tf

torch.set_num_threads(2)

N = 100_000


def _f32_pairs(seed, n=N):
    """Two float32 vectors over 13 decades, with signs."""
    rng = np.random.default_rng(seed)

    def one():
        return (rng.standard_normal(n)
                * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    return one(), one()


def _df_vec(seed, n=N, scale=6):
    """A normalized DF pair of float64 values over 2*scale decades, as
    numpy (hi, lo) and the float64 values."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * 10.0 ** rng.uniform(-scale, scale, n)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo, hi.astype(np.float64) + lo.astype(np.float64)


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "two_prod"])
def test_error_free_transforms_are_bitwise_and_exact(name):
    a, b = _f32_pairs(1)
    if name == "fast_two_sum":                  # needs |a| >= |b|
        a, b = (np.where(np.abs(a) >= np.abs(b), a, b),
                np.where(np.abs(a) >= np.abs(b), b, a))
    s, e = getattr(tf, name)(torch.as_tensor(a), torch.as_tensor(b))
    s_r, e_r = getattr(rtf, name)(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(s.numpy(), _np(s_r))
    assert np.array_equal(e.numpy(), _np(e_r))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    exact = a64 * b64 if name == "two_prod" else a64 + b64
    got = s.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    # s + e equals a + b (a * b) as real numbers, so both round alike in
    # float64 (a product of two float32 is exact there)
    assert np.array_equal(got, exact)


def test_two_prod_is_not_contracted():
    """Canary: a fused multiply-add anywhere in two_prod (or in a*b - p)
    would return the error of another product; each e must be the exact
    float64 remainder a*b - p, rounded once."""
    a, b = _f32_pairs(2)
    p, e = tf.two_prod(torch.as_tensor(a), torch.as_tensor(b))
    want = (a.astype(np.float64) * b.astype(np.float64)
            - p.numpy().astype(np.float64)).astype(np.float32)
    assert np.array_equal(e.numpy(), want)
    assert np.count_nonzero(e.numpy()) > N // 2
    # the same with a sum of products: (x*y) + z must round x*y first
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 rounds to 1 + 2^-11 (a tie, to
    # even); a fused multiply-add would keep the 2^-24
    x = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    z = torch.tensor([-(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert float(x * x + z) == 0.0


def _ops():
    """(name, port fn, reference fn, number of DF args, extra args) of
    every DF op, and its float64 twin and error bound."""
    return {
        "df_add": (lambda x, y: tf.df_add(x, y),
                   lambda x, y: rtf.df_add(x, y),
                   lambda x, y: x + y, lambda x, y: np.abs(x) + np.abs(y)),
        "df_sub": (lambda x, y: tf.df_sub(x, y),
                   lambda x, y: rtf.df_sub(x, y),
                   lambda x, y: x - y, lambda x, y: np.abs(x) + np.abs(y)),
        "df_mul": (lambda x, y: tf.df_mul(x, y),
                   lambda x, y: rtf.df_mul(x, y),
                   lambda x, y: x * y, lambda x, y: np.abs(x * y)),
        "df_scale_df": (lambda x, y: tf.df_scale_df(x, y),
                        lambda x, y: rtf.df_scale_df(x, y),
                        lambda x, y: x * y, lambda x, y: np.abs(x * y)),
        "df_div": (lambda x, y: tf.df_div(x, y),
                   lambda x, y: rtf.df_div(x, y),
                   lambda x, y: x / y, lambda x, y: np.abs(x / y)),
    }


def _pair(hi, lo, torch_side=True):
    if torch_side:
        return tf.DF(torch.as_tensor(hi), torch.as_tensor(lo))
    return rtf.DF(jnp.asarray(hi), jnp.asarray(lo))


def _f64(d):
    return (np.asarray(d.hi).astype(np.float64)
            + np.asarray(d.lo).astype(np.float64))


@pytest.mark.parametrize("name", sorted(_ops()))
def test_binary_df_ops_match_reference_and_f64(name):
    fn, ref_fn, f64_fn, mag = _ops()[name]
    xh, xl, x64 = _df_vec(3)
    yh, yl, y64 = _df_vec(4)
    got = _f64(fn(_pair(xh, xl), _pair(yh, yl)))
    want = _f64(ref_fn(_pair(xh, xl, False), _pair(yh, yl, False)))
    exact = f64_fn(x64, y64)
    m = mag(x64, y64)
    assert np.all(np.abs(got - want) <= 2.0 ** -46 * m)
    # the float64 result itself rounds at 2^-53 * |value|
    assert np.all(np.abs(got - exact) <= 2.0 ** -44 * m)


@pytest.mark.parametrize("name", ["df_add_f32", "df_scale", "df_scale_num",
                                  "df_neg", "df_normalize"])
def test_mixed_df_ops_match_reference_and_f64(name):
    xh, xl, x64 = _df_vec(5)
    v, _ = _f32_pairs(6)
    v64 = v.astype(np.float64)
    X, Xr = _pair(xh, xl), _pair(xh, xl, False)
    if name == "df_add_f32":
        got = tf.df_add_f32(X, torch.as_tensor(v))
        want = rtf.df_add_f32(Xr, jnp.asarray(v))
        exact, m = x64 + v64, np.abs(x64) + np.abs(v64)
    elif name == "df_scale":
        got = tf.df_scale(X, torch.as_tensor(v))
        want = rtf.df_scale(Xr, jnp.asarray(v))
        exact, m = x64 * v64, np.abs(x64 * v64)
    elif name == "df_scale_num":
        # a Python number is rounded to float32 first, as the reference's
        # weak typing does.  The reference splits the number in float64
        # (its two_prod then multiplies 12-bit halves by the 24-bit
        # float32 number, not exactly), so it is held to the port only at
        # a number of few bits, as the step's gamma and alpha are; the
        # port's product with 0.1 is held to float64
        got = tf.df_scale(X, 0.5)
        want = rtf.df_scale(Xr, 0.5)
        c32 = float(np.float32(0.1))
        exact, m = x64 * c32, np.abs(x64 * c32)
        got01 = _f64(tf.df_scale(X, 0.1))
        assert np.all(np.abs(got01 - exact) <= 2.0 ** -45 * m)
        exact, m = x64 * 0.5, np.abs(x64 * 0.5)
    elif name == "df_neg":
        got, want, exact, m = tf.df_neg(X), rtf.df_neg(Xr), -x64, np.abs(x64)
    else:
        got = tf.df_normalize(torch.as_tensor(xh), torch.as_tensor(xl))
        want = rtf.df_normalize(jnp.asarray(xh), jnp.asarray(xl))
        exact, m = x64, np.abs(x64)
    got, want = _f64(got), _f64(want)
    assert np.all(np.abs(got - want) <= 2.0 ** -46 * m)
    assert np.all(np.abs(got - exact) <= 2.0 ** -45 * m)


def test_conversions_match_reference():
    _, _, x64 = _df_vec(7)
    got = tf.df_from_f64(torch.as_tensor(x64))
    want = rtf.df_from_f64(x64)
    assert np.array_equal(got.hi.numpy(), _np(want.hi))
    assert np.array_equal(got.lo.numpy(), _np(want.lo))
    assert np.all(np.abs(tf.df_to_f64(got).numpy() - x64)
                  <= 2.0 ** -48 * np.abs(x64))
    for c in (0.1, -1173.15, 5.669e-8, 3.0):
        d, r = tf.df_const(c), rtf.df_const(c)
        assert float(d.hi) == float(r.hi) and float(d.lo) == float(r.lo)
        assert tf.as_df(c).hi.dtype == torch.float32
    f32 = torch.as_tensor(np.float32([1.5, -2.25]))
    assert torch.equal(tf.as_df(f32).lo, torch.zeros(2))
    assert torch.equal(tf.as_df(torch.as_tensor(x64[:8])).hi, got.hi[:8])
    z = tf.df_zeros_like(f32)
    assert not z.hi.any() and not z.lo.any()


def test_df_dot2_matches_reference():
    terms = [(_df_vec(10 + k, 4096, 3), _df_vec(40 + k, 4096, 3))
             for k in range(9)]
    got = tf.df_dot2((_pair(a[0], a[1]), _pair(b[0], b[1]))
                     for a, b in terms)
    want = rtf.df_dot2((_pair(a[0], a[1], False), _pair(b[0], b[1], False))
                       for a, b in terms)
    exact = sum(a[2] * b[2] for a, b in terms)
    m = sum(np.abs(a[2] * b[2]) for a, b in terms)
    assert np.all(np.abs(_f64(got) - _f64(want)) <= 2.0 ** -46 * m)
    # the O(eps) terms of each product add in float32, each rounding at
    # ~2^-48 * |a b|: n = 9 terms stay within 16 * 2^-48 of sum |a b|
    assert np.all(np.abs(_f64(got) - exact) <= 2.0 ** -44 * m)


# ---------------------------------------------------------------------------
# the two-float SpMV
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layouts():
    """(label, port OffsetMatrix on the CPU) of the three dense layouts:
    the README thermal (C=1) and elastic (C=2) fixtures of
    test_torch_spmv.py on dense layouts, and the thermo-elastic bar at
    e_number=2 (C=4, 16 units, 117 offsets)."""
    from test_torch_spmv import _port_operator
    from metafem_torch.examples import thermal_elasticity_3d as te
    out = [(name, _port_operator(name, True)[1])
           for name in ("thermal", "elastic")]
    dom, wp = te.build(e_number=2, device="cpu",
                       layout_opts={"dense_min_n": 0})
    te.heat_front(dom, wp)
    out.append(("thermo_elastic", dom.assemble_tangent()[0]))
    # the thermal fixture's default layout: the diagonal dense, the rest
    # in the COO tail
    out.append(("thermal_coo_tail", _port_operator("thermal", False)[1]))
    return out


def _df_inputs(A, seed):
    """A pair of matrix values (A's, perturbed in their low bits) and an
    x pair, from a numpy seed."""
    rng = np.random.default_rng(seed)
    v64 = A.vals.numpy() * (1.0 + 1e-3 * rng.standard_normal(A.vals.shape))
    x64 = rng.standard_normal(A.n) * 10.0 ** rng.uniform(-2, 2, A.n)
    return tf.df_from_f64(torch.as_tensor(v64)), tf.df_from_f64(
        torch.as_tensor(x64))


@pytest.mark.parametrize("case", [0, 1, 2, 3],
                         ids=["thermal_C1", "elastic_C2",
                              "thermo_elastic_C4", "thermal_C1_coo_tail"])
def test_df_offset_mv_matches_reference_and_f64(case):
    from metafem_torch.linsolve.block_offset import OffsetMatrix
    name, A = _layouts()[case]
    lo = A.layout
    (grp,) = lo.pallas_groups
    assert grp.n_vars == (1, 2, 4, 1)[case]
    assert (lo.n_coo > 0) == (case == 3)
    vals, x = _df_inputs(A, 12 + case)
    y = tf.df_to_f64(tf.df_offset_mv(vals, lo, x)).numpy()
    y_ref = _f64(rtf.df_offset_mv(
        rtf.DF(jnp.asarray(vals.hi.numpy()), jnp.asarray(vals.lo.numpy())),
        lo, rtf.DF(jnp.asarray(x.hi.numpy()), jnp.asarray(x.lo.numpy()))))
    v64, x64 = tf.df_to_f64(vals), tf.df_to_f64(x)
    y64 = OffsetMatrix.from_values(v64, lo).mv(x64).numpy()
    ax = OffsetMatrix.from_values(v64.abs(), lo).mv(x64.abs()).numpy()
    assert np.all(np.abs(y - y_ref) <= 2.0 ** -46 * ax), name
    # each df_add rounds at ~2^-48 of its partial sum, so the error grows
    # with the row: the C=4 rows (324 entries) reach 2^-45.9 * |A||x| in
    # both packages, the C=1 rows (21 entries) 2^-46.5
    bound = 2.0 ** -45 * ax
    assert np.all(np.abs(y - _exact_product(A, vals, x)) <= bound), name
    # the float64 product rounds each of a row's n entries at 2^-53
    n_row = OffsetMatrix.from_values((v64 != 0).double(), lo).mv(
        torch.ones_like(x64)).numpy()
    assert np.all(np.abs(y - y64) <= bound + n_row * 2.0 ** -53 * ax), name


def _exact_product(A, vals, x):
    """A x of the DF pairs, exact up to one final rounding: each entry's
    (v_hi + v_lo)(x_hi + x_lo) is four products of two float32, exact in
    float64, and each row adds them with math.fsum."""
    import math
    rows, cols, pos = (t.numpy() for t in A._triplets())
    vh, vl = (w.numpy().astype(np.float64)[pos] for w in vals)
    xh, xl = (w.numpy().astype(np.float64)[cols] for w in x)
    terms = np.stack([vh * xh, vh * xl, vl * xh, vl * xl], 1)
    order = np.argsort(rows, kind="stable")
    bounds = np.searchsorted(rows[order], np.arange(A.n + 1))
    t = terms[order]
    return np.array([math.fsum(t[bounds[i]:bounds[i + 1]].ravel())
                     for i in range(A.n)])


@functools.lru_cache(maxsize=None)
def _pikachu_tangent():
    """The unstructured brick's tangent (metafem_torch.examples.
    pikachu_brick at nel=(4, 3, 3)): one C=1 dense group over a Morton
    numbering beside its BSR tail, the shape of the df32 unstructured
    step's dense group."""
    from metafem_torch.examples import pikachu_brick
    dom, _ = pikachu_brick.build((4, 3, 3), device="cpu")
    A = dom.assemble_tangent()[0]
    assert A.layout.n_coo > 0 and A.layout.blk_b == 8
    return A


@pytest.mark.parametrize("case", [0, 1, 2, "pikachu"],
                         ids=["thermal_C1", "elastic_C2",
                              "thermo_elastic_C4", "pikachu_C1_morton"])
def test_packed_df_product_equals_unpacked_formula(case):
    """group_mv_df_plain over the packed pair gives the bits of
    group_mv_df_dense (the reference's formula over the block-offset
    storage, stored zeros included); a packed pair over a float32 plan
    is refused."""
    A = _pikachu_tangent() if case == "pikachu" else _layouts()[case][1]
    (grp,) = A.layout.pallas_groups
    G, n_off, C, n_cp = len(grp.units), grp.n_off, grp.n_vars, grp.n_cp
    vals, x = _df_inputs(A, 20 + (3 if case == "pikachu" else case))
    (plan,) = A.pack_plans(vec=offset_spmv.DF_VEC)
    sl = slice(grp.base, grp.base + G * n_off * n_cp)
    packed = offset_spmv.pack_df(vals.hi[sl], vals.lo[sl], plan)
    assert packed.shape == (plan.n_packed, 2)
    xw = tf.DF(x.hi.view(C, n_cp), x.lo.view(C, n_cp))
    y_hi, y_lo = offset_spmv.group_mv_df(packed, xw.hi, xw.lo, plan)
    dense = offset_spmv.group_mv_df_dense(
        tf.DF(vals.hi[sl].view(G, n_off, n_cp),
              vals.lo[sl].view(G, n_off, n_cp)), xw, grp)
    assert torch.equal(y_hi, dense.hi) and torch.equal(y_lo, dense.lo)
    (plan32,) = A.pack_plans(vec=4)
    with pytest.raises(ValueError, match="float64 plan"):
        offset_spmv.pack_df(vals.hi[sl], vals.lo[sl], plan32)


def test_group_mv_df_has_no_fallback_off_the_cpu():
    """A CUDA-typed call with no card (meta tensors) raises before any
    launch is counted; so does any other device."""
    _, A = _layouts()[0]
    (grp,) = A.layout.pallas_groups
    (plan,) = A.pack_plans(vec=offset_spmv.DF_VEC)
    offset_spmv.reset_launches()
    meta = torch.device("meta")
    xw = torch.empty((1, grp.n_cp), dtype=torch.float32, device=meta)
    packed = torch.empty((plan.n_packed, 2), dtype=torch.float32,
                         device=meta)
    with pytest.raises(ValueError):
        offset_spmv.group_mv_df(packed, xw, xw, plan)
    assert offset_spmv.group_mv_df.launches == 0
    # float64 words or a float64 packed pair are refused on any device
    x64 = torch.zeros((1, grp.n_cp), dtype=torch.float64)
    with pytest.raises(TypeError):
        offset_spmv.group_mv_df(torch.zeros((plan.n_packed, 2)), x64, x64,
                                plan)
    assert offset_spmv.group_mv_df.launches == 0


# ---------------------------------------------------------------------------
# the compensated reductions and the two-float residual phase
# ---------------------------------------------------------------------------

def test_apply_device_maps_df_matches_reference():
    """The cap-term compensated gather sum with an overflow (cap 4 over
    slots hit up to 9 times) against the reference's."""
    from metafem.solver import scatter as rsc
    from metafem_torch.solver import scatter as sc
    rng = np.random.default_rng(31)
    num = 500
    slots = rng.integers(0, num, 3000)
    slots[:40] = 7                              # one slot far over cap
    hi, lo, v64 = _df_vec(32, slots.size, 3)
    gr = sc.build_gather_reduce(slots, num, cap=4)
    assert gr.overflow_src is not None
    got = sc.apply_device_maps_df(sc.maps_to_device(gr, "cpu"),
                                  _pair(hi, lo), num)
    rgr = rsc.build_gather_reduce(slots, num, cap=4)
    want = rsc.apply_device_maps_df(rsc.maps_to_device(rgr),
                                    _pair(hi, lo, False), num)
    exact = np.bincount(slots, weights=v64, minlength=num)
    m = np.bincount(slots, weights=np.abs(v64), minlength=num)
    assert np.all(np.abs(_f64(got) - _f64(want)) <= 2.0 ** -46 * m)
    assert np.all(np.abs(_f64(got) - exact) <= 2.0 ** -45 * m)


sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))


def _strip_pair():
    from test_refined import _radiating_thermal
    from test_torch_refined import _port_radiating
    ref = _radiating_thermal(dtype=jnp.float32, nonlinear_volume=True)
    dom = _port_radiating(dtype=torch.float32, nonlinear_volume=True)
    return ref, dom, None


def _cavity_pair():
    import cavity_2d as ref_cavity
    from metafem_torch.examples import cavity_2d
    ref, _, wp_r, _ = ref_cavity.build(e_number=8, dtype=jnp.float32)
    dom, _, wp, _ = cavity_2d.build(e_number=8, device="cpu",
                                    dtype=torch.float32)
    rng = np.random.default_rng(33)
    n_cp = dom.workpieces[wp].mesh.n_cp
    fields = {"uw1": np.full(n_cp, 0.1),
              "tau_m": rng.uniform(0.5, 2.0, n_cp),
              "tau_c": rng.uniform(0.5, 2.0, n_cp)}
    for name, col in fields.items():
        ref.set_field(wp_r, name, col)
        dom.set_field(wp, name, col)
    ref.refresh_fields()
    dom.refresh_fields()
    return ref, dom, 0.05


@pytest.mark.parametrize("case", ["kT_strip", "cavity_e8"])
def test_nonaff_res_df_phase_matches_reference(case):
    """The nonaffine volume's residues in two-float arithmetic over each
    package's own frozen DF tables, at one seeded DF state, against the
    reference's phase and against the float64 phase on the float64
    tables: hi + lo within 1e-13 * max|r|."""
    ref, dom, scale = (_strip_pair if case == "kT_strip"
                       else _cavity_pair)()
    for d in (ref, dom):
        d.freeze_linear_tangent()
        d.freeze_refined_residual()
    assert ref._refined["wp_df"] is not None
    assert dom._refined["wp_df"] is not None
    ref._ensure_device_maps("nonaff_res", "nonaff_nl")
    dom._ensure_device_maps("nonaff_res", "nonaff_nl")
    rng = np.random.default_rng(34)
    shape = tuple(dom.x.shape)
    if scale is None:
        xs64 = 323.15 + rng.normal(0.0, 50.0, shape)
    else:
        xs64 = scale * rng.standard_normal(shape)
    xs = tf.df_from_f64(torch.as_tensor(xs64))
    st = {**dom._runtime_state(), "wp": dom._refined["wp_df"], "x_star": xs,
          "K_params": torch.ones(shape[0], dtype=torch.float64),
          "t": 0.0, "dt": 1.0}
    got, _ = dom._run_phase(st, "nonaff_res_df")
    st_r = {**ref._runtime_state(), "wp": ref._refined["wp_df"],
            "x_star": rtf.df_from_f64(xs64),
            "K_params": jnp.ones(shape[0], jnp.float64),
            "t": jnp.float64(0.0), "dt": jnp.float64(1.0)}
    want, _ = ref._run_phase(st_r, "nonaff_res_df")
    want = _f64(want)
    g = tf.df_to_f64(got).numpy()
    tol = 1e-13 * np.abs(want).max()
    np.testing.assert_allclose(g, want, rtol=0, atol=tol)
    # the same phase in float64 over the port's float64 tables
    st64 = {**st, "wp": dom._refined["wp"],
            "x_star": torch.as_tensor(xs64)}
    r64, _ = dom._run_phase(st64, "nonaff_res")
    np.testing.assert_allclose(g, r64.numpy(), rtol=0, atol=tol)
