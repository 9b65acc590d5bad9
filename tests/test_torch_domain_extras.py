"""Domain extras of the PyTorch port, float64 on the CPU:

- ``register_function``: a user callback with and without a ``user``
  parameter, lowered inside ``evaluate_at_itg`` on the README thermal
  strip, within 1e-12 * max of the reference package's;
- an unknown function raises the reference's ``ValueError``;
- ``user_state``: arrays become tensors on the domain's device once, when
  assigned, and callbacks receive those tensors;
- the Mooney-Rivlin cases of tests/test_hyperelastic.py on the port's
  ``hyperelastic_3d``: the analytic tensile curve within 4%, and c01
  stiffening the response;
- the step constants (time-integration parameters, weak-form constants)
  copied to the device once per value: the same tensor on every call,
  and steps bitwise equal to steps that copy them anew on every call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metafem as ref_mf
import metafem_torch as mf
from metafem_torch import config, interop
from metafem_torch.examples import hyperelastic_3d, thermal_2d
from metafem_torch.linsolve import krylov

from test_multigrid import _thermal_domain

torch.set_num_threads(2)

NEL = (6, 3)


@pytest.fixture(scope="module")
def strip():
    """The reference's and the port's thermal strip at one seeded x."""
    ref = _thermal_domain(nel=NEL)
    dom, _ = thermal_2d.build(NEL, device="cpu")
    x = 500.0 + 100.0 * np.random.default_rng(37).standard_normal(
        np.asarray(ref.x).shape)
    ref.x = jnp.asarray(x)
    interop.load_reference_state(dom, x=x)
    return ref, dom


def _both(strip, expr_of):
    """(reference, port) evaluate_at_itg of expr_of(package, domain)."""
    ref, dom = strip
    want = np.asarray(ref.evaluate_at_itg(0, expr_of(ref_mf, ref)))
    got = dom.evaluate_at_itg(0, expr_of(mf, dom))
    assert got.shape == want.shape == (dom.workpieces[0].mesh.n_el,
                                       dom.workpieces[0].disc.n_itg)
    return got, want


def test_registered_function_without_user(strip):
    ref, dom = strip
    for d in (ref, dom):
        d.register_function("cube_plus", lambda a, b: a * a * a + b)
    got, want = _both(strip, lambda pkg, d: pkg.fn(
        "cube_plus", d.sym("T"), d.sym("T").d(1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    # the callback against the same expression written out
    T = dom.sym("T")
    inline = dom.evaluate_at_itg(0, T * T * T + T.d(1))
    assert torch.equal(got, inline)


def test_registered_function_with_user(strip):
    ref, dom = strip
    n_el, nq = (dom.workpieces[0].mesh.n_el, dom.workpieces[0].disc.n_itg)
    k = np.random.default_rng(41).uniform(1.0, 2.0, (n_el, nq))
    seen = []

    def scaled(a, *, user):
        seen.append(user["k"])
        return a * user["k"] + user["c"]

    for d in (ref, dom):
        d.register_function("scaled", scaled)
        d.user_state = {"k": k, "c": 0.5}
    got, want = _both(strip, lambda pkg, d: pkg.fn("scaled", d.sym("T")))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    port_k = seen[-1]
    assert torch.is_tensor(port_k) and port_k is dom.user_state["k"]
    assert port_k.device == dom.device and port_k.dtype == dom.dtype


def test_unknown_function_raises(strip):
    ref, dom = strip
    msgs = []
    for pkg, d in ((ref_mf, ref), (mf, dom)):
        with pytest.raises(ValueError, match="unknown function 'nowhere'") \
                as err:
            d.evaluate_at_itg(0, pkg.fn("nowhere", d.sym("T")))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_user_state_moves_to_the_device_once():
    dom = mf.FEM_Domain(2, device="cpu")
    already = torch.ones(3, dtype=torch.float64)
    dom.user_state = {"a": np.zeros((2, 3)), "idx": np.arange(3),
                      "t": already, "k": 3.0, "name": "isotropic"}
    u = dom.user_state
    assert torch.is_tensor(u["a"]) and u["a"].device == dom.device
    assert u["a"].dtype == dom.dtype
    assert u["idx"].dtype == torch.int64
    assert u["t"] is already                   # no copy of a device tensor
    assert u["k"] == 3.0 and isinstance(u["k"], float)
    assert u["name"] == "isotropic"
    # a float32 domain keeps its arrays in float32
    dom32 = mf.FEM_Domain(2, device="cpu", dtype=torch.float32)
    dom32.user_state = {"a": np.zeros(2)}
    assert dom32.user_state["a"].dtype == torch.float32


def test_mooney_rivlin_uniaxial_vs_analytic():
    """The analytic tensile curve of static_Mooney_Rivlin.jl's first
    setup (C10=1e6, C01=1e6, lam=1e8) within 4%, the reference test's
    bar (the clamped end stiffens the bar by ~2.3%)."""
    dom, wp, _ = hyperelastic_3d.build(e_number=1, material="mooney_rivlin",
                                       device="cpu")
    c10, c01, lam = 1e6, 1e6, 1e8
    P1s, d1s = hyperelastic_3d.run_loading(
        dom, wp, 2 * (c10 + c01), lam, total_steps=3, sigma_step=4e5,
        c10=c10, c01=c01)
    ana = np.array([hyperelastic_3d.analytic_uniaxial_mr(s, c10, c01, lam)
                    for s in P1s])
    err = np.abs(d1s - ana) / np.abs(ana)
    assert err.max() < 0.04, err


def test_mooney_rivlin_c01_stiffens_response():
    dom, wp, _ = hyperelastic_3d.build(e_number=1, material="mooney_rivlin",
                                       device="cpu")
    _, d_a = hyperelastic_3d.run_loading(
        dom, wp, 4e6, 1e8, total_steps=1, sigma_step=4e5, c10=1e6, c01=1e6)
    _, d_b = hyperelastic_3d.run_loading(
        dom, wp, 12e6, 1e8, total_steps=1, sigma_step=4e5, c10=1e6, c01=5e6)
    assert 0 < d_b[-1] < d_a[-1]


def _copy_every_call(key, dtype, device):
    """The constants as the steps made them before the cache: a new
    tensor from the host on every call."""
    values = (float.fromhex(key) if isinstance(key, str)
              else [float.fromhex(h) for h in key])
    return torch.as_tensor(np.asarray(values, np.float64), dtype=dtype,
                           device=device)


def test_constants_are_shared():
    a = config.device_constant((1.0, 0.5), torch.float64, "cpu")
    assert a is config.device_constant([1.0, 0.5], torch.float64,
                                       torch.device("cpu"))
    assert a is not config.device_constant((1.0, 0.5), torch.float32, "cpu")
    s = config.device_constant(2, torch.float64, "cpu")
    assert s.shape == () and float(s) == 2.0
    from metafem_torch.solver.lowering import _BUILTIN_FNS as fns
    t = torch.tensor([1.0, 3.0], dtype=torch.float64)
    hits = config._cached_constant.cache_info().hits
    fns["max"](t, 2.0)
    fns["max"](t, 2.0)
    assert config._cached_constant.cache_info().hits >= hits + 1


def test_constants_keep_the_sign_of_zero():
    for first, second in ((0.0, -0.0), (-0.0, 0.0)):
        a = config.device_constant(first, torch.float64, "cpu")
        b = config.device_constant((second, 1.0), torch.float64, "cpu")
        c = config.device_constant(second, torch.float64, "cpu")
        assert not a.requires_grad and not c.requires_grad
        assert np.copysign(1.0, float(a)) == np.copysign(1.0, first)
        assert np.copysign(1.0, float(b[0])) == np.copysign(1.0, second)
        assert np.copysign(1.0, float(c)) == np.copysign(1.0, second)


def _host_step():
    dom, mesh = thermal_2d.build((8, 4), device="cpu")
    thermal_2d.step(dom)
    return dom.x


def _jit_step():
    dom, mesh = thermal_2d.build((8, 4), device="cpu")
    dom.update_one_step_jit(max_iter=6, sv_func=krylov.bicgstab,
                            precond="jacobi")
    return dom.x


def _refined_step():
    dom, mesh = thermal_2d.build((8, 4), device="cpu")
    dom.freeze_linear_tangent()
    dom.freeze_refined_residual()
    step = dom.make_refined_step(sv_func=krylov.bicgstab, precond="jacobi")
    x, _, res, _ = step(dom._runtime_state(), dom.x, dom.dt, dom.dt)
    assert res < 1e-6
    return x


def _dynamic_step():
    """Two levels of time derivatives and the dissipative alpha (J2)."""
    from metafem_torch.examples import j2_plasticity as j2
    dom, wp, p = j2.build(e_number=2, device="cpu")
    j2.run_load_sequence(dom, wp, p, [120.0], Y_initial=100, Eb=25e3,
                         Ep=25e3, max_relax=3)
    return dom.x


@pytest.mark.parametrize("run", [_host_step, _jit_step, _refined_step,
                                 _dynamic_step],
                         ids=["update_one_step", "jitted", "refined",
                              "second_order"])
def test_steps_are_bitwise_unchanged_by_the_cache(run, monkeypatch):
    cached = run()
    monkeypatch.setattr(config, "_cached_constant", _copy_every_call)
    assert torch.equal(cached, run())
