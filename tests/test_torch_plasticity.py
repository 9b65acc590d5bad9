"""J2 plasticity of the PyTorch port against the reference package,
float64 on the CPU (``j2_plasticity`` at e_number=2, nel=(5,2,2), the
size of tests/test_plasticity.py): a user return map registered with
``user=`` history, the history kept as tensors on the domain's device
and updated through ``evaluate_at_itg``, sparse LU in both packages.

- ``evaluate_at_itg`` of each Voigt strain at a seeded x within
  1e-12 * max of the reference's;
- the first seven load levels of the isotropic sequence: the end
  elongations and the ep, b and Y history within 1e-8 * max of the
  reference's;
- the full mixed-hardening sequence against the analytic elongations
  at atol 1.5e-3 (the reference test's bar);
- the history checks of tests/test_plasticity.py: isotropic hardening
  moves Y and not b, kinematic hardening moves b and not Y.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))
import j2_plasticity as ref_j2  # noqa: E402

from metafem_torch import interop  # noqa: E402
from metafem_torch.examples import j2_plasticity as j2  # noqa: E402

torch.set_num_threads(2)


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


@pytest.fixture(scope="module")
def strained():
    """Both domains at one seeded x, with a seeded plastic history."""
    dom_r, wp_r, p = ref_j2.build(e_number=2)
    dom, wp, p_port = j2.build(e_number=2, device="cpu")
    assert p_port == p
    rng = np.random.default_rng(31)
    x = 1e-3 * rng.standard_normal(np.asarray(dom_r.x).shape)
    dom_r.x = jnp.asarray(x)
    interop.load_reference_state(dom, x=x)
    ref_j2.reset_history(dom_r, wp_r, 100.0, 25e3, 25e3)
    j2.reset_history(dom, wp, 100.0, 25e3, 25e3)
    return dom_r, wp_r, dom, wp


@pytest.mark.parametrize("ab", ref_j2._VOIGT, ids=lambda ab: f"e{ab[0]}{ab[1]}")
def test_evaluate_at_itg_matches_reference(strained, ab):
    dom_r, wp_r, dom, wp = strained
    want = np.asarray(dom_r.evaluate_at_itg(wp_r, dom_r.sym("e")[ab]))
    got = dom.evaluate_at_itg(wp, dom.sym("e")[ab])
    n_el = dom.workpieces[wp].mesh.n_el
    assert got.shape == (n_el, dom.workpieces[wp].disc.n_itg)
    assert got.device == dom.device and got.dtype == dom.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_return_map_through_user_history_matches_reference(strained):
    """The registered callback, reading the history through ``user``,
    evaluated at the quadrature points: ep of the return map."""
    dom_r, wp_r, dom, wp = strained
    for a, b in ((1, 1), (2, 3)):
        want = np.asarray(dom_r.evaluate_at_itg(wp_r, dom_r.sym("ep")[a, b]))
        got = dom.evaluate_at_itg(wp, dom.sym("ep")[a, b]).numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_isotropic_levels_match_reference():
    grp = ref_j2.SEQUENCES[0]
    runs = []
    for mod, kw in ((ref_j2, {}), (j2, {"device": "cpu"})):
        dom, wp, p = mod.build(e_number=2, **kw)
        d1s = mod.run_load_sequence(dom, wp, p, grp["s"][:7], Y_initial=100,
                                    Eb=grp["Eb"], Ep=grp["Ep"])
        runs.append((d1s, dom.user_state))
    (d1_r, u_r), (d1, u) = runs
    np.testing.assert_allclose(d1, d1_r, rtol=0,
                               atol=1e-8 * np.abs(d1_r).max())
    for key in ("ep", "b", "Y"):
        want = np.asarray(u_r[key])
        assert u[key].device.type == "cpu" and u[key].shape == want.shape
        np.testing.assert_allclose(_np(u[key]), want, rtol=0,
                                   atol=1e-8 * max(np.abs(want).max(), 1.0),
                                   err_msg=key)


def test_mixed_sequence_vs_analytic():
    dom, wp, p = j2.build(e_number=2, device="cpu")
    grp = j2.SEQUENCES[1]
    d1s = j2.run_load_sequence(dom, wp, p, grp["s"], Y_initial=100,
                               Eb=grp["Eb"], Ep=grp["Ep"])
    np.testing.assert_allclose(d1s, grp["d1"], atol=1.5e-3)


def test_hardening_state_evolution():
    """Isotropic hardening moves Y and not b; kinematic moves b and not
    Y."""
    dom, wp, p = j2.build(e_number=2, device="cpu")
    grp = j2.SEQUENCES[0]                 # Eb=0, Ep=Ey/2 (isotropic)
    j2.run_load_sequence(dom, wp, p, grp["s"][:7], Y_initial=100,
                         Eb=grp["Eb"], Ep=grp["Ep"])
    u = dom.user_state
    assert float(u["ep"].abs().max()) > 1e-4
    assert float(u["Y"].max()) > 100.0
    np.testing.assert_allclose(_np(u["b"]), 0.0)

    grp = j2.SEQUENCES[2]                 # Eb=Ey/2, Ep=0 (kinematic)
    j2.run_load_sequence(dom, wp, p, grp["s"][:5], Y_initial=100,
                         Eb=grp["Eb"], Ep=grp["Ep"])
    u = dom.user_state
    assert float(u["b"].abs().max()) > 1.0
    np.testing.assert_allclose(_np(u["Y"]), 100.0)
