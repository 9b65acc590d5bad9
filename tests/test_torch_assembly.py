"""Assembly of the PyTorch port against the reference package.

The thermal strip of the README at nel=(20,10): the reference's
``tests/test_multigrid._thermal_domain`` and the port's
``examples/thermal_2d.build`` state the same weak forms.  Both start
from the same x (a seeded, non-uniform temperature, so the T^4 radiation
term is exercised away from a constant state) and the port's
``k_linear``, ``residue`` and ``K_total`` must agree with the
reference's ``dom._k_linear`` and ``dom._res_k`` within 1e-10 of each
vector's largest entry.  The default layout at this size spills most
offsets to the COO tail (n_cp = 861 < 4096), which exercises the gather
maps; the ``dense_min_n=0`` layout keeps every offset dense, so the whole
tangent reduces by strided lattice adds and the tail is empty.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metafem.solver.domain import FEM_Domain as RefDomain
from metafem_torch import interop
from metafem_torch.examples import thermal_2d
from metafem_torch.solver.domain import FEM_Domain

from test_multigrid import _thermal_domain

torch.set_num_threads(2)

NEL = (20, 10)


def _state(dom):
    """Runtime state with K_linear assembled, as update_one_step uses."""
    dom.time_discretization.update_time(dom.dt, dom.pattern.max_time_level)
    st = dom._runtime_state()
    st["K_linear"] = dom._k_linear(st)
    return st


@pytest.mark.parametrize("dense", [False, True], ids=["default", "dense"])
def test_updaters_match_reference(dense, monkeypatch):
    if dense:
        for cls in (RefDomain, FEM_Domain):
            orig = cls.assemble_global_variables

            def dense_layout(self, _orig=orig, **opts):
                return _orig(self, dense_min_n=0, **opts)
            monkeypatch.setattr(cls, "assemble_global_variables",
                                dense_layout)
    ref = _thermal_domain(nel=NEL)
    dom, _ = thermal_2d.build(NEL, device="cpu")
    lo_r, lo_p = ref.pattern.offset_layout, dom.pattern.offset_layout
    assert lo_p.segments == lo_r.segments
    assert lo_p.n_coo == lo_r.n_coo
    if dense:
        assert lo_p.n_coo == 0
        fast_k = dom._fast_maps["lin"]["k"]     # volume K streams
        assert fast_k and all(rest.size == 0 for _, rest in fast_k.values())
    else:
        assert lo_p.n_coo > 0

    rng = np.random.default_rng(11)
    x = 500.0 + 100.0 * rng.standard_normal(np.asarray(ref.x).shape)
    ref.x = jnp.asarray(x)
    interop.load_reference_state(dom, x=x, t=ref.t, dt=ref.dt)

    st_r, st_p = _state(ref), _state(dom)
    res_r, K_r = ref._res_k(st_r)
    res_p, K_p = dom._res_k(st_p)
    for got, want in ((st_p["K_linear"], st_r["K_linear"]),
                      (res_p, res_r), (K_p, K_r)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


def test_reference_fields_load_into_the_port():
    """Named controlpoint columns carried across by load_reference_state
    land on the port's mesh and in its runtime state, as the reference's
    set_field puts them on its mesh."""
    ref = _thermal_domain(nel=(6, 3))
    dom, _ = thermal_2d.build((6, 3), device="cpu")
    T = 300.0 + np.random.default_rng(5).random(dom.workpieces[0].mesh.n_cp)
    ref.set_field(0, "T", T)
    interop.load_reference_state(dom, fields={0: {"T": T}})
    want = np.asarray(ref.workpieces[0].mesh.fields["T"])
    assert np.array_equal(dom.workpieces[0].mesh.fields["T"], want)
    got = dom._runtime_state()["wp"][0]["fields"]["T"]
    assert got.dtype == dom.dtype and got.device == dom.device
    assert np.array_equal(got.numpy(), want)


def test_assembly_repeats_bitwise():
    dom, _ = thermal_2d.build((6, 3), device="cpu")
    st = _state(dom)
    r1, K1 = dom._res_k(st)
    r2, K2 = dom._res_k(st)
    assert torch.equal(r1, r2) and torch.equal(K1, K2)


def test_elastic_tangent_matches_reference():
    """Two coupled channels (C=2, full 2x2 units) through symbolic
    definitions and a symmetric-tensor field: chip_smoke's elastic
    operator against the reference fixture it mirrors."""
    import chip_smoke
    from test_multigrid import _elastic_domain_2d, _tangent
    A_r, res_r = _tangent(_elastic_domain_2d(nel=(8, 4)))
    A_p, res_p = chip_smoke.elastic_domain((8, 4), "cpu").assemble_tangent()
    assert A_p.layout.segments == A_r.layout.segments
    for got, want in ((A_p.vals, A_r.vals), (res_p, res_r)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


def test_builtin_functions_take_tensors_and_numbers():
    from metafem_torch.solver.lowering import _BUILTIN_FNS as fns
    t = torch.tensor([1.0, 3.0], dtype=torch.float64)
    assert torch.equal(fns["max"](t, 2.0), torch.tensor([2.0, 3.0],
                                                          dtype=t.dtype))
    assert torch.equal(fns["ifelse"](t > 2.0, t, 0.0),
                       torch.tensor([0.0, 3.0], dtype=t.dtype))
    assert float(fns["log"](1.0)) == 0.0
