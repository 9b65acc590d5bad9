"""Freeze persistence, host-side freezes and the volume-table release of
the PyTorch port, against the reference package.

The cases of tests/test_freeze_persist.py on the port's twin of
``_radiating_thermal`` at nel=(8,4) (affine volume, T^4 radiation on a
boundary): a fresh identical domain that loads the pickle steps bit for
bit as the domain that computed the freezes; the pickle holds numpy
arrays only and no copy of the state's volume tables; a stale layout is
refused; releasing the volume tables leaves the step bit for bit equal,
and paths that assemble volumes refuse to run until ``update_mesh``.

Beside them, against the reference on the same mesh: the layout
fingerprint is equal; ``freeze_linear_tangent(on_host=True)``'s
components, ``_host_tangent`` and the A_td that ``freeze_refined_residual``
takes from the host components agree to 1e-12 of each operator's
largest entry (the same float64 element arithmetic, summed in another
order).  And the flagship bench warm-starts from ``--freeze-cache``: the
second run loads the freezes and its step is bit for bit the first's.
"""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metafem_torch import bench
from metafem_torch.linsolve import krylov
from metafem_torch.solver.domain import StaleFreezeCache

from test_refined import _radiating_thermal
from test_torch_refined import _port_radiating

torch.set_num_threads(2)

NEL = (8, 4)


def _frozen_dom(**kw):
    dom = _port_radiating(nel=NEL, **kw)
    dom.converge_tol = 1e-10
    dom.freeze_linear_tangent()
    dom.freeze_refined_residual()
    return dom


def _one_step(dom):
    step = dom.make_refined_step(sv_func=krylov.bicgstab, maxiter=200,
                                 max_refine=8, max_pass=1, precond="jacobi")
    x1, _, res, _ = step(dom._runtime_state(), dom.x, 0.0, 1.0)
    return x1, res


def _rel(got, want):
    got = (got.double().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float64))
    want = (want.double().numpy() if torch.is_tensor(want)
            else np.asarray(want, np.float64))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_save_load_roundtrip_matches(tmp_path):
    dom = _frozen_dom()
    x_ref, res_ref = _one_step(dom)
    assert res_ref < 1e-10

    fz = str(tmp_path / "fz.pkl")
    dom.save_freezes(fz)
    with open(fz, "rb") as f:
        blob = pickle.load(f)
    # host arrays only, and the alias sentinel instead of the state's
    # volume tables
    assert not any(isinstance(v, torch.Tensor) for v in _leaves(blob))
    assert set(blob) == {"_k_linear_td", "_refined", "_layout_fp"}
    for w in blob["_refined"]["wp"]:
        assert w["el"] == "__state_el__"
        assert w["fields"] == "__mesh_fields64__"

    dom2 = _port_radiating(nel=NEL)
    dom2.converge_tol = 1e-10
    dom2.load_freezes(fz)
    assert dom2._refined["wp"][0]["el"] is dom2.state["wp"][0]["el"]
    assert dom2._refined["A"].dtype == torch.float64
    assert dom2._k_linear_td.dtype == dom._k_linear_td.dtype
    fields = dom._refined["wp"][0]["fields"]
    assert set(dom2._refined["wp"][0]["fields"]) == set(fields)
    for name, col in dom2._refined["wp"][0]["fields"].items():
        # ghost slots' coordinates are NaN
        np.testing.assert_array_equal(col.numpy(), fields[name].numpy())
    x2, res2 = _one_step(dom2)
    assert torch.equal(x2, x_ref)
    assert res2 == res_ref


def test_stale_layout_rejected(tmp_path):
    dom = _frozen_dom()
    fz = str(tmp_path / "fz.pkl")
    dom.save_freezes(fz)
    dom2 = _port_radiating(nel=(10, 4))        # another layout
    with pytest.raises(ValueError, match="stale cache"):
        dom2.load_freezes(fz)
    with pytest.raises(StaleFreezeCache):
        dom2.load_freezes(fz)
    assert dom2._refined is None and dom2._k_linear_td is None


def test_free_volume_tables_step_identical():
    dom = _frozen_dom()
    x_ref, _ = _one_step(dom)
    dom.free_volume_tables()
    el = dom.state["wp"][0]["el"]
    assert el["itg_vals"] is None and el["weights"] is None
    assert el["el_cp"] is not None       # boundary gathers index through it
    assert dom._refined["wp"][0]["el"] is el
    x2, res2 = _one_step(dom)
    assert torch.equal(x2, x_ref)
    assert res2 < 1e-10


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_free_volume_tables_guards(dtype):
    dom = _port_radiating(nel=NEL, dtype=dtype)
    with pytest.raises(RuntimeError, match="freeze_refined_residual"):
        dom.free_volume_tables()
    dom_nl = _port_radiating(nel=NEL, dtype=dtype, nonlinear_volume=True)
    dom_nl.freeze_linear_tangent()
    dom_nl.freeze_refined_residual()
    with pytest.raises(RuntimeError, match="volume-nonaffine"):
        dom_nl.free_volume_tables()
    assert dom_nl.state["wp"][0]["el"]["itg_vals"] is not None


def test_freed_tables_fail_fast():
    dom = _frozen_dom()
    dom.free_volume_tables()
    calls = (dom.update_one_step, dom.update_one_step_jit,
             dom.assemble_tangent, dom.setup_mg,
             lambda: dom.make_jitted_step(sv_func=krylov.bicgstab))
    for call in calls:
        with pytest.raises(RuntimeError, match="free_volume_tables"):
            call()
    dom.update_mesh()
    assert dom.state["wp"][0]["el"]["itg_vals"] is not None
    dom.update_one_step(max_iter=1)      # rebuilt tables: runs again


def test_legacy_pickle_el_copy_dropped(tmp_path):
    """A file carrying a full copy of the state's volume tables (the
    reference's format before its sentinel) reloads without the copy:
    the live state's tables are re-attached by identity."""
    dom = _frozen_dom()
    x_ref, res_ref = _one_step(dom)
    fz = str(tmp_path / "fz_legacy.pkl")
    dom.save_freezes(fz)
    with open(fz, "rb") as f:
        blob = pickle.load(f)
    blob["_refined"]["wp"] = [
        {**w, "el": {k: v.numpy() for k, v in
                     dom.state["wp"][i]["el"].items()}}
        for i, w in enumerate(blob["_refined"]["wp"])]
    with open(fz, "wb") as f:
        pickle.dump(blob, f, protocol=4)
    dom2 = _port_radiating(nel=NEL)
    dom2.converge_tol = 1e-10
    dom2.load_freezes(fz)
    assert dom2._refined["wp"][0]["el"] is dom2.state["wp"][0]["el"]
    x2, res2 = _one_step(dom2)
    assert torch.equal(x2, x_ref)
    assert res2 == res_ref


def test_nonaffine_volume_roundtrip(tmp_path):
    """A float32 domain with a nonaffine volume keeps its own float64
    volume tables and their two-float split in the refined record: both
    are saved and loaded, not replaced by the state's."""
    dom = _port_radiating(nel=NEL, dtype=torch.float32,
                          nonlinear_volume=True)
    dom.freeze_linear_tangent()
    dom.freeze_refined_residual()
    fz = str(tmp_path / "fz.pkl")
    dom.save_freezes(fz)
    dom2 = _port_radiating(nel=NEL, dtype=torch.float32,
                           nonlinear_volume=True)
    dom2.load_freezes(fz)
    el, el2 = dom._refined["wp"][0]["el"], dom2._refined["wp"][0]["el"]
    assert el2 is not dom2.state["wp"][0]["el"]
    assert el2["itg_vals"].dtype == torch.float64
    assert torch.equal(el2["itg_vals"], el["itg_vals"])
    df, df2 = dom._refined["wp_df"][0]["el"], dom2._refined["wp_df"][0]["el"]
    assert type(df2["itg_vals"]) is type(df["itg_vals"])
    assert torch.equal(df2["itg_vals"].hi, df["itg_vals"].hi)
    assert torch.equal(df2["itg_vals"].lo, df["itg_vals"].lo)


def test_layout_fingerprint_matches_reference():
    ref = _radiating_thermal(nel=NEL)
    dom = _port_radiating(nel=NEL)
    fp = dom._layout_fp()
    assert fp == tuple(ref._layout_fp())
    assert all(type(v) is int for v in fp)


@pytest.mark.parametrize("transient", [False, True])
def test_on_host_linear_tangent_matches(transient):
    ref = _radiating_thermal(nel=NEL, transient=transient)
    dom = _port_radiating(nel=NEL, transient=transient)
    if transient:
        for d in (ref, dom):
            d.time_discretization.update_time(0.5, d.pattern.max_time_level)
    ref.freeze_linear_tangent(on_host=True)
    dom.freeze_linear_tangent(on_host=True)
    host = dom._k_linear_td.clone()
    assert host.shape[0] == (2 if transient else 1)
    assert host.dtype == dom.dtype and host.device == dom.device
    assert _rel(host, np.asarray(ref._k_linear_td)) <= 1e-12
    assert len(dom._host_lin_td64()) == host.shape[0]
    dom.freeze_linear_tangent(on_host=False)
    assert _rel(host, dom._k_linear_td) <= 1e-12


def test_on_host_default_follows_the_lattice(monkeypatch):
    dom = _port_radiating(nel=NEL)

    def refuse():
        raise AssertionError("a lattice mesh took the host path")
    monkeypatch.setattr(dom, "_host_lin_td64", refuse)
    dom.freeze_linear_tangent()
    assert dom._k_linear_td is not None
    mesh = dom.workpieces[0].mesh
    monkeypatch.setattr(mesh, "lattice_shape", None)
    with pytest.raises(AssertionError, match="host path"):
        dom.freeze_linear_tangent()


def test_host_tangent_matches_assembled():
    ref = _radiating_thermal(nel=NEL)
    dom = _port_radiating(nel=NEL)
    rng = np.random.default_rng(12)
    x = np.asarray(ref.x) * (1.0 + 0.05 * rng.standard_normal(ref.x.shape))
    ref.x = jnp.asarray(x)
    dom.x = torch.as_tensor(x)
    A, _ = dom.assemble_tangent()
    K_host = dom._host_tangent()
    assert K_host.dtype == np.float64
    assert _rel(K_host, A.vals) <= 1e-12
    ref.time_discretization.update_time(ref.dt, ref.pattern.max_time_level)
    assert _rel(K_host, np.asarray(ref._host_tangent())) <= 1e-12


def test_refined_freeze_takes_host_components():
    ref = _radiating_thermal(nel=NEL)
    dom = _port_radiating(nel=NEL)
    for d in (ref, dom):
        d.freeze_linear_tangent(on_host=True)
    assert dom._all_forms_affine() and ref._all_forms_affine()
    phases = []
    run = dom._run_phase

    def recording(st, phase):
        phases.append(phase)
        return run(st, phase)
    dom._run_phase = recording
    dom.freeze_refined_residual()
    dom._run_phase = run
    assert "aff_lin" not in phases and "aff_res" in phases
    ref.freeze_refined_residual()
    A_ref = (np.asarray(ref._refined["A_hi"], np.float64)
             + np.asarray(ref._refined["A_lo"], np.float64))
    A = dom._refined["A"]
    assert A.dtype == torch.float64
    assert _rel(A, A_ref) <= 1e-12
    # the device path's A_td on the same domain
    dom.drop_host_caches()
    dom.freeze_refined_residual()
    assert _rel(A, dom._refined["A"]) <= 1e-12


@pytest.mark.parametrize("mutate", ["refresh_fields", "set_field",
                                    "dessemble_x", "update_mesh"])
def test_host_caches_dropped_on_field_changes(mutate):
    dom = _port_radiating(nel=NEL)
    dom._host_wp64()
    dom._host_lin_td64()
    assert dom._host_wp64_cache is not None
    assert dom._host_lin_td64_cache is not None
    if mutate == "set_field":
        mesh = dom.workpieces[0].mesh
        dom.set_field(0, "s", np.ones(mesh.n_cp))
    else:
        getattr(dom, mutate)()
    assert dom._host_wp64_cache is None
    assert dom._host_lin_td64_cache is None


def test_bench_warm_start_from_freeze_cache(tmp_path, capsys):
    """bench --freeze-cache: the first run computes and saves, the second
    loads and steps bit for bit as the first; a cache of another mesh is
    stale, and that run recomputes and saves anew."""
    fz = str(tmp_path / "fz.pkl")
    cold = bench.run((8, 4), device="cpu", log=None, freeze_cache=fz)
    assert "save_freezes" in cold["one_time_s"]
    assert "load_freezes" not in cold["one_time_s"]
    warm = bench.run((8, 4), device="cpu", log=None, freeze_cache=fz)
    assert set(warm["one_time_s"]) == {"setup", "load_freezes"}
    assert warm["converge_once_residual"] is None
    assert torch.equal(warm["_x"], cold["_x"])
    assert warm["final_residual"] == cold["final_residual"] < 1e-6
    assert warm["cheb_interval"] == cold["cheb_interval"]
    other = bench.run((10, 4), device="cpu", log=None, freeze_cache=fz)
    assert "stale cache" in capsys.readouterr().err
    assert "save_freezes" in other["one_time_s"]
    assert other["final_residual"] < 1e-6


def _assert_same_tree(a, b, path="freezes"):
    """Equal structure, and tensors of equal dtype, shape and bits."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device), \
            path
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same_tree(u, v, f"{path}[{i}]")
    elif hasattr(a, "vals") and hasattr(a, "layout"):       # OffsetMatrix
        assert b.layout is not None, path
        _assert_same_tree(a.vals, b.vals, path + ".vals")
    else:
        assert a == b, path


def test_multigrid_freezes_roundtrip(tmp_path):
    """The flagship's whole freeze set (float32 domain: linear tangent,
    refined record, V-cycle state with its fine OffsetMatrix, hierarchy,
    tuned spectrum and Chebyshev enclosure) comes back with every
    tensor's dtype, shape and bits."""
    dom = bench.build_domain((8, 4), device="cpu")
    dom.freeze_linear_tangent()
    dom.setup_mg()
    dom.freeze_refined_residual()
    assert dom._mg_cheb is not None
    fz = str(tmp_path / "fz.pkl")
    dom.save_freezes(fz)
    dom2 = bench.build_domain((8, 4), device="cpu")
    dom2.load_freezes(fz)
    for name in ("_k_linear_td", "_refined", "_mg_frozen", "_mg_hier",
                 "_mg_cheb", "_mg_spectrum"):
        _assert_same_tree(getattr(dom, name), getattr(dom2, name), name)
    assert dom2._mg_frozen[0]["A"].layout is dom2.pattern.offset_layout
    for name in ("_auxmg", "_auxmg_cheb", "_auxmg_spectrum"):
        assert getattr(dom2, name, None) is None
