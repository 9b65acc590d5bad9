"""Checkpoints, VTK output and profiling of the PyTorch port, against the
reference package.

The cases of tests/test_aux.py on the port's twin of its transient
order-2 quad domain (dT/dt + lam T = 0, direct solver): a resumed run
is bit for bit the uninterrupted one, a checkpoint of another mesh is
refused, the VTK writer writes a quadratic quad, the memory ledger and
the phase timer report.  Beside them:

- checkpoints cross between the packages both ways: the resumed domain
  steps on with the direct solver and its x agrees with the other
  package's uninterrupted run within 1e-12 * max|x| (both solve the same
  float64 systems by sparse LU);
- ``write_vtk`` writes the same bytes as the reference writer for the
  same mesh and fields, with and without ``shift_field``, and on a
  serendipity mesh whose ghost lattice slots it compacts away;
- ``memory_report`` has the reference's keys and values on the same
  domain and dtype, except that the port's element-to-control-point
  tables are int64 where the reference's are int32 (4 more bytes per
  entry, counted here), and that the port counts 8 bytes per K entry on
  a float64 domain where the reference counts 4 (its dtype test misses
  the jax.numpy float64 type);
- ``trace_profile`` on the CPU writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metafem as ref_mf
from metafem import Bilinear as RefBilinear
from metafem.io import write_vtk as ref_write_vtk
from metafem.io.checkpoint import load_checkpoint as ref_load_checkpoint
from metafem.io.checkpoint import save_checkpoint as ref_save_checkpoint
from metafem.solver.domain import FEM_Domain as RefDomain
from metafem.utils import memory_report as ref_memory_report

import metafem_torch as mf
from metafem_torch import Bilinear
from metafem_torch.io import load_checkpoint, save_checkpoint, write_vtk
from metafem_torch.solver.domain import FEM_Domain
from metafem_torch.utils import memory_report, phase_timer, trace_profile

from test_refined import _radiating_thermal
from test_torch_refined import _port_radiating

torch.set_num_threads(2)


def _transient(pkg="port", n=3, dtype=None):
    """tests/test_aux.py's _make_transient_domain in either package."""
    if pkg == "port":
        lib, Dom, Bil = mf, FEM_Domain, Bilinear
        kw = {"device": "cpu", "dtype": dtype or torch.float64}
    else:
        lib, Dom, Bil = ref_mf, RefDomain, RefBilinear
        kw = {"dtype": dtype or jnp.float64}
    vert, conn = lib.make_square((1.0, 1.0), (n, n))
    geo = lib.construct_total_mesh(vert, conn)
    dom = Dom(2, **kw)
    wp = dom.add_workpiece(geo)
    T = dom.internal_var("T")
    lam = dom.external_var("lam", "GLOBAL_VAR")
    dom.assign_workpiece_weakform(wp, Bil(T, T.dt() + lam * T))
    dom.global_vars["lam"] = 0.7
    dom.initialize_local_assembly()
    # order-2 elements need itg_order >= 4 for a full-rank mass matrix
    dom.mesh_classical(itp_order=2, itg_order=5)
    dom.assemble_global_variables()
    dom.compile()
    dom.converge_tol = 1e-12
    dom.linear_solver = dom.make_direct_solver()
    mesh = dom.workpieces[wp].mesh
    dom.set_field(wp, "T", np.ones(mesh.n_cp))
    dom.set_field(wp, "T_t", np.full(mesh.n_cp, -0.7))
    dom.assemble_x()
    dom.dt = 0.05
    return dom, wp


def _steps(dom, n):
    for _ in range(n):
        dom.update_one_step(max_iter=3)


def _x(dom) -> np.ndarray:
    x = dom.x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TestCheckpoint:
    def test_save_load_resume_bitexact(self, tmp_path):
        dom, wp = _transient()
        _steps(dom, 3)
        dom.dessemble_x()
        dom.user_state = {"hist": np.arange(4.0), "nested": {"Y": 2.5}}
        ckpt = str(tmp_path / "state.npz")
        save_checkpoint(dom, ckpt)
        _steps(dom, 2)
        x_expected = dom.x.clone()

        dom2, _ = _transient()
        meta = load_checkpoint(dom2, ckpt)
        assert meta["t"] == pytest.approx(0.15)
        assert dom2.x.dtype == dom2.dtype and dom2.x.device == dom2.device
        hist = dom2.user_state["hist"]
        assert isinstance(hist, torch.Tensor) and hist.device == dom2.device
        assert torch.equal(hist, torch.arange(4.0, dtype=torch.float64))
        assert dom2.user_state["nested"]["Y"] == 2.5
        _steps(dom2, 2)
        assert torch.equal(dom2.x, x_expected)

    def test_shape_mismatch_rejected(self, tmp_path):
        dom, _ = _transient()
        ckpt = str(tmp_path / "s.npz")
        save_checkpoint(dom, ckpt)
        vert, conn = mf.make_square((1.0, 1.0), (4, 4))
        geo = mf.construct_total_mesh(vert, conn)
        dom3 = FEM_Domain(2, device="cpu")
        wpx = dom3.add_workpiece(geo)
        T = dom3.internal_var("T")
        dom3.assign_workpiece_weakform(wpx, Bilinear(T, T.dt() + T))
        dom3.initialize_local_assembly()
        dom3.mesh_classical(itp_order=2, itg_order=5)
        dom3.assemble_global_variables()
        with pytest.raises(ValueError, match="shape mismatch"):
            load_checkpoint(dom3, ckpt)

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_checkpoint_crosses_packages(self, tmp_path, writer):
        """One package writes after 3 steps and steps 2 more; the other
        loads and steps 2 more with the direct solver."""
        src, wp = _transient("ref" if writer == "reference" else "port")
        dst, _ = _transient("port" if writer == "reference" else "ref")
        _steps(src, 3)
        src.dessemble_x()
        src.user_state = {"hist": np.arange(3.0)}
        ckpt = str(tmp_path / "cross.npz")
        (ref_save_checkpoint if writer == "reference"
         else save_checkpoint)(src, ckpt)
        _steps(src, 2)
        meta = (load_checkpoint if writer == "reference"
                else ref_load_checkpoint)(dst, ckpt)
        assert meta["t"] == pytest.approx(0.15)
        np.testing.assert_array_equal(
            np.asarray(dst.workpieces[0].mesh.fields["T"]),
            np.load(ckpt)["wp0.T"])
        np.testing.assert_array_equal(np.asarray(dst.user_state["hist"]),
                                      np.arange(3.0))
        _steps(dst, 2)
        assert dst.t == pytest.approx(src.t)
        x_src, x_dst = _x(src), _x(dst)
        np.testing.assert_allclose(x_dst, x_src, rtol=0,
                                   atol=1e-12 * np.abs(x_src).max())


def _vtk_pair(tmp_path, ref_mesh, ref_et, port_mesh, port_et, **kw):
    a, b = str(tmp_path / "ref.vtk"), str(tmp_path / "port.vtk")
    ref_write_vtk(a, ref_mesh, ref_et, **kw)
    write_vtk(b, port_mesh, port_et, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read(), fb.read()


class TestVTK:
    def test_write_quadratic_quad(self, tmp_path):
        dom, wp = _transient()
        dom.dessemble_x()
        path = str(tmp_path / "out.vtk")
        write_vtk(path, dom.workpieces[wp].mesh,
                  dom.workpieces[wp].disc.element_type)
        txt = open(path).read()
        assert "UNSTRUCTURED_GRID" in txt
        assert "SCALARS T double" in txt
        mesh = dom.workpieces[wp].mesh
        assert f"POINTS {mesh.n_cp} double" in txt
        assert f"CELLS {mesh.n_el}" in txt

    @pytest.mark.parametrize("shift", [False, True])
    def test_bytes_equal_reference(self, tmp_path, shift):
        ref, _ = _transient("ref")
        dom, _ = _transient()
        _steps(ref, 2)
        _steps(dom, 2)
        for d in (ref, dom):
            d.dessemble_x()
        rm, pm = ref.workpieces[0].mesh, dom.workpieces[0].mesh
        np.testing.assert_array_equal(pm.cp_coords, rm.cp_coords)
        np.testing.assert_array_equal(pm.el_cp, rm.el_cp)
        rng = np.random.default_rng(4)
        fields = {name: np.asarray(col) for name, col in rm.fields.items()}
        fields["u1"] = 1e-2 * rng.standard_normal(rm.n_cp)
        fields["u2"] = 1e-2 * rng.standard_normal(rm.n_cp)
        for name, col in fields.items():
            ref.set_field(0, name, col)
            dom.set_field(0, name, col)
        kw = {"shift_field": "u", "shift_scale": 3.0} if shift else {}
        a, b = _vtk_pair(tmp_path, rm, ref.workpieces[0].disc.element_type,
                         pm, dom.workpieces[0].disc.element_type, **kw)
        assert b"SCALARS u1 double" in b
        assert a == b

    def test_bytes_equal_reference_with_ghost_slots(self, tmp_path):
        """Order-2 serendipity quads leave the lattice's element centres
        unoccupied: both writers compact them away."""
        ref = _radiating_thermal(nel=(8, 4))
        dom = _port_radiating(nel=(8, 4))
        rm, pm = ref.workpieces[0].mesh, dom.workpieces[0].mesh
        occ = np.asarray(pm.is_occupied, bool)
        assert not occ.all()
        rng = np.random.default_rng(5)
        T = 300.0 + rng.standard_normal(rm.n_cp)
        ref.set_field(0, "T", T)
        dom.set_field(0, "T", T)
        a, b = _vtk_pair(tmp_path, rm, ref.workpieces[0].disc.element_type,
                         pm, dom.workpieces[0].disc.element_type)
        assert f"POINTS {int(occ.sum())} double".encode() in b
        assert a == b


def _index_entries(dom) -> int:
    """Entries of the element-to-control-point tables in the state."""
    n = 0
    for wps in dom.state["wp"]:
        n += wps["el"]["el_cp"].numel()
        n += sum(part["el_cp"].numel() for parts in wps["bdy"].values()
                 for part in parts)
    return n


class TestObservability:
    def test_memory_report(self):
        dom, _ = _transient()
        rep = memory_report(dom, unit="KB")
        assert rep["TOTAL (KB)"] > 0
        assert rep["wp0.geometry"] > 0
        assert rep["sparse.K(linear+total)"] > 0

    @pytest.mark.parametrize("case", ["transient_f64", "transient_f32",
                                      "radiating"])
    def test_memory_report_matches_reference(self, case):
        if case == "radiating":          # boundary tables, ghost slots
            ref = _radiating_thermal(nel=(8, 4))
            dom = _port_radiating(nel=(8, 4))
        else:
            f32 = case.endswith("f32")
            ref, _ = _transient("ref", dtype=jnp.float32 if f32 else None)
            dom, _ = _transient(dtype=torch.float32 if f32 else None)
        f64 = dom.dtype == torch.float64
        hist = np.arange(4.0, dtype=np.float64 if f64 else np.float32)
        for d in (ref, dom):
            d.user_state = {"hist": hist, "Y": 2.5}
        rep_ref = ref_memory_report(ref, unit="B")
        rep = memory_report(dom, unit="B")
        assert list(rep) == list(rep_ref)
        # the port's el_cp tables are int64 where the reference's are
        # int32; and the reference counts 4 bytes per K entry for any
        # dtype whose str() is not "float64", which a jax.numpy float64
        # type's is not (metafem/utils/profiling.py:77-78)
        extra = {"wp0.geometry": 4 * _index_entries(dom)}
        assert extra["wp0.geometry"] > 0
        if f64:
            extra["sparse.K(linear+total)"] = rep_ref[
                "sparse.K(linear+total)"]
        extra["TOTAL (B)"] = sum(extra.values())
        for key, want in rep_ref.items():
            assert rep[key] == want + extra.get(key, 0), key
        assert rep["sparse.K(linear+total)"] == \
            2 * dom.pattern.nnz * (8 if f64 else 4)
        assert memory_report(dom, unit="MB")["TOTAL (MB)"] == \
            rep["TOTAL (B)"] / 2 ** 20

    def test_phase_timer(self, capsys):
        times = {}
        with phase_timer("demo", results=times) as out:
            out.append(torch.ones(3) * 2)
        with phase_timer("demo", results=times, verbose=False):
            pass
        assert "demo" in times and times["demo"] > 0
        assert capsys.readouterr().out.count("demo") == 1

    def test_trace_profile_writes_chrome_trace(self, tmp_path):
        logdir = str(tmp_path / "trace")
        a = torch.randn(64, 64, dtype=torch.float64)
        with trace_profile(logdir) as prof:
            (a @ a).sum()
        assert os.path.dirname(prof.trace_path) == logdir
        with open(prof.trace_path) as f:
            trace = json.load(f)
        names = {ev.get("name", "") for ev in trace["traceEvents"]}
        assert any("mm" in n for n in names), sorted(names)[:20]
