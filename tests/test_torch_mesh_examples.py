"""The mesh readers and the two stress-concentration examples of the
PyTorch port against the reference package, float64 on the CPU, on
meshes that the test writes itself (the reference's Abaqus and COMSOL
files are not in this repository).

``chip_smoke``'s writers put each mesh in the two formats that
``read_mesh`` reads; the reference examples are pointed at the written
files by patching their ``REF_DIR``/``MESH_PATH``, and the port's
examples read the same files with ``device="cpu"``.

- ``read_mesh`` of each written .inp and .mphtxt (the quarter-hole
  plate, the quarter-hole block, the pikachu brick in centimetres and
  the duct with its stepped cylinder): vertices and connectivity exactly
  equal between the packages and to what was written;
- stress 2D (C=2 serendipity quads, 16 x 8) and 3D (C=3 serendipity
  hexes, 4 x 2 x 2) with sparse LU in both packages: d within 1e-9 *
  max|d|, and S22 of ``s22_at`` at the reference tests' points within
  1e-8 of each other (host numpy probes of the same fields);
- stress 2D with its own GMRES(20): d within 100 * converge_tol * max|d|
  of the reference's GMRES(20), and within the same of LU's.  The
  penalty-stiff operator (tau_b = 10^4 E / L^2) spreads what a residual
  of 1e-8 leaves in d: on this mesh the two GMRES runs stop 1240
  iterations in at 5.5e-7 * max|d| from each other, the reference's at
  9.2e-7 and the port's at 3.7e-7 from LU's d (on an 8 x 4 plate they
  take the same 520 iterations and agree to 1e-12);
- each stress example with the port's layout forced to a BSR tail
  (``layout_opts={"blk_min_tail": 1}``) and the Krylov solver (GMRES(20)
  in 2D, IDR(8) in 3D), against the reference's default layout with the
  same solver, within the bar of that solver (100 * converge_tol *
  max|d| for GMRES, 10 * converge_tol * max|d| for IDR(8)): the only
  check of the C=2 and C=3 BSR tails against the reference on the CPU.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))
import stress_concentration_2d as ref_sc2  # noqa: E402
import stress_concentration_3d as ref_sc3  # noqa: E402
from metafem.mesh import readers as ref_readers  # noqa: E402

import chip_smoke  # noqa: E402
import metafem_torch as mf  # noqa: E402
from metafem_torch.examples import stress_concentration_2d as sc2  # noqa
from metafem_torch.examples import stress_concentration_3d as sc3  # noqa
from metafem_torch.solver.domain import FEM_Domain  # noqa: E402

torch.set_num_threads(2)

PLATE = (16, 8)
BLOCK = (4, 2, 2)
#: the reference tests' probe points (tests/test_stress_concentration.py
#: and tests/test_stress_concentration_3d.py)
PTS_2D = np.array([[3.92, 0.0], [3.8, 0.0], [3.6, 0.0]])
PTS_3D = np.array([[1.25, 0.0, 0.0], [1.75, 0.0, 0.0], [2.5, 0.0, 0.0]])
#: the examples' Newton tolerance (converge_tol)
TOL = 1e-8


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("abaqus")
    chip_smoke.write_inp(str(d / "2D_Mesh.inp"),
                         *chip_smoke.plate_2d(*PLATE))
    chip_smoke.write_inp(str(d / "3D_Mesh.inp"),
                         *chip_smoke.block_3d(*BLOCK))
    return str(d)


@pytest.mark.parametrize("name", ["plate.inp", "block.inp", "brick.mphtxt",
                                  "duct.mphtxt"])
def test_read_mesh_matches_reference(tmp_path, name):
    make = {"plate.inp": lambda: chip_smoke.plate_2d(*PLATE),
            "block.inp": lambda: chip_smoke.block_3d(*BLOCK),
            "brick.mphtxt": lambda: chip_smoke.pikachu_brick_cm((3, 2, 2)),
            "duct.mphtxt": lambda: chip_smoke.duct((12, 3, 3))}[name]
    vert, conn = make()
    path = str(tmp_path / name)
    (chip_smoke.write_inp if name.endswith(".inp")
     else chip_smoke.write_mphtxt)(path, vert, conn)
    v_port, c_port = mf.read_mesh(path)
    v_ref, c_ref = ref_readers.read_mesh(path)
    assert np.array_equal(v_port, v_ref) and np.array_equal(c_port, c_ref)
    assert np.array_equal(v_port, vert) and np.array_equal(c_port, conn)
    geo = mf.construct_total_mesh(v_port, c_port)
    assert geo.shape == ("CUBE" if name.endswith(".inp") else "SIMPLEX")
    if name == "plate.inp":
        # counter-clockwise quads
        p = v_port[c_port]
        area = np.sum(p[:, :, 0] * np.roll(p[:, :, 1], -1, 1)
                      - np.roll(p[:, :, 0], -1, 1) * p[:, :, 1], axis=1)
        assert (area > 0).all()


def test_block_facet_tests_take_only_their_planes():
    """chip_smoke's block at the card's size: the example's facet tests
    (centre within 0.05 of x = 0, of y = 0) take the symmetry plane's
    faces and the one column of hole faces beside it, and no face of the
    z = 0 plane; with 24 angular cells they took z = 0 faces up to
    r = 1.5 into the penalty."""
    geo = mf.construct_total_mesh(*chip_smoke.block_3d())
    bids = geo.boundary_facet_ids()
    c = geo.facet_centers()[bids]
    n_z = chip_smoke.BLOCK_3D[2]
    for axis in (0, 1):
        sel = c[c[:, axis] < 0.05]
        on_plane = sel[:, axis] < 1e-12
        on_hole = np.abs(np.hypot(sel[:, 0], sel[:, 1]) - 1.0) < 0.01
        assert (on_plane | on_hole).all()
        assert on_hole.sum() == n_z


def _direct(self, **_kw):
    """make_iterative_solver replaced by the domain's sparse LU."""
    return self.make_direct_solver()


def _ref_2d(ref_dir, lu):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_sc2, "REF_DIR", ref_dir)
        if lu:
            mp.setattr(ref_sc2.FEM_Domain, "make_iterative_solver", _direct)
        return ref_sc2.solve()


def _port_2d(ref_dir, lu, **kw):
    with pytest.MonkeyPatch.context() as mp:
        if lu:
            mp.setattr(FEM_Domain, "make_iterative_solver", _direct)
        return sc2.solve(ref_dir=ref_dir, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_2d(ref_dir):
    return {"lu": _ref_2d(ref_dir, True), "gmres": _ref_2d(ref_dir, False)}


@pytest.fixture(scope="module")
def ref_3d(ref_dir):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_sc3, "REF_DIR", ref_dir)
        return {"lu": ref_sc3.solve(solver="lu"),
                "idrs": ref_sc3.solve(solver="idrs")}


def _fields(out, names):
    dom, _, wp, _ = out
    mesh = dom.workpieces[wp].mesh
    return np.stack([np.asarray(mesh.fields[k], np.float64) for k in names])


def _d_rel(port, ref, dim):
    names = [f"d{k + 1}" for k in range(dim)]
    a, b = _fields(port, names), _fields(ref, names)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _residual_ok(port):
    assert port[3]["residual"] < TOL


def test_stress_2d_lu_matches_reference(ref_dir, ref_2d):
    ref = ref_2d["lu"]
    port = _port_2d(ref_dir, lu=True)
    _residual_ok(port)
    assert _d_rel(port, ref, 2) <= 1e-9
    s_port = sc2.s22_at(*port[:3], PTS_2D, port[3])
    s_ref = ref_sc2.s22_at(*ref[:3], PTS_2D, ref[3])
    assert np.abs(s_port - s_ref).max() <= 1e-8


@pytest.mark.parametrize("layout", ["default", "bsr_tail"])
def test_stress_2d_gmres_matches_reference(ref_dir, ref_2d, layout):
    opts = {"blk_min_tail": 1} if layout == "bsr_tail" else None
    port = _port_2d(ref_dir, lu=False, layout_opts=opts)
    lo = port[0].pattern.offset_layout
    assert lo.blk_b == (8 if layout == "bsr_tail" else 0)
    assert lo.pallas_groups[0].n_vars == 2
    _residual_ok(port)
    assert port[0].solve_log, "GMRES ran no pass"
    assert _d_rel(port, ref_2d["gmres"], 2) <= 100 * TOL
    assert _d_rel(port, ref_2d["lu"], 2) <= 100 * TOL


def test_stress_3d_lu_matches_reference(ref_dir, ref_3d):
    ref = ref_3d["lu"]
    port = sc3.solve(solver="lu", ref_dir=ref_dir, device="cpu")
    _residual_ok(port)
    assert _d_rel(port, ref, 3) <= 1e-9
    s_port = sc3.s22_at(*port[:3], PTS_3D, port[3])
    s_ref = ref_sc3.s22_at(*ref[:3], PTS_3D, ref[3])
    assert np.abs(s_port - s_ref).max() <= 1e-8


def test_stress_3d_idrs_bsr_tail_matches_reference(ref_dir, ref_3d):
    port = sc3.solve(solver="idrs", ref_dir=ref_dir, device="cpu",
                     layout_opts={"blk_min_tail": 1})
    lo = port[0].pattern.offset_layout
    assert lo.blk_b == 8 and lo.pallas_groups[0].n_vars == 3
    _residual_ok(port)
    assert _d_rel(port, ref_3d["idrs"], 3) <= 10 * TOL
