"""The multi-device layer of the PyTorch port (metafem_torch/parallel/)
against the reference package.

- ``mesh_classical(lattice_pad=)`` builds the reference's layouts: the
  strip (72, 32) padded to 8 lattice planes and the jittered tet brick
  (6, 4, 4) padded to 4 ghost control points have the reference
  domain's n_cp, DOF count, storage size, dense segments and occupancy
  mask, exactly (no ranks).
- The matrix over a row window (an ``OffsetMatrix`` over a
  ``block_offset.WindowLayout``, no ranks): every rank's rows of A x, diag(A), A diag(s) x and the
  two-float product, over the windows of 1 to 4 ranks, concatenate
  bitwise to the whole matrix's on a dense-group layout, a BSR-tail
  layout and a scalar COO-tail layout (the kernels' plain versions on
  the CPU); the whole window's pack plans are the whole plans.  The
  windows' shares of A.T x sum in rank order to the whole A.T x within
  1e-14 of its largest entry (dense C=1 and C=2, BSR and COO tails).
- ``parallel.dryrun`` on 4 gloo ranks on the CPU (``torch.distributed.run
  --standalone``, one torch thread per rank, a 300 s limit): each leg's
  sharded result is held to the reference's single-device result on the
  same domain and inputs, at the reference's bars: the assembly within
  1e-12 of the largest entry, every step's x within 1e-8·max|x|
  (tests/test_parallel.py's).  The dry run itself has already held each
  sharded step to the port's unsharded step in the same rank (1e-8),
  the iteration counts equal on every rank, the layout split (n/N rows
  of the residual pair and the fine smoother diagonal, the window
  storage of A_td) and a bitwise repeat; its records are checked
  here.  The two-float and unstructured legs are in
  test_torch_parallel_tet.py.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from metafem.linsolve import krylov as ref_krylov
from metafem_torch.linsolve import twofloat as tf
from metafem_torch.linsolve.block_offset import OffsetMatrix, WindowLayout
from metafem_torch.parallel import dryrun
from test_parallel import _make_strip, _make_tet_thermal

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
LEGS = ("assembly", "element_step", "row_step", "mg_step", "refined",
        "nested")
STEP_LEGS = LEGS[1:]


def run_dryrun(out_dir, legs, extra=()) -> dict:
    """parallel.dryrun on RANKS gloo ranks on the CPU (``extra``: more
    arguments); its summary."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(RANKS), "-m",
           "metafem_torch.parallel.dryrun", "--device", "cpu",
           "--threads", "1", "--out", str(out_dir), "--legs",
           ",".join(legs), *extra]
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, (p.stdout[-6000:], p.stderr[-6000:])
    with open(os.path.join(out_dir, "summary.json")) as f:
        return json.load(f)


def check_leg(out_dir, summary, leg, x_ref) -> np.ndarray:
    """The dry run's own checks, then the sharded x against the
    reference's single-device x."""
    rec = summary["legs"][leg]
    assert summary["ranks"] == RANKS
    assert rec["res"] < 1e-9 and rec["res_whole"] < 1e-9
    assert rec["max_rel_vs_whole"] <= 1e-8
    assert rec["iters_all_ranks"] == [rec["iters"]] * RANKS
    x = np.load(os.path.join(out_dir, leg + ".npz"))["x"]
    x_ref = np.asarray(x_ref, np.float64)
    assert x.shape == x_ref.shape
    np.testing.assert_allclose(x, x_ref, atol=1e-8 * np.abs(x_ref).max(),
                               rtol=0)
    return x


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return out, run_dryrun(out, LEGS)


@functools.lru_cache(maxsize=None)
def reference_graft() -> dict:
    """The reference's single-device results on the dry run's first
    domain (``__graft_entry__._build_domain(nel=(4, 2), lattice_pad=4)``),
    leg by leg in the dry run's order."""
    f64 = jnp.float64
    dom = graft._build_domain(nel=(RANKS, 2), lattice_pad=RANKS)
    state = dom._runtime_state()
    state["x_star"] = dom.x
    r0, K0 = dom._res_k(state)
    out = {"residue": r0, "K": K0, "K_linear": dom._k_linear(state)}
    dom.converge_tol = 1e-9
    args = (dom.x, f64(0.0), f64(1.0))
    out["element_step"] = dom.make_jitted_step(
        sv_func=ref_krylov.bicgstabl, s=2, maxiter=400, max_newton=6,
        max_pass=2)(dom._runtime_state(), *args)[0]
    out["row_step"] = dom.make_jitted_step(
        sv_func=ref_krylov.bicgstab, maxiter=800, max_newton=6,
        max_pass=2)(dom._runtime_state(), *args)[0]
    dom.freeze_linear_tangent()
    dom.setup_mg(tune=False)
    out["mg_step"] = dom.make_jitted_step(
        sv_func=ref_krylov.bicgstab, maxiter=200, max_newton=6, max_pass=2,
        precond="mg", reuse_mg=True, static_k_linear=True)(
            dom._runtime_state(), *args)[0]
    dom.freeze_refined_residual()
    out["refined"] = dom.make_refined_step(
        sv_func=ref_krylov.bicgstab, maxiter=200, max_refine=10, max_pass=1,
        precond="mg")(dom._runtime_state(), jnp.asarray(dom.x),
                      f64(0.0), f64(1.0))[0]
    return out


def reference_nested():
    """The reference's single-device refined multigrid step on the
    strip (72, 32), lattice_pad=8 (test_parallel's nested-mesh leg)."""
    dom = _make_strip((72, 32), lattice_pad=8)
    dom.converge_tol = 1e-9
    dom.freeze_linear_tangent()
    dom.setup_mg(tune=False)
    dom.freeze_refined_residual()
    return dom.make_refined_step(
        sv_func=ref_krylov.bicgstab, maxiter=100, max_refine=10,
        max_pass=1, precond="mg")(dom._runtime_state(), jnp.asarray(dom.x),
                                  jnp.float64(0.0), jnp.float64(1.0))[0]


# ---------------------------------------------------------------------------
# no ranks
# ---------------------------------------------------------------------------

def _layout_facts(dom):
    lo = dom.pattern.offset_layout
    mesh = dom.workpieces[0].mesh
    occ = mesh.is_occupied
    return {"n_cp": mesh.n_cp, "n": dom.pattern.basicfield_size,
            "n_storage": lo.n_storage,
            "segments": [tuple(int(v) for v in s) for s in lo.segments],
            "occupied": (np.ones(mesh.n_cp, bool) if occ is None
                         else np.asarray(occ))}


@pytest.mark.parametrize("case", ["strip", "tet"])
def test_mesh_classical_lattice_pad_matches_reference(case):
    if case == "strip":
        ref = _make_strip((72, 32), lattice_pad=8)
        port = dryrun.strip_domain((72, 32), lattice_pad=8)
        pad = 8
    else:
        ref = _make_tet_thermal(lattice_pad=4)
        port = dryrun.tet_domain(lattice_pad=4)
        pad = 4
    a, b = _layout_facts(port), _layout_facts(ref)
    for k in ("n_cp", "n", "n_storage", "segments"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["occupied"], b["occupied"])
    assert a["n"] % pad == 0 and a["n_storage"] % pad == 0
    assert not a["occupied"].all()       # the padding added ghosts


@functools.lru_cache(maxsize=None)
def _window_case(case):
    if case == "dense":
        dom = dryrun.strip_domain((24, 10), lattice_pad=4)
        dom.assemble_global_variables(dense_min_n=0)
        dom.compile()
    elif case == "dense_c2":
        dom = dryrun.elastic_domain_2d((12, 4), lattice_pad=4)
        dom.assemble_global_variables(dense_min_n=0)
        dom.compile()
    elif case == "bsr":
        dom = dryrun.tet_domain(lattice_pad=4, blk_min_tail=1)
    else:
        dom = dryrun.tet_domain(lattice_pad=4)
    A, _ = dom.assemble_tangent()
    return A


@pytest.mark.parametrize("case", ["dense", "bsr", "coo"])
def test_window_products_concatenate_to_whole(case):
    A = _window_case(case)
    lo = A.layout
    assert {"dense": lo.n_coo == 0, "bsr": lo.blk_b == 8,
            "coo": lo.n_coo > 0 and lo.blk_b == 0}[case]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(lo.n, dtype=torch.float64, generator=g)
    s = torch.rand(lo.n, dtype=torch.float64, generator=g) + 0.5
    Adf = tf.df_from_f64(A.vals)
    xdf = tf.df_from_f64(x)
    want = (A.mv(x), A.diag(), A.scale_cols(s).mv(x),
            tf.df_offset_mv(Adf, lo, xdf))
    for N in (1, 2, 3, 4):
        parts = []
        for r in range(N):
            wl = WindowLayout(lo, [(gr.n_cp * r // N, gr.n_cp * (r + 1) // N)
                                   for gr in lo.pallas_groups])
            sto = torch.as_tensor(wl.storage)
            W = OffsetMatrix.from_values(A.vals[sto], lo, wl)
            ydf = tf.df_offset_mv(tf.DF(Adf.hi[sto], Adf.lo[sto]), lo, xdf,
                                  window=wl)
            parts.append((W.mv(x), W.diag(), W.scale_cols(s).mv(x), ydf))
        for i in range(3):
            assert torch.equal(torch.cat([p[i] for p in parts]), want[i])
        assert torch.equal(torch.cat([p[3].hi for p in parts]), want[3].hi)
        assert torch.equal(torch.cat([p[3].lo for p in parts]), want[3].lo)
    whole = WindowLayout(lo, [(0, gr.n_cp) for gr in lo.pallas_groups])
    assert whole.whole
    Ww = OffsetMatrix.from_values(A.vals, lo, whole)
    for pw, p in zip(Ww.pack_plans(), A.pack_plans()):
        assert torch.equal(pw.positions.long(), p.positions.long())
        assert torch.equal(pw.rows, p.rows)
    if lo.blk_b:
        assert torch.equal(Ww.packed_tail(), A.packed_tail())


@pytest.mark.parametrize("case", ["dense", "dense_c2", "bsr", "coo"])
def test_window_tmv_sums_to_whole(case):
    """Every window's share of A.T x (x: the window's rows), summed in
    rank order over the windows of 1 to 4 ranks, is the whole A.T x
    within 1e-14 x max|y| (the whole product adds unit by unit, the
    windows' shares rank by rank); the whole window's is the whole
    product, bitwise; on C=1 and C=2 dense layouts, a BSR tail (its
    blocks shared by two windows add only their own rows) and a scalar
    COO tail."""
    A = _window_case(case)
    lo = A.layout
    assert {"dense": lo.n_coo == 0 and lo.pallas_groups[0].n_vars == 1,
            "dense_c2": lo.n_coo == 0 and lo.pallas_groups[0].n_vars == 2,
            "bsr": lo.blk_b == 8,
            "coo": lo.n_coo > 0 and lo.blk_b == 0}[case]
    x = torch.randn(lo.n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    want = A.tmv(x)
    ref = A.to_scipy().T @ x.numpy()
    np.testing.assert_allclose(want.numpy(), ref, rtol=0,
                               atol=1e-14 * np.abs(ref).max())
    for N in (1, 2, 3, 4):
        acc = None
        for r in range(N):
            wl = WindowLayout(lo, [(gr.n_cp * r // N, gr.n_cp * (r + 1) // N)
                                   for gr in lo.pallas_groups])
            W = OffsetMatrix.from_values(A.vals[torch.as_tensor(wl.storage)],
                                         lo, wl)
            part = W.tmv(wl.local(x))
            assert part.shape == (lo.n,)
            acc = part.clone() if acc is None else acc + part
        scale = float(want.abs().max())
        assert float((acc - want).abs().max()) <= 1e-14 * scale, N
    whole = WindowLayout(lo, [(0, gr.n_cp) for gr in lo.pallas_groups])
    assert torch.equal(OffsetMatrix.from_values(A.vals, lo, whole).tmv(x),
                       want)


def test_window_cuts_where_window_storage_is_n(monkeypatch):
    """A C=1 dense strip at N = n_off ranks: each window's storage is
    n_off * n_cp / N = n entries, as long as a whole residual.  The cuts
    are explicit, so a whole residual is cut to the window's rows and a
    whole storage vector to its storage, a vector of the wrong length is
    refused, and the window products still concatenate bitwise to the
    whole matrix's."""
    from metafem_torch.parallel import comm, rowshard
    dom = dryrun.strip_domain((24, 10), lattice_pad=25)
    dom.assemble_global_variables(dense_min_n=0)
    dom.compile()
    A, residue = dom.assemble_tangent()
    lo = A.layout
    (grp,) = lo.pallas_groups
    N = grp.n_off
    assert grp.n_vars == 1 and lo.n_coo == 0 and grp.n_cp % N == 0
    g = torch.Generator().manual_seed(5)
    x = torch.randn(lo.n, dtype=torch.float64, generator=g)
    ys = []
    for r in range(N):
        monkeypatch.setattr(comm, "row_group", lambda mesh: (None, r, N))
        rows = rowshard.RowWindow(lo, mesh=None)
        assert rows.even and rows.mine.n_storage == lo.n
        want = residue[torch.as_tensor(rows.mine.rows)]
        got = rowshard.constrain(rows, residue)
        assert got.shape == (lo.n // N,) and torch.equal(got, want)
        sto = rowshard.constrain(rows, A.vals, storage=True)
        assert torch.equal(sto, A.vals[torch.as_tensor(rows.mine.storage)])
        with pytest.raises(ValueError, match="whole vector"):
            rows.local(got)
        with pytest.raises(ValueError, match="whole storage"):
            rows.local_storage(residue[:lo.n - 1])
        W = rows.matrix(A)
        assert W.window is rows.mine and rows.matrix(W) is W
        ys.append(W.mv(x))
    assert torch.equal(torch.cat(ys), A.mv(x))


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def test_assembly_matches_reference(sharded_run):
    out, summary = sharded_run
    rec = summary["legs"]["assembly"]
    assert max(rec["max_rel"].values()) <= 1e-12
    e0, e1, n_el = rec["elements"]
    assert (e0, e1 - e0) == (0, n_el // RANKS)
    got = np.load(os.path.join(out, "assembly.npz"))
    ref = reference_graft()
    for k in ("residue", "K", "K_linear"):
        want = np.asarray(ref[k], np.float64)
        np.testing.assert_allclose(got[k], want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("leg", STEP_LEGS)
def test_sharded_step_matches_reference(sharded_run, leg):
    out, summary = sharded_run
    x_ref = (reference_nested() if leg == "nested"
             else reference_graft()[leg])
    check_leg(out, summary, leg, x_ref)
    rec = summary["legs"][leg]
    if leg != "element_step":
        lay = rec["layout"]
        assert lay["rows"] * RANKS == lay["n"]
    if leg in ("mg_step", "refined", "nested"):
        assert rec["layout"]["inv_diag"][-1] * RANKS == rec["layout"]["n"]
    if leg in ("refined", "nested"):
        assert rec["layout"]["storage"] < rec["layout"]["n_storage"]
    if leg == "row_step":
        # the assembly's partial sums land by reduce-scatter
        assert rec["comm"]["reduce_scatter_calls"] > 0
        b = rec["bytes_per_reduction"]
        assert b["reduce_scatter"] < b["all_reduce"]
