"""The port stands alone: no JAX and no reference package on its path.

The machine with the card has PyTorch but no JAX, so any import of
``jax``, ``jaxlib`` or ``metafem`` from the port or from chip_smoke.py,
at any depth, would end the run there before it starts.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import metafem_torch
from metafem_torch import FEM_Domain

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "metafem"}


def _port_sources():
    root = os.path.join(REPO, "metafem_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_banned_import_in_any_source():
    found = []
    n_files = 0
    for path in _port_sources():
        n_files += 1
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(path, n) for n in names
                      if n.split(".")[0] in BANNED]
    assert n_files > 30
    assert not found, found


def test_slice_runs_with_jax_and_reference_blocked(tmp_path):
    """A fresh interpreter in which importing jax, jaxlib or metafem
    fails imports the port and chip_smoke.py, runs the slice phase, the
    flagship bench (small) and a BiCGStab(4) solve on a sorted-COO matrix
    on the CPU, with the solver menu, the jitted step, the 3D examples
    and the multi-field examples imported, J2's return map run, one
    two-float (df32) refined step of the small flagship, and, with the io
    and utils packages imported, a save and load of its freezes, a
    checkpoint round trip, a VTK file and the memory report, the
    unstructured example (BSR tail, auxmg, refined step) small, and,
    with the four mesh-reading examples imported, the 2D stress plate
    from an .inp that chip_smoke writes: lazy imports inside functions
    are caught too."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'metafem'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import metafem_torch, chip_smoke\n"
        "out = chip_smoke.phase_slice(torch.device('cpu'), nel=(10, 5))\n"
        "assert out['residual'] < 1e-6, out\n"
        "print('SLICE-OK')\n"
        "from metafem_torch import bench\n"
        "from metafem_torch.benchmarks import gather_probe\n"
        "rec = bench.run((8, 4), device='cpu', log=None)\n"
        "assert rec['final_residual'] < 1e-6, rec['final_residual']\n"
        "print('BENCH-OK')\n"
        "from metafem_torch.linsolve import driver, krylov, poly, precond\n"
        "from metafem_torch.linsolve.spmv import SparseMatrix\n"
        "from metafem_torch.solver import jit_step\n"
        "from metafem_torch.examples import cantilever_3d, hyperelastic_3d\n"
        "from metafem_torch.examples import (cavity_2d, j2_plasticity,\n"
        "                                    thermal_elasticity_3d)\n"
        "z = torch.zeros((6, 2, 3), dtype=torch.float64)\n"
        "e6 = z.clone(); e6[0] = 0.01\n"
        "ep, b, Y = j2_plasticity.radial_return(\n"
        "    e6, z, z, torch.full((2, 3), 100.0, dtype=torch.float64),\n"
        "    5e4, 0.0, 0.0, 5e4, 1.0)\n"
        "assert float(ep[0].min()) > 0 and float(Y.min()) > 100.0\n"
        "n = 32\n"
        "i = torch.arange(n)\n"
        "rows = torch.cat([i, i[1:], i[:-1]])\n"
        "cols = torch.cat([i, i[:-1], i[1:]])\n"
        "vals = torch.cat([torch.full((n,), 2.0, dtype=torch.float64),\n"
        "                  torch.full((2 * n - 2,), -1.0, dtype=torch.float64)])\n"
        "o = torch.sort(rows * n + cols).indices\n"
        "A = SparseMatrix(vals[o], rows[o], cols[o], n)\n"
        "b = torch.ones(n, dtype=torch.float64)\n"
        "x, it, res = krylov.bicgstabl(A, b, tol=1e-10, maxiter=500, s=4)\n"
        "assert float(res) < 1e-10 and it > 0, (it, float(res))\n"
        "print('MENU-OK')\n"
        "from metafem_torch.linsolve import twofloat\n"
        "from metafem_torch.solver import df_lowering\n"
        "dom = bench.build_domain((8, 4), device='cpu')\n"
        "dom.freeze_linear_tangent()\n"
        "dom.setup_mg(tune=False)\n"
        "dom.freeze_refined_residual()\n"
        "step = dom.make_refined_step(sv_func=krylov.bicgstab,\n"
        "                             residual_mode='df32', **bench.STEP_KW)\n"
        "x0 = twofloat.df_from_f64(dom.x.double())\n"
        "x, _, res, it = step(dom._runtime_state(), x0, 0.0, 1.0)\n"
        "assert isinstance(x, twofloat.DF) and res < 1e-6, (res, it)\n"
        "print('DF32-OK')\n"
        "import os\n"
        "import metafem_torch.io, metafem_torch.utils\n"
        "from metafem_torch.io import checkpoint\n"
        f"d = {str(tmp_path)!r}\n"
        "fz, ck = os.path.join(d, 'fz.pkl'), os.path.join(d, 'ck.npz')\n"
        "dom.save_freezes(fz)\n"
        "dom2 = bench.build_domain((8, 4), device='cpu')\n"
        "dom2.load_freezes(fz)\n"
        "assert torch.equal(dom2._k_linear_td, dom._k_linear_td)\n"
        "assert torch.equal(dom2._refined['A'], dom._refined['A'])\n"
        "dom.x = dom.x * 1.01\n"
        "checkpoint.save_checkpoint(dom, ck)\n"
        "checkpoint.load_checkpoint(dom2, ck)\n"
        "assert torch.equal(dom2.x, dom.x)\n"
        "w = dom.workpieces[0]\n"
        "metafem_torch.io.write_vtk(os.path.join(d, 'o.vtk'), w.mesh,\n"
        "                           w.disc.element_type)\n"
        "rep = metafem_torch.utils.memory_report(dom2)\n"
        "assert rep['TOTAL (MB)'] > 0, rep\n"
        "print('PERSIST-OK')\n"
        "from metafem_torch.examples import pikachu_brick\n"
        "pikachu_brick.main(['--cpu', '--nel', '4', '3', '3'])\n"
        "print('UNSTRUCTURED-OK')\n"
        "from metafem_torch.examples import (cylinder_flow_3d, pikachu_3d,\n"
        "    stress_concentration_2d, stress_concentration_3d)\n"
        "plate = os.path.join(d, 'plate.inp')\n"
        "chip_smoke.write_inp(plate, *chip_smoke.plate_2d(8, 4))\n"
        "stress_concentration_2d.main(['--cpu', '--mesh', plate])\n"
        "print('MESH-EXAMPLES-OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SLICE-OK" in proc.stdout
    assert "BENCH-OK" in proc.stdout
    assert "MENU-OK" in proc.stdout
    assert "DF32-OK" in proc.stdout
    assert "PERSIST-OK" in proc.stdout
    assert "UNSTRUCTURED-OK" in proc.stdout
    assert "MESH-EXAMPLES-OK" in proc.stdout


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FEM_Domain(2)
    assert FEM_Domain(2, device="cpu").device.type == "cpu"


def test_interop_matrix_defaults_to_cuda(monkeypatch):
    """offset_matrix_from_numpy is an entry point like FEM_Domain: no
    device means CUDA, and it raises without CUDA instead of building a
    CPU matrix."""
    from metafem_torch import interop
    from metafem_torch.examples import thermal_2d
    dom, _ = thermal_2d.build((6, 3), device="cpu")
    lo = dom.pattern.offset_layout
    vals = np.random.default_rng(3).standard_normal(lo.n_storage)
    A = interop.offset_matrix_from_numpy(vals, lo, device="cpu")
    assert A.vals.device.type == "cpu" and A.vals.dtype == torch.float64
    assert np.array_equal(A.vals.numpy(), vals)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.offset_matrix_from_numpy(vals, lo)


def test_tf32_is_off():
    assert metafem_torch.config is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
