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


def test_slice_runs_with_jax_and_reference_blocked():
    """A fresh interpreter in which importing jax, jaxlib or metafem
    fails imports the port and chip_smoke.py, runs the slice phase and
    the flagship bench (small) on the CPU: lazy imports inside functions
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
        "print('BENCH-OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SLICE-OK" in proc.stdout
    assert "BENCH-OK" in proc.stdout


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
