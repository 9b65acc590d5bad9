"""The random-gather probe of the PyTorch port against the reference.

The reference's TPU kernel (benchmarks/pallas_gather_probe.py,
``vmem_gather_kernel``) runs here in Pallas interpret mode on the same
inputs as the port's plain version, at the TPU probe's two sizes.  A
gather is exact, so every comparison is bitwise.  The CUDA kernel itself
runs only on the card (chip_smoke.py holds it against the plain
version there); these tests check the wrapper's CPU path and its
refusals.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from benchmarks import pallas_gather_probe as ref_probe
from metafem_torch.benchmarks import gather_probe

torch.set_num_threads(2)


@pytest.mark.parametrize("n_win,n_idx", gather_probe.SIZES)
def test_plain_gather_matches_reference_kernel_bitwise(n_win, n_idx):
    x, idx = gather_probe.probe_inputs(n_win, n_idx, "cpu")
    got = gather_probe.gather_plain(x, idx)
    xn, idn = x.numpy(), idx.numpy()
    assert np.array_equal(got.numpy(), xn[idn])
    want = pl.pallas_call(
        ref_probe.vmem_gather_kernel,
        out_shape=jax.ShapeDtypeStruct((n_idx,), jnp.float32),
        interpret=True)(jnp.asarray(xn), jnp.asarray(idn))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", gather_probe.VARIANTS)
def test_wrapper_takes_the_plain_path_on_the_cpu(variant):
    x, idx = gather_probe.probe_inputs(*gather_probe.SIZES[0], "cpu")
    before = gather_probe.gather.launches
    out = gather_probe.gather(x, idx, variant)
    assert torch.equal(out, gather_probe.gather_plain(x, idx))
    assert gather_probe.gather.launches == before


def test_window_beyond_the_shared_memory_limit_raises():
    """65536 float32 values (256 KB) exceed the 227 KB a block may hold;
    the window variant refuses them instead of switching variants."""
    x, idx = gather_probe.probe_inputs(*gather_probe.SIZES[1], "cpu")
    with pytest.raises(ValueError, match="232448 bytes"):
        gather_probe.gather(x, idx, "window")
    assert torch.equal(gather_probe.gather(x, idx, "global"),
                       gather_probe.gather_plain(x, idx))


def test_wrapper_refuses_other_devices_and_types():
    x = torch.empty(16, dtype=torch.float32, device="meta")
    idx = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gather_probe.gather(x, idx)
    with pytest.raises(TypeError, match="int32"):
        gather_probe.gather(torch.zeros(4), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="CUDA is required"):
        gather_probe.run(device="cpu")


def test_bound_counts_each_byte_once():
    # 4 B of idx and 4 B of out per gather, 4 B of x per window entry
    assert gather_probe.bound_ms(16384, 131072) == pytest.approx(
        (8 * 131072 + 4 * 16384) / 3.35e12 * 1e3)
