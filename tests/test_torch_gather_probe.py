"""The random-gather probe of the PyTorch port against the reference.

The reference's TPU kernel (benchmarks/pallas_gather_probe.py,
``vmem_gather_kernel``) runs here in Pallas interpret mode on the same
inputs as the port's plain version, at the TPU probe's two sizes and at
a scaled-down analogue of the main path's size (a tenth of the 3D bar's
541,059 values, a hundredth of its tangent's 89,057,289 reads).  A
gather is exact, so every comparison is bitwise.  The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against the
plain version there); these tests check the wrapper's CPU path, its
refusals, the cluster addressing the window kernel computes and the
SpMV read stream the probe takes from a pack plan.
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


@pytest.mark.parametrize("n_win,n_idx",
                         gather_probe.TPU_SIZES + ((5411, 890573),))
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
    """65536 float32 values (256 KB) exceed the 227 KB one block may hold
    but fit a cluster of two; a window above 16 blocks of 227 KB is
    refused instead of switching variants, and so is a cluster too small
    for its window."""
    x, idx = gather_probe.probe_inputs(*gather_probe.TPU_SIZES[1], "cpu")
    assert gather_probe.min_cluster(x.numel(), 232448) == 2
    assert torch.equal(gather_probe.gather(x, idx, "window"),
                       gather_probe.gather_plain(x, idx))
    with pytest.raises(ValueError, match="cluster of 1 blocks"):
        gather_probe.gather(x, idx, "window", cluster=1)
    for k in (0, 17):
        with pytest.raises(ValueError, match="1 to 16 blocks"):
            gather_probe.gather(x, idx, "window", cluster=k)
    big = torch.zeros(16 * 58112 + 1)
    with pytest.raises(ValueError, match="16 x 232448 bytes"):
        gather_probe.gather(big, idx, "window")
    assert torch.equal(gather_probe.gather(big, idx, "global"),
                       gather_probe.gather_plain(big, idx))


def test_wrapper_refuses_other_devices_and_types():
    x = torch.empty(16, dtype=torch.float32, device="meta")
    idx = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gather_probe.gather(x, idx)
    with pytest.raises(TypeError, match="int32"):
        gather_probe.gather(torch.zeros(4), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="CUDA is required"):
        gather_probe.run(device="cpu")


@pytest.mark.parametrize("n_win,n_idx", gather_probe.SIZES)
def test_bound_counts_each_byte_once(n_win, n_idx):
    # 4 B of idx and 4 B of out per gather, 4 B of x per window entry
    assert gather_probe.bound_ms(n_win, n_idx) == pytest.approx(
        (8 * n_idx + 4 * n_win) / 3.35e12 * 1e3)


def test_sizes_hold_the_main_path_shape():
    """The TPU probe's two sizes, then the 3D bar's x read once per
    structural entry of its tangent: 0.71 GB of idx and out, a bytes bound
    of about 0.21 ms, a window of 2.16 MB that needs a cluster of 10."""
    assert gather_probe.SIZES[:2] == ((16384, 131072), (65536, 524288))
    n_win, n_idx = gather_probe.MAIN_PATH_SIZE
    assert gather_probe.SIZES[2] == (541059, 89057289)
    assert 8 * n_idx == 712458312
    assert gather_probe.bound_ms(n_win, n_idx) == pytest.approx(0.2133,
                                                                abs=1e-4)
    assert gather_probe.min_cluster(n_win, 232448) == 10
    assert gather_probe.cluster_sizes(n_win, 232448, 16) == [10, 16]
    assert gather_probe.cluster_sizes(16384, 232448, 8) == [1, 2, 4, 8]


@pytest.mark.parametrize("n_win,k", [(16384, 1), (65536, 2), (65536, 3),
                                     (541059, 10), (541059, 16),
                                     (929792, 16), (5411, 7), (7, 4)])
def test_window_slices_cover_the_window_once(n_win, k):
    """Every index has exactly one (rank, offset), inside its rank's slice
    and inside one block's shared memory; the kernel's float reciprocal
    with its one-step correction equals integer division."""
    s = gather_probe.slice_len(n_win, k)
    assert s % 4 == 0 and 4 * s <= 232448
    rank, off = gather_probe.window_slices(n_win, k)
    assert int(rank.min()) >= 0 and int(rank.max()) < k
    assert int(off.min()) >= 0 and int(off.max()) < s
    flat = rank * s + off
    assert torch.equal(flat, torch.arange(n_win))
    assert torch.equal(rank, torch.arange(n_win) // s)
    # the window read back through its slices, as the blocks hold them
    x = torch.from_numpy(np.random.default_rng(k).random(n_win,
                                                         dtype=np.float32))
    held = torch.zeros(k, s)
    held.view(-1)[:n_win] = x
    assert torch.equal(held[rank, off], x)


@pytest.mark.parametrize("name", ["thermal", "elastic"])
def test_spmv_stream_reads_each_structural_column_of_an_occupied_point(
        name):
    """The read stream of a tangent's packed SpMV: one read per structural
    entry whose column is an occupied control point's (these plans hold
    no fill), renumbered to the compact x of the occupied DOF, which it
    reads whole; the multiset is held against the layout's own
    structural (row, column) pairs."""
    from test_torch_spmv import _port_operator
    A, At, _, occupied = _port_operator(name, True)
    (grp,) = A.layout.pallas_groups
    C, n_cp = grp.n_vars, grp.n_cp
    (plan,) = At.pack_plans()
    assert plan.n_fill == 0
    occ = torch.as_tensor(occupied)
    n_win, idx = gather_probe.spmv_stream(plan, occ)
    assert plan.columns is None
    assert n_win == C * int(occupied.sum()) < C * n_cp
    assert idx.dtype == torch.int32
    assert torch.equal(torch.unique(idx), torch.arange(n_win,
                                                       dtype=torch.int32))
    _, cols, _ = At._triplets(At.structural_mask())
    local = cols - grp.dof_offset
    local = local[(local >= 0) & (local < C * n_cp)]
    occ_flat = occ.repeat(C)
    rank = torch.cumsum(occ_flat, 0) - 1
    want = torch.sort(rank[local[occ_flat[local]]]).values
    assert torch.equal(torch.sort(idx.long()).values, want)
    with pytest.raises(ValueError, match="control points"):
        gather_probe.spmv_stream(plan, occ[1:])
