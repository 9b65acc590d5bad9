"""Multiple workpieces in one domain of the PyTorch port, against the
reference package, float64 on the CPU: the two thermal blocks of
tests/test_multi_workpiece.py (conductivities 1 and 5, order-1
elements), one monolithic system with disjoint DOF blocks.

- the DOF offsets of both packages and the disjoint blocks;
- each block's temperature within 1e-9 * max of the reference's, with
  sparse LU in both;
- block 0 against a single-workpiece solve of the same configuration;
- the same domain with right-Jacobi BiCGStab over the block-offset
  matrix (one dense group per workpiece on a ``dense_min_n=0`` layout)
  within 1e-8 * max of sparse LU, and no multigrid mask for two
  workpieces;
- both blocks in order-2 serendipity elements, whose unoccupied cell
  centres are ghost rows of each block: the unit ghost diagonal on
  exactly those rows, the temperatures within 1e-9 * max of the
  reference's, and BiCGStab within 1e-8 * max of sparse LU.
"""

import numpy as np
import pytest
import torch

import metafem as ref_mf
import metafem_torch as mf
from metafem.solver.domain import FEM_Domain as RefDomain
from metafem_torch.solver.domain import FEM_Domain

torch.set_num_threads(2)

BLOCKS = (((4, 4), 1.0), ((6, 3), 5.0))


def _blocks(pkg, Domain, blocks=BLOCKS, solver="lu", serendipity=False,
            **dom_kw):
    """The two-block domain (or one block) stepped once to 1e-10, with
    order-1 Lagrange elements or order-2 serendipity ones (whose
    unoccupied cell centres are ghost rows)."""
    dom = Domain(2, **dom_kw)
    T = dom.internal_var("T")
    s = dom.external_var("s", "CONTROLPOINT_VAR")
    i = pkg.index("i")
    wps = []
    for nel, k in blocks:
        vert, conn = pkg.make_square((1.0, 1.0), nel)
        geo = pkg.construct_total_mesh(vert, conn)
        wp = dom.add_workpiece(geo)
        bg = dom.add_boundary(wp, geo.boundary_facet_ids())
        dom.assign_workpiece_weakform(
            wp, -k * pkg.Bilinear(T.d(i), T.d(i)) + pkg.Bilinear(T, s))
        dom.assign_boundary_weakform(
            wp, bg, 100.0 * pkg.Bilinear(T, 1.0 - T))
        wps.append(wp)
    dom.initialize_local_assembly()
    if serendipity:
        dom.mesh_classical(itp_order=2, itg_order=3, itp_type="Serendipity")
    else:
        dom.mesh_classical(itp_order=1, itg_order=3)
    if solver == "lu":
        dom.assemble_global_variables()
    else:
        dom.assemble_global_variables(dense_min_n=0)
    dom.compile()
    dom.converge_tol = 1e-10
    dom.linear_solver = (dom.make_direct_solver() if solver == "lu"
                         else dom.make_iterative_solver(maxiter=500))
    for wp in wps:
        mesh = dom.workpieces[wp].mesh
        dom.set_field(wp, "s", np.full(mesh.n_cp, 10.0))
    dom.refresh_fields()
    dom.assemble_x()
    res = dom.update_one_step(max_iter=3)
    dom.dessemble_x()
    return dom, res


@pytest.fixture(scope="module")
def pair():
    return (_blocks(ref_mf, RefDomain),
            _blocks(mf, FEM_Domain, device="cpu"))


def test_dof_blocks_are_disjoint(pair):
    (dom_r, _), (dom, res) = pair
    assert res < 1e-10
    infos = dom.pattern.wp_infos
    assert [(w.dof_offset, w.n_cp) for w in infos] == \
        [(w.dof_offset, w.n_cp) for w in dom_r.pattern.wp_infos]
    assert infos[0].dof_offset == 0
    assert infos[1].dof_offset == infos[0].n_cp
    assert dom.pattern.basicfield_size == infos[0].n_cp + infos[1].n_cp
    assert dom._mg_mask is None


@pytest.mark.parametrize("wp", [0, 1])
def test_each_block_matches_reference(pair, wp):
    (dom_r, _), (dom, _) = pair
    want = np.asarray(dom_r.workpieces[wp].mesh.fields["T"])
    got = dom.workpieces[wp].mesh.fields["T"]
    assert want.max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


def test_block_zero_matches_a_single_workpiece(pair):
    _, (dom, _) = pair
    single, res = _blocks(mf, FEM_Domain, blocks=BLOCKS[:1], device="cpu")
    assert res < 1e-10
    T0 = dom.workpieces[0].mesh.fields["T"]
    T1 = dom.workpieces[1].mesh.fields["T"]
    # same physics, conductivity 5x: a smaller temperature rise
    assert 1.0 < T1.max() < T0.max()
    np.testing.assert_allclose(T0, single.workpieces[0].mesh.fields["T"],
                               rtol=1e-9)


def test_iterative_solve_over_two_dense_groups(pair):
    _, (dom, _) = pair
    it, res = _blocks(mf, FEM_Domain, solver="bicgstab", device="cpu")
    lo = it.pattern.offset_layout
    assert len(lo.pallas_groups) == 2 and lo.n_coo == 0
    assert [g.dof_offset for g in lo.pallas_groups] == \
        [w.dof_offset for w in it.pattern.wp_infos]
    assert res < 1e-10
    for wp in (0, 1):
        want = dom.workpieces[wp].mesh.fields["T"]
        np.testing.assert_allclose(it.workpieces[wp].mesh.fields["T"], want,
                                   rtol=0, atol=1e-8 * np.abs(want).max())


def test_ghost_rows_of_both_blocks():
    ref, _ = _blocks(ref_mf, RefDomain, serendipity=True)
    dom, res = _blocks(mf, FEM_Domain, serendipity=True, device="cpu")
    it, res_it = _blocks(mf, FEM_Domain, serendipity=True,
                         solver="bicgstab", device="cpu")
    assert res < 1e-10 and res_it < 1e-10
    lo = dom.pattern.offset_layout
    ghost_rows = []
    for w, info in zip(dom.workpieces, dom.pattern.wp_infos):
        ghost = np.nonzero(~np.asarray(w.mesh.is_occupied, bool))[0]
        assert ghost.size > 0
        ghost_rows.append(info.dof_offset + ghost)
    ghost_rows = np.concatenate(ghost_rows)
    diag = dom._ghost_diag.numpy()
    assert np.array_equal(np.nonzero(diag)[0],
                          np.sort(lo.diag_storage[ghost_rows]))
    assert (diag[lo.diag_storage[ghost_rows]] == 1.0).all()
    for wp in (0, 1):
        occ = np.asarray(dom.workpieces[wp].mesh.is_occupied, bool)
        want = np.asarray(ref.workpieces[wp].mesh.fields["T"])[occ]
        got = dom.workpieces[wp].mesh.fields["T"][occ]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
        np.testing.assert_allclose(
            it.workpieces[wp].mesh.fields["T"][occ], got, rtol=0,
            atol=1e-8 * np.abs(got).max())
