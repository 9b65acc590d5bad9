"""Row-sharded solver layout: every rank holds a window of the rows of
the tangent, of the frozen refined operator and of every Krylov vector;
the assembly's partial sums are reduce-scattered onto the windows, each
product gathers x and runs the rank's rows, each dot is a local sum plus
one all-reduce.

Port of ``metafem/parallel/rowshard.py``.  The reference declares the
row-block layout with ``with_sharding_constraint`` and lets GSPMD insert
the collectives; here they are explicit (``comm.py``), in the places
GSPMD puts them:

* a rank's **row window** (``RowWindow``) is a window of control points
  [c0, c1) of every workpiece group with all its components (the flat
  DOF index is c*P + lattice), c0 = n_cp*rank//N.  With one scalar
  field it is the reference's contiguous row block; with
  ``mesh_classical(lattice_pad=N)`` a slab of whole lattice planes along
  the first lattice axis (the reference's ``lattice_sharding``).  Its
  storage is ``block_offset.WindowLayout``'s: the group slabs' columns
  [c0, c1) and the tail's entries (blocks) of its rows;
* ``RowShardedOp.mv`` gathers x and runs the window's rows of the
  matrix (an ``OffsetMatrix`` over the window: the hand-written kernels
  on the window's plans);
* ``RowShardedOp.tmv`` sums every window's share of A.T x
  (``OffsetMatrix.tmv`` over the window) onto the windows in rank order;
* the Krylov solvers take the window from the operator
  (``row_window``), all-reduce their dots (``krylov._dot`` through
  ``RowWindow.reduce``) and draw their shadow spaces whole before
  keeping the rank's rows;
* the multigrid V-cycle runs its fine level on the window and its coarse
  levels whole on every rank, on the gathered restriction
  (``multigrid.vcycle``), and so does its setup (``multigrid.mg_setup``
  of a ``RowShardedOp``); the auxiliary-space cycle likewise
  (``auxmg.AuxMGOperator``);
* a whole step on a state that ``shard_domain_state`` cut gathers each
  cut cache back once (``held``, ``whole_mg_state``: the inverses of the
  cuts, ``RowWindow.gather_storage``/``gather``/``gather_lattice``).

The sharding objects of the reference are descriptors here (``Sharding``)
of what a rank holds: an element range, rows, a lattice slab, or all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..linsolve.block_offset import OffsetMatrix, WindowLayout
from . import comm


def _row_axes(mesh):
    """The mesh axes a row window splits over: the one axis of a 1-D
    mesh, all axes of a nested ('slice', 'el') mesh, flattened rank-major
    (``comm.row_group``), so outer blocks align with the leading axis."""
    names = tuple(mesh.mesh_dim_names or ())
    return names if len(names) > 1 else names[-1]


class RowWindow:
    """The row windows of ``layout`` over the mesh's row axes: this
    rank's (``mine``, a ``block_offset.WindowLayout``) and every rank's,
    with the collectives that move vectors and storage between whole and
    window (``gather``, ``gather_storage``, ``gather_lattice``,
    ``reduce_scatter_rows``, ``reduce_scatter_storage``) and the
    reductions (``reduce``, ``norm``)."""

    def __init__(self, layout, mesh):
        self.mesh = mesh
        _, self.rank, self.size = comm.row_group(mesh)
        N = self.size
        self.layout = layout
        self.n = layout.n
        self.windows = [WindowLayout(layout, [
            (g.n_cp * r // N, g.n_cp * (r + 1) // N)
            for g in layout.pallas_groups]) for r in range(N)]
        self.mine = self.windows[self.rank]
        self.n_local = self.mine.n_local
        #: every window holds n/N rows: the reference's divisibility rule
        self.even = all(g.n_cp % N == 0 for g in layout.pallas_groups)
        self.m_rows = max(w.n_local for w in self.windows)
        self.m_sto = max(w.n_storage for w in self.windows)
        rows_all = np.concatenate([w.rows for w in self.windows])
        self.rows_identity = (self.even and np.array_equal(
            rows_all, np.arange(self.n)))
        self._dev: dict = {}

    # -- index tables ----------------------------------------------------
    def _tables(self, device) -> dict:
        key = str(device)
        if key not in self._dev:
            def dev(a):
                return torch.as_tensor(np.asarray(a, np.int64),
                                       device=device)

            def take(sizes, m):
                return np.concatenate([r * m + np.arange(s, dtype=np.int64)
                                       for r, s in enumerate(sizes)])
            self._dev[key] = {
                "rows_all": dev(np.concatenate(
                    [w.rows for w in self.windows])),
                "take_rows": dev(take([w.n_local for w in self.windows],
                                      self.m_rows)),
                "sto_all": dev(np.concatenate(
                    [w.storage for w in self.windows])),
                "take_sto": dev(take([w.n_storage for w in self.windows],
                                     self.m_sto)),
                "storage": dev(self.mine.storage)}
        return self._dev[key]

    # -- whole -> window ---------------------------------------------------
    def local(self, v: torch.Tensor) -> torch.Tensor:
        """The window's rows of a whole vector (the last axis)."""
        if v.shape[-1] != self.n:
            raise ValueError(f"a whole vector has {self.n} rows, not "
                             f"{v.shape[-1]}")
        return self.mine.local(v)

    def local_storage(self, v: torch.Tensor) -> torch.Tensor:
        """The window's storage of a whole storage vector (the last
        axis)."""
        if v.shape[-1] != self.layout.n_storage:
            raise ValueError(f"a whole storage vector has "
                             f"{self.layout.n_storage} entries, not "
                             f"{v.shape[-1]}")
        return v[..., self._tables(v.device)["storage"]]

    def lattice_local(self, v: torch.Tensor, lead: int) -> torch.Tensor:
        """The window of a whole lattice-shaped array [*lead axes, *S] of
        the one lattice workpiece, as [*lead axes, c1 - c0]."""
        (g,) = self.layout.pallas_groups
        c0, c1 = self.mine.cps[0]
        flat = v.reshape(tuple(v.shape[:lead]) + (-1,))
        if flat.shape[-1] != g.n_cp:
            raise ValueError(f"a whole lattice has {g.n_cp} points, not "
                             f"{flat.shape[-1]}")
        return flat[..., c0:c1]

    # -- collectives -----------------------------------------------------
    def reduce(self, fn, *vs) -> torch.Tensor:
        """The sum over ranks of fn of the ranks' windows vs (this rank's
        given), the same bits on every rank (``comm.all_reduce``)."""
        return comm.all_reduce(fn(*vs), self.mesh)

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        """The 2-norm of the whole vector whose window is v: the ranks'
        local norms gathered and combined, the same bits on every
        rank."""
        local = torch.linalg.norm(v)
        if self.size == 1:
            return local
        return torch.linalg.norm(comm.all_gather(local.reshape(1),
                                                 self.mesh))

    def _all_windows(self, v: torch.Tensor, m: int) -> torch.Tensor:
        """Every rank's v [*lead, k] (k <= m: padded to m), as
        [*lead, N*m], rank by rank."""
        buf = torch.nn.functional.pad(v, (0, m - v.shape[-1]))
        allv = comm.all_gather(buf, self.mesh)          # [N, *lead, m]
        return allv.movedim(0, -2).reshape(tuple(v.shape[:-1])
                                           + (self.size * m,))

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """The whole vectors (the last axis) from every rank's window (v:
        this rank's)."""
        if self.size == 1:
            return v
        allv = self._all_windows(v, self.m_rows)
        if self.rows_identity:
            return allv
        t = self._tables(v.device)
        out = torch.empty(tuple(v.shape[:-1]) + (self.n,), dtype=v.dtype,
                          device=v.device)
        out[..., t["rows_all"]] = allv[..., t["take_rows"]]
        return out

    # -- window -> whole: the inverses of the cuts -----------------------
    def gather_storage(self, v: torch.Tensor) -> torch.Tensor:
        """The whole storage vectors (the last axis) from every rank's
        window storage: one all-gather, then the inverse of
        ``reduce_scatter_storage``'s permutation.  A BSR tail's block
        shared by two windows arrives twice with the same values."""
        if self.size == 1:
            return v
        allv = self._all_windows(v, self.m_sto)
        t = self._tables(v.device)
        out = torch.zeros(tuple(v.shape[:-1]) + (self.layout.n_storage,),
                          dtype=v.dtype, device=v.device)
        out[..., t["sto_all"]] = allv[..., t["take_sto"]]
        return out

    def gather_lattice(self, v: torch.Tensor, lead: int) -> torch.Tensor:
        """The whole flat lattice [*lead axes, n_cp] from every rank's
        ``lattice_local`` window [*lead axes, c1 - c0] (equal pieces: the
        windows are cut only where they divide)."""
        if not self.even:
            raise ValueError("lattice windows are cut only where they "
                             "divide the mesh")
        if self.size == 1:
            return v
        return self._all_windows(v.contiguous(), v.shape[-1])

    def reduce_scatter_rows(self, v: torch.Tensor) -> torch.Tensor:
        """The window of the sum over ranks of the whole vectors v."""
        if self.size == 1:
            return self.mine.local(v)
        if self.rows_identity:
            return comm.reduce_scatter(v, self.mesh)
        t = self._tables(v.device)
        buf = torch.zeros(self.size * self.m_rows, dtype=v.dtype,
                          device=v.device)
        buf[t["take_rows"]] = v[t["rows_all"]]
        return comm.reduce_scatter(buf, self.mesh)[:self.n_local]

    def reduce_scatter_storage(self, v: torch.Tensor) -> torch.Tensor:
        """The window's storage of the sum over ranks of the whole storage
        vectors v: one gather of v into rank-major window order (built
        once per layout), one reduce-scatter."""
        t = self._tables(v.device)
        if self.size == 1:
            return v[t["storage"]]
        buf = torch.zeros(self.size * self.m_sto, dtype=v.dtype,
                          device=v.device)
        buf[t["take_sto"]] = v[t["sto_all"]]
        return comm.reduce_scatter(buf, self.mesh)[:self.mine.n_storage]

    def bytes_per_reduction(self, itemsize: int) -> dict:
        """Bytes each rank sends to land a whole storage vector's sum on
        the windows: by the permuted reduce-scatter, and by an all-reduce
        of the whole vector whose window is then kept."""
        N = self.size
        return {"reduce_scatter": (N - 1) * self.m_sto * itemsize,
                "all_reduce": 2 * (N - 1) * (-(-self.layout.n_storage // N))
                * itemsize}

    def matrix(self, A: OffsetMatrix) -> OffsetMatrix:
        """The window's rows of A: a whole OffsetMatrix is cut, one over
        this window is A itself."""
        if A.window is self.mine:
            return A
        if not A.window.whole:
            raise ValueError("the matrix holds another row window")
        return OffsetMatrix.from_values(self.local_storage(A.vals),
                                        self.layout, self.mine)


def row_window(layout, mesh) -> RowWindow:
    """The RowWindow of (layout, mesh), built once and kept on the
    layout (so it lives as long as the layout's domain)."""
    cache = layout.__dict__.setdefault("_row_windows", {})
    hit = cache.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        hit = (mesh, RowWindow(layout, mesh))
        cache[id(mesh)] = hit
    return hit[1]


# ---------------------------------------------------------------------------
# the descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """What a rank holds of an array: ``"elements"`` (a contiguous block
    of the leading element axis), ``"rows"`` (the row window of the last
    axis, DOF rows), ``"storage"`` (the window's storage of the last
    axis), ``"lattice"`` (the window of the lattice axes after ``lead``
    leading axes) or ``"replicated"`` (all)."""
    kind: str
    mesh: object
    rows: Optional[RowWindow] = None
    ndim: int = 1
    lead: int = 0


def rowblock_sharding(rows: RowWindow, ndim: int = 1,
                      storage: bool = False) -> Sharding:
    """The row window of the LAST axis: rows of a vector, or with
    ``storage`` the window's storage of a matrix (or of the storage axis
    of the [L+1, n_storage] stacks)."""
    return Sharding("storage" if storage else "rows", rows.mesh, rows, ndim)


def lattice_sharding(rows: RowWindow, ndim: int, lead: int = 1) -> Sharding:
    """The window of the lattice axes after ``lead`` leading channel
    axes: [C, *S] smoother diagonals, [C, C, *S] channel blocks, [1, *S]
    masks."""
    return Sharding("lattice", rows.mesh, rows, ndim, lead)


def constrain(rows: Optional[RowWindow], v, storage: bool = False):
    """The window of a whole row vector, or with ``storage`` of a whole
    storage vector (the last axis); a no-op without a row window, so
    call sites stay unconditional."""
    if rows is None or v is None:
        return v
    return rows.local_storage(v) if storage else rows.local(v)


def held(rows: Optional[RowWindow], record: dict, key: str,
         storage: bool = False):
    """A row-shaped cache ``record[key]`` (of a state of
    ``parallel.shard_domain_state``, or of its refined record) as a step
    over ``rows`` needs it: as it stands where the record is on that
    layout (uncut for a whole step, ``record["cut_to"]`` the step's
    window); on the window (``constrain``) where a row-sharded step
    reads an uncut record; whole (``uncut``) where a whole step reads a
    cut one.  A record cut to another window is refused."""
    v = record.get(key)
    cut = record.get("cut_to")
    if v is None or cut is rows:
        return v
    if rows is None:
        return uncut(record, key, cut.gather_storage if storage
                     else cut.gather)
    if cut is not None:
        raise ValueError(f"{key!r} is held on another row window")
    return constrain(rows, v, storage)


def uncut(record: dict, key: str, gather):
    """``gather(record[key])``: the whole array of a cut record's
    ``key``, gathered from every rank's window at the first call and
    kept in the record (``record["uncut"]``), so that a whole step
    gathers once.  A collective: every rank of the mesh calls it."""
    cache = record.setdefault("uncut", {})
    if key not in cache:
        cache[key] = gather(record[key])
    return cache[key]


def put_divisible(v, sharding: Sharding, mesh):
    """v cut as ``sharding`` says when its split divides the mesh (every
    window holds n/N rows), else whole on every rank: the reference's
    rule, under which uneven sizes stay replicated.  Structured domains
    split via ``mesh_classical(lattice_pad=N)``."""
    rows = sharding.rows
    if sharding.kind not in ("rows", "storage", "lattice"):
        raise ValueError(f"put_divisible splits rows, storage or "
                         f"lattices, not {sharding.kind!r}")
    if not rows.even:
        return v
    if sharding.kind == "lattice":
        return rows.lattice_local(v, sharding.lead)
    return constrain(rows, v, storage=sharding.kind == "storage")


def shard_mg_state(mg_state, rows: RowWindow):
    """The frozen multigrid state (multigrid.mg_setup) with its FINE
    level on the rank's window: the assembled operator's storage, the
    smoother diagonal, the channel blocks and the occupancy mask, and
    the window itself under "rows" (all whole where the window does not
    divide: ``put_divisible``'s rule; ``local_mg_state`` cuts them at the
    step); the coarser (Galerkin) levels stay whole:
    level 1 is already 2^dim times smaller and the V-cycle spends most
    of its time in the fine smoother."""
    if mg_state is None:
        return None
    if rows.even:
        return local_mg_state(mg_state, rows)
    return mg_state


def local_mg_state(mg_state, rows: RowWindow):
    """The multigrid state with every fine-level array on the window and
    the window under "rows"; a state already on this window (its "rows"
    is ``rows``) is returned as it is."""
    held_by = mg_state[0].get("rows")
    if held_by is rows:
        return mg_state
    if held_by is not None:
        raise ValueError("the multigrid state is on another row window")
    out = [dict(e) for e in mg_state]
    e0 = out[0]
    if "A" in e0:
        e0["A"] = rows.matrix(e0["A"])
    for k, lead in (("inv_diag", 1), ("mask", 1), ("inv_diag_blk", 2)):
        if k in e0:
            e0[k] = rows.lattice_local(e0[k], lead)
    e0["rows"] = rows
    return tuple(out)


def whole_mg_state(mg_state, shape):
    """The inverse of ``local_mg_state``: the multigrid state with its
    fine level gathered back from every rank's window (the operator's
    storage, ``inv_diag``, ``mask``, ``inv_diag_blk``; ``shape`` the
    fine lattice's shape) and no "rows"; a whole state is returned as it
    is.  A collective: every rank of the window's mesh calls it."""
    rows = mg_state[0].get("rows")
    if rows is None:
        return mg_state
    out = [dict(e) for e in mg_state]
    e0 = out[0]
    del e0["rows"]
    if "A" in e0:
        e0["A"] = OffsetMatrix.from_values(
            rows.gather_storage(e0["A"].vals), rows.layout)
    for k, lead in (("inv_diag", 1), ("mask", 1), ("inv_diag_blk", 2)):
        if k in e0:
            e0[k] = rows.gather_lattice(e0[k], lead).reshape(
                tuple(e0[k].shape[:lead]) + tuple(shape))
    return tuple(out)


class RowShardedMGOperator:
    """A multigrid-preconditioned operator (multigrid.MGOperator,
    auxmg.AuxMGOperator or auxmg.SparseInnerOp) whose state runs its fine
    level on the window: products and the preconditioner take and return
    the window's rows.  Carries the window, so the Krylov solvers
    all-reduce their dots over the mesh."""

    def __init__(self, op, rows: RowWindow):
        self.op = op
        self.row_window = rows
        self.mesh = rows.mesh

    def mv(self, v):
        return self.op.mv(v)

    def apply_m(self, y):
        return self.op.apply_m(y)

    @property
    def n(self):
        return self.row_window.n


class RowShardedOp:
    """A matrix whose products land on the window: ``mv(x_local)``
    gathers x, runs the window's rows of the matrix
    (an ``OffsetMatrix`` over the window) and returns the window's rows
    of A x.
    Carries the window, so the Krylov solvers all-reduce their dots over
    the mesh."""

    def __init__(self, inner, rows: RowWindow):
        self.inner = rows.matrix(inner)
        self.row_window = rows
        self.mesh = rows.mesh

    def mv(self, x):
        return self.inner.mv(self.row_window.gather(x))

    def tmv(self, x):
        """The window's rows of A.T x (x: the window's rows): every
        window's share (``OffsetMatrix.tmv`` over the window), summed in
        rank order onto the windows (``reduce_scatter_rows``)."""
        return self.row_window.reduce_scatter_rows(self.inner.tmv(x))

    def diag(self, *a, **kw):
        return self.inner.diag()

    def scale_cols(self, s) -> "RowShardedOp":
        """A diag(s) with s the window's rows (gathered here)."""
        return RowShardedOp(self.inner.scale_cols(self.row_window.gather(s)),
                            self.row_window)

    @property
    def n(self):
        return self.row_window.n
