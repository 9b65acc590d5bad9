"""Carry state across from the reference package, as plain numpy.

Both helpers take numpy arrays and plain Python objects, never arrays of
another framework, so a test can start the reference and the port from
the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .config import resolve_device
from .linsolve.auxmg import AuxDesc
from .linsolve.block_offset import (OffsetLayout, OffsetMatrix, PallasGroup,
                                    sorted_segment_plan)
from .linsolve.multigrid import MGHierarchy, hierarchy_for_domain
from .linsolve.spmv import SparseMatrix
from .linsolve.twofloat import DF, df_to_f64


def _as_layout(layout) -> OffsetLayout:
    """The port's OffsetLayout from any object with its fields (e.g. the
    reference's layout, whose fields are numpy arrays and tuples)."""
    if isinstance(layout, OffsetLayout):
        return layout
    groups = tuple(PallasGroup(**{f.name: getattr(g, f.name)
                                  for f in dataclasses.fields(PallasGroup)})
                   for g in layout.pallas_groups)
    fields = {f.name: getattr(layout, f.name)
              for f in dataclasses.fields(OffsetLayout)
              if f.name != "pallas_groups"}
    return OffsetLayout(pallas_groups=groups, **fields)


def offset_matrix_from_numpy(vals: np.ndarray, layout,
                             device=None) -> OffsetMatrix:
    """An OffsetMatrix holding the storage values ``vals`` [n_storage]
    under ``layout`` (the port's or one with the same fields), on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    lo = _as_layout(layout)
    vals = np.asarray(vals)
    if vals.shape != (lo.n_storage,):
        raise ValueError(f"vals {vals.shape} != ({lo.n_storage},)")
    return OffsetMatrix.from_values(
        torch.tensor(vals, device=resolve_device(device)), lo)


def sparse_matrix_from_numpy(vals: np.ndarray, rows: np.ndarray,
                             cols: np.ndarray, n: int,
                             device=None) -> SparseMatrix:
    """A SparseMatrix of n x n holding ``vals`` at (``rows``, ``cols``),
    given in CSR order (rows sorted), on ``device`` (CUDA unless the
    caller asks for the CPU); the indices are stored as int64."""
    vals, rows, cols = (np.asarray(a) for a in (vals, rows, cols))
    if not vals.shape == rows.shape == cols.shape or vals.ndim != 1:
        raise ValueError(f"vals {vals.shape}, rows {rows.shape} and cols "
                         f"{cols.shape} must be equal 1-D shapes")
    if rows.size and np.any(np.diff(rows) < 0):
        raise ValueError("rows must be sorted (CSR order)")
    dev = resolve_device(device)
    return SparseMatrix(torch.tensor(vals, device=dev),
                        torch.tensor(rows.astype(np.int64), device=dev),
                        torch.tensor(cols.astype(np.int64), device=dev),
                        int(n))


def load_reference_state(dom, x: Optional[np.ndarray] = None,
                         fields: Optional[Dict[int, Dict[str, np.ndarray]]]
                         = None, t: Optional[float] = None,
                         dt: Optional[float] = None) -> None:
    """Load the reference domain's numpy state into the port's compiled
    domain: the global x [L+1, bfs], named controlpoint columns per
    workpiece, and the time and step."""
    for wp_id, cols in (fields or {}).items():
        for name, col in cols.items():
            dom.set_field(wp_id, name, np.asarray(col))
    if fields:
        dom.refresh_fields()
    if x is not None:
        x = np.asarray(x)
        if tuple(x.shape) != tuple(dom.x.shape):
            raise ValueError(f"x {x.shape} != {tuple(dom.x.shape)}")
        dom.x = torch.tensor(x, dtype=dom.dtype, device=dom.device)
    if t is not None:
        dom.t = float(t)
    if dt is not None:
        dom.dt = float(dt)


def _df_tree(tree, device):
    """A nest of dicts and lists with pair leaves (anything with ``hi``
    and ``lo``) and array leaves, as the port's DF pairs and tensors on
    ``device`` (integer arrays as int64)."""
    if hasattr(tree, "hi") and hasattr(tree, "lo"):
        return DF(*(torch.tensor(np.asarray(w), dtype=torch.float32,
                                 device=device) for w in (tree.hi, tree.lo)))
    if isinstance(tree, dict):
        return {k: _df_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_df_tree(v, device) for v in tree]
    if tree is None:
        return None
    a = np.asarray(tree)
    return torch.tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a,
                        device=device)


def _aux_tree(tree: dict, dom) -> dict:
    """The reference's auxmg tree (numpy leaves) as the port's: the
    float leaves in the domain's dtype, the index leaves int64, and the
    Pᵀ segment-sum plan (``cell_plan``) that the port builds at setup."""
    dev = dom.device

    def f(a):
        return torch.tensor(np.asarray(a), dtype=dom.dtype, device=dev)
    out = {}
    for key, val in tree.items():
        if val is None:
            out[key] = None
        elif key == "lat":
            out[key] = tuple({k: f(v) for k, v in lvl.items()
                              if v is not None} for lvl in val)
        elif key in ("cell", "bd_sel", "bd_rows"):
            out[key] = torch.tensor(np.asarray(val).astype(np.int64),
                                    device=dev)
        else:
            out[key] = f(val)
    out["cell_plan"] = sorted_segment_plan(np.asarray(tree["cell"]), dev)
    return out


def load_reference_freezes(dom, k_linear_td: Optional[np.ndarray] = None,
                           refined: Optional[Dict[str, np.ndarray]] = None,
                           mg_frozen=None, mg_hier=None, auxmg=None,
                           auxmg_spectrum=None, auxmg_cheb=None) -> None:
    """Load the reference domain's freezes into the port's compiled
    domain, so each stage of the refined step can be compared alone:

    - ``k_linear_td``: the stacked linear tangent components
      [L+1, n_storage] (the reference's ``_k_linear_td``);
    - ``refined``: the reference's ``_refined`` with numpy ``A_hi``,
      ``A_lo``, ``b_hi``, ``b_lo`` and, optionally, ``bnd_dofs`` and
      ``wp_df`` (its tables with numpy leaves, each pair any object with
      ``hi`` and ``lo``); the port stores hi + lo in float64 for its
      float64 mode, keeps the pairs themselves for its two-float mode,
      and builds its own float64 tables of the nonaffine remainder;
    - ``mg_frozen``: the reference's ``_mg_frozen`` with numpy leaves, a
      sequence of per-level dicts whose level-0 ``"A"`` holds ``vals``;
      ``mg_hier`` is any object with MGHierarchy's fields (default: the
      port's hierarchy of ``dom``);
    - ``auxmg``: the reference's ``_auxmg`` pair (tree, (desc, hier)),
      the tree with numpy leaves (cell, w, the lattice state ``lat``,
      inv_diag, omega and, under smooth='sparse', bd_sel, bd_rows,
      smooth_lump and smooth_bd), desc and hier any objects with
      AuxDesc's and MGHierarchy's fields; ``auxmg_spectrum`` and
      ``auxmg_cheb`` its tuned spectrum and Chebyshev enclosure."""
    dev = dom.device
    if k_linear_td is not None:
        dom._k_linear_td = torch.tensor(np.asarray(k_linear_td),
                                        dtype=dom.dtype, device=dev)
    if refined is not None:
        def f32(a):
            return torch.tensor(np.asarray(a), dtype=torch.float32,
                                device=dev)

        words = {k: f32(refined[k])
                 for k in ("A_hi", "A_lo", "b_hi", "b_lo")}
        rec = dom._refined_record(
            df_to_f64(DF(words["A_hi"], words["A_lo"])),
            df_to_f64(DF(words["b_hi"], words["b_lo"])))
        rec.update(words)
        if refined.get("bnd_dofs") is not None:
            rec["bnd_dofs"] = torch.tensor(
                np.asarray(refined["bnd_dofs"]).astype(np.int64), device=dev)
        if refined.get("wp_df") is not None:
            rec["wp_df"] = _df_tree(refined["wp_df"], dev)
        dom._refined = rec
    if mg_frozen is not None:
        levels = []
        for entry in mg_frozen:
            lvl = {}
            for key, val in entry.items():
                if key == "A":
                    lvl[key] = OffsetMatrix.from_values(
                        torch.tensor(np.asarray(val.vals), dtype=dom.dtype,
                                     device=dev),
                        dom.pattern.offset_layout)
                elif val is not None:
                    lvl[key] = torch.tensor(np.asarray(val),
                                            dtype=dom.dtype, device=dev)
            levels.append(lvl)
        dom._mg_frozen = tuple(levels)
        dom._mg_hier = (hierarchy_for_domain(dom) if mg_hier is None
                        else MGHierarchy(**{
                            f.name: getattr(mg_hier, f.name)
                            for f in dataclasses.fields(MGHierarchy)}))
    if auxmg is not None:
        tree, (desc, hier) = auxmg

        def fields(cls, obj):
            return cls(**{f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(cls)})
        dom._auxmg = (_aux_tree(tree, dom),
                      (fields(AuxDesc, desc), fields(MGHierarchy, hier)))
    if auxmg_spectrum is not None:
        dom._auxmg_spectrum = tuple(float(v) for v in auxmg_spectrum)
    if auxmg_cheb is not None:
        (lo, hi), rate = auxmg_cheb
        dom._auxmg_cheb = ((float(lo), float(hi)), float(rate))
