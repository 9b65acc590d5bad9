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
from .linsolve.block_offset import OffsetLayout, OffsetMatrix, PallasGroup
from .linsolve.multigrid import MGHierarchy, hierarchy_for_domain


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


def load_reference_freezes(dom, k_linear_td: Optional[np.ndarray] = None,
                           refined: Optional[Dict[str, np.ndarray]] = None,
                           mg_frozen=None, mg_hier=None) -> None:
    """Load the reference domain's freezes into the port's compiled
    domain, so each stage of the refined step can be compared alone:

    - ``k_linear_td``: the stacked linear tangent components
      [L+1, n_storage] (the reference's ``_k_linear_td``);
    - ``refined``: the reference's ``_refined`` with numpy ``A_hi``,
      ``A_lo``, ``b_hi``, ``b_lo``; the port stores hi + lo in float64
      and builds its own float64 tables of the nonaffine remainder;
    - ``mg_frozen``: the reference's ``_mg_frozen`` with numpy leaves, a
      sequence of per-level dicts whose level-0 ``"A"`` holds ``vals``;
      ``mg_hier`` is any object with MGHierarchy's fields (default: the
      port's hierarchy of ``dom``)."""
    dev = dom.device
    if k_linear_td is not None:
        dom._k_linear_td = torch.tensor(np.asarray(k_linear_td),
                                        dtype=dom.dtype, device=dev)
    if refined is not None:
        f64 = torch.float64

        def pair(hi, lo):
            return (torch.tensor(np.asarray(refined[hi]), dtype=f64,
                                 device=dev)
                    + torch.tensor(np.asarray(refined[lo]), dtype=f64,
                                   device=dev))
        dom._refined = {"A": pair("A_hi", "A_lo"), "b": pair("b_hi", "b_lo"),
                        "wp": dom._refined_tables()}
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
