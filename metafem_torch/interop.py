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
