"""Mesh file readers: Abaqus .inp and COMSOL .mphtxt.

Capability parity with the reference's 100-102 readers
(ref_geometry/101_Read_INP.jl, 102_Read_MPHTXT.jl): returns (vert,
connections) for the volume element block, with vertex-id remapping.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np


def read_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    if path.lower().endswith(".inp"):
        return read_inp(path)
    if path.lower().endswith(".mphtxt"):
        return read_mphtxt(path)
    raise ValueError(f"unknown mesh format: {path}")


def read_inp(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Abaqus: *NODE block (id, x, y[, z]) and *ELEMENT blocks.  Node ids
    are remapped to dense 0-based ids.  If several *ELEMENT blocks exist,
    the one with the most rows wins (the volume block)."""
    node_ids, node_coords = [], []
    element_blocks = []
    section = None
    with open(path) as f:
        cur_rows = []
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("**"):
                continue
            if line.startswith("*"):
                if section == "element" and cur_rows:
                    element_blocks.append(cur_rows)
                cur_rows = []
                kw = line.split(",")[0].upper()
                if kw == "*NODE":
                    section = "node"
                elif kw == "*ELEMENT":
                    section = "element"
                else:
                    section = None
                continue
            parts = [p for p in re.split(r"[,\s]+", line) if p]
            if section == "node":
                node_ids.append(int(parts[0]))
                node_coords.append([float(v) for v in parts[1:]])
            elif section == "element":
                cur_rows.append([int(v) for v in parts[1:]])
        if section == "element" and cur_rows:
            element_blocks.append(cur_rows)
    if not node_ids or not element_blocks:
        raise ValueError(f"no NODE/ELEMENT blocks found in {path}")
    block = max(element_blocks, key=len)
    conn = np.asarray(block, dtype=np.int64)
    ids = np.asarray(node_ids, dtype=np.int64)
    remap = np.full(ids.max() + 1, -1, dtype=np.int64)
    remap[ids] = np.arange(len(ids))
    conn = remap[conn]
    if (conn < 0).any():
        raise ValueError("element references an undefined node id")
    return np.asarray(node_coords, dtype=float), conn


def read_mphtxt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """COMSOL text mesh: '# number of mesh points' + coordinate lines,
    then one or more element-type sections; the element block with the
    most rows among volume-sized blocks is returned (the reference takes
    the first block; real COMSOL exports list vtx/edg/tri before tet, so
    largest-block selection is the robust generalization)."""
    with open(path) as f:
        lines = f.readlines()

    def strip_comment(s: str) -> str:
        return s.split("#")[0].strip()

    i = 0
    n_points = None
    start_vid = 0
    coords = None
    element_blocks = []
    while i < len(lines):
        line = lines[i]
        if "# number of mesh points" in line:
            n_points = int(strip_comment(line))
            i += 1
            # optional 'lowest mesh point index' line
            while i < len(lines):
                s = lines[i]
                if "lowest mesh point index" in s:
                    start_vid = int(strip_comment(s))
                    i += 1
                    continue
                if "# Mesh point coordinates" in s or strip_comment(s):
                    break
                i += 1
            if "# Mesh point coordinates" in lines[i]:
                i += 1
            coords = []
            while len(coords) < n_points:
                s = strip_comment(lines[i])
                i += 1
                if s:
                    coords.append([float(v) for v in s.split()])
            coords = np.asarray(coords)
            continue
        if re.search(r"#\s*number of elements", line):
            n_el = int(strip_comment(line))
            i += 1
            if i < len(lines) and "# Elements" in lines[i]:
                i += 1
            rows = []
            while len(rows) < n_el and i < len(lines):
                s = strip_comment(lines[i])
                i += 1
                if s:
                    rows.append([int(v) for v in s.split()])
            if rows:
                element_blocks.append(np.asarray(rows, dtype=np.int64))
            continue
        i += 1
    if coords is None or not element_blocks:
        raise ValueError(f"no mesh points/elements found in {path}")
    dim = coords.shape[1]
    volume_sizes = {2: (3, 4), 3: (4, 8)}[dim]
    candidates = [b for b in element_blocks if b.shape[1] in volume_sizes]
    if not candidates:
        candidates = element_blocks
    conn = max(candidates, key=len) - start_vid
    return coords, conn
