"""Checkpoint / resume of the full solver state.

A copy of the reference package's ``io/checkpoint.py`` for the port,
with the same file format, so each package reads the other's
checkpoints.  MetaFEM.jl has no checkpointing; its closest mechanism is
the assemble_X!/dessemble_X! state sync plus per-step VTK dumps.  A
checkpoint captures everything needed to resume a run exactly: the
global x/dx (all time levels), t/dt, every named controlpoint column per
workpiece, the user history tree (e.g. plasticity state), and the
global material constants.  Stored as a single .npz (portable, no extra
dependency) with the JSON meta as a uint8 array; mesh and physics are
rebuilt by re-running the setup script.
"""

from __future__ import annotations

import json

import numpy as np
import torch

_VERSION = 1


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _flatten_user(user, prefix="user"):
    out = {}
    if isinstance(user, dict):
        for k, v in user.items():
            out.update(_flatten_user(v, f"{prefix}.{k}"))
    else:
        out[prefix] = _host(user)
    return out


def _unflatten_user(arrays, prefix="user"):
    tree: dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "."):
            continue
        parts = key[len(prefix) + 1:].split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v if v.ndim else v.item()
    return tree


def save_checkpoint(domain, path: str) -> None:
    arrays = {"x": _host(domain.x), "dx": _host(domain.dx)}
    meta = {"version": _VERSION, "t": float(domain.t),
            "dt": float(domain.dt),
            "global_vars": {k: float(v)
                            for k, v in domain.global_vars.items()},
            "n_workpieces": len(domain.workpieces)}
    for i, wp in enumerate(domain.workpieces):
        for name, col in wp.mesh.fields.items():
            arrays[f"wp{i}.{name}"] = np.asarray(col)
    arrays.update(_flatten_user(domain.user_state))
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(domain, path: str) -> dict:
    """Restore a checkpoint into a domain that has been set up (meshed
    and compiled) with the same problem definition: x and dx go to the
    domain's device in its dtype, the user state to the device through
    ``domain.user_state``.  Returns the meta dict."""
    data = np.load(path if str(path).endswith(".npz") else path + ".npz")
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["version"] != _VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != "
                         f"{_VERSION}")
    if meta["n_workpieces"] != len(domain.workpieces):
        raise ValueError("workpiece count mismatch")
    x = data["x"]
    if domain.x is not None and x.shape != tuple(domain.x.shape):
        raise ValueError(f"state shape mismatch: checkpoint {x.shape} vs "
                         f"domain {tuple(domain.x.shape)}")
    domain.x = torch.as_tensor(x, dtype=domain.dtype, device=domain.device)
    domain.dx = torch.as_tensor(data["dx"], dtype=domain.dtype,
                                device=domain.device)
    domain.t = meta["t"]
    domain.dt = meta["dt"]
    domain.global_vars.update(meta["global_vars"])
    for i, wp in enumerate(domain.workpieces):
        for name in list(wp.mesh.fields):
            key = f"wp{i}.{name}"
            if key in data:
                wp.mesh.fields[name][...] = data[key]
    user = _unflatten_user({k: data[k] for k in data.files
                            if k.startswith("user.")})
    if user:
        domain.user_state = user
    if domain.state is not None:
        domain.refresh_fields()
    return meta
