"""Checkpoint / resume of node states (port of
tensornetworksfork_tpu/utils/checkpoint.py).

`node_states()` / `load_node_states` (a layer's {name: tensor} dict, a sum
layer's list of them) are written to and read from an `.npz` in the JAX
package's layout, so a checkpoint crosses between the packages either way:
a dict's arrays under their names with `__layout__` = -1, a list's under
`m{i}/{name}` with `__layout__` = its length. A path without `.npz` gains
it, as the JAX package's npz protocol does. The JAX package writes orbax
directories where orbax is installed; the port writes npz only.
"""
from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch

from .device import resolve_device


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _npz(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_node_states(path: str, states: Union[dict, list]) -> None:
    """states: {name: tensor} or [{name: tensor}, ...] (sum layers)."""
    flat = {}
    if isinstance(states, list):
        for mi, d in enumerate(states):
            for k, v in d.items():
                flat[f"m{mi}/{k}"] = _host(v)
        flat["__layout__"] = np.asarray(len(states))
    else:
        for k, v in states.items():
            flat[k] = _host(v)
        flat["__layout__"] = np.asarray(-1)
    path = _npz(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **flat)


def load_node_states(path: str, device="cuda") -> Union[dict, list]:
    """The states `save_node_states` wrote (or the JAX package's npz), as
    tensors on `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    with np.load(_npz(path)) as data:
        layout = int(data["__layout__"])
        if layout < 0:
            return {k: torch.from_numpy(v).to(dev) for k, v in data.items()
                    if k != "__layout__"}
        out = [dict() for _ in range(layout)]
        for k, v in data.items():
            if k == "__layout__":
                continue
            mi, name = k.split("/", 1)
            out[int(mi[1:])][name] = torch.from_numpy(v).to(dev)
        return out
