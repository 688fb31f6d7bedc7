"""Params crossing between the JAX package and this one.

Both packages build a model's topology with the same calls, so the params
dicts have the same names and shapes; JAX params go in as
`{k: np.asarray(v)}`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import resolve_device


def params_from_numpy(params: Dict[str, np.ndarray], device="cuda",
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """numpy arrays -> tensors of `dtype` on `device` (copies). Defaults to
    the card and raises RuntimeError where none is visible (utils/device.py);
    pass device="cpu" for the CPU."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=dev)
            for k, v in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """tensors (any device) -> numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
