"""Params crossing between the JAX package and this one (the tensor
networks' params dicts, and the baselines' flax trees).

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


def mlp_params_from_flax(params, spatial=None) -> Dict[str, torch.Tensor]:
    """A flax param tree of the JAX package's MLP / PINet / ResMLP /
    SimpleCNN (numpy leaves; the top "params" level optional) -> the
    `state_dict` of the port's module (models/baselines.py), on the CPU.

    Dense_i -> dense.i (weight = kernelᵀ), Conv_i -> conv.i (HWIO kernel ->
    OIHW weight). Where convolutions come first, Dense_0 reads flax's NHWC
    flatten order (h, w, c); its rows are permuted to the port's NCHW order
    (c, h, w). `spatial` = (H, W) of the last feature map (default: square,
    from Dense_0's rows and the last conv's channels)."""
    tree = params.get("params", params)
    out = {}

    def index(name):
        return int(name.rsplit("_", 1)[1])

    convs = sorted((k for k in tree if k.startswith("Conv_")), key=index)
    for name in convs:
        k = np.asarray(tree[name]["kernel"])
        out[f"conv.{index(name)}.weight"] = torch.tensor(k.transpose(3, 2, 0, 1).copy())
        out[f"conv.{index(name)}.bias"] = torch.tensor(np.asarray(tree[name]["bias"]))
    for name in sorted((k for k in tree if k.startswith("Dense_")), key=index):
        k = np.asarray(tree[name]["kernel"])
        if convs and index(name) == 0:
            C = np.asarray(tree[convs[-1]]["kernel"]).shape[-1]
            H, W = spatial or (int(round(np.sqrt(k.shape[0] // C))),) * 2
            k = k.reshape(H, W, C, -1).transpose(2, 0, 1, 3).reshape(C * H * W, -1)
        out[f"dense.{index(name)}.weight"] = torch.tensor(k.T.copy())
        out[f"dense.{index(name)}.bias"] = torch.tensor(np.asarray(tree[name]["bias"]))
    return out
