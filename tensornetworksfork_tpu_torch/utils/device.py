"""The device an entry point of the port runs on.

Entry points (`Network`, the layer builders, `TensorTrainRegressor`, the
tabular CLI) default to the card. Asking for CUDA where no card is visible
raises: the port never falls back to the CPU on its own, so a run on the
CPU is always one the caller asked for (`device="cpu"`, `--device cpu`).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`torch.device(device)`, after checking that a CUDA device is visible
    when one is asked for. Raises RuntimeError instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but no CUDA device is visible; "
            "pass device='cpu' (--device cpu on the command line) to run on "
            "the CPU")
    return dev
