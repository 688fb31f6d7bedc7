"""Image patch extraction for the convolutional TT models (port of
tensornetworksfork_tpu/ops/patches.py).

`extract_patches` is `torch.nn.functional.unfold(...).transpose(-2, -1)`:
(B, num_patches, C*kh*kw), the channel index slowest, the element order the
JAX package reproduces with `conv_general_dilated_patches`. `add_bias_patch`
appends a zero patch row and a zero pixel column with a 1 in the corner.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_patches(x: torch.Tensor, kernel_size, stride=None,
                    padding: int = 0) -> torch.Tensor:
    """x: (B, C, H, W) or (B, H, W) -> (B, L, C*kh*kw), L the number of
    sliding windows; zero padding of `padding` on each side first."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    if stride is None:
        stride = kernel_size
    if x.ndim == 3:
        x = x[:, None]
    return F.unfold(x, kernel_size, stride=stride,
                    padding=padding).transpose(-2, -1).contiguous()


def add_bias_patch(x: torch.Tensor) -> torch.Tensor:
    """(B, L, P) -> (B, L+1, P+1): a zero patch row and a zero pixel column
    appended, the corner set to 1."""
    B, L, P = x.shape
    out = x.new_zeros((B, L + 1, P + 1))
    out[:, :L, :P] = x
    out[:, -1, -1] = 1.0
    return out


def image_to_conv_input(x: torch.Tensor, kernel_size: int, stride: int,
                        padding: int = 0) -> torch.Tensor:
    """Unfold, then the bias patch."""
    return add_bias_patch(extract_patches(x, kernel_size, stride, padding))
