"""Feature maps (port of tensornetworksfork_tpu/ops/feature_maps.py):
complex Fourier bases (dense or sparse), a Gaussian-RBF quantisation map and
Legendre polynomials.

Each map takes X (B, d) and returns the per-sample feature tensor (B, d, K)
that a TT with one carriage per feature reads through
`per_position_inputs`. A tensor X stays on its device; anything else goes
to `device` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import torch

from ..utils.device import resolve_device


def _as_tensor(X, device) -> torch.Tensor:
    if torch.is_tensor(X) and device is None:
        return X
    return torch.as_tensor(X, device=resolve_device(device or "cuda"))


def fourier_basis(X, num_frequencies: int, dense: bool = True,
                  frequencies=None, device=None) -> torch.Tensor:
    """Complex Fourier features exp(i k x) per input dimension, complex64.
    dense: k = -K..K; sparse: k in {0, 1, 2, 4, ..., 2^(K-1)}; or an
    explicit frequency list."""
    X = _as_tensor(X, device)
    if frequencies is None:
        if dense:
            frequencies = torch.arange(-num_frequencies, num_frequencies + 1)
        else:
            frequencies = torch.cat([torch.zeros(1),
                                     2.0 ** torch.arange(num_frequencies)])
    k = torch.as_tensor(frequencies, dtype=torch.float32, device=X.device)
    return torch.exp(1j * X[..., None] * k[None, None, :]).to(torch.complex64)


def gaussian_rbf_basis(X, centers=None, num_centers: int = 8,
                       width: float = None, input_range=(-1.0, 1.0),
                       device=None) -> torch.Tensor:
    """exp(-(x - c_j)² / (2 width²)) over a grid of centers (default
    `num_centers` evenly spaced over input_range, width their spacing)."""
    X = _as_tensor(X, device)
    if centers is None:
        centers = torch.linspace(input_range[0], input_range[1], num_centers)
    centers = torch.as_tensor(centers, dtype=X.dtype, device=X.device)
    if width is None:
        width = float(centers[1] - centers[0]) if len(centers) > 1 else 1.0
    z = (X[..., None] - centers[None, None, :]) / width
    return torch.exp(-0.5 * z * z)


def legendre_basis(X, degree: int, device=None) -> torch.Tensor:
    """Legendre polynomials P_0..P_degree of each feature, by
    (n+1) P_{n+1} = (2n+1) x P_n - n P_{n-1}."""
    X = _as_tensor(X, device)
    polys = [torch.ones_like(X), X]
    for n in range(1, degree):
        polys.append(((2 * n + 1) * X * polys[n] - n * polys[n - 1]) / (n + 1))
    return torch.stack(polys[: degree + 1], dim=-1)


def per_position_inputs(features):
    """(B, d, K) feature tensor -> list of per-position (B, K) inputs, the
    layout of TT layers with one carriage per feature."""
    return [features[:, i] for i in range(features.shape[1])]
