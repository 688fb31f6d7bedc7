"""Synthetic / feature-map study script (port of
tensornetworksfork_tpu/experiments/default_train.py).

Fits a TT to a random polynomial target under a chosen feature map — raw
(+ a bias column), dense or sparse complex Fourier, Gaussian-RBF, Legendre —
or with the uncertainty (Gaussian NLL) head, or over TT-compressed data
(a `CompressedTensorTrainLayer`, whose data are baked in).

variant: raw | fourier | fourier_sparse | rbf | legendre | uncertainty |
data_comp

Run:  python -m tensornetworksfork_tpu_torch.experiments.default_train <variant> [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.sweep import SweepConfig, accumulating_sweep
from ..data.synthetic import RandomPolynomialRange
from ..models.layers import CompressedTensorTrainLayer, TensorTrainLayer
from ..ops import feature_maps
from ..ops.bregman import (SquareBregFunction, SquareComplexBregFunction,
                           UncertaintyAutogradLoss)
from ..ops.compression import DataCompression, train_compress
from ..utils.device import resolve_device
from ..utils.metrics import rmse

VARIANTS = ("raw", "fourier", "fourier_sparse", "rbf", "legendre",
            "uncertainty", "data_comp")


def run(variant: str = "raw", S: int = 2048, d: int = 4, degree: int = 3,
        N: int = 3, r: int = 8, num_swipes: int = 8, eps: float = 1e-4,
        eps_decay: float = 0.8, seed: int = 0, verbose: int = 0,
        device="cuda") -> dict:
    """Returns {variant, ok, train_rmse, pred}: pred the predictions that
    train_rmse scores (the mean head's under uncertainty)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(S, d)).astype(np.float32)
    target = RandomPolynomialRange(d, degree, random_state=seed)
    y = target.evaluate(X).astype(np.float32)
    y = ((y - y.mean()) / (y.std() + 1e-8)).reshape(-1, 1)

    dtype = torch.float32
    loss = SquareBregFunction()
    out_dim = 1
    feats = np.concatenate([X, np.ones((S, 1), np.float32)], axis=1)
    Xt = torch.as_tensor(X, device=dev)

    if variant == "raw":
        f = d + 1
        x_in = torch.as_tensor(feats, device=dev)
    elif variant in ("fourier", "fourier_sparse"):
        F = feature_maps.fourier_basis(Xt, num_frequencies=degree,
                                       dense=variant == "fourier")
        x_in = feature_maps.per_position_inputs(F)
        f, N = F.shape[-1], d
        dtype = torch.complex64
        loss = SquareComplexBregFunction()
    elif variant == "rbf":
        F = feature_maps.gaussian_rbf_basis(Xt, num_centers=max(degree + 2, 4))
        x_in = feature_maps.per_position_inputs(F)
        f, N = F.shape[-1], d
    elif variant == "legendre":
        F = feature_maps.legendre_basis(Xt, degree=degree)
        x_in = feature_maps.per_position_inputs(F)
        f, N = F.shape[-1], d
    elif variant == "uncertainty":
        f = d + 1
        x_in = torch.as_tensor(feats, device=dev)
        loss = UncertaintyAutogradLoss()
        out_dim = 2
        y = y.reshape(-1)
    elif variant == "data_comp":
        blocks = DataCompression(feats, device=dev).non_compressed(degree=N)
        blocks, _ = train_compress(list(blocks), rank=4 * r)
        layer = CompressedTensorTrainLayer(blocks, bond_dim=r, output_shape=(1,),
                                           seed=seed, device=dev)
        cfg = SweepConfig(num_swipes=num_swipes, method="ridge_cholesky",
                          eps=eps, eps_decay=eps_decay, verbose=verbose)
        params, ok = accumulating_sweep(layer.network, layer.params, {},
                                        torch.as_tensor(y, device=dev), loss, cfg)
        layer.params = params
        pred = layer({}).cpu().numpy()
        return {"variant": variant, "ok": ok,
                "train_rmse": rmse(y, pred.reshape(y.shape)), "pred": pred}
    else:
        raise ValueError(f"unknown variant {variant!r}")

    layer = TensorTrainLayer(N, r, f, output_shape=(out_dim,),
                             constrict_bond=True, dtype=dtype, seed=seed,
                             device=dev)
    # the Gaussian-NLL Hessian is indefinite: Cholesky would fail, so the
    # general ridge solve with strong damping and step clipping
    if variant == "uncertainty":
        cfg = SweepConfig(num_swipes=num_swipes, method="ridge_exact",
                          eps=max(eps, 1.0), eps_decay=0.7,
                          adaptive_step=True, verbose=verbose)
    else:
        cfg = SweepConfig(num_swipes=num_swipes, method="ridge_cholesky",
                          eps=eps, eps_decay=eps_decay, verbose=verbose)
    params, ok = accumulating_sweep(layer.network, layer.params, x_in,
                                    torch.as_tensor(y, device=dev), loss, cfg)
    layer.params = params
    pred = layer(x_in).cpu().numpy()
    if variant == "uncertainty":
        return {"variant": variant, "ok": ok, "train_rmse": rmse(y, pred[:, 0]),
                "pred": pred[:, 0]}
    if np.iscomplexobj(pred):
        pred = pred.real
    return {"variant": variant, "ok": ok,
            "train_rmse": rmse(y, pred.reshape(y.shape)), "pred": pred.reshape(y.shape)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("variant", nargs="?", default="raw", choices=VARIANTS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    res = run(args.variant, verbose=1, device=args.device)
    print({k: v for k, v in res.items() if k != "pred"})


if __name__ == "__main__":
    main()
