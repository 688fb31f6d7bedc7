"""Growing / DMRG experiments (port of
tensornetworksfork_tpu/experiments/growing.py).

- `run_grow_cart`: train a conv-TT, append a carriage (`grow_cart`) and
  retrain, `grow_steps` times;
- `run_dmrg_growth`: two-site DMRG on a synthetic polynomial — grow a
  middle block, train it alone, SVD-split it with rank / error truncation,
  train the whole chain, repeat.

Both run on `device` (the card unless the caller asks for the CPU).

Run:  python -m tensornetworksfork_tpu_torch.experiments.growing [cart|dmrg] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.sweep import SweepConfig, accumulating_sweep
from ..models import growing
from ..models.layers import TensorConvolutionTrainLayer
from ..ops.bregman import SquareBregFunction
from ..utils.device import resolve_device
from ..utils.metrics import rmse


def run_dmrg_growth(X2, y, bond_dim: int = 8, grow_steps: int = 2,
                    rank: int = 8, err: Optional[float] = None,
                    num_swipes: int = 4, eps: float = 1e-4,
                    verbose: int = 0, device="cuda"):
    """X2: (S, 2, f) initial two-position inputs; each step adds two
    positions in the middle (copies of the middle column). Returns (layer,
    history)."""
    dev = resolve_device(device)
    f = X2.shape[-1]
    layer = growing.TensorTrainDMRGInfiLayer(bond_dim, f, output_shape=(1,),
                                             device=dev)
    cfg = SweepConfig(num_swipes=num_swipes, method="ridge_cholesky", eps=eps)
    y_t = torch.as_tensor(np.asarray(y), device=dev)
    history: List[dict] = []

    def train(x):
        xb = layer.bind_x(torch.as_tensor(x, device=dev))
        params, ok = accumulating_sweep(layer.network, layer.params, xb, y_t,
                                        SquareBregFunction(), cfg)
        layer.params = params
        return ok, rmse(np.asarray(y), layer(xb).cpu().numpy())

    x = np.asarray(X2)
    ok, e = train(x)
    history.append({"positions": layer.num_carriages, "rmse": e, "ok": ok})
    for _ in range(grow_steps):
        layer.grow_middle()
        mid = x.shape[1] // 2
        x = np.concatenate([x[:, :mid], x[:, mid:mid + 1], x[:, mid:mid + 1],
                            x[:, mid:]], axis=1)
        ok, e = train(x)  # trains only the grown block
        split_err = layer.split_node(rank=rank, err=err)
        ok2, e2 = train(x)  # the whole chain after the split
        history.append({"positions": layer.num_carriages, "rmse": e2,
                        "split_err": split_err, "ok": ok and ok2})
        if verbose:
            print(history[-1])
    return layer, history


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_grow_cart(x, y, start_carriages: int = 1, grow_steps: int = 2,
                  bond_dim: int = 8, convolution_bond: int = 4,
                  num_swipes: int = 3, eps: float = 1.0,
                  eps_decay: float = 0.5, loss_fn=None, verbose: int = 0,
                  device="cuda", output_dim=None):
    """Conv-TT cart growth: train, append a carriage, retrain. x: (S, P, pp)
    patched images (the bias patch last); y one-hot or targets. Returns
    (layer, history); each step's entry has its carriages, parameters,
    train RMSE, ok and `seconds` (the step's sweep, synchronised).

    output_dim: the model's outputs, y's columns by default. The C-1-logit
    losses (XEBregman) need one output fewer than y's one-hot columns, which
    y's columns cannot give; with such an output_dim the train RMSE is that
    of the class probabilities (a zero logit appended, w = 1) against y, and
    `train_accuracy` is added."""
    dev = resolve_device(device)
    loss_fn = loss_fn or SquareBregFunction()
    x_t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=dev)
    y_t = torch.as_tensor(np.asarray(y) if not torch.is_tensor(y) else y, device=dev)
    y_host = y_t.cpu().numpy()
    n_out = int(y_t.shape[1]) if output_dim is None else int(output_dim)
    layer = TensorConvolutionTrainLayer(
        num_carriages=start_carriages, bond_dim=bond_dim,
        num_patches=x_t.shape[1], patch_pixels=x_t.shape[2],
        output_shape=(n_out,), convolution_bond=convolution_bond, device=dev)
    cfg = SweepConfig(num_swipes=num_swipes, method="ridge_cholesky", eps=eps,
                      eps_decay=eps_decay)
    history: List[dict] = []
    for step in range(grow_steps + 1):
        _sync(dev)
        t0 = time.perf_counter()
        params, ok = accumulating_sweep(layer.network, layer.params, x_t, y_t,
                                        loss_fn, cfg)
        _sync(dev)
        seconds = time.perf_counter() - t0
        layer.params = params
        pred = layer(x_t)
        entry = {"carriages": layer.num_carriages, "params": layer.num_parameters()}
        if n_out == y_host.shape[1] - 1:
            probs = torch.softmax(torch.cat([pred, torch.zeros_like(pred[:, :1])], 1), 1)
            entry["train_rmse"] = rmse(y_host, probs.cpu().numpy())
            entry["train_accuracy"] = float(np.mean(
                probs.argmax(1).cpu().numpy() == y_host.argmax(1)))
        else:
            entry["train_rmse"] = rmse(y_host, pred.cpu().numpy())
        history.append(dict(entry, ok=ok, seconds=seconds))
        if verbose:
            print(history[-1])
        if step < grow_steps:
            layer = growing.grow_cart(layer)
    return layer, history


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("growth", nargs="?", default="cart", choices=("cart", "dmrg"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rng = np.random.default_rng(0)
    if args.growth == "cart":
        x = rng.standard_normal((512, 6, 5)).astype(np.float32)
        x[:, -1] = 0.0
        x[:, -1, -1] = 1.0  # the bias patch
        y = rng.standard_normal((512, 2)).astype(np.float32)
        run_grow_cart(x, y, grow_steps=2, bond_dim=4, convolution_bond=2,
                      verbose=1, device=args.device)
    else:
        S, f = 1024, 4
        X2 = rng.standard_normal((S, 2, f)).astype(np.float32)
        X2[..., -1] = 1.0
        y = (X2[:, 0, 0] * X2[:, 1, 1]).reshape(S, 1).astype(np.float32)
        run_dmrg_growth(X2, y, bond_dim=4, rank=4, verbose=1, device=args.device)


if __name__ == "__main__":
    main()
