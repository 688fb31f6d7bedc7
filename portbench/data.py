"""Inputs and weights of a cell, made on its device from the seed.

Every draw goes through one `torch.Generator` on the device, in a fixed
order and in a few large calls, so a seed gives the same inputs and
weights on every run.

- `images`: the MNIST stand-in of the port's `data/images.py`
  (`synthetic_images`): each class mean a random image, each sample its
  class's mean plus noise of 1.5, unfolded into patches with the bias
  patch as the port's `ops/patches.py` does.
- `regression`: the port's `data/synthetic.py` `make_regression`: X
  uniform in [-1, 1]^d, y a root-product polynomial of X
  (y = prod_k (w_k . x - root_k), w_k softmax rows), standardized.
- `weights`: one normal draw split into the network's cores, each scaled
  to unit Frobenius norm, as the port's topology initialises them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def images(gen: torch.Generator, n: int, side: int, kernel: int, classes: int,
           noise: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(patches (n, L+1, k*k+1) f32, one-hot labels (n, classes) f32)."""
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    protos = torch.randn((classes, 1, side, side), generator=gen, device=device)
    x = torch.randn((n, 1, side, side), generator=gen, device=device)
    x.mul_(noise).add_(protos[labels])
    p = F.unfold(x, kernel, stride=kernel).transpose(1, 2)
    del x
    out = torch.zeros((n, p.shape[1] + 1, p.shape[2] + 1), device=device)
    out[:, :-1, :-1] = p
    out[:, -1, -1] = 1.0
    return out, F.one_hot(labels, classes).float()


def regression(gen: torch.Generator, n: int, d: int, degree: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X (n, d) f32, y (n, 1) f32 standardized)."""
    X = torch.rand((n, d), generator=gen, device=device, dtype=torch.float64) * 2 - 1
    C = torch.randn((degree, d), generator=gen, device=device, dtype=torch.float64)
    C = torch.softmax(C, dim=1)
    roots = torch.rand((degree,), generator=gen, device=device, dtype=torch.float64) * 2 - 1
    X = X.float()
    y = torch.prod(X.double() @ C.T - roots[None, :], dim=1)
    y = (y - y.mean()) / (y.std(unbiased=False) + 1e-8)
    return X, y.float()[:, None]


def weights(gen: torch.Generator, shapes: Dict[str, Tuple[int, ...]], device
            ) -> Dict[str, torch.Tensor]:
    """Cores of the given canonical shapes, unit Frobenius norm each."""
    sizes = [int(torch.tensor(s).prod()) for s in shapes.values()]
    flat = torch.randn((sum(sizes),), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        w = flat[at:at + n]
        out[name] = (w / torch.linalg.vector_norm(w)).reshape(shape)
        at += n
    return out


def conv_tt_shapes(N: int, r: int, CB: int, P: int, pp: int, C: int
                   ) -> Dict[str, Tuple[int, ...]]:
    """Canonical core shapes of a conv-TT: A_i (r_i, c_i, patches, r_i+1)
    with the C logits on A_1, C_i (cb_i, pixels, cb_i+1)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for i in range(1, N + 1):
        shapes[f"A{i}"] = (1 if i == 1 else r, C if i == 1 else 1, P, 1 if i == N else r)
    for i in range(1, N + 1):
        shapes[f"C{i}"] = (1 if i == 1 else CB, pp, 1 if i == N else CB)
    return shapes


def tt_shapes(N: int, r: int, f: int) -> Dict[str, Tuple[int, ...]]:
    """Canonical core shapes of a TT with one output and unconstricted
    bonds: A_i (r_i, 1, features, r_i+1)."""
    return {f"A{i}": (1 if i == 1 else r, 1, f, 1 if i == N else r)
            for i in range(1, N + 1)}
