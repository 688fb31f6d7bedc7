"""The CIFAR-10 stand-in of the `cifar_minres` cell, made on its device from
the seed, in the layout `train_image.load_data` gives the model.

Each class mean is a random 3 x 32 x 32 image (standard normal pixels) and
each sample its class's mean plus normal noise of `noise` times that
(`data/images.py` `synthetic_images`, three channels); the sum is scaled to
a pixel standard deviation of 0.5, about that of CIFAR-10 under the
reference's normalisation (mean 0.5, std 0.5 a channel). At a noise of 24
the classifier that knows the class means (the nearest mean, Bayes-optimal
here) is right on about 77 % of the samples, so no model separates the
classes: the cross entropy stays away from 0 and its Hessian from 0, as on
CIFAR-10. The images are unfolded into kernel x kernel patches at stride
kernel, the channel index slowest (`ops/patches.py`), and a zero patch row
and a zero pixel column are appended with a 1 in the corner: (n, 17, 193)
for 32 x 32 x 3 at kernel 8. Labels come one-hot over the classes.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def images(gen: torch.Generator, n: int, side: int, kernel: int, channels: int, classes: int,
           noise: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(patches (n, L+1, channels*kernel*kernel+1) f32, one-hot labels (n,
    classes) f32), drawn through `gen` in a fixed order."""
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    protos = torch.randn((classes, channels, side, side), generator=gen, device=device)
    x = torch.randn((n, channels, side, side), generator=gen, device=device)
    x.mul_(noise).add_(protos[labels]).mul_(0.5 / math.sqrt(1.0 + noise * noise))
    p = F.unfold(x, kernel, stride=kernel).transpose(1, 2)
    del x
    out = torch.zeros((n, p.shape[1] + 1, p.shape[2] + 1), device=device)
    out[:, :-1, :-1] = p
    out[:, -1, -1] = 1.0
    return out, F.one_hot(labels, classes).float()
