"""Image datasets (port of tensornetworksfork_tpu/data/images.py): MNIST,
FashionMNIST and CIFAR from staged files, sklearn's 8x8 digits from a copy
committed beside this module, and a shape-faithful synthetic stand-in.

Nothing is downloaded. The loaders read the standard on-disk formats (idx
ubyte files, the keras-style .npz, CIFAR's pickled batches) where they are
staged and raise FileNotFoundError otherwise; the image trainer then falls
back to `synthetic_image_classification`. Preprocessing is the reference
protocol: normalise by the dataset's mean and std, unfold into kernel x
stride patches, append the bias patch, one-hot the labels. Images and
labels come back as float32 CPU tensors; the caller moves them to its
device.

The digits: `python -m tensornetworksfork_tpu_torch.data.images
--write-digits` (needs sklearn) stores sklearn's `load_digits()` images
(1,797 x 8 x 8, integers 0-16, as uint8) and targets in `digits.npz`, which
`load_digits_images` reads, so that a machine without sklearn runs the
digits gate on the same data.
"""
from __future__ import annotations

import argparse
import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.patches import image_to_conv_input

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081

# per dataset: classes, channels, per-channel normalisation (mean, std), the
# image drivers' default kernel and stride, and the side of its images (the
# JAX package's registry; ImageNet keeps the reference's 100-class subset)
DATASETS = {
    "mnist": dict(num_classes=10, channels=1,
                  normalize=((MNIST_MEAN,), (MNIST_STD,)),
                  default_kernel=4, default_stride=4, side=28),
    "fashionmnist": dict(num_classes=10, channels=1,
                         normalize=((MNIST_MEAN,), (MNIST_STD,)),
                         default_kernel=4, default_stride=4, side=28),
    "cifar10": dict(num_classes=10, channels=3,
                    normalize=((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
                    default_kernel=8, default_stride=8, side=32),
    "cifar100": dict(num_classes=100, channels=3,
                     normalize=((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
                     default_kernel=8, default_stride=8, side=32),
    "imagenet": dict(num_classes=100, channels=3,
                     normalize=((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
                     default_kernel=8, default_stride=8, side=64),
}

DIGITS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "digits.npz")

_IDX_NAMES = {
    "train_images": ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
    "train_labels": ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
    "test_images": ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
    "test_labels": ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
}


def _read_idx(path: str) -> np.ndarray:
    """An idx ubyte file (gzipped or not) as a uint8 array: the native
    parser (`native.read_idx`) first for an uncompressed file, as in the JAX
    package, else the Python reader."""
    if not path.endswith(".gz"):
        from .. import native
        out = native.read_idx(path)
        if out is not None:
            return out
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def _find(root: str, names) -> Optional[str]:
    for name in names:
        for cand in (name, name + ".gz"):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                return p
    return None


def load_mnist_like(root: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x_train, y_train, x_test, y_test) from idx files or mnist.npz."""
    npz = os.path.join(root, "mnist.npz")
    if os.path.exists(npz):
        with np.load(npz) as d:
            return d["x_train"], d["y_train"], d["x_test"], d["y_test"]
    paths = {k: _find(root, v) for k, v in _IDX_NAMES.items()}
    if all(paths.values()):
        return (_read_idx(paths["train_images"]),
                _read_idx(paths["train_labels"]),
                _read_idx(paths["test_images"]),
                _read_idx(paths["test_labels"]))
    raise FileNotFoundError(
        f"no MNIST-format data under {root!r} (idx ubyte or mnist.npz); "
        "nothing is downloaded — stage the files there or use "
        "synthetic_image_classification()")


def preprocess_images(x: np.ndarray, y: np.ndarray, kernel_size: int = 4,
                      kernel_stride: int = 4, num_classes: int = 10,
                      mean=MNIST_MEAN, std=MNIST_STD):
    """Normalise, unfold, bias patch, one-hot. x is (N, H, W) or
    (N, C, H, W) in 0..255; mean and std are scalars or per-channel."""
    x = np.asarray(x, np.float32) / 255.0
    if x.ndim == 3:
        x = x[:, None]
    m = np.asarray(mean, np.float32).reshape(1, -1, 1, 1)
    s = np.asarray(std, np.float32).reshape(1, -1, 1, 1)
    x = (x - m) / s
    xp = image_to_conv_input(torch.from_numpy(x), kernel_size, kernel_stride)
    onehot = np.eye(num_classes, dtype=np.float32)[np.asarray(y).astype(int)]
    return xp, torch.from_numpy(onehot)


def load_cifar(root: str, num_classes: int = 10
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x_train, y_train, x_test, y_test), x (N, 3, 32, 32) uint8, from the
    pickled python batches (cifar-10-batches-py/, cifar-100-python/) or a
    cifar{10,100}.npz."""
    import pickle

    npz = os.path.join(root, f"cifar{num_classes}.npz")
    if os.path.exists(npz):
        with np.load(npz) as d:
            return d["x_train"], d["y_train"], d["x_test"], d["y_test"]

    def read_batch(path, label_key):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data = d[b"data"] if b"data" in d else d["data"]
        labels = d.get(label_key)
        if labels is None:
            labels = d[label_key.decode()]
        return (np.asarray(data, np.uint8).reshape(-1, 3, 32, 32),
                np.asarray(labels, np.int64))

    if num_classes == 100:
        base = os.path.join(root, "cifar-100-python")
        if os.path.isdir(base):
            xtr, ytr = read_batch(os.path.join(base, "train"), b"fine_labels")
            xte, yte = read_batch(os.path.join(base, "test"), b"fine_labels")
            return xtr, ytr, xte, yte
    else:
        base = os.path.join(root, "cifar-10-batches-py")
        if os.path.isdir(base):
            parts = [read_batch(os.path.join(base, f"data_batch_{i}"),
                                b"labels") for i in range(1, 6)]
            xtr = np.concatenate([p[0] for p in parts])
            ytr = np.concatenate([p[1] for p in parts])
            xte, yte = read_batch(os.path.join(base, "test_batch"), b"labels")
            return xtr, ytr, xte, yte
    raise FileNotFoundError(
        f"no CIFAR-{num_classes} data under {root!r} (pickled python batches "
        "or .npz); nothing is downloaded — stage the files there or use the "
        "synthetic stand-in")


def write_digits(path: str = DIGITS_FILE) -> None:
    """Store sklearn's bundled digits (images as uint8, targets) at `path`."""
    from sklearn.datasets import load_digits

    ds = load_digits()
    images = np.asarray(ds.images)
    if not (np.array_equal(images, np.round(images)) and images.min() >= 0
            and images.max() <= 16):
        raise ValueError("load_digits() images are not integers in 0..16")
    np.savez_compressed(path, images=images.astype(np.uint8),
                        target=np.asarray(ds.target, np.uint8))


def load_digits_arrays(path: str = DIGITS_FILE) -> Tuple[np.ndarray, np.ndarray]:
    """(images (1797, 8, 8) uint8, targets (1797,) int64) from `path`."""
    with np.load(path) as d:
        return d["images"], d["target"].astype(np.int64)


def load_digits_images(kernel_size: int = 2, kernel_stride: int = 2,
                       seed: int = 42, test_fraction: float = 0.2):
    """sklearn's 8x8 digits (1,797 samples, 10 classes), read from the
    committed copy: (x_train, y_train, x_test, y_test) through the
    reference patch protocol, the test rows a fixed permutation's first
    `test_fraction` under `seed`."""
    images, labels = load_digits_arrays()
    imgs = images.astype(np.float32)  # values 0..16
    imgs = (imgs / 16.0 - 0.5) / 0.5
    n = len(labels)
    idx = np.random.RandomState(seed).permutation(n)
    n_test = int(n * test_fraction)
    te, tr = idx[:n_test], idx[n_test:]
    xp = image_to_conv_input(torch.from_numpy(imgs[:, None]), kernel_size,
                             kernel_stride)
    onehot = torch.from_numpy(np.eye(10, dtype=np.float32)[labels])
    te_t, tr_t = torch.from_numpy(te), torch.from_numpy(tr)
    return xp[tr_t], onehot[tr_t], xp[te_t], onehot[te_t]


def synthetic_images(S: int = 8192, side: int = 28, num_classes: int = 10,
                     seed: int = 0, channels: int = 1):
    """The stand-in's images (S, channels, side, side) f32 and integer
    labels: each class mean is a random image, each sample its class's mean
    plus noise, so a model can beat chance."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, S)
    protos = rng.standard_normal(
        (num_classes, channels, side, side)).astype(np.float32)
    x = protos[labels] + 1.5 * rng.standard_normal(
        (S, channels, side, side)).astype(np.float32)
    return x, labels


def synthetic_image_classification(S: int = 8192, side: int = 28,
                                   num_classes: int = 10, kernel_size: int = 4,
                                   kernel_stride: int = 4, seed: int = 0,
                                   channels: int = 1):
    """Shape-faithful synthetic stand-in with a learnable signal
    (`synthetic_images`), unfolded into patches with the bias patch, and
    one-hot labels. channels=3 gives the CIFAR/ImageNet shape."""
    x, labels = synthetic_images(S, side, num_classes, seed, channels)
    xp = image_to_conv_input(torch.from_numpy(x), kernel_size, kernel_stride)
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    return xp, torch.from_numpy(onehot)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write-digits", action="store_true",
                    help=f"store sklearn's digits in {DIGITS_FILE} (needs sklearn)")
    args = ap.parse_args(argv)
    if args.write_digits:
        write_digits()
        print(f"wrote {DIGITS_FILE}")


if __name__ == "__main__":
    main()
