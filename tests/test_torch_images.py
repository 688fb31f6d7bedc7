"""The image data path of the port against the JAX package: patches, the
preprocessing, the synthetic stand-in, the loaders, the digits copy, the
new metrics and the Timer. Inputs come from numpy seeds; every comparison
is bit for bit (np.testing.assert_array_equal) unless stated."""
import os
import pickle
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.data import images as jimg  # noqa: E402
from tensornetworksfork_tpu.ops import patches as jpat  # noqa: E402
from tensornetworksfork_tpu.utils import metrics as jmet  # noqa: E402
from tensornetworksfork_tpu_torch.data import images as timg  # noqa: E402
from tensornetworksfork_tpu_torch.ops import patches as tpat  # noqa: E402
from tensornetworksfork_tpu_torch.utils import metrics as tmet  # noqa: E402


def same(t, j):
    np.testing.assert_array_equal(t.numpy() if isinstance(t, torch.Tensor)
                                  else np.asarray(t), np.asarray(j))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("kernel,stride", [(2, 2), (4, 4), (4, 2)])
@pytest.mark.parametrize("padding", [0, 1])
def test_patches_bit_equal(channels, kernel, stride, padding):
    rng = np.random.default_rng(kernel * 10 + channels + padding)
    x = rng.standard_normal((3, channels, 13, 11)).astype(np.float32)
    if channels == 1:
        x = x[:, 0]  # (B, H, W): the channel axis is added
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    same(tpat.extract_patches(xt, kernel, stride, padding),
         jpat.extract_patches(xj, kernel, stride, padding))
    same(tpat.image_to_conv_input(xt, kernel, stride, padding),
         jpat.image_to_conv_input(xj, kernel, stride, padding))
    p = rng.standard_normal((2, 5, 7)).astype(np.float32)
    same(tpat.add_bias_patch(torch.from_numpy(p)),
         jpat.add_bias_patch(jnp.asarray(p)))


@pytest.mark.parametrize("channels,mean,std", [
    (1, timg.MNIST_MEAN, timg.MNIST_STD),
    (3, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))])
def test_preprocess_images_bit_equal(channels, mean, std):
    rng = np.random.default_rng(channels)
    shape = (6, 28, 28) if channels == 1 else (6, 3, 32, 32)
    x = rng.integers(0, 256, shape).astype(np.uint8)
    y = rng.integers(0, 10, 6)
    k = 4 if channels == 1 else 8
    xt, yt = timg.preprocess_images(x, y, k, k, 10, mean, std)
    xj, yj = jimg.preprocess_images(x, y, k, k, 10, mean, std)
    same(xt, xj)
    same(yt, yj)


@pytest.mark.parametrize("channels,side,kernel", [(1, 28, 4), (3, 32, 8)])
def test_synthetic_image_classification_bit_equal(channels, side, kernel):
    xt, yt = timg.synthetic_image_classification(
        300, side=side, kernel_size=kernel, kernel_stride=kernel, seed=5,
        channels=channels)
    xj, yj = jimg.synthetic_image_classification(
        300, side=side, kernel_size=kernel, kernel_stride=kernel, seed=5,
        channels=channels)
    same(xt, xj)
    same(yt, yj)
    assert xt.dtype == torch.float32 and xt.device.type == "cpu"


def test_digits_file_equals_sklearn():
    """The committed copy holds sklearn's load_digits() exactly."""
    datasets = pytest.importorskip("sklearn.datasets")
    ds = datasets.load_digits()
    images, target = timg.load_digits_arrays()
    assert images.dtype == np.uint8 and images.shape == (1797, 8, 8)
    np.testing.assert_array_equal(images.astype(np.float64), ds.images)
    np.testing.assert_array_equal(target, ds.target)


def test_load_digits_images_bit_equal():
    """The digits gate's data: kernel 2/2, the split seed 42 of the
    protocol (the JAX side reads sklearn, the port the committed copy)."""
    pytest.importorskip("sklearn")
    t = timg.load_digits_images(2, 2, seed=42)
    j = jimg.load_digits_images(2, 2, seed=42)
    assert [tuple(a.shape) for a in t] == [(1438, 17, 5), (1438, 10),
                                           (359, 17, 5), (359, 10)]
    for a, b in zip(t, j):
        same(a, b)


def test_write_digits_roundtrip(tmp_path):
    pytest.importorskip("sklearn")
    path = str(tmp_path / "digits.npz")
    timg.write_digits(path)
    a = timg.load_digits_arrays(path)
    b = timg.load_digits_arrays()
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def _write_idx(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x00000800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def test_load_mnist_like_staged(tmp_path):
    """Staged idx files (one gzipped), then a mnist.npz: the same arrays as
    the JAX loader; an empty directory raises FileNotFoundError."""
    import gzip
    rng = np.random.default_rng(0)
    arrs = {"train-images-idx3-ubyte": rng.integers(0, 256, (20, 28, 28)),
            "train-labels-idx1-ubyte": rng.integers(0, 10, 20),
            "t10k-images-idx3-ubyte": rng.integers(0, 256, (8, 28, 28)),
            "t10k-labels-idx1-ubyte": rng.integers(0, 10, 8)}
    for name, a in arrs.items():
        _write_idx(str(tmp_path / name), a.astype(np.uint8))
    with open(tmp_path / "t10k-labels-idx1-ubyte", "rb") as f:
        raw = f.read()
    os.remove(tmp_path / "t10k-labels-idx1-ubyte")
    with gzip.open(tmp_path / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(raw)
    for a, b, want in zip(timg.load_mnist_like(str(tmp_path)),
                          jimg.load_mnist_like(str(tmp_path)), arrs.values()):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want)
    np.savez(tmp_path / "mnist.npz", x_train=np.zeros((2, 28, 28), np.uint8),
             y_train=np.ones(2, np.uint8), x_test=np.zeros((1, 28, 28), np.uint8),
             y_test=np.ones(1, np.uint8))
    for a, b in zip(timg.load_mnist_like(str(tmp_path)),
                    jimg.load_mnist_like(str(tmp_path))):
        np.testing.assert_array_equal(a, b)
    empty = tmp_path / "none"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        timg.load_mnist_like(str(empty))


@pytest.mark.parametrize("num_classes", [10, 100])
def test_load_cifar_staged(tmp_path, num_classes):
    """CIFAR's pickled python batches: the same arrays as the JAX loader."""
    rng = np.random.default_rng(num_classes)
    key = b"fine_labels" if num_classes == 100 else b"labels"

    def batch(path, n):
        d = {b"data": rng.integers(0, 256, (n, 3 * 32 * 32)).astype(np.uint8),
             key: list(rng.integers(0, num_classes, n))}
        with open(path, "wb") as f:
            pickle.dump(d, f)

    if num_classes == 100:
        base = tmp_path / "cifar-100-python"
        base.mkdir()
        batch(base / "train", 6)
        batch(base / "test", 4)
    else:
        base = tmp_path / "cifar-10-batches-py"
        base.mkdir()
        for i in range(1, 6):
            batch(base / f"data_batch_{i}", 3)
        batch(base / "test_batch", 4)
    for a, b in zip(timg.load_cifar(str(tmp_path), num_classes),
                    jimg.load_cifar(str(tmp_path), num_classes)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        timg.load_cifar(str(tmp_path / "none"), num_classes)


def test_datasets_registry_matches():
    assert timg.DATASETS == jimg.DATASETS


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 50)]
    p = rng.standard_normal((50, 4)).astype(np.float32)
    for name in ("accuracy", "balanced_accuracy", "error_rate"):
        assert getattr(tmet, name)(y, p) == getattr(jmet, name)(y, p), name
    assert tmet.error_rate(y, y) == 0.0


def test_timer_phases():
    from tensornetworksfork_tpu_torch.utils.timing import Timer
    t = Timer()
    for _ in range(2):
        with t.phase("a"):
            pass
    with pytest.raises(ValueError):
        with t.phase("b"):
            raise ValueError
    s = t.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert t.totals["a"] >= 0 and t.rate("a") > 0
    assert np.isnan(t.rate("missing"))
