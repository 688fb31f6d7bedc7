"""The port's feature maps held against the JAX package's on the same
numpy inputs: within rtol 1e-6 (and 1e-6 x max|.| for entries near zero,
where cos, sin and exp of f32 arguments may round apart); Fourier features
are complex64 in both."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tensornetworksfork_tpu.ops import feature_maps as jf  # noqa: E402
from tensornetworksfork_tpu_torch.ops import feature_maps as tf  # noqa: E402

RTOL = 1e-6

CASES = {
    "fourier_dense": ("fourier_basis", (3,), {}),
    "fourier_sparse": ("fourier_basis", (3,), dict(dense=False)),
    "fourier_explicit": ("fourier_basis", (0,), dict(frequencies=[0.5, 1.0, 3.0])),
    "rbf_default": ("gaussian_rbf_basis", (), {}),
    "rbf_grid": ("gaussian_rbf_basis", (), dict(num_centers=5, input_range=(-2.0, 2.0))),
    "rbf_centers": ("gaussian_rbf_basis", (), dict(centers=[-0.5, 0.0, 0.7], width=0.3)),
    "legendre": ("legendre_basis", (4,), {}),
    "legendre_linear": ("legendre_basis", (1,), {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_feature_map_matches_jax(name):
    fn, args, kw = CASES[name]
    X = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    want = np.asarray(getattr(jf, fn)(X, *args, **kw))
    got_np = getattr(tf, fn)(X, *args, device="cpu", **kw)
    got_t = getattr(tf, fn)(torch.tensor(X), *args, **kw)  # stays on its device
    for got in (got_np, got_t):
        assert got.device.type == "cpu"
        assert got.numpy().dtype == want.dtype
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_per_position_inputs_matches_jax():
    F = np.random.default_rng(1).standard_normal((6, 4, 3)).astype(np.float32)
    want = jf.per_position_inputs(F)
    got = tf.per_position_inputs(torch.tensor(F))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_feature_maps_default_to_the_card():
    """A numpy input goes to the card unless the CPU is asked for; without
    a card that raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.legendre_basis(np.zeros((2, 2), np.float32), 2)
