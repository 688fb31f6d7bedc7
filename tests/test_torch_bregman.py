"""Every Bregman loss of the port held against the JAX package's: the same
(loss, grad, Hessian) triple on the same predictions and targets, made from
a numpy seed. Tolerance: rtol 1e-5 and atol 1e-6 x max|value| in float32
(both sides sum a handful of terms in another order; the autograd losses
take their derivatives through torch.func here and jax there). The
Hessian's form (full or diagonal) must agree, since the engine reads it
from ndim.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.ops import bregman as jb  # noqa: E402
from tensornetworksfork_tpu_torch.ops import bregman as tb  # noqa: E402

B, C = 11, 4
RTOL = 1e-5


def _phi_j(x):
    return jnp.sum(x ** 2) + jnp.sum(jnp.exp(0.3 * x))


def _phi_t(x):
    return torch.sum(x ** 2) + torch.sum(torch.exp(0.3 * x))


def _huber_j(x, y):
    d = x - y
    return jnp.sum(jnp.sqrt(1.0 + d * d))


def _huber_t(x, y):
    d = x - y
    return torch.sum(torch.sqrt(1.0 + d * d))


def _data(kind, seed):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((B, C)).astype(np.float32)
    if kind == "onehot":  # C-1 logits against C classes
        return pred[:, :C - 1], np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    if kind == "prob":
        return pred, rng.uniform(0, 1, (B, C)).astype(np.float32)
    if kind == "complex":
        z = pred + 1j * rng.standard_normal((B, C)).astype(np.float32)
        t = rng.standard_normal((B, C)) + 1j * rng.standard_normal((B, C))
        return z.astype(np.complex64), t.astype(np.complex64)
    if kind == "gauss":  # (mean, std logit) head against a scalar target
        return pred[:, :2], rng.standard_normal(B).astype(np.float32)
    return pred, rng.standard_normal((B, C)).astype(np.float32)


# name -> (JAX loss, port loss, data kind)
LOSSES = {
    "square": (jb.SquareBregFunction(), tb.SquareBregFunction(), "real"),
    "square_complex": (jb.SquareComplexBregFunction(),
                       tb.SquareComplexBregFunction(), "complex"),
    "softmax_squared": (jb.SoftmaxSquaredLoss(w=0.7), tb.SoftmaxSquaredLoss(w=0.7),
                        "prob"),
    "xe": (jb.XEBregman(w=1.3), tb.XEBregman(w=1.3), "onehot"),
    "binary_kl": (jb.BinaryKLDivBregman(w=0.8), tb.BinaryKLDivBregman(w=0.8),
                  "prob"),
    "autograd_default": (jb.AutogradLoss(), tb.AutogradLoss(), "real"),
    "autograd_custom": (jb.AutogradLoss(_huber_j), tb.AutogradLoss(_huber_t), "real"),
    "autograd_bregman": (jb.AutogradBregman(_phi_j), tb.AutogradBregman(_phi_t),
                         "real"),
    "uncertainty": (jb.UncertaintyAutogradLoss(), tb.UncertaintyAutogradLoss(),
                    "gauss"),
}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_triple_matches_jax(name):
    jl, tl, kind = LOSSES[name]
    pred, y = _data(kind, seed=sorted(LOSSES).index(name))
    jloss, jg, jH = jl(jnp.asarray(pred), jnp.asarray(y))
    tloss, tg, tH = tl(torch.tensor(pred), torch.tensor(y))
    _close(tloss.numpy(), jloss, f"{name} loss")
    _close(tg.numpy(), jg, f"{name} grad")
    _close(tH.numpy(), jH, f"{name} hess")
    assert (tH.ndim == tg.ndim) == (jH.ndim == jg.ndim)  # diagonal vs full
    _close(tl(torch.tensor(pred), torch.tensor(y), only_loss=True).numpy(), jloss,
           f"{name} only_loss")


def test_softmax_jac_matches_jax():
    s = torch.softmax(torch.tensor(_data("real", 1)[0]), dim=-1)
    _close(tb._softmax_jac(s).numpy(), jb._softmax_jac(jnp.asarray(s.numpy())),
           "softmax jac")


def test_full_hessians_are_symmetric():
    """The Gram kernels mirror the upper triangle, so every full Hessian the
    port's losses give must be symmetric per sample."""
    for name, (_, tl, kind) in LOSSES.items():
        pred, y = _data(kind, 3)
        _, g, H = tl(torch.tensor(pred), torch.tensor(y))
        if H.ndim != g.ndim:
            torch.testing.assert_close(H, H.transpose(-1, -2), msg=name)
