"""The plain reference against the port's plain CPU path at tiny widths:
the conv-TT and TT forwards, a swipe of ridge node updates with a full
Hessian (conv-TT, cross entropy) and with a diagonal one (TT, squared
error), and the served forward."""
import pytest
import torch

from portbench import data
from portbench.reference import tn

N, R, CB, P, PP, C = 3, 3, 2, 5, 17, 9


def conv_setup(seed=3, rows=384):
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    gen = data.generator(seed, "cpu")
    w0 = data.weights(gen, data.conv_tt_shapes(N, R, CB, P, PP, C), "cpu")
    X, y = data.images(gen, rows, 8, 4, 10, 1.5, "cpu")
    layer = TensorConvolutionTrainLayer(num_carriages=N, bond_dim=R, num_patches=P,
                                        patch_pixels=PP, output_shape=(C,),
                                        convolution_bond=CB, device="cpu", use_kernels=True)
    layer.params = {k: w0[k].reshape(v.shape) for k, v in layer.params.items()}
    return w0, X, y, layer


def tt_setup(seed=4, rows=512, f=6, r=3):
    from tensornetworksfork_tpu_torch.models.layers import TensorTrainLayer
    gen = data.generator(seed, "cpu")
    w0 = data.weights(gen, data.tt_shapes(3, r, f + 1), "cpu")
    X, y = data.regression(gen, rows, f, 3, "cpu")
    X = torch.cat([X, torch.ones((rows, 1))], 1)
    layer = TensorTrainLayer(3, r, f + 1, output_shape=1, constrict_bond=False, device="cpu",
                             use_kernels=True)
    layer.params = {k: w0[k].reshape(v.shape) for k, v in layer.params.items()}
    return w0, X, y, layer


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def test_conv_tt_forward():
    w0, X, _, layer = conv_setup()
    assert rel(layer(X), tn.Net(w0, N, True).forward(X)) < 1e-5


def test_tt_forward():
    w0, X, _, layer = tt_setup()
    assert rel(layer(X), tn.Net(w0, 3, False).forward(X)) < 1e-5


def sweep(layer, loss, X, y, chunk, swipes):
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    sw = Sweeper(layer.network, loss, SweepConfig(num_swipes=swipes, batch_size=chunk,
                                                  method="ridge_cholesky", eps=5.0,
                                                  eps_decay=0.25))
    out, ok = sw.run([layer.params], X, y)
    assert ok
    return out[0]


def test_full_hessian_updates():
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    w0, X, y, layer = conv_setup()
    got = sweep(layer, XEBregman(w=1.0), X, y, 128, 1)
    net = tn.Net(w0, N, True)
    tn.run(net, X, y, "xe", 1, 5.0, 0.25)
    for k in w0:
        assert rel(got[k].reshape(w0[k].shape), net.p[k]) < 1e-4, k


def test_diagonal_hessian_updates():
    from tensornetworksfork_tpu_torch.ops.bregman import SquareBregFunction
    w0, X, y, layer = tt_setup()
    got = sweep(layer, SquareBregFunction(), X, y, 128, 2)
    net = tn.Net(w0, 3, False)
    tn.run(net, X, y, "square", 2, 5.0, 0.25)
    for k in w0:
        assert rel(got[k].reshape(w0[k].shape), net.p[k]) < 1e-4, k


def test_served_forward():
    from tensornetworksfork_tpu_torch.utils.serving import export_forward, load_forward
    w0, X, _, layer = conv_setup(rows=96)
    f = load_forward(export_forward(layer, (P, PP), device="cpu"))
    assert rel(f(X), tn.Net(w0, N, True).forward(X)) < 1e-5


@pytest.mark.parametrize("kind,lo,hi", [("tf32", 1e-5, 1e-2), ("fp8", 1e-3, 0.1), ("int4", 1e-3, 1.0)])
def test_control_numerics_move_the_gram(kind, lo, hi):
    gen = torch.Generator().manual_seed(0)
    J = torch.randn((4096, 64), generator=gen, dtype=torch.float64)
    K = J * torch.rand((4096, 1), generator=gen, dtype=torch.float64)
    exact = J.T @ K
    A = torch.zeros((64, 64), dtype=torch.float64)
    tn.Numerics(kind).gram(J, K, A)
    assert lo < rel(tn.mirror(A), exact) < hi
    A = torch.zeros((64, 64), dtype=torch.float64)
    tn.Numerics().gram(J, K, A)
    assert rel(tn.mirror(A), exact) < 1e-14
