"""The frozen counts against the port's own FLOP count, and the least times
against the kernel table's bound column (PERF.md section 6)."""
import pytest
import torch

from portbench.counts import flops, networks
from portbench.counts.flops import gram_call, least_s, peaks


def port_epoch(layer, loss, B, S, y_cols, swipes):
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.utils.flops import epoch_flops
    sw = Sweeper(layer.network, loss, SweepConfig(num_swipes=swipes, batch_size=B))
    return epoch_flops(sw, torch.zeros((S, 1)), torch.zeros((S, y_cols)))["total"]


@pytest.mark.parametrize("N,r,CB,P,pp,C,B,S,swipes", [
    (3, 3, 2, 5, 17, 9, 64, 256, 1), (4, 4, 2, 7, 5, 3, 32, 96, 2), (2, 2, 3, 4, 6, 1, 16, 16, 1)])
def test_conv_tt_matches_epoch_flops(N, r, CB, P, pp, C, B, S, swipes):
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    layer = TensorConvolutionTrainLayer(num_carriages=N, bond_dim=r, num_patches=P,
                                        patch_pixels=pp, output_shape=(C,),
                                        convolution_bond=CB, device="cpu")
    want = port_epoch(layer, XEBregman(), B, S, C + 1, swipes)
    net = networks.conv_tt(N, r, CB, P, pp, C)
    got = flops.run_flops(net, S, B, swipes, True, gram="full", junction="mean")["total"]
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("N,r,f,B,S,swipes", [(3, 3, 7, 64, 256, 2), (4, 5, 4, 32, 64, 1)])
def test_tt_matches_epoch_flops(N, r, f, B, S, swipes):
    from tensornetworksfork_tpu_torch.models.layers import TensorTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import SquareBregFunction
    layer = TensorTrainLayer(N, r, f, output_shape=1, constrict_bond=False, device="cpu")
    want = port_epoch(layer, SquareBregFunction(), B, S, 1, swipes)
    got = flops.run_flops(networks.tt(N, r, f), S, B, swipes, False,
                          gram="full", junction="mean")["total"]
    assert got == pytest.approx(want, rel=1e-12)


def test_upper_gram_counts_the_triangle_once():
    net = networks.conv_tt(3, 3, 2, 5, 17, 9)
    full = flops.run_flops(net, 256, 64, 1, True, gram="full")
    upper = flops.run_flops(net, 256, 64, 1, True, gram="upper")
    saved = 0
    for p in flops.visits(net, 1):
        for ni in p:
            D, CJ = net.D(ni), flops._cj(net, ni)
            saved += 4 * (2 * 64 * CJ * D * D - 64 * CJ * D * (D + 1))
    assert full["total"] - upper["total"] == saved


def test_exact_junction_skips_the_whole_column():
    net = networks.conv_tt(4, 3, 2, 5, 17, 9)
    passes = flops.visits(net, 2)
    names = [[net.names[ni] for ni in p] for p in passes]
    assert names[0] == ["A1", "A2", "A3", "A4", "C1", "C2", "C3", "C4"]
    assert names[1] == ["C3", "C2", "C1", "A3", "A2", "A1"]
    assert names[2] == ["A2", "A3", "A4", "C2", "C3", "C4"]


def test_least_times_match_the_kernel_table():
    pk = peaks()
    # K3: 18,432 rows x the padded width 16,640, int8: the table's 2.578 ms
    ops, nb = gram_call(18432, 1, 16640, False, 2)
    k3 = least_s(ops - 2 * 18432 * 16640, nb, pk["gram_peak"]["fastest"],
                 pk["hbm_bytes_per_s"])
    assert k3 * 1e3 == pytest.approx(2.578, rel=1e-3)
    # K6 f32: 18,432 rows x D 16,200, three TF32 products a multiply-add: 29.319 ms
    ops, nb = gram_call(18432, 1, 16200, False, 4)
    k6 = least_s(ops - 2 * 18432 * 16200, nb, pk["gram_peak"]["reference"],
                 pk["hbm_bytes_per_s"])
    assert k6 * 1e3 == pytest.approx(29.319, rel=1e-3)
