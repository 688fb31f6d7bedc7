"""Tests that need a CUDA card: every kernel of csrc/gram.cu and
csrc/wgram.cu against its plain version on the card, at small, ragged
shapes.

This file imports no JAX, so it also runs on a machine without it (the
suite's conftest.py imports JAX, hence --noconftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.cuda
def test_all_kernels_match_plain_on_cuda():
    """chip_smoke's kernel checks (K1-K3, K6, K10, then K7, K8, K9, K11) at
    small shapes, each against its plain version with its tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    device = torch.device("cuda")
    chip_smoke.check_kernels(device, S=40, D=700, rows4=333, D4=137)
    chip_smoke.check_weighted_kernels(device, small=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("C", [0, 1, 3])
def test_split_weighted_gram_matches_plain_on_cuda(C, splits, dtype):
    """The split weighted Gram of csrc/wgram.cu against its plain version,
    at ragged shapes (333 rows, D=137): K9 (C=0) and K11 with 1 and 3
    classes, in one split and in three. Held to 1e-5 of max|A| (f32 sums in
    another order over at most 333 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    gen = torch.Generator().manual_seed(40 + 4 * C + splits)
    dev = torch.device("cuda")
    rows, D = 333, 137
    kg.reset_launches()
    if C == 0:
        X = torch.randn(rows, D, generator=gen).to(dev, dtype)
        h = (torch.rand(rows, generator=gen) + 0.5).to(dev)
        A = kg.mirror_gram(kg.weighted_gram(X, h, splits=splits))
        A_p = kg.mirror_gram(kg.weighted_gram_plain(X, h))
        key = "weighted_gram"
    else:
        Dp = kg.plan_tiles(D)[3]
        Jt, _ = kg.retile_rows(torch.randn(rows, D, generator=gen).to(dev, dtype), Dp)
        hh = torch.randn(rows, C, C, generator=gen)
        H = ((hh + hh.transpose(1, 2)) / 2).contiguous().to(dev)
        A = kg.mirror_own_out(kg.own_out_gram(Jt, H, C, D, splits=splits))
        A_p = kg.mirror_own_out(kg.own_out_gram_plain(Jt, H, C, D))
        key = "own_out_gram"
    torch.cuda.synchronize()
    assert kg.LAUNCHES[key] == 1
    err = float((A - A_p).abs().max())
    assert err <= 1e-5 * float(A_p.abs().max()), err
