"""Tests that need a CUDA card: every kernel of csrc/gram.cu, csrc/qgram.cu
and csrc/wgram.cu against its plain version on the card, at small, ragged
shapes (K6 in f32 also against float64; K2, K3/K4 and K8 bit for bit, K1's
Jt too, and its Kt in f32); the Krylov solvers and the float64 solve tier
on CUDA tensors against float64; serving artifacts on the card against the
eager forward, and the native-stream batch regressor against the CPU.

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
    """chip_smoke's kernel checks (K1-K3, K6, K10, then K7, K8, K9, K11, K2
    and K3) at small shapes, each against its plain version with its
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    device = torch.device("cuda")
    chip_smoke.check_kernels(device, S=40, D=700, rows4=333, D4=137)
    chip_smoke.check_weighted_kernels(device, small=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,D,shift", [(1, 701, 0), (3, 701, 0), (9, 701, 0), (16, 701, 0),
                                       (1, 1000, 0), (3, 1000, 0), (9, 1000, 0),
                                       (10, 1000, 0), (11, 1000, 0), (16, 1000, 0),
                                       (9, 1000, 1), (9, 16200, 0)])
def test_retile_hmix_matches_plain_on_cuda(C, D, shift, dtype):
    """K1 with the fused rhs against its plain version (chip_smoke's
    check_retile_hmix): Jt bit-equal, Kt bit-equal in f32 and within 1 bf16
    ulp in bf16, b per column within 4 sqrt(S*C) 2^-24 of sum |g||J|, one
    launch counted. D = 701 and J one value off a 16-byte boundary take the
    one-value path, D = 1,000 the packs with zero packs past D (16-byte
    packs; 8-byte ones for bf16 beyond 10 classes);
    9,000 samples make runs of several staged chunks and ragged groups of
    the samples a thread holds; the last case is the flagship's S = 2,048,
    D = 16,200."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    S = 2048 if D == 16200 else chip_smoke.HMIX_SAMPLES
    chip_smoke.check_retile_hmix(torch.device("cuda"), S, C, D, dtype, shift=shift)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("D", [137, 140])
def test_split_gram_pair_matches_plain_on_cuda(D, splits, dtype):
    """K10 (gram_pair without a carry) on the split Gram of csrc/wgram.cu
    against its plain version, Y unrelated to X, in one split and in three;
    D=137 loads element by element, D=140 (a row of 140 values) by 16-byte
    (f32) and 8-byte (bf16) chunks. Held to 1e-5 of max|A| (f32 sums in
    another order over 333 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    gen = torch.Generator().manual_seed(60 + D + splits)
    dev = torch.device("cuda")
    X = torch.randn(333, D, generator=gen).to(dev, dtype)
    Y = torch.randn(333, D, generator=gen).to(dev, dtype)
    kg.reset_launches()
    A = kg.mirror_gram(kg.gram_pair(X, Y, splits=splits))
    A_p = kg.mirror_gram(kg.gram_pair_plain(X, Y))
    torch.cuda.synchronize()
    assert kg.LAUNCHES["gram_pair"] == 1 and kg.LAUNCHES["gram_pair_tiled"] == 0
    err = float((A - A_p).abs().max())
    assert err <= 1e-5 * float(A_p.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [96, 12288])
def test_weighted_gram_tiled_carry_on_cuda(rows, dtype):
    """K7 with the node's D < Dp (300 of 512), two chunks chained into one
    carry, against its plain version: the carry's padding stays zero and
    the mirrored [:D, :D] block agrees to chip_smoke's gram_tol of the
    2 x rows summed (1e-5 of max|A| at 96 rows, 4 sqrt(24,576) 2^-24 =
    3.7e-5 at 12,288). 96 rows take one split
    (the carry added in the kernel's epilogue), 12,288 rows three (added by
    the reduction, carry first)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    gen = torch.Generator().manual_seed(70)
    dev = torch.device("cuda")
    D, Dp = 300, 512
    assert kg.wgram_plan(rows, D, 1, True, kg.sm_count(dev))[1] == (1 if rows < 4096 else 3)
    acc = torch.zeros((Dp, Dp), device=dev)
    acc_p = torch.zeros_like(acc)
    kg.reset_launches()
    for _ in range(2):
        Xt, _ = kg.retile_rows(torch.randn(rows, D, generator=gen).to(dev, dtype), Dp)
        h = (torch.rand(rows, generator=gen) + 0.5).to(dev)
        kg.weighted_gram_tiled(Xt, h, acc, D)
        kg.weighted_gram_tiled_plain(Xt, h, acc_p)
    torch.cuda.synchronize()
    assert kg.LAUNCHES["weighted_gram_tiled"] == 2
    assert not acc[D:].any() and not acc[:, D:].any()
    A, A_p = kg.mirror_gram(acc[:D, :D]), kg.mirror_gram(acc_p[:D, :D])
    err = float((A - A_p).abs().max())
    tol = max(1e-5, 4 * (2 * rows) ** 0.5 * 2.0 ** -24)
    assert err <= tol * float(A_p.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D,W", [(333, 137, 137), (1000, 700, 1024), (77, 1100, 1536)])
def test_gram_pair_carry_matches_plain_on_cuda(rows, D, W, dtype):
    """K6 (gram_pair with a carry) over the node's D of (rows, W) operands
    whose columns past D are zero, two chunks chained into a nonzero carry,
    against its plain version: f32 on the 3xTF32 kernel, bf16 on the split
    Gram. Rows that are not a multiple of a stage; W = 137 loads element by
    element. The upper triangle over D agrees to chip_smoke's gram_tol of
    the 2 x rows summed (at least 1e-5 of max|A|); every entry outside the
    upper tiles over D keeps the carry bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    gen = torch.Generator().manual_seed(80 + D)
    dev = torch.device("cuda")
    carry = torch.randn(W, W, generator=gen).to(dev)
    acc, acc_p = carry.clone(), carry.clone()
    kg.reset_launches()
    for _ in range(2):
        X, Y = (torch.nn.functional.pad(torch.randn(rows, D, generator=gen),
                                        (0, W - D)).to(dev, dtype) for _ in range(2))
        assert kg.gram_pair(X, Y, acc=acc, D=D) is acc
        kg.gram_pair_plain(X, Y, acc=acc_p)
    torch.cuda.synchronize()
    assert kg.LAUNCHES["gram_pair_tiled"] == 2 and kg.LAUNCHES["gram_pair"] == 0
    i = torch.arange(W, device=dev)
    tile = i // kg.WTILE
    done = (tile[:, None] <= tile[None, :]) & (i[:, None] < D) & (i[None, :] < D)
    assert torch.equal(acc[~done], carry[~done])
    err = float((acc - acc_p)[done].abs().max())
    tol = max(1e-5, 4 * (2 * rows) ** 0.5 * 2.0 ** -24)
    assert err <= tol * float(acc_p[:D, :D].abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("D", [100, 128, 129, 256, 700, 1100, 16200])
@pytest.mark.parametrize("rows", [1, 63, 64, 65, 1000, 4133, 2048 * 9])
def test_gram_pair_cluster_bit_equal_to_split_on_cuda(rows, D):
    """K6 in bf16 on the clustered Gram (gram_pair's route for W a multiple
    of 128) against the split Gram in one split on the same inputs
    (_launch_wgram_split with has_acc), two chunks chained into a nonzero
    carry: torch.equal everywhere, the carry kept bit for bit outside the
    upper tiles over D (the lower tile of each diagonal cluster among them),
    and each call counted under gram_pair_tiled_cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(rows * 7 + D)
    W = -(-D // kg.WTILE) * kg.WTILE
    carry = torch.randn((W, W), generator=gen, device=dev)
    acc, acc_s = carry.clone(), carry.clone()
    kg.reset_launches()
    for _ in range(2):
        X, Y = (torch.nn.functional.pad(torch.randn((rows, D), generator=gen, device=dev),
                                        (0, W - D)).to(torch.bfloat16) for _ in range(2))
        assert kg.k6_kernel(X.dtype, W, X.data_ptr(), Y.data_ptr()) == "cluster"
        assert kg.gram_pair(X, Y, acc=acc, D=D) is acc
        kg._launch_wgram_split(X, None, 0, None, acc_s, D, True, 1, "gram_pair", Y=Y,
                               has_acc=True)
    torch.cuda.synchronize()
    assert kg.LAUNCHES["gram_pair_tiled_cluster"] == 2 and kg.LAUNCHES["gram_pair_tiled"] == 2
    i = torch.arange(W, device=dev)
    tile = i // kg.WTILE
    done = (tile[:, None] <= tile[None, :]) & (i[:, None] < D) & (i[None, :] < D)
    assert torch.equal(acc[~done], carry[~done])
    assert not torch.equal(acc[done], carry[done])
    assert torch.equal(acc, acc_s)


@pytest.mark.cuda
@pytest.mark.parametrize("W,offset", [(137, 0), (1028, 0), (1024, 4)])
def test_gram_pair_bf16_off_tma_terms_takes_split_on_cuda(W, offset):
    """bf16 operands TMA cannot address (a row stride not a multiple of 8
    values, or a base off 16 bytes) take the split Gram: the result equals
    _launch_wgram_split's and gram_pair_tiled_cluster stays 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(W + offset)
    rows, D = 333, W - 7
    X, Y = (torch.randn((rows * W + offset,), generator=gen, device=dev)
            .to(torch.bfloat16)[offset:].view(rows, W) for _ in range(2))
    carry = torch.randn((W, W), generator=gen, device=dev)
    acc, acc_s = carry.clone(), carry.clone()
    kg.reset_launches()
    kg.gram_pair(X, Y, acc=acc, D=D)
    kg._launch_wgram_split(X, None, 0, None, acc_s, D, True, 1, "gram_pair", Y=Y,
                           has_acc=True)
    torch.cuda.synchronize()
    assert kg.LAUNCHES["gram_pair_tiled"] == 1 and kg.LAUNCHES["gram_pair_tiled_cluster"] == 0
    assert torch.equal(acc, acc_s)


@pytest.mark.cuda
def test_fast_tier_sweep_takes_cluster_gram_on_cuda(monkeypatch):
    """A fast-tier (bf16 Gram, bf16 aux) conv-TT swipe at test size on the
    packed route: every K6 call takes the clustered Gram."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    monkeypatch.setenv("TNF_GRAM_DTYPE", "bf16")
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    rng = np.random.default_rng(3)
    S, P, pp, C = 192, 6, 5, 3
    X = torch.tensor(rng.standard_normal((S, P, pp)).astype(np.float32), device="cuda")
    y = torch.tensor(np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)],
                     device="cuda")
    layer = TensorConvolutionTrainLayer(4, 6, P, pp, output_shape=(C,), convolution_bond=2,
                                        seed=0, device="cuda", use_kernels=True)
    cfg = SweepConfig(num_swipes=1, batch_size=64, method="ridge_cholesky", eps=5.0,
                      eps_decay=0.25)
    kg.reset_launches()
    _, ok = Sweeper(layer.network, XEBregman(1.0), cfg).run([layer.params], X, y)
    torch.cuda.synchronize()
    assert ok
    assert kg.LAUNCHES["gram_pair_tiled"] > 0
    assert kg.LAUNCHES["gram_pair_tiled_cluster"] == kg.LAUNCHES["gram_pair_tiled"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,D,W", [(333, 137, 137), (1000, 700, 1024), (4133, 1100, 1536)])
def test_gram_pair_carry_f32_holds_to_float64_on_cuda(rows, D, W):
    """K6 in f32 (3xTF32) from a zero carry against the float64 Gram of its
    full-mantissa operands, entry by entry over each entry's scale
    (chip_smoke's PAIR_BOUND); a kernel that rounded its operands to TF32
    would be off by hundreds of 2^-24."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    gen = torch.Generator().manual_seed(90 + D)
    dev = torch.device("cuda")
    X, Y = (torch.nn.functional.pad(torch.randn(rows, D, generator=gen) * 0.05,
                                    (0, W - D)).to(dev) for _ in range(2))
    acc = kg.gram_pair(X, Y, acc=torch.zeros((W, W), device=dev), D=D)
    A64, scale = chip_smoke.pair_float64(X[:, :D], Y[:, :D])
    ratio = chip_smoke.pair_errors(acc[:D, :D], A64, scale)[1]
    assert ratio <= chip_smoke.PAIR_BOUND, ratio / 2.0 ** -24


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D,Dp,shift", [(37, 137, 512, 0), (64, 300, 512, 0),
                                             (64, 256, 512, 1), (512, 8256, 8704, 0)])
def test_retile_rows_bit_equal_on_cuda(rows, D, Dp, shift, dtype):
    """K8 bit-equal to its plain version, with and without the fused
    Kt = X * h (h of both signs, X with zeros: signed zeros must match):
    D = 137 (one value at a time in both dtypes), 300 (16-byte packs in
    f32, one value at a time in bf16), 8,256 (packs in both), and X one
    value off a 16-byte boundary (shift: one value at a time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    gen = torch.Generator().manual_seed(rows + D)
    dev = torch.device("cuda")
    base = torch.randn(rows * D + shift, generator=gen)
    base[::7] = 0.0
    X = base.to(dev, dtype)[shift:].view(rows, D)
    h = (torch.rand(rows, generator=gen) * 4 - 2).to(dev)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    kg.reset_launches()
    for hh in (None, h):
        Jt, Kt = kg.retile_rows(X, Dp, hh)
        Jt_p, Kt_p = kg.retile_rows_plain(X, Dp, hh)
        torch.cuda.synchronize()
        assert torch.equal(Jt.view(bits), Jt_p.view(bits))
        if hh is not None:
            assert torch.equal(Kt.view(bits), Kt_p.view(bits))
    assert kg.LAUNCHES["retile_rows"] == 2


def _kmajor_storage(Q):
    """The whole code matrix Qt (Dp, ldq) behind a K-major view Q = Qt[:, :Bp].T."""
    ld = Q.stride(1)
    return torch.as_strided(Q, (Q.shape[1], ld), (ld, 1))


def _bf16_operand(gen, rows, Dp, dev):
    """A bf16 (rows, Dp) operand whose columns differ in scale, with a zero
    column (5), as the quantiser's inputs do."""
    X = torch.randn(rows, Dp, generator=gen) * torch.exp(torch.randn(Dp, generator=gen))
    X[:, 5] = 0.0
    return X.to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block,Dp", [(64, 32, 512), (520, 2048, 1024),
                                           (2600, 2048, 1024), (18432, 2048, 512)])
def test_quantize_tiled_bit_equal_on_cuda(rows, block, Dp):
    """K2 bit-equal to its plain version in values and in layout: the codes
    K-major (Q = Qt[:, :Bp].T, equal strides), Qt's zero pad past Bp and the
    scales (1 for the zero column). 520 rows quantise in one block of 544,
    2,600 in two of 2,048 (Bp 4,096, the last block ragged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    dev = torch.device("cuda")
    X = _bf16_operand(torch.Generator().manual_seed(rows), rows, Dp, dev)
    kg.reset_launches()
    Q, s = kg.quantize_tiled(X, block)
    Q_p, s_p = kg.quantize_tiled_plain(X, block)
    torch.cuda.synchronize()
    assert kg.LAUNCHES["quantize_tiled"] == 1
    assert Q.shape == Q_p.shape and Q.stride() == Q_p.stride()
    assert torch.equal(_kmajor_storage(Q), _kmajor_storage(Q_p))
    assert torch.equal(s, s_p) and bool((s[:, 5] == 1).all())


def _int8_chunk(gen, rows, Dp, block, dev):
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    return (kg.quantize_tiled(_bf16_operand(gen, rows, Dp, dev), block)
            + kg.quantize_tiled(_bf16_operand(gen, rows, Dp, dev), block))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("rows,block", [(96, 32), (520, 2048), (4096, 2048)])
def test_gram_pair_band_q_bit_equal_on_cuda(rows, block, n):
    """K3 (s8 wgmma) over two chained chunks into a random carry equals its
    plain version bit for bit (torch.equal): odd and even slab counts (the
    band's far pairs, (0, 2) and (0, 3), on swapped tiles), blocks of 32,
    544 and 2,048 rows, Bp = 96 and 544 not a multiple of a 128-row stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    gen = torch.Generator().manual_seed(100 * n + rows)
    dev = torch.device("cuda")
    Dp = n * kg.TILE
    acc = torch.randn(Dp, Dp, generator=gen).to(dev)
    acc_p = acc.clone()
    kg.reset_launches()
    for _ in range(2):
        Q1, s1, Q2, s2 = _int8_chunk(gen, rows, Dp, block, dev)
        assert kg.gram_pair_band_q(Q1, s1, Q2, s2, acc) is acc
        kg.gram_pair_q_plain(Q1, s1, Q2, s2, acc_p)
    torch.cuda.synchronize()
    assert kg.LAUNCHES["gram_pair_q"] == 2
    assert torch.equal(acc, acc_p)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block", [(96, 32), (2600, 2048)])
def test_gram_pair_tiled_q_bit_equal_on_cuda(rows, block):
    """K4 (no carry, natural orientation) equals its plain version bit for
    bit, lower slab pairs zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    dev = torch.device("cuda")
    Dp = 3 * kg.TILE
    Q1, s1, Q2, s2 = _int8_chunk(torch.Generator().manual_seed(rows), rows, Dp, block, dev)
    A = kg.gram_pair_tiled_q(Q1, s1, Q2, s2)
    A_p = kg.gram_pair_q_plain(Q1, s1, Q2, s2, torch.zeros_like(A), band=False,
                               has_acc=False)
    torch.cuda.synchronize()
    assert torch.equal(A, A_p)


@pytest.mark.cuda
def test_gram_pair_band_q_rejects_row_major_codes_on_cuda():
    """K3 takes quantize_tiled's K-major codes only: a row-major copy of
    them raises (no silent copy), and so does a view whose row stride is
    not a multiple of 16 bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    dev = torch.device("cuda")
    Q1, s1, Q2, s2 = _int8_chunk(torch.Generator().manual_seed(3), 96, 512, 32, dev)
    acc = torch.zeros((512, 512), device=dev)
    with pytest.raises(ValueError):
        kg.gram_pair_band_q(Q1.contiguous(), s1, Q2, s2, acc)
    odd = torch.zeros((512, 104), dtype=torch.int8, device=dev)[:, :96].T
    with pytest.raises(ValueError):
        kg.gram_pair_band_q(Q1, s1, odd, s2, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_a,shape_b", [((300, 17), (17, 64)),
                                             ((40, 50, 8), (40, 8, 33)),
                                             ((999, 4100), (4100, 1)),
                                             ((18432, 16200), (16200, 1))])
def test_aux_matmul_default_on_cuda(shape_a, shape_b):
    """The bf16 aux tier's product on the card (bf16 operands, an f32
    result) against its CPU plain form (the rounded operands multiplied in
    f32): f32 out, each entry within 4 sqrt(K) 2^-24 of sum_k |a||b|, the
    two forms' f32 sums in different orders; a bf16-output product of the
    same operands, or any sum rounded to bf16 on the way, is outside it.
    The last shape is the flagship's packed prediction (2,048 x 9 rows, D =
    16,200), where cuBLAS's bf16 product sums less accurately than its f32
    one (still well inside the bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.core.contract import matmul
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(shape_a, generator=gen)
    b = torch.randn(shape_b, generator=gen)
    got = matmul(a.cuda(), b.cuda(), "default")
    plain = matmul(a, b, "default")
    assert got.dtype == torch.float32 and got.is_cuda
    K = shape_a[-1]
    scale = matmul(a.bfloat16().abs(), b.bfloat16().abs(), "highest")
    bound = 4 * K ** 0.5 * 2.0 ** -24
    assert float(((got.cpu() - plain).abs() / scale).max()) <= bound
    fn = torch.bmm if len(shape_a) == 3 else torch.mm
    rounded_out = fn(a.cuda().bfloat16(), b.cuda().bfloat16()).float().cpu()
    assert float(((rounded_out - plain).abs() / scale).max()) > bound


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cg", "minres", "lanczos"])
def test_krylov_on_cuda_against_float64(name):
    """chip_smoke's phase 8b at D = 512: each solver on a CUDA operator held
    to a float64 dense solve at tests/test_matrixfree.py's bound, and to the
    same solver on the CPU run for the card's iteration count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.check_krylov(torch.device("cuda"), D=512, names=(name,))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["minres", "cg"])
def test_graphed_matvec_swipe_matches_eager_on_cuda(method, monkeypatch):
    """A matrix-free swipe of a type-I sum of 1-2 conv-TT carriages (r=4,
    CB=2, 3 x 16 x 16 images at kernel 8, 512 rows in 4 chunks) on the card
    with each update's matvec replayed as a CUDA graph, against the same
    swipe launched eagerly: the same k at every update, the parameters
    within 1e-5 (the graph replays the eager kernels; 1e-5 leaves room for
    cuBLAS to pick another kernel under capture), the counter at k + 2 to
    k + 2 + LAG matvecs an update (the host reads the flags as they arrive;
    a node updates in both passes),
    and a second swipe from the first's warm starts as close."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from portbench import cifar, data
    from tensornetworksfork_tpu_torch.core import krylov
    from tensornetworksfork_tpu_torch.core.sweep import Member, SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.experiments import train_image
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    monkeypatch.delenv("TNF_AUX_PRECISION", raising=False)
    monkeypatch.delenv("TNF_GRAM_DTYPE", raising=False)
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", "0")
    dev = torch.device("cuda")
    gen = data.generator(11, dev)
    X, y = cifar.images(gen, 512, 16, 8, 3, 10, 24.0, dev)
    P, q = X.shape[1], X.shape[2]
    model = train_image.build_model({"model_type": "tt_type1", "N": 2, "r": 4, "CB": 2,
                                     "seed": 0, "device": dev}, P, q, 10)
    scale = 1.0 / float(model(X[:64]).std(unbiased=False))

    def swipes(graphed):
        monkeypatch.setattr(Sweeper, "graph_matvecs", graphed)
        sw = Sweeper([Member(l.network, fn) for l, fn in zip(model.layers, model.input_fns)],
                     XEBregman(w=scale),
                     SweepConfig(num_swipes=1, batch_size=128, method=method, max_iter=50,
                                 eps=5.0, eps_decay=0.25))
        out, plist = [], model.params_list
        for _ in range(2):
            m0, n0 = dict(sw.krylov_matvecs), len(sw.krylov_iters)
            plist, ok = sw.run(plist, X, y)
            assert ok
            ks = [(m, n, int(k)) for m, n, k in sw.krylov_iters[n0:]]
            mv = {key: v - m0.get(key, 0) for key, v in sw.krylov_matvecs.items()}
            out.append((torch.cat([p[k].reshape(-1) for p in plist for k in sorted(p)]),
                        ks, mv))
        return out, sw

    eager, _ = swipes(False)
    graphed, sw = swipes(True)
    assert sw._graph_kit is not None
    for (pe, ke, _), (pg, kg, mv) in zip(eager, graphed):
        assert ke == kg
        assert float((pg - pe).abs().max() / pe.abs().max()) < 1e-5
        for key in mv:
            ks = [k for m, n, k in kg if (m, n) == key]
            assert sum(ks) + 2 * len(ks) <= mv[key] <= sum(ks) + (2 + krylov.LAG) * len(ks)


@pytest.mark.cuda
def test_prepared_matvec_graph_replay_on_cuda():
    """The matvec of a D = 16,384 middle core (member 3 of a type-I sum at
    r=32, CB=4 on 32 x 32 x 3 images at kernel 8: 16 patches of 192 pixels,
    2,048 rows in 4 chunks) on the prepared route (`prepare_jacobian`):
    replayed as a CUDA graph (`Sweeper._record_matvec`), bit-equal to its
    eager call; and within 1e-5 of max|A v| of the einsum route's (f32
    sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from portbench import cifar, data
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.experiments import train_image
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    dev = torch.device("cuda")
    gen = data.generator(12, dev)
    X, y = cifar.images(gen, 2048, 32, 8, 3, 10, 24.0, dev)
    model = train_image.build_model({"model_type": "tt_type1", "N": 3, "r": 32, "CB": 4,
                                     "seed": 0, "device": dev}, X.shape[1], X.shape[2], 10)
    layer, fn = model.layers[2], model.input_fns[2]
    net, params = layer.network, layer.params
    t = net.topology
    ni = [n.name for n in t.nodes].index("A2")
    ci, core = t.col_of[ni], params["A2"]
    assert core.numel() >= 10_000
    scale = 1.0 / float(net.forward(params, fn(X[:64])).std(unbiased=False))
    ops_all, H_all = [], []
    for xc, yc in zip(X.chunk(4), y.chunk(4)):
        inputs = net.bind_inputs(fn(xc))
        left = net.env_chain(params, inputs, "left")
        right = net.env_chain(params, inputs, "right")
        ops = net.jacobian_operands(ni, params, inputs, left[ci - 1], right[ci + 1])
        H_all.append(XEBregman(w=scale)(net.jacobian_apply(ni, ops, core), yc)[2])
        ops_all.append(ops)
    preps = [net.prepare_jacobian(ni, ops) for ops in ops_all]
    assert all(p is not None for p in preps)

    def matvec(prepared):
        def mv(v_flat):
            v = v_flat.reshape(core.shape)
            Av = torch.zeros_like(v)
            for p, ops, H in zip(preps, ops_all, H_all):
                if prepared:
                    Av = Av + p.transpose_apply(net.hessian_apply(H, p.apply(v)))
                else:
                    Av = Av + net.jacobian_transpose_apply(
                        ni, ops, net.hessian_apply(H, net.jacobian_apply(ni, ops, v)))
            return Av.reshape(-1)
        return mv
    v = torch.randn((core.numel(),), device=dev,
                    generator=torch.Generator(dev).manual_seed(3))
    replay = Sweeper(net, XEBregman(), SweepConfig())._record_matvec(matvec(True), v)
    eager = matvec(True)(v)
    assert torch.equal(replay(v), eager)
    ref = matvec(False)(v)
    assert float((eager - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_f64_ladder_on_cuda():
    """chip_smoke's phase 8a ladder: the float64 tier on CUDA tensors meets
    a numpy float64 oracle at every eps down to 1e-12, and at the corner
    where the f32 tier fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.check_f64_ladder(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["exact", "ridge_exact", "ridge_cholesky",
                                    "cholesky", "ridge_trace"])
def test_f64_solve_block_on_cuda(method):
    """solve_block(solve_dtype="float64") on CUDA tensors against the same
    semantics in float64 on the CPU (diagonal-mean rescale, eps as an f32
    value, ridge_trace's |b|^2 scale): within 2 f32 ulps of max|step| (both
    float64, rounded to f32); the step stays on the card in f32, and a
    singular system gives NaN and ok False there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from tensornetworksfork_tpu_torch.core.solve import solve_block
    gen = torch.Generator().manual_seed(5)
    D = 300
    M = torch.randn(D, D, generator=gen, dtype=torch.float64)
    A = (M @ M.T / D + 0.01 * torch.eye(D, dtype=torch.float64)).float()
    A = torch.triu(A) + torch.triu(A, 1).T
    b = torch.randn(D, generator=gen)
    nv = torch.randn(D, generator=gen)
    eps = 1e-4
    step, ok = solve_block(A.cuda(), b.cuda(), nv.cuda(), method, eps,
                           solve_dtype="float64")
    assert step.is_cuda and step.dtype == torch.float32 and bool(ok)
    A64, b64 = A.double(), b.double()
    s = A64.diagonal().abs().mean()
    A64, b64 = A64 / s, b64 / s
    e = float(np.float32(eps))
    if method == "ridge_trace":
        e = e * float((b64 ** 2).sum())
    if method != "exact" and method != "cholesky":
        A64 = A64 + 2 * e * torch.eye(D, dtype=torch.float64)
        b64 = b64 + 2 * e * nv.double()
    ref = torch.linalg.solve(A64, -b64).float()
    assert float((step.cpu() - ref).abs().max()) <= 2.5e-7 * float(ref.abs().max())
    S = torch.zeros(D, D)
    S[0, 0] = 1.0
    bad, ok = solve_block(S.cuda(), b.cuda(), nv.cuda(),
                          "cholesky" if "cholesky" in method else "exact", 0.0,
                          solve_dtype="float64")
    assert not bool(ok) and bool(torch.isnan(bad).all())


@pytest.mark.cuda
def test_zoo_layers_and_losses_match_cpu_on_cuda():
    """chip_smoke's phase 9 (i): one swipe of every zoo layer builder and
    loss (and one with orthonormalize=True), kernels on the card against
    their plain versions on the CPU, from the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.check_zoo_reference(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kernel", [(dict(model_type="cpd"), "weighted_gram"),
                                       (dict(linear_dim=4), "weighted_gram"),
                                       (dict(cum_sum=True), "weighted_gram_tiled")])
def test_zoo_families_launch_their_kernels_on_cuda(kw, kernel, monkeypatch):
    """A small fit of cpd, linear_dim and cum_sum on the card launches the
    Gram kernel of its route (cum_sum's middle core on the tiled route with
    TNF_PACKED_SYRK_MIN_D=1) and beats predicting the mean."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    X, y = make_regression(S=2560, d=8, degree=3, seed=0)
    est = TensorTrainRegressor(N=3, r=4, batch_size=512, eps_start=5.0,
                               eps_decay=0.25, num_swipes=2, device="cuda", **kw)
    kg.reset_launches()
    est.fit(X[:2048], y[:2048], X_val=X[2048:], y_val=y[2048:])
    assert est.fit_ok_ and kg.LAUNCHES[kernel] > 0
    assert float(np.sqrt(np.mean((est.predict(X[2048:]) - y[2048:]) ** 2))) < 1.0


@pytest.mark.cuda
def test_polynomial_and_tnml_on_cuda():
    """The polynomial baseline's float32 Ridge on the card against the same
    fit on the CPU (within 1e-3 x max|pred|: two float32 Cholesky solves of
    a cond ~1e5 kernel system), and a TNML fit on the card beats the
    majority class."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from tensornetworksfork_tpu_torch.data.tabular import load_sklearn_dataset
    from tensornetworksfork_tpu_torch.models.baselines import PolynomialRegressionWrapper
    from tensornetworksfork_tpu_torch.models.tnml import TNMLRegressor
    d = load_sklearn_dataset("diabetes", seed=42)
    preds = [PolynomialRegressionWrapper(3, "l2", 0.5, device=dev)
             .fit(d["X_train"], d["y_train"]).predict(d["X_test"])
             for dev in ("cpu", "cuda")]
    assert np.abs(preds[1] - preds[0]).max() <= 1e-3 * np.abs(preds[0]).max()
    bc = load_sklearn_dataset("breast_cancer", seed=42)
    est = TNMLRegressor(r=4, num_swipes=2, eps_start=0.5, task="classification",
                        input_scale="minmax", device="cuda")
    est.fit(bc["X_train"], bc["y_train"], X_val=bc["X_val"], y_val=bc["y_val"])
    yv = bc["y_val"].reshape(-1)
    acc = float(np.mean(est.predict(bc["X_val"]).argmax(1) == yv))
    assert est.fit_ok_ and acc > max(yv.mean(), 1 - yv.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 300])
def test_serving_artifact_on_cuda(batch, tmp_path):
    """A type-I sum of conv-TTs exported on the card with a symbolic batch,
    saved and loaded with torch alone: its output at batches 1, 3 and 300
    (none of them the trace's example batch) stays on the card and matches the
    eager forward within 1e-5 of max|pred|, argmax equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensornetworksfork_tpu_torch.models.layers import SumLayer, TensorConvolutionTrainLayer
    from tensornetworksfork_tpu_torch.utils.serving import export_forward, load_forward, save_forward
    model = SumLayer([TensorConvolutionTrainLayer(n, 6, 12, 9, output_shape=(9,),
                                                  convolution_bond=3, seed=n, device="cuda")
                      for n in (1, 2, 3)])
    p = str(tmp_path / "sum.pt2")
    save_forward(p, export_forward(model, (12, 9), device="cuda"))
    f = load_forward(p)
    x = torch.randn(batch, 12, 9, device="cuda")
    got, want = f(x), model(x)
    assert got.device.type == "cuda" and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
def test_estimator_export_on_cuda():
    """A classification TensorTrainRegressor fitted on the card exports
    with its device; the artifact's logits match predict."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    from tensornetworksfork_tpu_torch.utils.serving import load_forward
    rng = np.random.default_rng(2)
    X = rng.uniform(-1, 1, size=(512, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    reg = TensorTrainRegressor(N=3, r=4, task="classification", num_swipes=2,
                               eps_start=0.5, seed=0, device="cuda").fit(X, y)
    f = load_forward(reg.export())
    assert f.device.type == "cuda"
    logits, ref = f(X).cpu().numpy(), reg.predict(X)
    assert np.abs(logits - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("swipe_method", ["batch_unique", "batch_same", "batch_block"])
def test_native_stream_batch_regressor_on_cuda(swipe_method, monkeypatch):
    """TensorTrainBatchRegressor(stream="native") on the card: the native
    stream opens, the batches' rows are the host X's, the fit launches the
    split Gram, and its predictions match the same fit on the CPU (the same
    stream, so the same minibatches) within 1e-4 of max|pred|. eps 5.0 down
    to 5.0 x 0.25^3 (phase 10's): at eps 1.0 batch_same amplifies rounding
    (on the CPU, y one ulp up moves its predictions by 7.9e-3 of max|pred|,
    against 4.2e-7 here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.models.module import TensorTrainBatchRegressor
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    from tensornetworksfork_tpu_torch.utils import data_stream
    X, y = make_regression(S=2560, d=16, degree=3, seed=0)
    opened = []
    Stream = data_stream.MinibatchStream

    class Checked(Stream):
        def epoch(self):
            for xb, idx in super().epoch():
                assert np.array_equal(xb, self._owner[idx])
                yield xb, idx

    def record(*a, **k):
        opened.append(Checked(*a, **k))
        return opened[-1]
    monkeypatch.setattr(data_stream, "MinibatchStream", record)
    preds = []
    for dev in ("cuda", "cpu"):
        kg.reset_launches()
        est = TensorTrainBatchRegressor(N=3, r=4, batch_size=512, num_swipes=2,
                                        swipe_method=swipe_method, perturb=False,
                                        constrict_bond=False, eps_start=5.0,
                                        eps_end=5.0 * 0.25 ** 3, seed=0,
                                        stream="native", device=dev)
        est.fit(X[:2048], y[:2048], X[2048:], y[2048:])
        if dev == "cuda":
            assert kg.LAUNCHES["weighted_gram"] > 0
        preds.append(est.predict(X[2048:]))
    assert all(s.batches_per_epoch == 4 for s in opened) and len(opened) == 2
    assert np.abs(preds[0] - preds[1]).max() <= 1e-4 * np.abs(preds[1]).max()


@pytest.mark.cuda
def test_launch_on_operands_device_on_cuda():
    """A wrapper launches on its operands' device and that device's stream,
    whatever device is current: K10 on operands on the second card while
    the first is current, held to its plain version; operands on two
    cards raise."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the operands must lie on another "
                    "card than the current one")
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    X, Y = (torch.randn((333, 137), generator=gen, device=dev) for _ in range(2))
    before = kg.LAUNCHES["gram_pair"]
    A = kg.gram_pair(X, Y)
    torch.cuda.synchronize(dev)
    assert A.device == dev and torch.cuda.current_device() == 0
    assert kg.LAUNCHES["gram_pair"] == before + 1
    ref = kg.gram_pair_plain(X, Y)
    torch.testing.assert_close(torch.triu(A), torch.triu(ref), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="different devices"):
        kg.gram_pair(X, Y.to("cuda:0"))
