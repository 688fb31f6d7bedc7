"""Tests that need a CUDA card: every kernel of csrc/gram.cu, csrc/qgram.cu
and csrc/wgram.cu against its plain version on the card, at small, ragged
shapes (K6 in f32 also against float64; K2, K3/K4 and K8 bit for bit, K1's
Jt too, and its Kt in f32).

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
