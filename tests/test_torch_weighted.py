"""The port's diagonal-weighted kernels (K7, K8, K9, K11 in
tensornetworksfork_tpu_torch/ops/cuda/gram.py) held against the JAX package's
Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the Pallas functions
run in interpret mode. Inputs come from a numpy seed and go to both. The
TPU kernels work on (n, rows, tile) slabs and the port on row-major
(rows, Dp) matrices, so slabs are converted before comparing. Tolerances:
the weighted operand is rounded the same way on both sides (one f32 or one
bf16 rounding of x*w), so only the f32 sums differ in order — held to 1e-5
of max|A|; the relayout (K8) is held to bit-equality.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.ops.pallas import gram as jg  # noqa: E402
from tensornetworksfork_tpu_torch.ops.cuda import gram as tg  # noqa: E402

TILE = 128  # a small slab for the Pallas side; D is ragged against it
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def slabs_to_rows(a):
    """(n, rows, tile) -> (rows, n*tile) as f32."""
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    n, rows, tile = a.shape
    return a.transpose(1, 0, 2).reshape(rows, n * tile)


def rows_to_slabs(a, tile=TILE):
    rows, Dp = a.shape
    return a.reshape(rows, Dp // tile, tile).transpose(1, 0, 2)


def operand(rng, rows, D, Dp, dtype):
    """(rows, Dp) numpy f32 with D ragged columns set, the rest zero, and
    its torch copy in `dtype` (bf16 values are the rounded ones on both
    sides)."""
    X = np.zeros((rows, Dp), np.float32)
    X[:, :D] = rng.standard_normal((rows, D))
    Xt = torch.tensor(X).to(DTYPES[dtype][1])
    return Xt.float().numpy(), Xt


def assert_close_rel(a, b, rtol=1e-5):
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_retile_rows_matches_pallas(dtype, weighted):
    """K8: the zero-padded relayout is bit-equal; with h, the fused
    Kt = (J * h) rounded once to J's dtype is bit-equal to the reference
    engine's (Jt.astype(f32) * h).astype(Jt.dtype)."""
    rng = np.random.default_rng(11)
    rows, D, n = 40, 300, 3
    jd, td = DTYPES[dtype]
    X = torch.tensor(rng.standard_normal((rows, D)).astype(np.float32)).to(td)
    h = rng.standard_normal(rows).astype(np.float32)
    Xj = jnp.asarray(X.float().numpy(), jd)
    Jt_j = jg.retile_rows(Xj, n, TILE)
    Jt, Kt = tg.retile_rows(X, n * TILE, torch.tensor(h) if weighted else None)
    assert Jt.dtype == td and Jt.shape == (rows, n * TILE)
    np.testing.assert_array_equal(Jt.float().numpy(), slabs_to_rows(Jt_j))
    if weighted:
        Kt_j = (Jt_j.astype(jnp.float32) * jnp.asarray(h)[None, :, None]).astype(jd)
        assert Kt.dtype == td
        np.testing.assert_array_equal(Kt.float().numpy(), slabs_to_rows(Kt_j))
    else:
        assert Kt is None


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("carry", [False, True])
def test_weighted_gram_tiled_matches_pallas(dtype, carry):
    """K7 on the tiled layout. With carry: two chunks chained into one
    carry against the Pallas acc kernel, mirrored once; without: one chunk
    into a zero carry against the mirrored Pallas result."""
    rng = np.random.default_rng(12 if carry else 13)
    rows, D, n = 64, 300, 3
    Dp = n * TILE
    jd, td = DTYPES[dtype]
    acc_j = jnp.zeros((Dp, Dp), jnp.float32)
    acc_t = torch.zeros((Dp, Dp))
    for _ in range(2 if carry else 1):
        Xn, Xt = operand(rng, rows, D, Dp, dtype)
        h = rng.standard_normal(rows).astype(np.float32)
        Xs = jnp.asarray(rows_to_slabs(Xn), jd)
        if carry:
            acc_j = jg.weighted_gram_tiled(Xs, jnp.asarray(h), interpret=True,
                                           tile=TILE, block=32, acc=acc_j)
        else:
            A_j = jg.weighted_gram_tiled(Xs, jnp.asarray(h), interpret=True,
                                         tile=TILE, block=32, mirror=True)
        out = tg.weighted_gram_tiled(Xt, torch.tensor(h), acc_t)
        assert out is acc_t  # the carry is updated in place
    if carry:
        A_j = jg.mirror_gram(acc_j)
    A_t = tg.mirror_gram(acc_t)
    assert_close_rel(A_t[:D, :D].numpy(), np.asarray(A_j)[:D, :D])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weighted_gram_flat_matches_pallas(dtype):
    """K9: the flat weighted Gram of a ragged (rows, D) operand, mirrored,
    against weighted_gram (its packed route pads D to a tile itself)."""
    rng = np.random.default_rng(14)
    rows, D = 90, 150
    jd, td = DTYPES[dtype]
    Xn, Xt = operand(rng, rows, D, D, dtype)
    h = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    A_j = np.asarray(jg.weighted_gram(jnp.asarray(Xn, jd), jnp.asarray(h),
                                      interpret=True))
    A_t = tg.mirror_gram(tg.weighted_gram(Xt, torch.tensor(h))).numpy()
    assert A_t.shape == (D, D)
    assert_close_rel(A_t, A_j)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 3])
def test_own_out_gram_matches_pallas(dtype, C):
    """K11 on the tiled layout (ragged DJ), finished by mirror_own_out on
    both sides: every class-pair block A[p, q] = J^T diag(H[:, p, q]) J,
    whole over (d, e). H is symmetric per sample (the loss contract)."""
    rng = np.random.default_rng(15 + C)
    S, DJ, n = 48, 150, 2
    Dp = n * TILE
    jd, td = DTYPES[dtype]
    Jn, Jt = operand(rng, S, DJ, Dp, dtype)
    h = rng.standard_normal((S, C, C)).astype(np.float32)
    H = (h + h.transpose(0, 2, 1)) / 2
    A_j = jg.mirror_own_out(jg.own_out_gram(
        jnp.asarray(rows_to_slabs(Jn), jd), jnp.asarray(H), C,
        interpret=True, tile=TILE, block=16))
    raw = tg.own_out_gram(Jt, torch.tensor(H), C, DJ)
    assert raw.shape == (C, C, Dp, Dp)
    lower = np.tril(np.ones((C, C), bool), -1)
    assert not raw.numpy()[lower].any()  # lower pairs stay zero until mirrored
    A_t = tg.mirror_own_out(raw)
    assert_close_rel(A_t[:, :, :DJ, :DJ].numpy(),
                     np.asarray(A_j)[:, :, :DJ, :DJ])


def test_weighted_wrappers_check_operands():
    """Operands on a device that is neither the CPU nor CUDA, or on mixed
    devices, raise instead of taking the plain version."""
    X = torch.zeros((8, 64))
    with pytest.raises(ValueError):  # a tensor on neither the CPU nor CUDA
        tg.weighted_gram(X.to("meta"), torch.zeros(8, device="meta"))
    with pytest.raises(ValueError):
        tg.retile_rows(X.to("meta"), 32)
    with pytest.raises(ValueError):  # operands on mixed devices
        tg.own_out_gram(X, torch.zeros((8, 1, 1), device="meta"), 1)
