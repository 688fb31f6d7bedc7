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


def split_sum(X, w, splits):
    """The split kernel's arithmetic in plain PyTorch: weighted Grams of the
    row ranges that tg.split_rows plans, added in split order in f32."""
    n, rps = tg.split_rows(X.shape[0], splits)
    A = None
    for z in range(n):
        rs = slice(z * rps, (z + 1) * rps)
        part = tg._weighted_operand(X[rs], w[rs]).T @ X[rs].float()
        A = part if A is None else A + part
    return A, n


def test_split_rows_cover_every_row_once():
    """Every row lies in exactly one split, no split is empty, and no more
    splits than asked for are made."""
    for rows in (1, 63, 64, 333, 5000, 65536):
        for splits in (1, 2, 3, 4, 7, 11, 64):
            n, rps = tg.split_rows(rows, splits)
            assert 1 <= n <= splits
            seen = np.zeros(rows, int)
            for z in range(n):
                lo, hi = z * rps, min(rows, (z + 1) * rps)
                assert lo < hi
                seen[lo:hi] += 1
            assert (seen == 1).all(), (rows, splits)


def test_split_plan_fills_the_card():
    """On 132 SMs: no split where the grid already holds 4 CTAs per SM (the
    conv-TT flagship's first core: 64 tiles x 45 class pairs), none for a
    table too short to split, and at the regression's 1,032-wide outputs
    (K9's 45 upper tiles, K11's 81 whole ones) enough splits for about 4
    CTAs per SM, none shorter than SPLIT_MIN_ROWS."""
    sms = 132
    assert tg.wgram_plan(8192, 900, 45, False, sms)[1] == 1
    assert tg.wgram_splits(4 * sms, 10 ** 6, sms) == 1
    assert tg.wgram_plan(333, 137, 1, True, sms)[1] == 1
    for upper, tiles in ((True, 45), (False, 81)):
        npairs, n, rps = tg.wgram_plan(65536, 1032, 1, upper, sms)
        assert npairs == tiles
        assert n > 1 and rps >= tg.SPLIT_MIN_ROWS
        assert npairs * n >= 3.5 * sms


def test_split_plan_of_the_flagship_a4():
    """K10 at the conv-TT flagship's A4 (73,728 rows, D=900: 36 upper
    tiles) on 132 SMs, in both dtypes: split so that the CTAs fill whole
    waves of WGRAM_RESIDENT = 2 CTAs an SM — 7 splits, 252 CTAs in one wave
    of 264 slots."""
    sms = 132
    npairs, n, rps = tg.wgram_plan(73728, 900, 1, True, sms)
    assert npairs == 36 and n > 1 and rps >= tg.SPLIT_MIN_ROWS
    slots = tg.WGRAM_RESIDENT * sms
    waves = -(-npairs * n // slots)
    assert npairs * n >= 0.95 * waves * slots
    assert (n, waves) == (7, 1)


@pytest.mark.parametrize("ntiles", [1, 9, 13, 127])
def test_upper_tile_table_lists_each_tile_once_in_blocks(ntiles):
    """The upper-triangle tile table of the float Grams lists every tile
    ti <= tj exactly once, in GROUP x GROUP blocks. At K6's 127 tiles a side
    (D = 16,200) any 132 consecutive tiles (a wave on 132 SMs) read at most
    4 GROUP operand strips (X's d-strips and Y's e-strips together); in row
    order a wave reads up to 129."""
    t = tg._pair_table_np(ntiles, 1, False)
    pairs = [tuple(p) for p in t[:, :2].tolist()]
    assert sorted(pairs) == [(i, j) for i in range(ntiles) for j in range(i, ntiles)]
    assert not t[:, 2].any()
    blocks = [(i // tg.GROUP, j // tg.GROUP) for i, j in pairs]
    assert blocks == sorted(blocks)
    strips = max(len(set(t[i:i + 132, 0])) + len(set(t[i:i + 132, 1]))
                 for i in range(max(1, len(t) - 131)))
    assert strips <= 4 * tg.GROUP + 1


def tiled_carry_sum(Xt, h, acc, D):
    """K7 as the split kernel sums it (one split), in plain PyTorch: the
    chunk's weighted Gram over the node's D columns added to the carry once
    per element (carry + chunk sum); the carry past D is not touched."""
    part = tg._weighted_operand(Xt[:, :D], h).T @ Xt[:, :D].float()
    acc[:D, :D] = acc[:D, :D] + part
    return acc


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weighted_gram_tiled_narrow_carry_matches_pallas(dtype):
    """K7 with the node's D < Dp, two chunks chained into one carry: the
    kernel's order of sums (tiled_carry_sum) and the wrapper (its plain
    version here) against the Pallas acc kernel, mirrored once, to 1e-5 of
    max|A|; the carry's padding rows and columns stay zero."""
    rng = np.random.default_rng(60)
    rows, D, n = 64, 300, 3
    Dp = n * TILE
    jd, td = DTYPES[dtype]
    acc_j = jnp.zeros((Dp, Dp), jnp.float32)
    acc_e = torch.zeros((Dp, Dp))
    acc_t = torch.zeros((Dp, Dp))
    for _ in range(2):
        Xn, Xt = operand(rng, rows, D, Dp, dtype)
        h = rng.uniform(0.5, 2.0, rows).astype(np.float32)
        acc_j = jg.weighted_gram_tiled(jnp.asarray(rows_to_slabs(Xn), jd),
                                       jnp.asarray(h), interpret=True, tile=TILE,
                                       block=32, acc=acc_j)
        tiled_carry_sum(Xt, torch.tensor(h), acc_e, D)
        assert tg.weighted_gram_tiled(Xt, torch.tensor(h), acc_t, D) is acc_t
    A_j = np.asarray(jg.mirror_gram(acc_j))[:D, :D]
    for acc in (acc_e, acc_t):
        assert not acc[D:].any() and not acc[:, D:].any()
        assert_close_rel(tg.mirror_gram(acc[:D, :D]).numpy(), A_j)


@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_weighted_gram_matches_pallas(dtype, splits):
    """K9 as the split kernel sums it (partial Grams over the planned row
    ranges, added in split order) against the Pallas weighted_gram at a
    ragged shape: 333 rows, D=137."""
    rng = np.random.default_rng(20 + splits)
    rows, D = 333, 137
    jd, td = DTYPES[dtype]
    Xn, Xt = operand(rng, rows, D, D, dtype)
    h = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    A_j = np.asarray(jg.weighted_gram(jnp.asarray(Xn, jd), jnp.asarray(h),
                                      interpret=True))
    A_t, n = split_sum(Xt, torch.tensor(h), splits)
    assert n == splits
    # the rounded operand makes XwᵀX asymmetric at its rounding: both sides
    # keep the upper triangle and mirror it
    assert_close_rel(tg.mirror_gram(A_t).numpy(), A_j)


@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 3])
def test_split_own_out_gram_matches_pallas(C, dtype, splits):
    """K11 as the split kernel sums it, class pair by class pair, against
    the Pallas own_out_gram (mirrored) at 333 rows, DJ=137."""
    rng = np.random.default_rng(30 + 4 * C + splits)
    S, DJ, n = 333, 137, 2
    Dp = n * TILE
    jd, td = DTYPES[dtype]
    Jn, Jt = operand(rng, S, DJ, Dp, dtype)
    h = rng.standard_normal((S, C, C)).astype(np.float32)
    H = torch.tensor((h + h.transpose(0, 2, 1)) / 2)
    A_j = np.asarray(jg.mirror_own_out(jg.own_out_gram(
        jnp.asarray(rows_to_slabs(Jn), jd), jnp.asarray(H.numpy()), C,
        interpret=True, tile=TILE, block=16)))[:, :, :DJ, :DJ]
    A_t = np.zeros_like(A_j)
    for p, q in zip(*np.triu_indices(C)):
        blk, nz = split_sum(Jt[:, :DJ], H[:, p, q], splits)
        assert nz == splits
        A_t[q, p] = blk.numpy().T  # mirror_own_out's lower pairs
        A_t[p, q] = blk.numpy()     # a diagonal pair stays whole
    assert_close_rel(A_t, A_j)
