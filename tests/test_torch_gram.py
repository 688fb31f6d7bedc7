"""The port's Gram-path kernels (tensornetworksfork_tpu_torch/ops/cuda/gram.py)
held against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX functions run
in interpret mode, as tests/test_pallas.py and tests/test_int8_gram.py run
them. Inputs are made from a numpy seed and handed to both. Layouts differ
(the TPU kernels use (n, rows, tile) slabs, the port row-major (rows, Dp)
matrices), so the helpers below convert the JAX outputs before comparing.
"""
import ast
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.ops.pallas import gram as jg  # noqa: E402
from tensornetworksfork_tpu_torch.ops.cuda import gram as tg  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tensornetworksfork_tpu_torch"


def slabs_to_rows(a):
    """(n, rows, tile) -> (rows, n*tile)."""
    a = np.asarray(a)
    n, rows, tile = a.shape
    return a.transpose(1, 0, 2).reshape(rows, n * tile)


def rows_to_slabs(a, tile):
    rows, Dp = a.shape
    return a.reshape(rows, Dp // tile, tile).transpose(1, 0, 2)


def bf16(x):
    return torch.tensor(x).to(torch.bfloat16)


def _hmix_inputs(S, C, D, seed=0):
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((S, C, D)).astype(np.float32)
    h = rng.standard_normal((S, C, C)).astype(np.float32)
    g = rng.standard_normal((S, C)).astype(np.float32)
    return J, (h + h.transpose(0, 2, 1)) / 2, g


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_retile_hmix_matches_pallas(dtype):
    """Jt equal. Kt: in bf16 within 1 bf16 ulp — K is mixed in f32 and
    rounded once on both sides, but the reference builds its ragged tail
    tile with an XLA einsum whose summation order may move that one
    rounding; in f32 within C 2^-23 of sum_e |H[s,c,e] J[s,e,d]| (an f32
    sum of C products, which the einsum and XLA's fused multiply-adds may
    round in another order)."""
    S, C, D, tile = 64, 3, 300, 128  # two full 128-tiles + a ragged tail
    n = (D + tile - 1) // tile
    J, H, _ = _hmix_inputs(S, C, D)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                      torch.float32)
    Jj = jnp.asarray(J, jdt)
    Jt_j, Kt_j = jg.retile_hmix(Jj, jnp.asarray(H), n, tile, interpret=True)
    # (n, C, S, tile) -> class-major rows (C*S, n*tile)
    to_rows = lambda a: np.asarray(a.astype(jnp.float32)).transpose(
        1, 2, 0, 3).reshape(C * S, n * tile)
    Jt_t, Kt_t, b = tg.retile_hmix(torch.tensor(J).to(tdt), torch.tensor(H), n * tile)
    assert b is None
    np.testing.assert_array_equal(Jt_t.float().numpy(), to_rows(Jt_j))
    Kj = to_rows(Kt_j)
    if dtype == "bf16":
        tol = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(Kj), 1e-30))) - 7)
    else:
        mag = np.einsum("sce,sed->csd", np.abs(H), np.abs(np.asarray(Jj, np.float32)))
        tol = np.pad(C * 2.0 ** -23 * mag.reshape(C * S, D), ((0, 0), (0, n * tile - D)))
    assert np.all(np.abs(Kt_t.float().numpy() - Kj) <= tol)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_retile_hmix_rhs_matches_jax_dot(dtype):
    """b = Jtᵀg from retile_hmix (gvec class-major, in J's dtype) against the
    reference engine's dot_general(Jt, g) over the Pallas retile's Jt, f32
    results. bf16 products are exact in f32 and f32 ones rounded alike, so
    only the order of the S*C-term f32 sums differs: held per column to
    4 sqrt(S*C) 2^-24 of sum_r |g_r||Jt_rd|, and columns past D are zero."""
    S, C, D, tile = 64, 3, 300, 128
    n = (D + tile - 1) // tile
    J, H, g = _hmix_inputs(S, C, D, seed=1)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                      torch.float32)
    Jj = jnp.asarray(J, jdt)
    Jt_j, _ = jg.retile_hmix(Jj, jnp.asarray(H), n, tile, interpret=True)
    gvec_j = jnp.transpose(jnp.asarray(g)).reshape(C * S).astype(jdt)
    b_j = np.asarray(jax.lax.dot_general(
        Jt_j.reshape(n, C * S, tile), gvec_j, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)).reshape(n * tile)
    gvec = torch.tensor(g).T.reshape(-1).to(tdt)
    Jt, _, b = tg.retile_hmix(torch.tensor(J).to(tdt), torch.tensor(H), n * tile, gvec)
    assert b.dtype == torch.float32 and tuple(b.shape) == (n * tile,)
    scale = gvec.float().abs() @ Jt.float().abs()
    tol = 4 * np.sqrt(S * C) * 2.0 ** -24 * scale.numpy()
    assert np.all(np.abs(b.numpy() - b_j) <= tol)
    assert not b[D:].any()


@pytest.mark.parametrize("S,C,Dp,itemsize,sms,plan", [
    (2048, 9, 16384, 2, 132, (33, 63)),    # the flagship chunk, bf16: 8 strips
    (2048, 9, 16384, 4, 132, (16, 128)),   # f32: 16 strips
    (2048, 16, 16384, 2, 132, (16, 128)),  # bf16 beyond 10 classes: 8-byte packs
    (40, 3, 1024, 2, 132, (40, 1)),        # short S: a run a sample
    (40, 3, 1024, 4, 132, (40, 1)),
    (5, 9, 98304, 2, 132, (5, 1)),         # more strips than CTA slots: one run
    (1000, 1, 512, 4, 4, (8, 125)),
])
def test_hmix_plan_fills_one_wave(S, C, Dp, itemsize, sms, plan):
    """K1's runs of samples: every run non-empty and all S covered, and
    strips x runs at most HMIX_RESIDENT CTAs an SM (one wave), as many
    runs as fit; a strip is HMIX_THREADS packs of 16 bytes, or of 8 for
    bf16 beyond 10 classes."""
    runs, rps = tg.hmix_plan(S, C, Dp, itemsize, sms)
    assert (runs, rps) == plan
    assert (runs - 1) * rps < S <= runs * rps
    pack = tg.hmix_pack_values(C, itemsize) * itemsize
    assert pack == (8 if itemsize == 2 and C > 10 else 16)
    strips = -(-Dp * itemsize // (pack * tg.HMIX_THREADS))
    assert runs == 1 or strips * runs <= tg.HMIX_RESIDENT * sms


@pytest.mark.parametrize("rows,block,zero_col", [
    (200, 64, 5),    # several blocks, ragged last block (200 = 3*64 + 8)
    (50, 64, 0),     # rows < block: one block of rows rounded up to 32
    (96, 32, 130),   # exact blocks, zero column in the second slab
])
def test_quantize_tiled_matches_pallas(rows, block, zero_col):
    """Q and s bit-equal: absmax/127 scales, reciprocal multiply, round
    half to even, scale 1 for a zero column — identical float ops."""
    rng = np.random.default_rng(rows)
    tile, n = 128, 2
    X = rng.standard_normal((rows, n * tile)).astype(np.float32)
    X[:, zero_col] = 0.0
    Xb = bf16(X)
    Q_j, s_j = jg.quantize_tiled(
        jnp.asarray(rows_to_slabs(Xb.float().numpy(), tile), jnp.bfloat16),
        block, interpret=True)
    Q_t, s_t = tg.quantize_tiled(Xb, block)
    np.testing.assert_array_equal(Q_t.numpy(), slabs_to_rows(Q_j))
    np.testing.assert_array_equal(s_t.numpy(), slabs_to_rows(s_j))
    assert np.all(s_t.numpy()[:, zero_col] == 1.0)


@pytest.mark.parametrize("rows,block", [(200, 64), (50, 64), (96, 32), (520, 2048)])
def test_quantize_tiled_plain_is_kmajor_view(rows, block):
    """quantize_tiled returns the kernel's K-major layout on the CPU too: Q
    is Qt[:, :Bp].T for Qt (Dp, ldq), ldq = Bp rounded up to QTILE, zero
    codes past Bp; its values are the Pallas quantiser's."""
    rng = np.random.default_rng(rows + block)
    tile, n = 128, 2
    Xb = bf16(rng.standard_normal((rows, n * tile)).astype(np.float32))
    Q, s = tg.quantize_tiled(Xb, block)
    BS = tg.quant_block(rows, block)
    Bp = -(-rows // BS) * BS
    ldq = -(-Bp // tg.QTILE) * tg.QTILE
    assert Q.shape == (Bp, n * tile) and Q.stride() == (1, ldq)
    Qt = torch.as_strided(Q, (n * tile, ldq), (ldq, 1))
    assert not Qt[:, Bp:].any()
    assert torch.equal(Qt[:, :Bp], Q.T)
    Q_j, s_j = jg.quantize_tiled(
        jnp.asarray(rows_to_slabs(Xb.float().numpy(), tile), jnp.bfloat16),
        block, interpret=True)
    np.testing.assert_array_equal(Q.numpy(), slabs_to_rows(Q_j))
    np.testing.assert_array_equal(s.numpy(), slabs_to_rows(s_j))


@pytest.mark.parametrize("BS,W", [(32, 32), (544, 32), (2048, 32), (4096, 16), (8192, 8)])
def test_quant_strip_fits_the_kernel(BS, W):
    """The quantiser's strip: 32 columns while the block's 16 x 8 units fit
    the kernel's 512 threads, narrower for longer blocks."""
    assert tg.quant_strip(BS) == W
    assert BS // 16 * (W // 8) <= tg.QUANT_THREADS


def test_quant_strip_rejects_longer_blocks():
    with pytest.raises(ValueError):
        tg.quant_strip(16384)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 32])
@pytest.mark.parametrize("band", [False, True])
def test_int8_pair_table_covers_upper_slab_pairs(n, band):
    """The int8 Gram's table of 128-tiles (slab_tiles = 4): every tile of
    every upper 512-slab pair p <= q exactly once, swap constant within a
    slab pair and set for the band's far pairs (2 (q - p) > n) only, the
    tiles listed in GROUP x GROUP blocks."""
    st = tg.TILE // tg.QTILE
    t = tg._pair_table_np(n * st, st, band)
    ti, tj, sw = t[:, 0], t[:, 1], t[:, 2]
    assert len({(a, b) for a, b in zip(ti, tj)}) == len(t)
    want = {(a, b) for a in range(n * st) for b in range(n * st) if a // st <= b // st}
    assert set(zip(ti.tolist(), tj.tolist())) == want
    p, q = ti // st, tj // st
    for pq in set(zip(p.tolist(), q.tolist())):
        sel = (p == pq[0]) & (q == pq[1])
        assert len(set(sw[sel].tolist())) == 1
        assert sw[sel][0] == int(band and 2 * (pq[1] - pq[0]) > n)
    blocks = np.stack([ti // tg.GROUP, tj // tg.GROUP], 1)
    keys = blocks[:, 0] * (n * st) + blocks[:, 1]
    assert np.all(np.diff(keys) >= 0)


@pytest.mark.parametrize("cluster_rows", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 13, 25, 127])
def test_cluster_table_covers_upper_tiles_once(n, cluster_rows):
    """The clustered bf16 Gram's table: whole clusters of cluster_rows x 2
    CTAs in rank order (rank 2 i + j on tile (cluster_rows si + i, 2 sj +
    j), so a cluster row shares ti and a cluster column tj), and its stored
    tiles are every upper tile ti <= tj < n exactly once."""
    t = tg._cluster_table_np(n, cluster_rows)
    size = 2 * cluster_rows
    assert t.dtype == np.int32 and len(t) % size == 0
    c = t.reshape(-1, size, 3)
    i, j = np.divmod(np.arange(size), 2)
    si, sj = c[:, 0, 0] // cluster_rows, c[:, 0, 1] // 2
    assert np.all(c[:, 0, 0] % cluster_rows == 0) and np.all(c[:, 0, 1] % 2 == 0)
    assert np.array_equal(c[:, :, 0], cluster_rows * si[:, None] + i)
    assert np.array_equal(c[:, :, 1], 2 * sj[:, None] + j)
    assert len({(a, b) for a, b in zip(si, sj)}) == len(c)
    stored = [(a, b) for a, b, st in t.tolist() if st]
    assert len(stored) == len(set(stored))
    assert set(stored) == {(a, b) for a in range(n) for b in range(a, n)}


@pytest.mark.parametrize("cluster_rows", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 12, 13, 30, 127])
def test_cluster_table_skips_lower_and_past_d_and_walks_group_blocks(n, cluster_rows):
    """Only a tile below the diagonal (the lower tile of a 2 x 2 cluster on
    the diagonal) or past the last tile over D is not stored; no cluster
    holds no stored tile; clusters are listed in GROUP x GROUP-tile blocks,
    then in row order within a block (as the split Gram's upper table)."""
    t = tg._cluster_table_np(n, cluster_rows)
    ti, tj, st = t[:, 0], t[:, 1], t[:, 2]
    assert np.array_equal(st.astype(bool), (ti <= tj) & (tj < n))
    c = t.reshape(-1, 2 * cluster_rows, 3)
    assert np.all(c[:, :, 2].any(axis=1))
    if cluster_rows == 2:
        lower = c[:, 2]  # rank 2: tile (2 si + 1, 2 sj)
        diag = c[:, 0, 0] == c[:, 0, 1]
        assert np.array_equal(lower[:, 0] > lower[:, 1], diag)
        assert not np.any(lower[diag, 2])
        below = t[ti > tj]
        assert np.array_equal(below[:, 0], below[:, 1] + 1) and np.all(below[:, 0] % 2 == 1)
    first = c[:, 0]
    blocks = np.stack([first[:, 0] // tg.GROUP, first[:, 1] // tg.GROUP], 1)
    keys = blocks[:, 0] * n + blocks[:, 1]
    assert np.all(np.diff(keys) >= 0)
    for key in np.unique(keys):
        rows = first[keys == key]
        order = rows[:, 0] * (2 * n) + rows[:, 1]
        assert np.all(np.diff(order) > 0)


@pytest.mark.parametrize("dtype,ld,addresses,kernel", [
    (torch.float32, 16384, (0, 0), "tf32x3"),
    (torch.float32, 137, (4, 8), "tf32x3"),
    (torch.bfloat16, 16384, (0, 1 << 20), "cluster"),
    (torch.bfloat16, 1024, (16, 32), "cluster"),
    (torch.bfloat16, 8, (256, 256), "cluster"),
    (torch.bfloat16, 137, (0, 0), "split"),
    (torch.bfloat16, 140, (0, 0), "split"),
    (torch.bfloat16, 1028, (0, 0), "split"),
    (torch.bfloat16, 1024, (8, 0), "split"),
    (torch.bfloat16, 1024, (0, 2), "split"),
])
def test_k6_kernel_route(dtype, ld, addresses, kernel):
    """K6's route from what gram_pair can observe: f32 to the 3xTF32 Gram;
    bf16 to the clustered Gram where TMA can address both operands (row
    stride a multiple of 8 values, 16-byte-aligned bases), else to the split
    Gram (the 137-wide case of the card tests among them)."""
    assert tg.k6_kernel(dtype, ld, *addresses) == kernel


def test_gram_pair_band_q_plain_takes_any_layout():
    """On the CPU the int8 Gram's plain version gives the same bits for the
    K-major view quantize_tiled returns and for a row-major copy of it."""
    rng = np.random.default_rng(11)
    Xb, Kb = (bf16(rng.standard_normal((96, 1024)).astype(np.float32)) for _ in range(2))
    Q1, s1 = tg.quantize_tiled(Xb, 32)
    Q2, s2 = tg.quantize_tiled(Kb, 32)
    A = tg.gram_pair_band_q(Q1, s1, Q2, s2, torch.zeros((1024, 1024)))
    B = tg.gram_pair_band_q(Q1.contiguous(), s1, Q2.contiguous(), s2,
                            torch.zeros((1024, 1024)))
    assert torch.equal(A, B)


def _int8_operands(rng, n, rows, nb):
    Dp = n * tg.TILE
    Q1 = rng.integers(-127, 128, (rows, Dp)).astype(np.int8)
    Q2 = rng.integers(-127, 128, (rows, Dp)).astype(np.int8)
    s1 = rng.uniform(1e-3, 1e-1, (nb, Dp)).astype(np.float32)
    s2 = rng.uniform(1e-3, 1e-1, (nb, Dp)).astype(np.float32)
    return Q1, s1, Q2, s2


def _to_jax_q(Q, s):
    return (jnp.asarray(rows_to_slabs(Q, tg.TILE)),
            jnp.asarray(rows_to_slabs(s, tg.TILE)))


@pytest.mark.parametrize("n", [3, 4])  # odd and even slab counts
def test_gram_pair_band_q_chained_matches_pallas(n):
    """Two chained chunks through K3 and the finisher equal the reference
    band kernel + mirror_band exactly: the block dots are exact integers,
    the per-block rescale and the carry adds are the same f32 operations in
    the same order, and far slab pairs take the band's orientation."""
    rng = np.random.default_rng(n)
    rows, nb = 64, 2
    Dp = n * tg.TILE
    acc_j = jnp.zeros((Dp, Dp), jnp.float32)
    acc_t = torch.zeros((Dp, Dp))
    for _ in range(2):
        Q1, s1, Q2, s2 = _int8_operands(rng, n, rows, nb)
        acc_j = jg.gram_pair_band_q(*_to_jax_q(Q1, s1), *_to_jax_q(Q2, s2),
                                    acc_j, interpret=True, tile=tg.TILE)
        out = tg.gram_pair_band_q(torch.tensor(Q1), torch.tensor(s1),
                                  torch.tensor(Q2), torch.tensor(s2), acc_t)
        assert out is acc_t  # the carry is updated in place
    A_j = np.asarray(jg.mirror_band(acc_j, n, tg.TILE))
    A_t = tg.mirror_band(acc_t).numpy()
    np.testing.assert_array_equal(A_t, A_j)


def test_gram_pair_tiled_q_matches_pallas():
    """K4 (no carry, natural orientation), mirrored elementwise on both
    sides: exact for the same reasons as the band test."""
    rng = np.random.default_rng(7)
    n, rows, nb = 2, 96, 3
    Q1, s1, Q2, s2 = _int8_operands(rng, n, rows, nb)
    A_j = jg.gram_pair_tiled_q(*_to_jax_q(Q1, s1), *_to_jax_q(Q2, s2),
                               interpret=True, tile=tg.TILE, mirror=True)
    A_t = tg.mirror_gram(tg.gram_pair_tiled_q(
        torch.tensor(Q1), torch.tensor(s1), torch.tensor(Q2), torch.tensor(s2)))
    np.testing.assert_array_equal(A_t.numpy(), np.asarray(A_j))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gram_pair_carry_matches_pallas_tiled_add(dtype):
    """The float Gram with a carry (K6 with K5 folded in) against
    gram_pair_tiled + add_packed_upper + mirror_gram over two chunks.
    rtol 1e-5 of max|A|: f32 sums over the rows in another order (bf16
    operand products are exact in f32, so both dtypes share it)."""
    rng = np.random.default_rng(1 if dtype == "f32" else 2)
    rows, tile, n = 96, 128, 3
    D, Dp = 300, n * tile
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    acc_j = jnp.zeros((Dp, Dp), jnp.float32)
    acc_t = torch.zeros((Dp, Dp))
    for _ in range(2):
        J = np.zeros((rows, Dp), np.float32)
        J[:, :D] = rng.standard_normal((rows, D))
        K = np.zeros((rows, Dp), np.float32)
        K[:, :D] = rng.standard_normal((rows, D))
        A = jg.gram_pair_tiled(jnp.asarray(rows_to_slabs(J, tile), jd),
                               jnp.asarray(rows_to_slabs(K, tile), jd),
                               interpret=True, tile=tile, block=32)
        acc_j = jg.add_packed_upper(acc_j, A, tile=tile, interpret=True)
        tg.gram_pair(torch.tensor(J).to(td), torch.tensor(K).to(td), acc=acc_t)
    A_j = np.asarray(jg.mirror_gram(acc_j[:D, :D]))
    A_t = tg.mirror_gram(acc_t[:D, :D]).numpy()
    np.testing.assert_allclose(A_t, A_j, rtol=0, atol=1e-5 * np.abs(A_j).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gram_pair_flat_matches_pallas(dtype):
    """K10: flat symmetric Gram of a ragged (rows, D) pair, mirrored.
    rtol 1e-5 of max|A| (summation order)."""
    rng = np.random.default_rng(3)
    rows, D = 90, 150
    J = rng.standard_normal((rows, D)).astype(np.float32)
    W = rng.standard_normal((rows, rows)).astype(np.float32) * 0.1
    K = (W + W.T) @ J  # symmetric weighting keeps JᵀK symmetric
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    A_j = np.asarray(jg.gram_pair(jnp.asarray(J, jd), jnp.asarray(K, jd),
                                  interpret=True, symmetric=True))
    A_t = tg.mirror_gram(tg.gram_pair(torch.tensor(J).to(td),
                                      torch.tensor(K).to(td))).numpy()
    np.testing.assert_allclose(A_t, A_j, rtol=0, atol=1e-5 * np.abs(A_j).max())


def split_pair_sum(X, Y, splits):
    """K10 as the split kernel sums it, in plain PyTorch: A = sum_z X_zᵀ Y_z
    over the row ranges that tg.split_rows plans, each partial Gram in f32,
    added in split order in f32."""
    n, rps = tg.split_rows(X.shape[0], splits)
    A = None
    for z in range(n):
        rs = slice(z * rps, (z + 1) * rps)
        part = X[rs].float().T @ Y[rs].float()
        A = part if A is None else A + part
    return A, n


@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_gram_pair_matches_pallas(dtype, splits):
    """K10 in the split kernel's order of sums against the Pallas gram_pair
    (symmetric: upper tiles, mirrored) at a ragged shape — 333 rows, D=137,
    Y unrelated to X, so only the upper triangle of XᵀY is the result on
    both sides. rtol 1e-5 of max|A|: f32 sums over at most 333 rows in
    another order (bf16 products are exact in f32)."""
    rng = np.random.default_rng(50 + splits)
    rows, D = 333, 137
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    X = torch.tensor(rng.standard_normal((rows, D)).astype(np.float32)).to(td)
    Y = torch.tensor(rng.standard_normal((rows, D)).astype(np.float32)).to(td)
    A_j = np.asarray(jg.gram_pair(jnp.asarray(X.float().numpy(), jd),
                                  jnp.asarray(Y.float().numpy(), jd),
                                  interpret=True, symmetric=True))
    A_t, n = split_pair_sum(X, Y, splits)
    assert n == splits
    A_t = tg.mirror_gram(A_t).numpy()
    np.testing.assert_allclose(A_t, A_j, rtol=0, atol=1e-5 * np.abs(A_j).max())
    # the wrapper's plain version on the CPU agrees as well
    A_w = tg.mirror_gram(tg.gram_pair(X, Y, splits=splits)).numpy()
    np.testing.assert_allclose(A_w, A_j, rtol=0, atol=1e-5 * np.abs(A_j).max())


def test_port_never_imports_jax():
    """The GPU machine has no JAX: no module of the port, and not
    chip_smoke.py, may import it, flax, optax or the JAX package."""
    offenders = []
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                          "tensornetworksfork_tpu"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders


def test_launch_counters_and_kernel_source():
    """Every wrapper has a counter; plain versions (CPU tensors) never count;
    the kernel sources (csrc/gram.cu, csrc/wgram.cu) exist and define every
    entry point the loader binds."""
    from tensornetworksfork_tpu_torch.ops.cuda import _build
    assert set(tg.LAUNCHES) == {"retile_hmix", "quantize_tiled",
                                "gram_pair_q", "gram_pair", "gram_pair_tiled",
                                "gram_pair_tiled_cluster", "retile_rows",
                                "weighted_gram_tiled", "weighted_gram",
                                "own_out_gram"}
    tg.reset_launches()
    assert all(v == 0 for v in tg.LAUNCHES.values())
    J = bf16(np.ones((4, 2, 10), np.float32))
    H = torch.ones((4, 2, 2))
    Jt, Kt, _ = tg.retile_hmix(J, H, 512, bf16(np.ones(8, np.float32)))
    Q, s = tg.quantize_tiled(Jt)
    tg.gram_pair_band_q(Q, s, Q, s, torch.zeros((512, 512)))
    tg.gram_pair(Jt, Kt)
    h = torch.ones(8)
    Jr, _ = tg.retile_rows(Jt, 512, h)
    tg.weighted_gram_tiled(Jr, h, torch.zeros((512, 512)))
    tg.weighted_gram(Jt, h)
    tg.own_out_gram(Jr, H.repeat(2, 1, 1), 2, 10)
    assert all(v == 0 for v in tg.LAUNCHES.values())
    srcs = _build.sources()
    assert {PKG / "csrc" / "gram.cu", PKG / "csrc" / "wgram.cu"} <= set(srcs)
    text = "".join(src.read_text() for src in srcs)
    for name in _build._SIGNATURES:
        assert re.search(rf"\bint {name}\(", text), name
    assert "--use_fast_math" not in _build.NVCC_FLAGS


@pytest.mark.parametrize("status,text", [(-1, "no cuTensorMapEncodeTiled"),
                                         (-1001, "CUresult 1"), (1, "cudaError 1")])
def test_launch_status_raises(status, text):
    """An entry point's nonzero status raises with what failed: the TMA
    encoder missing, a tensor map refused (its CUresult) or a launch."""
    tg._raise_on(0, "k")
    with pytest.raises(RuntimeError, match=text):
        tg._raise_on(status, "k")


def test_wrappers_reject_other_devices():
    """A tensor that is neither on the CPU nor on CUDA raises instead of
    silently taking the plain version."""
    X = torch.empty((64, 512), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tg.quantize_tiled(X)


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """On a CUDA card: each kernel against its plain version (chip_smoke's
    kernel phase at small, ragged shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.check_kernels(torch.device("cuda"), S=40, D=700, rows4=333, D4=137)


def test_k10_float64_check_sees_rounded_operands():
    """chip_smoke's float64 check of K10 in f32: the plain f32 Gram of
    full-mantissa f32 operands stays under PAIR_BOUND, and the same operands
    rounded to bf16 or to TF32 (10 mantissa bits, to nearest) fail it by a
    wide margin, so a kernel that rounds its f32 operands cannot pass."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 3 * 2 ** -11)])
    assert chip_smoke.tf32_round(x).tolist() == [1 + 2 ** -10, 1.0, -(1 + 2 ** -9)]
    rng = np.random.default_rng(70)
    X, Y = (torch.tensor(rng.standard_normal((333, 137), np.float32) * 0.05)
            for _ in range(2))
    A64, scale = chip_smoke.pair_float64(X, Y)
    bound = chip_smoke.PAIR_BOUND
    assert chip_smoke.pair_errors(tg.gram_pair(X, Y), A64, scale)[1] <= bound
    for rnd in (lambda t: t.to(torch.bfloat16), chip_smoke.tf32_round):
        B = tg.gram_pair(rnd(X), rnd(Y))
        assert chip_smoke.pair_errors(B, A64, scale)[1] > 10 * bound


def tf32x_gram(X, Y, terms):
    """XᵀY as a kernel on the TF32 tensor cores forms it from split operands,
    in plain f32: x = hi + lo, hi = x rounded to TF32 (to nearest), lo =
    x - hi (exact in f32) rounded to TF32 again. terms = 3: lo_xᵀhi_y +
    hi_xᵀlo_y + hi_xᵀhi_y (3xTF32, small products first); 2: without
    lo_xᵀhi_y; 1: hi_xᵀhi_y alone (plain TF32)."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rnd = chip_smoke.tf32_round
    (xh, yh) = (rnd(X), rnd(Y))
    (xl, yl) = (rnd(X - xh), rnd(Y - yh))
    parts = [(xl, yh), (xh, yl), (xh, yh)][3 - terms:]
    A = None
    for a, b in parts:
        P = a.T @ b
        A = P if A is None else A + P
    return A


@pytest.mark.parametrize("rows,D", [(333, 137), (4096, 64)])
def test_k6_3xtf32_numerics_pass_float64_check(rows, D):
    """K6 in f32 runs on the 3xTF32 kernel: its numerics, emulated in plain
    f32, pass chip_smoke's float64 check (PAIR_BOUND), while 1xTF32 and
    2xTF32 (one side's low part dropped) fail it, so the check on the card
    tells a 3xTF32 kernel from a cheaper one."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(rows)
    X, Y = (torch.tensor(rng.standard_normal((rows, D), np.float32) * 0.05)
            for _ in range(2))
    A64, scale = chip_smoke.pair_float64(X, Y)
    bound = chip_smoke.PAIR_BOUND
    assert chip_smoke.pair_errors(tf32x_gram(X, Y, 3), A64, scale)[1] <= bound
    for terms in (1, 2):
        assert chip_smoke.pair_errors(tf32x_gram(X, Y, terms), A64, scale)[1] > 2 * bound


@pytest.mark.parametrize("name", ["gram_pair", "weighted_gram", "retile_rows",
                                  "quantize_tiled"])
def test_launch_wrappers_refuse_operands_on_different_devices(name):
    """Every launching wrapper takes its device from its operands and
    raises when they lie on different devices (here the CPU and the meta
    device, so the check runs without a card)."""
    X = torch.zeros((64, 64))
    other = torch.zeros((64, 64), device="meta")
    calls = {"gram_pair": lambda: tg.gram_pair(X, other),
             "weighted_gram": lambda: tg.weighted_gram(X, other[:, 0]),
             "retile_rows": lambda: tg.retile_rows(X, 128, other[:, 0]),
             "quantize_tiled": lambda: tg.quantize_tiled(X.to("meta"))}
    if name == "quantize_tiled":
        # one operand: its device is the launch's, and meta is not a card's
        with pytest.raises(ValueError, match="unsupported device type"):
            calls[name]()
        return
    with pytest.raises(ValueError, match="different devices"):
        calls[name]()
