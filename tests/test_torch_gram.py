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


def test_retile_hmix_matches_pallas():
    """Jt equal; Kt within 1 bf16 ulp — K is mixed in f32 and rounded once
    on both sides, but the reference builds its ragged tail tile with an XLA
    einsum whose summation order may move that one rounding."""
    rng = np.random.default_rng(0)
    S, C, D, tile = 64, 3, 300, 128  # two full 128-tiles + a ragged tail
    n = (D + tile - 1) // tile
    J = rng.standard_normal((S, C, D)).astype(np.float32)
    h = rng.standard_normal((S, C, C)).astype(np.float32)
    H = (h + h.transpose(0, 2, 1)) / 2
    J_bf = jnp.asarray(J, jnp.bfloat16)
    Jt_j, Kt_j = jg.retile_hmix(J_bf, jnp.asarray(H), n, tile, interpret=True)
    # (n, C, S, tile) -> class-major rows (C*S, n*tile)
    to_rows = lambda a: np.asarray(a.astype(jnp.float32)).transpose(
        1, 2, 0, 3).reshape(C * S, n * tile)
    Jt_t, Kt_t = tg.retile_hmix(bf16(J), torch.tensor(H), n * tile)
    np.testing.assert_array_equal(Jt_t.float().numpy(), to_rows(Jt_j))
    Kj = to_rows(Kt_j)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(Kj), 1e-30))) - 7)
    assert np.all(np.abs(Kt_t.float().numpy() - Kj) <= ulp)


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


def test_port_never_imports_jax():
    """The GPU machine has no JAX: no module of the port, and not
    chip_smoke.py, may import it or the JAX package."""
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
                if name.split(".")[0] in ("jax", "jaxlib", "tensornetworksfork_tpu"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders


def test_launch_counters_and_kernel_source():
    """Every wrapper has a counter; plain versions (CPU tensors) never count;
    csrc/gram.cu exists and defines every entry point the loader binds."""
    from tensornetworksfork_tpu_torch.ops.cuda import _build
    assert set(tg.LAUNCHES) == {"retile_hmix", "quantize_tiled",
                                "gram_pair_q", "gram_pair", "gram_pair_tiled",
                                "retile_rows",
                                "weighted_gram_tiled", "weighted_gram",
                                "own_out_gram"}
    tg.reset_launches()
    assert all(v == 0 for v in tg.LAUNCHES.values())
    J = bf16(np.ones((4, 2, 10), np.float32))
    H = torch.ones((4, 2, 2))
    Jt, Kt = tg.retile_hmix(J, H, 512)
    Q, s = tg.quantize_tiled(Jt)
    tg.gram_pair_band_q(Q, s, Q, s, torch.zeros((512, 512)))
    tg.gram_pair(Jt, Kt)
    h = torch.ones(8)
    Jr, _ = tg.retile_rows(Jt, 512, h)
    tg.weighted_gram_tiled(Jr, h, torch.zeros((512, 512)))
    tg.weighted_gram(Jt, h)
    tg.own_out_gram(Jr, H.repeat(2, 1, 1), 2, 10)
    assert all(v == 0 for v in tg.LAUNCHES.values())
    src = _build.SOURCE
    assert src == PKG / "csrc" / "gram.cu" and src.exists()
    text = src.read_text()
    for name in _build._SIGNATURES:
        assert re.search(rf"\bint {name}\(", text), name
    assert "--use_fast_math" not in _build.NVCC_FLAGS


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
