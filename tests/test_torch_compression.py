"""TT data compression, the compressed-data tensor train and input-less
members of the port held against the JAX package.

Singular vectors are fixed only up to sign (and a rotation inside a
repeated singular value), and LAPACK (JAX on the CPU) and torch choose
differently, so blocks are compared as contracted products, never factor by
factor: pair contractions and whole data trains within 1e-5 x max|.|, split
errors within 1e-5 (they are shares of the singular-value sum). The data
have no near-ties at the ranks cut. Sizes are those of JAX
tests/test_ops.py:43-83 and tests/test_zoo_extra.py:149-243.

The compressed TT's data blocks are CONST nodes; a data train's contraction
over its bonds is the same in both packages, and so is every forward and
swipe over it, whichever signs the SVD picked. Layer params are the JAX
package's, carried across with `params_from_numpy`; forwards agree within
rtol 1e-5, predictions after a swipe within 1e-4 x max|pred| (the
convention of tests/test_torch_zoo.py).
"""
import string

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core.sweep import Member as JMember  # noqa: E402
from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper  # noqa: E402
from tensornetworksfork_tpu.models import layers as jl  # noqa: E402
from tensornetworksfork_tpu.ops import bregman as jb  # noqa: E402
from tensornetworksfork_tpu.ops import compression as jc  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import (  # noqa: E402
    Member, SweepConfig, Sweeper, accumulating_sweep)
from tensornetworksfork_tpu_torch.models import layers as tl  # noqa: E402
from tensornetworksfork_tpu_torch.ops import bregman as tb  # noqa: E402
from tensornetworksfork_tpu_torch.ops import compression as tc  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy  # noqa: E402

REL = 1e-5       # contracted products and split errors
FWD_RTOL = 1e-5  # forwards from the same params
PRED_REL = 1e-4  # predictions after a swipe, x max|pred|


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(),
                               err_msg=what)


def _train_tensor(blocks):
    """Contract a data train (k_i, p_i, d, k_{i+1}) over its bonds: the
    (p_1, d, ..., p_n, d, k_last) tensor, independent of the SVD's gauge."""
    letters = iter(string.ascii_letters)
    bond = next(letters)
    terms, out = [], []
    for blk in blocks:
        p, d, nxt = next(letters), next(letters), next(letters)
        terms.append(bond + p + d + nxt)
        out += [p, d]
        bond = nxt
    expr = ",".join(terms) + "->" + "".join(out) + bond
    return np.einsum(expr, *[np.asarray(b, np.float64) for b in blocks])


def _t(blocks):
    return [b.numpy() for b in blocks]


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


# ---------------------------------------------------------------- compress
@pytest.mark.parametrize("rank,cut_off", [(8, None), (2, None), (8, 0.2)])
def test_compress_pair_matches_jax(rank, cut_off):
    """compress: the rebuilt pair contraction and split_err (test_ops.py:43
    sizes; rank 2 and a cut-off truncate)."""
    rng = np.random.default_rng(2)
    bl = rng.standard_normal((1, 3, 1, 8)).astype(np.float32)
    br = rng.standard_normal((8, 3, 1, 2)).astype(np.float32)
    uj, vj, ej = jc.compress(jnp.asarray(bl), jnp.asarray(br), rank=rank, cut_off=cut_off)
    ut, vt, et = tc.compress(torch.tensor(bl), torch.tensor(br), rank=rank, cut_off=cut_off)
    assert ut.shape == uj.shape and vt.shape == vj.shape
    pair = "abcd,defg->abcefg"
    _close(np.einsum(pair, ut.numpy(), vt.numpy()),
           np.einsum(pair, np.asarray(uj), np.asarray(vj)), REL, "pair")
    assert abs(et - ej) <= REL


def test_concat_and_train_concat_match_jax():
    """concat is the block-diagonal direct sum (bonds of size 1 shared):
    bit-equal to the JAX package's."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 3, 1, 4)).astype(np.float32)
    b = rng.standard_normal((3, 3, 1, 5)).astype(np.float32)
    c = rng.standard_normal((1, 3, 1, 5)).astype(np.float32)
    for x, y in ((a, b), (a, c), (c, b)):
        np.testing.assert_array_equal(tc.concat(torch.tensor(x), torch.tensor(y)).numpy(),
                                      np.asarray(jc.concat(jnp.asarray(x), jnp.asarray(y))))
    with pytest.raises(ValueError):
        tc.train_concat([torch.tensor(a)], [])


def test_feature_split_matches_jax():
    """feature_split of a (2, 12, 1, 5) block into 2 x 3 x 2: the contracted
    split blocks rebuild the same block, with the same mean split_err."""
    rng = np.random.default_rng(6)
    blk = rng.standard_normal((2, 12, 1, 5)).astype(np.float32)
    bj, ej = jc.feature_split(jnp.asarray(blk), (2, 3, 2), rank=5)
    bt, et = tc.feature_split(torch.tensor(blk), (2, 3, 2), rank=5)
    assert [tuple(b.shape) for b in bt] == [b.shape for b in bj]

    def full(blocks):
        return np.einsum("abzc,cdye,efgh->abdfgh", *[np.asarray(b) for b in blocks])
    _close(full(_t(bt)), full(bj), REL, "feature_split")
    assert abs(et - ej) <= REL


# ------------------------------------------------------- DataCompression
def _modes():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((32, 3)).astype(np.float32)
    X4 = rng.standard_normal((16, 4)).astype(np.float32)
    return {
        "non_compressed": (X, lambda dc: dc.non_compressed(degree=3)),
        "non_compressed_batch": (X, lambda dc: dc.non_compressed(
            degree=2, batch_index=1, batch_size=8)),
        "sequential": (X, lambda dc: dc.sequential_compress(batch_size=8, degree=3,
                                                            rank=10)),
        "parallel": (X, lambda dc: dc.parallel_compress(batch_size=8, degree=2,
                                                        rank=6)),
        "feature": (X4, lambda dc: dc.feature_compress(batch_size=8, degree=2,
                                                       feature_dim=(2, 2), rank=6)),
    }


@pytest.mark.parametrize("mode", list(_modes()))
def test_data_compression_modes_match_jax(mode):
    """Every DataCompression mode (test_ops.py:59-75 sizes): the same block
    shapes, and the data train contracted over its bonds within 1e-5 x
    max|.| of the JAX package's."""
    X, call = _modes()[mode]
    bj = call(jc.DataCompression(X))
    bt = call(tc.DataCompression(X, device="cpu"))
    assert [tuple(b.shape) for b in bt] == [b.shape for b in bj]
    assert bt[-1].shape[-1] == bj[-1].shape[-1]  # the sample axis
    _close(_train_tensor(_t(bt)), _train_tensor(bj), REL, mode)


def test_train_compress_errors_match_jax():
    """train_compress over the degree-3 raw train: each pair's split_err."""
    X = np.random.default_rng(3).standard_normal((10, 3)).astype(np.float32)
    raw_j = jc.DataCompression(X).non_compressed(degree=3)
    raw_t = tc.DataCompression(X, device="cpu").non_compressed(degree=3)
    for rank in (30, 4):
        bj, ej = jc.train_compress(list(raw_j), rank=rank)
        bt, et = tc.train_compress(list(raw_t), rank=rank)
        np.testing.assert_allclose(et, ej, rtol=0, atol=REL)
        _close(_train_tensor(_t(bt)), _train_tensor(bj), REL, f"rank {rank}")


# ----------------------------------------------- the compressed-data TT
def _compressed_layers(seed=7, S=64, f=4):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((S, f - 1)).astype(np.float32),
                        np.ones((S, 1), np.float32)], axis=1)
    bj, _ = jc.train_compress(list(jc.DataCompression(X).non_compressed(degree=2)),
                              rank=16)
    bt, _ = tc.train_compress(
        list(tc.DataCompression(X, device="cpu").non_compressed(degree=2)), rank=16)
    jlayer = jl.CompressedTensorTrainLayer(bj, bond_dim=4, output_shape=(1,), seed=0)
    tlayer = tl.CompressedTensorTrainLayer(bt, bond_dim=4, output_shape=(1,), seed=0,
                                           device="cpu")
    return X, jlayer, tlayer


def test_compressed_tt_forward_and_swipe_match_jax():
    """CompressedTensorTrainLayer (test_zoo_extra.py:149): the same topology
    (no input node), the forward within rtol 1e-5 and one swipe's
    predictions within 1e-4 x max|pred|, through accumulating_sweep."""
    X, jlayer, tlayer = _compressed_layers()
    y = (X[:, 0] * X[:, 1]).reshape(-1, 1).astype(np.float32)
    assert not tlayer.topology.input_nodes
    assert tlayer.topology.node_axes == jlayer.topology.node_axes
    p0 = params_from_numpy(_np(jlayer.params), device="cpu")
    np.testing.assert_allclose(tlayer({}, params=p0).numpy(), np.asarray(jlayer({})),
                               rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(np.asarray(jlayer({}))).max())
    cfg = dict(num_swipes=1, method="ridge_cholesky", eps=1e-5)
    from tensornetworksfork_tpu.core.sweep import accumulating_sweep as jsweep
    pj, okj = jsweep(jlayer.network, jlayer.params, {}, jnp.asarray(y),
                     jb.SquareBregFunction(), JConfig(**cfg))
    pt, okt = accumulating_sweep(tlayer.network, p0, {}, torch.tensor(y),
                                 tb.SquareBregFunction(), SweepConfig(**cfg))
    assert okj and okt
    _close(tlayer.network.forward(pt, {}).numpy(),
           np.asarray(jlayer.network.forward(pj, {})), PRED_REL, "swipe")


@pytest.mark.parametrize("batch", [-1, 32])
def test_sum_with_inputless_member_matches_jax(batch):
    """A type-I sum of a compressed-data TT (no input node) and a one-core
    TT, at batch -1 and 32 (test_zoo_extra.py:215): one swipe's predictions
    within 1e-4 x max|pred|. The input-less member takes the standalone
    full-batch update with the other member's cached output as its rest;
    its own padded, chunked forward is the other's rest."""
    rng = np.random.default_rng(9)
    S, f = 64, 4
    X = np.concatenate([rng.standard_normal((S, f - 1)).astype(np.float32),
                        np.ones((S, 1), np.float32)], axis=1)
    y = ((X[:, 0] * X[:, 1]) + 0.5 * X[:, 2]).reshape(S, 1).astype(np.float32)
    bj, _ = jc.train_compress(list(jc.DataCompression(X).non_compressed(degree=2)),
                              rank=16)
    bt, _ = tc.train_compress(
        list(tc.DataCompression(X, device="cpu").non_compressed(degree=2)), rank=16)
    jc_l = jl.CompressedTensorTrainLayer(bj, bond_dim=4, output_shape=(1,), seed=0)
    jt_l = jl.TensorTrainLayer(1, 1, f, output_shape=(1,), seed=1)
    tc_l = tl.CompressedTensorTrainLayer(bt, bond_dim=4, output_shape=(1,), seed=0,
                                         device="cpu")
    tt_l = tl.TensorTrainLayer(1, 1, f, output_shape=(1,), seed=1, device="cpu")
    cfg = dict(num_swipes=1, method="ridge_cholesky", eps=1e-5, batch_size=batch)
    pj, okj = JSweeper([JMember(jc_l.network, lambda x: {}), JMember(jt_l.network)],
                       jb.SquareBregFunction(), JConfig(**cfg)).run(
        [dict(jc_l.params), dict(jt_l.params)], jnp.asarray(X), jnp.asarray(y))
    p0 = [params_from_numpy(_np(jc_l.params), device="cpu"),
          params_from_numpy(_np(jt_l.params), device="cpu")]
    pt, okt = Sweeper([Member(tc_l.network, lambda x: {}), Member(tt_l.network)],
                      tb.SquareBregFunction(), SweepConfig(**cfg)).run(
        p0, torch.tensor(X), torch.tensor(y))
    assert okj and okt
    pred_j = (np.asarray(jc_l.network.forward(pj[0], {}))
              + np.asarray(jt_l.network.forward(pj[1], jnp.asarray(X))))
    pred_t = (tc_l.network.forward(pt[0], {})
              + tt_l.network.forward(pt[1], torch.tensor(X))).numpy()
    _close(pred_t, pred_j, PRED_REL, f"batch {batch}")


def test_concatenate_trains_matches_jax():
    """concatenate_trains (test_zoo_extra.py:173): the merged TT's forward
    from the JAX members' params within rtol 1e-5 of the JAX merge's, and
    it computes the members' mean."""
    f = 4
    jls = [jl.TensorTrainLayer(2, 3, f, output_shape=(1,), constrict_bond=False,
                               seed=s) for s in (0, 1)]
    tls = [tl.TensorTrainLayer(2, 3, f, output_shape=(1,), constrict_bond=False,
                               seed=s, device="cpu") for s in (0, 1)]
    for j, t in zip(jls, tls):
        t.params = params_from_numpy(_np(j.params), device="cpu")
    mj, mt = jl.concatenate_trains(jls), tl.concatenate_trains(tls)
    assert {k: tuple(v.shape) for k, v in mt.params.items()} == \
        {k: v.shape for k, v in mj.params.items()}
    x = np.random.default_rng(8).standard_normal((5, f)).astype(np.float32)
    want = np.asarray(mj(jnp.asarray(x)))
    got = mt(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(want).max())
    mean = (tls[0](torch.tensor(x)) + tls[1](torch.tensor(x))).numpy() / 2
    np.testing.assert_allclose(got, mean, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_compression_on_cuda_tensors_stays_there():
    """DataCompression and compress keep their blocks on the card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    X = np.random.default_rng(0).standard_normal((16, 3)).astype(np.float32)
    blocks = tc.DataCompression(X, device="cuda").sequential_compress(8, 2, rank=4)
    assert all(b.is_cuda for b in blocks)
