"""The bf16 aux tier (TNF_AUX_PRECISION=default; PRECISION=fast|fastest)
and the high / default dot precisions (TNF_AUX_PRECISION=high,
Network(precision=)): the port against the JAX package on the CPU.

On a TPU a DEFAULT-precision dot rounds its operands to bf16 and sums the
products in f32; a HIGH-precision dot (bf16x3) splits each f32 operand
into hi = bf16(a) and lo = bf16(a - hi) and sums the three products
hi·hi, hi·lo and lo·hi in f32. XLA on the CPU ignores both and runs the
dot in f32, so the JAX side is made to round as the TPU does in one of two
ways: its operands are rounded to bf16 before the call (a single product),
or `tpu_default_dots` wraps the `dot_general` behind `jax.lax.dot_general`
and `jnp.einsum` for the test's duration, rounding the operands of every
dot asked for at DEFAULT precision and splitting those of every dot asked
for at HIGH (products chained through rounded intermediates). Nothing in
the JAX package changes.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core import contract as jcon  # noqa: E402
from tensornetworksfork_tpu.core.engine import Network as JNetwork  # noqa: E402
from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper  # noqa: E402
from tensornetworksfork_tpu.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as JLayer)
from tensornetworksfork_tpu.ops.bregman import XEBregman as JXE  # noqa: E402
from tensornetworksfork_tpu_torch.core import contract as tcon  # noqa: E402
from tensornetworksfork_tpu_torch.core.engine import Network  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as TLayer)
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman as TXE  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)


def bf16(a):
    """a (numpy f32) rounded to bf16, as f32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _is(p, want):
    if isinstance(p, (tuple, list)):
        return len(p) > 0 and all(q == want for q in p)
    return p == want


def _bf16(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32) if x.dtype == jnp.float32 else x


@pytest.fixture
def tpu_default_dots(monkeypatch):
    """The JAX package's DEFAULT dots round their f32 operands to bf16 and
    sum in f32, and its HIGH dots sum the three bf16 products of bf16x3 in
    f32, hi·hi + (hi·lo + lo·hi), as on the TPU."""
    orig = jax.lax.dot_general

    def dot(lhs, rhs, dimension_numbers, precision=None,
            preferred_element_type=None, **kw):
        def one(a, b):
            return orig(a, b, dimension_numbers, jax.lax.Precision.HIGHEST,
                        preferred_element_type=preferred_element_type, **kw)
        if _is(precision, jax.lax.Precision.DEFAULT):
            return one(_bf16(lhs), _bf16(rhs))
        if _is(precision, jax.lax.Precision.HIGH) and jnp.float32 in (lhs.dtype, rhs.dtype):
            lh, rh = _bf16(lhs), _bf16(rhs)
            ll, rl = _bf16(lhs - lh), _bf16(rhs - rh)
            return one(lh, rh) + (one(lh, rl) + one(ll, rh))
        return orig(lhs, rhs, dimension_numbers, precision,
                    preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jax.lax, "dot_general", dot)
    monkeypatch.setattr(jnp, "einsum", functools.partial(jnp.einsum, _dot_general=dot))


# two-operand contractions: a product, a batched product, an outer product
# with a batch axis, two contracted axes
PAIRS = [
    ([(0, 1), (1, 2)], (0, 2), [(37, 45), (45, 11)]),
    ([(0, 1, 2), (0, 2, 3)], (0, 3, 1), [(5, 7, 30), (5, 30, 6)]),
    ([(0, 1), (0, 2)], (0, 1, 2), [(9, 4), (9, 6)]),
    ([(0, 1, 2), (1, 2, 3)], (3, 0), [(6, 8, 9), (8, 9, 5)]),
]


@pytest.mark.parametrize("axes,keep,shapes", PAIRS)
def test_contract_default_matches_jax_on_rounded_operands(axes, keep, shapes):
    """contract(..., "default") equals the JAX contract of the
    bf16-rounded operands to f32 rounding (1e-6 of max|A|); the unrounded
    product is off by far more (so a port that skips the rounding fails
    here), and "highest" equals the unrounded product."""
    rng = np.random.default_rng(len(shapes[0]))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    got = tcon.contract([(a, torch.from_numpy(x)) for a, x in zip(axes, arrs)],
                        keep, "default").numpy()
    want = np.asarray(jcon.contract([(a, jnp.asarray(bf16(x)))
                                     for a, x in zip(axes, arrs)], keep))
    plain = np.asarray(jcon.contract([(a, jnp.asarray(x))
                                      for a, x in zip(axes, arrs)], keep))
    scale = np.abs(want).max()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    assert np.abs(got - plain).max() > 1e-4 * scale
    high = tcon.contract([(a, torch.from_numpy(x)) for a, x in zip(axes, arrs)],
                         keep).numpy()
    np.testing.assert_allclose(high, plain, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("axes,keep,shapes", PAIRS + [
    # an axis of one operand that the result drops (summed before the dot)
    ([(0, 1, 7), (1, 2)], (2, 0), [(6, 8, 3), (8, 5)]),
    # three operands: the second product rounds the first one's result
    ([(0, 1), (1, 2), (2, 3)], (0, 3), [(12, 20), (20, 15), (15, 4)]),
])
def test_contract_default_matches_jax_tpu_rounding(axes, keep, shapes,
                                                   tpu_default_dots):
    """contract(..., "default") against the JAX contract at DEFAULT with
    the TPU's rounding: 1e-6 of max|A| (f32 sums in another order)."""
    rng = np.random.default_rng(7 + len(axes))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    got = tcon.contract([(a, torch.from_numpy(x)) for a, x in zip(axes, arrs)],
                        keep, "default").numpy()
    want = np.asarray(jcon.contract([(a, jnp.asarray(x)) for a, x in zip(axes, arrs)],
                                    keep, jax.lax.Precision.DEFAULT))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_matmul_default_rounds_operands():
    """matmul at "default": the rounded operands' product in f32, for 2-D
    and batched operands, bf16 or f32; "highest" multiplies bf16 operands
    in f32."""
    rng = np.random.default_rng(3)
    for sa, sb in (((30, 40), (40, 7)), ((3, 30, 40), (3, 40, 7))):
        a = torch.from_numpy(rng.standard_normal(sa).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(sb).astype(np.float32))
        want = a.bfloat16().double() @ b.bfloat16().double()
        for x, y in ((a, b), (a.bfloat16(), b)):
            got = tcon.matmul(x, y, "default")
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                       rtol=0, atol=1e-6 * float(want.abs().max()))
        hi = tcon.matmul(a.bfloat16(), b.bfloat16())
        assert hi.dtype == torch.float32
        np.testing.assert_allclose(hi.double().numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("axes,keep,shapes", PAIRS + [
    ([(0, 1, 7), (1, 2)], (2, 0), [(6, 8, 3), (8, 5)]),
    ([(0, 1), (1, 2), (2, 3)], (0, 3), [(12, 20), (20, 15), (15, 4)]),
])
def test_contract_high_matches_jax_tpu_rounding(axes, keep, shapes, tpu_default_dots):
    """contract(..., "high") against the JAX contract at HIGH with the
    TPU's bf16x3: 1e-6 of max|A| (f32 sums in another order). Single-pass
    rounding ("default") misses it by more than 1e-4 of max|A|, so a port
    that drops the lo terms fails here."""
    rng = np.random.default_rng(11 + len(axes))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ops = [(a, torch.from_numpy(x)) for a, x in zip(axes, arrs)]
    got = tcon.contract(ops, keep, "high").numpy()
    want = np.asarray(jcon.contract([(a, jnp.asarray(x)) for a, x in zip(axes, arrs)],
                                    keep, jax.lax.Precision.HIGH))
    scale = np.abs(want).max()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    single = tcon.contract(ops, keep, "default").numpy()
    assert np.abs(single - want).max() > 1e-4 * scale


def test_matmul_high_is_bf16x3():
    """matmul at "high": the three products of the operands' bf16 parts,
    summed in f32, for 2-D and batched operands. Against float64 of the
    operands as given its error stays below 2^-18 of sum|a||b| per entry
    (measured 8.7e-7 of it: bf16x3 drops lo·lo and lo's rounding, about
    2^-17 of each product), while "default"'s exceeds it (5.1e-4): the
    product without the lo terms fails the bound. hi + lo reproduces each operand within 2^-16 of its size."""
    rng = np.random.default_rng(5)
    for sa, sb in (((30, 400), (400, 7)), ((3, 30, 400), (3, 400, 7))):
        a = torch.from_numpy(rng.standard_normal(sa).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(sb).astype(np.float32))
        exact = a.double() @ b.double()
        size = a.double().abs() @ b.double().abs()
        hi, lo = tcon.split_bf16(a)
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert float(((hi.double() + lo.double() - a.double()).abs()
                      / a.double().abs()).max()) <= 2.0 ** -16
        errs = {}
        for p in ("high", "default", "highest"):
            got = tcon.matmul(a, b, p)
            assert got.dtype == torch.float32
            errs[p] = float(((got.double() - exact).abs() / size).max())
        assert errs["high"] <= 2.0 ** -18 < errs["default"], errs
        assert errs["highest"] <= errs["high"], errs
        (ah, al), (bh, bl) = tcon.split_bf16(a), tcon.split_bf16(b)
        want = (ah.double() @ bh.double()) + (ah.double() @ bl.double()
                                              + al.double() @ bh.double())
        np.testing.assert_allclose(tcon.matmul(a, b, "high").double().numpy(), want.numpy(),
                                   rtol=0, atol=1e-6 * float(want.abs().max()))


# a small conv-TT: 3 carriages, so the middle core A2 has a left and a right
# environment and the column advance into column 1 takes the staged lowering
N, R, CB, P, PP, C, S = 3, 4, 2, 6, 5, 3, 16


def conv_pair(seed=0):
    jl = JLayer(N, R, P, PP, output_shape=(C,), convolution_bond=CB, seed=seed)
    tl = TLayer(N, R, P, PP, output_shape=(C,), convolution_bond=CB, seed=seed,
                device="cpu")
    tl.params = params_from_numpy({k: np.asarray(v) for k, v in jl.params.items()},
                                  device="cpu")
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((S, P, PP)).astype(np.float32)
    return jl, tl, X


def test_env_step_conv_fast_default_matches_jax(monkeypatch, tpu_default_dots):
    """The staged conv advance (three products, each rounding its operands)
    at the aux tier against the JAX one with the TPU's rounding: 1e-6 of
    max|env| (f32 sums in another order). The f32 result differs from it
    by far more."""
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    jl, tl, X = conv_pair()
    jnet, tnet = jl.network, tl.network
    ji, ti = jnet.bind_inputs(jnp.asarray(X)), tnet.bind_inputs(torch.from_numpy(X))
    jprev = jnet.env_step(None, 0, jl.params, ji, [0])
    tprev = tnet.env_step(None, 0, tl.params, ti, [0])
    keep = tnet.env_keep([0, 1])
    got = tnet._env_step_conv_fast(tprev, tnet.column_operands(1, tl.params, ti), keep)
    want = jnet._env_step_conv_fast(jprev, jnet.column_operands(1, jl.params, ji), keep)
    assert got is not None and want is not None
    got, want = got.numpy(), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    monkeypatch.setenv("TNF_AUX_PRECISION", "highest")
    f32 = tnet._env_step_conv_fast(tprev, tnet.column_operands(1, tl.params, ti), keep)
    assert np.abs(f32.numpy() - got).max() > 1e-4 * scale


def test_env_step_conv_fast_high_matches_jax(monkeypatch, tpu_default_dots):
    """The staged conv advance at TNF_AUX_PRECISION=high against the JAX one
    with the TPU's bf16x3: 1e-6 of max|env|; its "default" form misses it
    by more than 1e-4 of it."""
    monkeypatch.setenv("TNF_AUX_PRECISION", "high")
    jl, tl, X = conv_pair()
    jnet, tnet = jl.network, tl.network
    ji, ti = jnet.bind_inputs(jnp.asarray(X)), tnet.bind_inputs(torch.from_numpy(X))
    jprev = jnet.env_step(None, 0, jl.params, ji, [0])
    tprev = tnet.env_step(None, 0, tl.params, ti, [0])
    keep = tnet.env_keep([0, 1])
    got = tnet._env_step_conv_fast(tprev, tnet.column_operands(1, tl.params, ti), keep)
    want = jnet._env_step_conv_fast(jprev, jnet.column_operands(1, jl.params, ji), keep)
    assert got is not None and want is not None
    got, want = got.numpy(), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    single = tnet._env_step_conv_fast(tprev, tnet.column_operands(1, tl.params, ti), keep)
    assert np.abs(single.numpy() - want).max() > 1e-4 * scale


@pytest.mark.parametrize("gram", ["f32", "bf16"])
def test_packed_jacobian_and_predict_default_match_jax(gram, monkeypatch,
                                                       tpu_default_dots):
    """The packed Jacobian of A2 (a contraction of the others, then a
    batched product with the left env) and J·core at the aux tier, against
    the JAX package with the TPU's rounding: J to 1e-6 of max|J| (2^-8 in
    the bf16 Gram tier, where J is stored in bf16 and may round one ulp
    apart), the prediction to 1e-5 of its max."""
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    monkeypatch.setenv("TNF_GRAM_DTYPE", gram)
    jl, tl, X = conv_pair(1)
    jnet, tnet = jl.network, tl.network
    ni = [spec.name for spec in jl.topology.nodes].index("A2")
    ji, ti = jnet.bind_inputs(jnp.asarray(X)), tnet.bind_inputs(torch.from_numpy(X))
    jL = jnet.env_chain(jl.params, ji, "left")
    jR = jnet.env_chain(jl.params, ji, "right")
    tL = tnet.env_chain(tl.params, ti, "left")
    tR = tnet.env_chain(tl.params, ti, "right")
    ci = jl.topology.col_of[ni]
    jpj = jnet.packed_jacobian(ni, jl.params, ji, jL[ci - 1], jR[ci + 1])
    tpj = tnet.packed_jacobian(ni, tl.params, ti, tL[ci - 1], tR[ci + 1])
    gj = np.asarray(jpj["arr"].astype(jnp.float32))
    gt = tpj["arr"].float().numpy()
    tol = 1e-6 if gram == "f32" else 2.0 ** -8
    np.testing.assert_allclose(gt, gj, rtol=0, atol=tol * np.abs(gj).max())
    pj = np.asarray(jnet.packed_predict(jpj, jl.params["A2"]))
    pt = tnet.packed_predict(tpj, tl.params["A2"]).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5 * np.abs(pj).max())


def test_aux_precision_reads_env_each_call(monkeypatch):
    """TNF_AUX_PRECISION is read on every call, each of the JAX package's
    three names accepted and any other raising; TNF_PRECISION is read once,
    at import, as in the JAX package, so setting it later leaves the
    networks' precision as it was."""
    jl, tl, _ = conv_pair()
    net = tl.network
    monkeypatch.delenv("TNF_AUX_PRECISION", raising=False)
    assert net.aux_precision == "highest"
    for name in ("DEFAULT", "high", "highest"):
        monkeypatch.setenv("TNF_AUX_PRECISION", name)
        assert net.aux_precision == name.lower()
    monkeypatch.setenv("TNF_AUX_PRECISION", "bf16")
    with pytest.raises(ValueError, match="precision must be one of"):
        net.aux_precision
    with pytest.raises(ValueError, match="precision must be one of"):
        Network(tl.topology, device="cpu")
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    monkeypatch.setenv("TNF_PRECISION", "default")
    from tensornetworksfork_tpu_torch.core import engine
    assert Network(tl.topology, device="cpu").precision == engine.DEFAULT_PRECISION


def test_unset_aux_precision_follows_the_network(monkeypatch):
    """With TNF_AUX_PRECISION unset the auxiliary contractions run at the
    network's precision (JAX engine.py aux_precision); set, it wins. The
    JAX package's networks do the same."""
    jl, tl, _ = conv_pair()
    monkeypatch.delenv("TNF_AUX_PRECISION", raising=False)
    for name, jp in (("high", jax.lax.Precision.HIGH),
                     ("default", jax.lax.Precision.DEFAULT),
                     ("highest", jax.lax.Precision.HIGHEST)):
        assert Network(tl.topology, device="cpu", precision=name).aux_precision == name
        assert JNetwork(jl.topology, precision=jp).aux_precision == jp
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    assert Network(tl.topology, device="cpu", precision="high").aux_precision == "default"
    assert (JNetwork(jl.topology, precision=jax.lax.Precision.HIGH).aux_precision
            == jax.lax.Precision.DEFAULT)


# One swipe of a tiny conv-TT (4 carriages) in the fast and fastest tiers,
# the port against the JAX package under the same environment with the
# TPU's rounding (tpu_default_dots). TNF_PACKED_SYRK_MIN_D=1 takes the tiled
# kernel route (K1, and in fastest K2/K3; plain versions here, Pallas in
# interpret mode there). Tolerance on the predictions after the swipe,
# relative to max|pred|, measured over seeds 0-2: fast 3.4e-7..2.2e-6,
# fastest 2.7e-7..4.9e-7 (f32 sums in another order through 14 chained
# solves); held to 5e-6 and 1e-6. Against the JAX package without the
# rounding (as XLA runs DEFAULT on the CPU) the same swipes differ by
# 2.3e-2..3.0e-2, so a port that skips the rounding fails here.
SW = dict(N=4, R=4, CB=2, P=6, PP=5, C=3, S=64, B=32)


def swipe_both(seed):
    c = SW
    jl = JLayer(c["N"], c["R"], c["P"], c["PP"], output_shape=(c["C"],),
                convolution_bond=c["CB"], seed=seed)
    tl = TLayer(c["N"], c["R"], c["P"], c["PP"], output_shape=(c["C"],),
                convolution_bond=c["CB"], seed=seed, use_kernels=True, device="cpu")
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((c["S"], c["P"], c["PP"])).astype(np.float32)
    Y = np.eye(c["C"] + 1, dtype=np.float32)[rng.integers(0, c["C"] + 1, c["S"])]
    cfg = dict(num_swipes=1, batch_size=c["B"], method="ridge_cholesky",
               eps=5.0, eps_decay=0.25)
    p0 = {k: np.asarray(v) for k, v in jl.params.items()}
    pj, okj = JSweeper(JNetwork(jl.topology, use_pallas=True), JXE(1.0),
                       JConfig(**cfg)).run([jl.params], jnp.asarray(X), jnp.asarray(Y))
    pt, okt = Sweeper(tl.network, TXE(1.0), SweepConfig(**cfg)).run(
        [params_from_numpy(p0, device="cpu")], torch.tensor(X), torch.tensor(Y))
    pred_j = np.asarray(jl.network.forward(pj[0], jnp.asarray(X)))
    pred_t = tl.network.forward(pt[0], torch.tensor(X)).numpy()
    return okj, okt, pred_j, pred_t, params_to_numpy(pt[0])


@pytest.mark.parametrize("tier,rtol", [("fast", 5e-6), ("fastest", 1e-6)])
def test_swipe_in_aux_tiers_matches_jax(tier, rtol, monkeypatch, tpu_default_dots):
    from tensornetworksfork_tpu_torch.utils.precision import TIERS
    for k, v in TIERS[tier].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", "0")
    okj, okt, pred_j, pred_t, pt = swipe_both(0)
    assert okj and okt
    assert all(np.isfinite(v).all() for v in pt.values())
    np.testing.assert_allclose(pred_t, pred_j, rtol=0,
                               atol=rtol * np.abs(pred_j).max())


# A bf16x3 product moves by about 2^-17 of itself (7.6e-6) where an input
# that moved by one f32 ulp crosses a rounding step of its lo part, and one
# ulp moves lo's rounding about 256 times as often as a DEFAULT operand's;
# so a swipe's 14 chained updates carry the packages' reordered f32 sums
# further at "high" than at "default" or "highest". Measured over seeds
# 0-2, f32 Gram operands: a single node update 9e-8..4e-7 of max|core| (as
# at "highest"), the whole swipe's predictions 8.6e-6..1.3e-5 of max|pred|
# ("highest": 3e-7..6e-7). Held to 3e-5.
HIGH_SWIPE_RTOL = 3e-5


def test_swipe_at_high_aux_precision_matches_jax(monkeypatch, tpu_default_dots):
    """One swipe with TNF_AUX_PRECISION=high on the tiled kernel route (f32
    Gram operands) against the JAX package with the TPU's bf16x3:
    predictions within HIGH_SWIPE_RTOL of max|pred|. Single-pass rounding
    misses it by more."""
    monkeypatch.setenv("TNF_AUX_PRECISION", "high")
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", "0")
    okj, okt, pred_j, pred_t, pt = swipe_both(0)
    assert okj and okt
    scale = np.abs(pred_j).max()
    np.testing.assert_allclose(pred_t, pred_j, rtol=0, atol=HIGH_SWIPE_RTOL * scale)
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    _, _, _, pred_single, _ = swipe_both(0)
    assert np.abs(pred_single - pred_j).max() > HIGH_SWIPE_RTOL * scale


NET_PRECISIONS = {"default": jax.lax.Precision.DEFAULT, "high": jax.lax.Precision.HIGH}


# Network(precision="high") on the plain routes: every product of the
# swipe, the Gram's too, is bf16x3. Given the same operands, each of the
# port's 213 products takes the fixture's split and its grouping
# hi·hi + (hi·lo + lo·hi), and lies within 5.5e-7 of the fixture's result
# (relative to the product's max): the order of the f32 sums, as far as
# the fixture itself lies from the exact sum of its three products
# (4.1e-7). Chained through the swipe's updates, that order moves the
# predictions by 6.0e-6 of max|pred| (seed 1); the JAX package under jit
# and under jax.disable_jit() lies 5.6e-6 from itself. So "high" is held to
# HIGH_SWIPE_RTOL, and to a float64 swipe of the same inputs at HIGHEST:
# the port no further from it than the JAX package (1.98e-5 against
# 2.58e-5 of max|pred|). `python studies/port_repairs_study.py high` prints
# these readings.


def _float64_swipe(jl, X, Y, cfg):
    """The JAX package's swipe of jl's initial params in float64 at
    HIGHEST: the predictions that bf16x3 approximates."""
    with jax.enable_x64(True):
        net = JNetwork(jl.topology, precision=jax.lax.Precision.HIGHEST, use_pallas=False)
        p0 = {k: jnp.asarray(np.asarray(v), dtype=jnp.float64) for k, v in jl.params.items()}
        X64 = jnp.asarray(X, dtype=jnp.float64)
        p, ok = JSweeper(net, JXE(1.0), JConfig(**cfg)).run(
            [p0], X64, jnp.asarray(Y, dtype=jnp.float64))
        assert ok
        pred = np.asarray(net.forward(p[0], X64))
    assert pred.dtype == np.float64
    return pred


@pytest.mark.parametrize("name", sorted(NET_PRECISIONS))
def test_network_precision_swipe_matches_jax(name, monkeypatch, tpu_default_dots):
    """TNF_PRECISION's counterpart, Network(precision=): one swipe of
    networks built at "default" and at "high" in both packages (the plain
    routes, so every product, the Gram's too, runs at that precision; the
    aux contractions follow it, TNF_AUX_PRECISION unset), with the TPU's
    rounding on the JAX side: predictions within 5e-6 of max|pred| at
    "default"; at "high" within HIGH_SWIPE_RTOL, and no further from a
    float64 swipe than the JAX package's (see the note above)."""
    monkeypatch.delenv("TNF_AUX_PRECISION", raising=False)
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    c = SW
    jl = JLayer(c["N"], c["R"], c["P"], c["PP"], output_shape=(c["C"],),
                convolution_bond=c["CB"], seed=1)
    tl = TLayer(c["N"], c["R"], c["P"], c["PP"], output_shape=(c["C"],),
                convolution_bond=c["CB"], seed=1, device="cpu")
    rng = np.random.default_rng(1)
    X = rng.standard_normal((c["S"], c["P"], c["PP"])).astype(np.float32)
    Y = np.eye(c["C"] + 1, dtype=np.float32)[rng.integers(0, c["C"] + 1, c["S"])]
    cfg = dict(num_swipes=1, batch_size=c["B"], method="ridge_cholesky", eps=5.0)
    jnet = JNetwork(jl.topology, precision=NET_PRECISIONS[name], use_pallas=False)
    tnet = Network(tl.topology, device="cpu", precision=name, use_kernels=False)
    pj, okj = JSweeper(jnet, JXE(1.0), JConfig(**cfg)).run(
        [jl.params], jnp.asarray(X), jnp.asarray(Y))
    p0 = params_from_numpy({k: np.asarray(v) for k, v in jl.params.items()}, device="cpu")
    pt, okt = Sweeper(tnet, TXE(1.0), SweepConfig(**cfg)).run(
        [p0], torch.tensor(X), torch.tensor(Y))
    assert okj and okt
    pred_j = np.asarray(jnet.forward(pj[0], jnp.asarray(X)))
    pred_t = tnet.forward(pt[0], torch.tensor(X)).numpy()
    scale = np.abs(pred_j).max()
    rtol = HIGH_SWIPE_RTOL if name == "high" else 5e-6
    np.testing.assert_allclose(pred_t, pred_j, rtol=0, atol=rtol * scale)
    if name == "high":
        pred64 = _float64_swipe(jl, X, Y, cfg)
        assert np.abs(pred_t - pred64).max() <= np.abs(pred_j - pred64).max()


def test_history_keyed_on_aux_precision(monkeypatch):
    """A second run of one Sweeper in another aux tier recomputes its
    environments: it ends exactly where a fresh Sweeper does."""
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    jl, tl, X = conv_pair(2)
    rng = np.random.default_rng(2)
    Y = torch.from_numpy(np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)])
    Xt = torch.from_numpy(X)
    cfg = SweepConfig(num_swipes=1, batch_size=8, method="ridge_cholesky",
                      eps=5.0, eps_decay=0.25)
    sw = Sweeper(tl.network, TXE(1.0), cfg)
    p1, ok = sw.run([tl.params], Xt, Y)
    assert ok
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    p2, _ = sw.run([dict(p1[0])], Xt, Y)
    p2_fresh, _ = Sweeper(tl.network, TXE(1.0), cfg).run([dict(p1[0])], Xt, Y)
    for k in p2[0]:
        torch.testing.assert_close(p2[0][k], p2_fresh[0][k], rtol=0, atol=0)


def test_fused_rhs_outside_k1_for_f32_j(monkeypatch, tpu_default_dots):
    """With f32 Gram operands and the aux tier, b is the product of the
    rounded J and g, formed outside K1 (which sums the J it retiles
    unrounded); in the bf16 tiers K1 sums it. Both against the JAX rhs with
    the TPU's rounding: 1e-5 of max|b|."""
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    rng = np.random.default_rng(4)
    Sx, Cx, D0, D1 = 40, 3, 4, 6
    J = rng.standard_normal((Sx, Cx, D0, D1)).astype(np.float32)
    g = rng.standard_normal((Sx, Cx)).astype(np.float32)
    Hm = rng.standard_normal((Sx, Cx, Cx)).astype(np.float32)
    H = np.einsum("sab,scb->sac", Hm, Hm).astype(np.float32)
    jl, tl, _ = conv_pair()
    for gram in ("f32", "bf16"):
        monkeypatch.setenv("TNF_GRAM_DTYPE", gram)
        dt = jnp.float32 if gram == "f32" else jnp.bfloat16
        base = {"out_part": (0,), "n_out": 1, "node_shape": (D0, D1),
                "a0_sz": D0, "r_sz": D1, "pad_out": 0}
        jpj = dict(base, arr=jnp.asarray(J).astype(dt))
        tpj = dict(base, arr=torch.from_numpy(np.asarray(jpj["arr"].astype(jnp.float32)))
                   .to(torch.float32 if gram == "f32" else torch.bfloat16))
        jnet = JNetwork(jl.topology, use_pallas=True)
        tnet = Network(tl.topology, device="cpu", use_kernels=True)
        _, bj = jnet.packed_gram_rhs(jpj, jnp.asarray(g), jnp.asarray(H))
        _, bt = tnet.packed_gram_rhs(tpj, torch.from_numpy(g), torch.from_numpy(H))
        bj = np.asarray(bj).reshape(-1)
        np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-5 * np.abs(bj).max())


def test_chip_smoke_aux_product_check_sees_rounding(monkeypatch):
    """chip_smoke's check of the aux tier's products (phase 6), on a tiny
    conv-TT swipe on the CPU: each recorded product lies within
    AUX_PRODUCT_BOUND sqrt(K) 2^-24 of sum|a||b| of float64 of its
    bf16-rounded operands; a matmul that returns bf16-rounded results, or
    one that skips the rounding, fails it."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    rng = np.random.default_rng(1)
    X = torch.tensor(rng.standard_normal((48, 6, 5)).astype(np.float32))
    y = torch.tensor(np.eye(4, dtype=np.float32)[rng.integers(0, 4, 48)])
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")

    def records():
        with chip_smoke.recorded_aux_products() as rec:
            layer = TLayer(4, 4, 6, 5, output_shape=(3,), convolution_bond=2, seed=0,
                           device="cpu", use_kernels=True)
            cfg = SweepConfig(num_swipes=1, batch_size=48, method="ridge_cholesky",
                              eps=5.0, eps_decay=0.25)
            Sweeper(layer.network, TXE(1.0), cfg).run([layer.params], X, y)
        return rec

    chip_smoke.check_aux_products("port", records())
    plain = tcon.matmul
    for wrong in (lambda a, b, p="highest": plain(a, b, p).bfloat16().float(),
                  lambda a, b, p="highest": plain(a, b, "highest")):
        monkeypatch.setattr(tcon, "matmul", wrong)
        monkeypatch.setattr("tensornetworksfork_tpu_torch.core.engine.matmul", wrong)
        with pytest.raises(AssertionError, match="off by"):
            chip_smoke.check_aux_products("control", records())
