"""One `Sweeper.run` swipe of a tiny conv-TT: the port against the JAX package.

Same params (made by JAX, copied across), same data (numpy seed), same
config; the Gram tier is set with monkeypatch.setenv. With
TNF_PACKED_SYRK_MIN_D=1 the middle cores take the tiled kernel route (the
kernels' plain versions on the CPU, Pallas interpret mode on the JAX side);
TNF_FULLBATCH_MAX_BYTES=0 switches the full-batch merge off so the chunk
carry is exercised across two chunks.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core.engine import Network as JNetwork  # noqa: E402
from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper  # noqa: E402
from tensornetworksfork_tpu.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as JLayer)
from tensornetworksfork_tpu.ops.bregman import XEBregman as JXE  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as TLayer)
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman as TXE  # noqa: E402
from tensornetworksfork_tpu_torch.ops.cuda import gram as tg  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)

N, R, CB, P, PP, C, S, B = 4, 4, 2, 6, 5, 3, 64, 32
CFG = dict(num_swipes=1, batch_size=B, method="ridge_cholesky", eps=5.0,
           eps_decay=0.25)


def swipe_both(X, Y, seed=0):
    jl = JLayer(N, R, P, PP, output_shape=(C,), convolution_bond=CB, seed=seed)
    tl = TLayer(N, R, P, PP, output_shape=(C,), convolution_bond=CB,
                seed=seed, use_kernels=True, device="cpu")
    p0 = {k: np.asarray(v) for k, v in jl.params.items()}
    pj, okj = JSweeper(JNetwork(jl.topology, use_pallas=True), JXE(1.0),
                       JConfig(**CFG)).run([jl.params], jnp.asarray(X),
                                           jnp.asarray(Y))
    pt, okt = Sweeper(tl.network, TXE(1.0), SweepConfig(**CFG)).run(
        [params_from_numpy(p0, device="cpu")], torch.tensor(X), torch.tensor(Y))
    pj = {k: np.asarray(v) for k, v in pj[0].items()}
    pred_j = np.asarray(jl.network.forward(pj, jnp.asarray(X)))
    pred_t = tl.network.forward(pt[0], torch.tensor(X)).numpy()
    return p0, (pj, okj, pred_j), (params_to_numpy(pt[0]), okt, pred_t)


def data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((S, P, PP)).astype(np.float32)
    Y = np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]
    return X, Y


# Tolerances on the predictions after the swipe, relative to max|pred|:
# - f32: the same f32 arithmetic summed in another order; the params are held
#   to rtol 1e-4, atol 1e-5 as well (measured ~1e-6 relative).
# - bf16: a J or K entry whose f32 sum lands next to a bf16 rounding boundary
#   rounds one ulp apart (0.4 %), and 14 chained solves carry it; measured
#   1.2e-3..4.9e-3 over seeds 0-2, held to 2e-2.
# - int8: such a one-ulp difference can also flip an int8 code (0.8 % of a
#   column's scale); measured 1.8e-3..1.2e-2 over seeds 0-2 (2.8e-3..2.1e-2
#   with the full-batch merge on), held to 5e-2.
@pytest.mark.parametrize("tier,fullbatch,rtol", [
    ("f32", "", 1e-4),
    ("f32", "0", 1e-4),
    ("bf16", "0", 2e-2),
    ("int8", "0", 5e-2),
])
def test_swipe_matches_jax(tier, fullbatch, rtol, monkeypatch):
    monkeypatch.setenv("TNF_GRAM_DTYPE", tier)
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", fullbatch)
    calls = {}

    def counting(name):
        fn = getattr(tg, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(tg, name, wrapper)

    for name in ("retile_hmix", "quantize_tiled", "gram_pair_band_q", "gram_pair"):
        counting(name)
    X, Y = data()
    p0, (pj, okj, pred_j), (pt, okt, pred_t) = swipe_both(X, Y)
    assert okj and okt
    scale = np.abs(pred_j).max()
    np.testing.assert_allclose(pred_t, pred_j, rtol=0, atol=rtol * scale)
    if tier == "f32":
        for k in pj:
            np.testing.assert_allclose(pt[k], pj[k], rtol=1e-4, atol=1e-5)
    # the swipe went through the kernel routes: the tiled route's kernels
    # for the middle cores, the flat Gram for A4/C1/C4
    assert calls.get("retile_hmix", 0) > 0 and calls.get("gram_pair", 0) > 0
    if tier == "int8":
        assert calls.get("quantize_tiled", 0) > 0
        assert calls.get("gram_pair_band_q", 0) > 0
    else:
        assert "quantize_tiled" not in calls and "gram_pair_band_q" not in calls


def test_singular_swipe_matches_jax(monkeypatch):
    """A non-finite input makes every solve fail: both packages report
    ok=False after the first half-pass and keep every node at its old value
    (the deferred-ok contract)."""
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    X, Y = data(1)
    X[0, 0, 0] = np.nan
    p0, (pj, okj, _), (pt, okt, _) = swipe_both(X, Y, seed=1)
    assert okj is False and okt is False
    for k in p0:
        np.testing.assert_array_equal(pt[k], p0[k])
        np.testing.assert_array_equal(pj[k], p0[k])


def test_sum_of_conv_tts_swipe_matches_jax(monkeypatch):
    """A type-I sum of two conv-TTs (the second sees x sliced down to fewer
    patches and pixels): the members' cached outputs feed each other's
    predictions. f32 tier; rtol 1e-4 of max|pred| (f32 sums in another
    order)."""
    from tensornetworksfork_tpu.core.sweep import Member as JMember
    from tensornetworksfork_tpu.models.layers import SumLayer as JSum
    from tensornetworksfork_tpu_torch.core.sweep import Member
    from tensornetworksfork_tpu_torch.models.layers import SumLayer

    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    X, Y = data(2)
    shapes = [(2, P, PP), (3, P - 1, PP - 1)]
    jls = [JLayer(n, R, p, pp, output_shape=(C,), convolution_bond=CB, seed=i)
           for i, (n, p, pp) in enumerate(shapes)]
    tls = [TLayer(n, R, p, pp, output_shape=(C,), convolution_bond=CB, seed=i,
                  use_kernels=True, device="cpu")
           for i, (n, p, pp) in enumerate(shapes)]
    jsum, tsum = JSum(jls), SumLayer(tls)
    jm = [JMember(JNetwork(l.topology, use_pallas=True), f)
          for l, f in zip(jls, jsum.input_fns)]
    tm = [Member(l.network, f) for l, f in zip(tls, tsum.input_fns)]
    p0 = [{k: np.asarray(v) for k, v in l.params.items()} for l in jls]
    pj, okj = JSweeper(jm, JXE(1.0), JConfig(**CFG)).run(
        [l.params for l in jls], jnp.asarray(X), jnp.asarray(Y))
    pt, okt = Sweeper(tm, TXE(1.0), SweepConfig(**CFG)).run(
        [params_from_numpy(p, device="cpu") for p in p0], torch.tensor(X), torch.tensor(Y))
    assert okj and okt
    pred_j = np.asarray(jsum(jnp.asarray(X), params_list=pj))
    pred_t = tsum(torch.tensor(X), params_list=pt).numpy()
    np.testing.assert_allclose(pred_t, pred_j, rtol=0,
                               atol=1e-4 * np.abs(pred_j).max())


def test_sweep_timers_report_every_phase(monkeypatch):
    """TNF_SWEEP_TIMERS=1 attributes the swipe's wall time to far chains,
    near-side advances and one update phase per node (port only)."""
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    monkeypatch.setenv("TNF_SWEEP_TIMERS", "1")
    X, Y = data()
    tl = TLayer(N, R, P, PP, output_shape=(C,), convolution_bond=CB, seed=0,
                device="cpu")
    sw = Sweeper(tl.network, TXE(1.0), SweepConfig(**CFG))
    _, ok = sw.run([tl.params], torch.tensor(X), torch.tensor(Y))
    assert ok
    assert {f"update:{n}" for n in ("A1", "A2", "A3", "A4", "C1", "C2", "C3", "C4")} \
        <= set(sw.timers)
    assert "far_envs" in sw.timers and "advance" in sw.timers
    assert "TOTAL" in sw.timer_report()
