"""The image trainer (`experiments/train_image.py`) and the replication
runner (`experiments/reproduce_result.py`) of the port against the JAX
package on the CPU, and the options that stay unported."""
import csv
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core.sweep import Member as JMember  # noqa: E402
from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper  # noqa: E402
from tensornetworksfork_tpu.experiments import reproduce_result as jrr  # noqa: E402
from tensornetworksfork_tpu.experiments import train_image as jti  # noqa: E402
from tensornetworksfork_tpu.models.layers import SumLayer as JSum  # noqa: E402
from tensornetworksfork_tpu.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as JLayer)
from tensornetworksfork_tpu.ops.bregman import XEBregman as JXE  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import Member, SweepConfig, Sweeper  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import reproduce_result as trr  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import train_image as tti  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import SumLayer  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as TLayer)
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman as TXE  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy  # noqa: E402


@pytest.fixture(autouse=True)
def _no_preset_leftovers(monkeypatch):
    """The image drivers read their configuration from the environment, and
    a PRESET's setdefault (tests/test_experiments.py runs one in the same
    process when a worker takes both files) leaves its variables set: each
    test here starts without them."""
    for k in ("PRESET",) + tuple(tti.PRESETS["cifar_minres"]):
        monkeypatch.delenv(k, raising=False)


# the JAX package's own image-driver test size (tests/test_experiments.py)
SMALL = dict(N="2", R="4", CB="2", NUM_SWIPES="2", EARLY_STOPPING="4",
             SYNTHETIC_SAMPLES="1024", BATCH_SIZE="512", VERBOSE="0")


def test_type1_sum_with_one_carriage_member_matches_jax(monkeypatch):
    """The type-I sum of train_image (members of 1, 2 and 3 carriages, the
    first a single core that owns the logits, the others on x without its
    bias row and column): one swipe through the Sweeper, f32 tier, with the
    kernel routes' plain versions. Parameters and predictions to 1e-4 of
    their max (f32 sums in another order); the model's methods as the JAX
    ones."""
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    rng = np.random.default_rng(0)
    S, P, PP, C = 96, 7, 5, 4
    X = rng.standard_normal((S, P, PP)).astype(np.float32)
    X[:, -1, :] = 0.0
    X[:, :, -1] = 0.0
    X[:, -1, -1] = 1.0
    Y = np.eye(C, dtype=np.float32)[rng.integers(0, C, S)]
    jls, tls = [], []
    for i in range(1, 4):
        p, pp = (P, PP) if i == 1 else (P - 1, PP - 1)
        jls.append(JLayer(i, 4, p, pp, output_shape=(C - 1,), convolution_bond=2,
                          seed=10 + i))
        tls.append(TLayer(i, 4, p, pp, output_shape=(C - 1,), convolution_bond=2,
                          seed=10 + i, device="cpu", use_kernels=True))
        tls[-1].params = params_from_numpy(
            {k: np.asarray(v) for k, v in jls[-1].params.items()}, device="cpu")
    jm, tm = JSum(jls), SumLayer(tls)
    assert tm.num_parameters() == jm.num_parameters()
    assert list(tls[0].params) == list(jls[0].params)
    assert tuple(tls[0].params["A1"].shape) == tuple(jls[0].params["A1"].shape) == (C - 1, P)
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    np.testing.assert_allclose(tm.forward_batch(Xt, 40).numpy(),
                               np.asarray(jm.forward_batch(Xj, 40)), rtol=1e-5, atol=1e-6)
    cfg = dict(num_swipes=1, batch_size=48, method="ridge_cholesky", eps=5.0,
               eps_decay=0.25)
    pj, okj = JSweeper([JMember(l.network, f) for l, f in zip(jm.layers, jm.input_fns)],
                       JXE(1.0), JConfig(**cfg)).run(jm.params_list, Xj, jnp.asarray(Y))
    pt, okt = Sweeper([Member(l.network, f) for l, f in zip(tm.layers, tm.input_fns)],
                      TXE(1.0), SweepConfig(**cfg)).run(tm.params_list, Xt,
                                                        torch.from_numpy(Y))
    assert okj and okt
    for a, b in zip(pt, pj):
        for k in b:
            b_k = np.asarray(b[k])
            np.testing.assert_allclose(a[k].numpy(), b_k, rtol=0,
                                       atol=1e-4 * np.abs(b_k).max())
    jm.set_params_list(pj)
    tm.set_params_list(pt)
    pred_j = np.asarray(jm(Xj))
    np.testing.assert_allclose(tm(Xt).numpy(), pred_j, rtol=0,
                               atol=1e-4 * np.abs(pred_j).max())
    states = tm.node_states()
    tm.load_node_states([{k: v * 0 for k, v in s.items()} for s in states])
    assert float(tm(Xt).abs().max()) == 0.0
    tm.load_node_states(states)
    np.testing.assert_array_equal(tm(Xt).numpy(), tm.forward_batch(Xt, 1000).numpy())


def test_train_image_matches_jax(monkeypatch, tmp_path):
    """train_image at the JAX package's own test size (N=2, r=4, CB=2, two
    swipes, 1,024 synthetic samples) in the reference tier, from the same
    parameters (the JAX model's, copied across): the same parameter count,
    the same calibration w (rtol 1e-5) and a test accuracy within one test
    sample (100/512 points) of the JAX run's."""
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DATA_PATH", str(tmp_path / "nodata"))
    monkeypatch.setenv("RESULTS_FILE", str(tmp_path / "img.csv"))
    monkeypatch.setenv("PRECISION", "reference")
    monkeypatch.setenv("TNF_FIT_PRECOMPILE", "0")
    monkeypatch.setenv("DEVICE", "cpu")
    seen = {}

    def jbuild(config, *a):
        model = jti_build(config, *a)
        seen["params"] = [{k: np.asarray(v) for k, v in l.params.items()}
                          for l in model.layers]
        return model

    def tbuild(config, *a):
        model = tti_build(config, *a)
        for layer, p in zip(model.layers, seen["params"]):
            layer.params = params_from_numpy(p, device="cpu")
        return model

    def recording(key, cls):
        def make(w):
            seen[key] = w
            return cls(w=w)
        return make

    jti_build, tti_build = jti.build_model, tti.build_model
    monkeypatch.setattr(jti, "build_model", jbuild)
    monkeypatch.setattr(tti, "build_model", tbuild)
    monkeypatch.setattr(jti, "XEBregman", recording("w_jax", jti.XEBregman))
    monkeypatch.setattr(tti, "XEBregman", recording("w_port", tti.XEBregman))
    rj = jti.train_model(jti.get_config_from_env())
    config = tti.get_config_from_env()
    assert config["results_file"] == str(tmp_path / "img.csv")
    rt = tti.train_model(config)
    assert set(rt) == set(rj)
    assert rt["num_parameters"] == rj["num_parameters"]
    assert rt["dataset"] == rj["dataset"] == "MNIST-synthetic"
    assert seen["w_port"] == pytest.approx(seen["w_jax"], rel=1e-5)
    assert abs(rt["test_accuracy"] - rj["test_accuracy"]) <= 100 / 512 + 1e-9
    assert rt["test_accuracy"] > 20.0 and not rt["singular"]


@pytest.mark.parametrize("tier", ["fast", "fastest"])
def test_train_image_runs_in_aux_tiers(tier, monkeypatch, tmp_path):
    """PRECISION=fast and fastest run through train_image (with the kernel
    routes' plain versions on the CPU), beat chance and write the CSV."""
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("NUM_SWIPES", "1")
    monkeypatch.setenv("DATA_PATH", str(tmp_path / "nodata"))
    monkeypatch.setenv("RESULTS_FILE", str(tmp_path / "img.csv"))
    monkeypatch.setenv("PRECISION", tier)
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    monkeypatch.delenv("TNF_AUX_PRECISION", raising=False)
    built = []

    def build(config, *a):
        model = tti_build(config, *a)
        for layer in model.layers:
            layer.network.use_kernels = True
        built.append(model)
        return model

    tti_build = tti.build_model
    monkeypatch.setattr(tti, "build_model", build)
    tti.main()
    with open(tmp_path / "img.csv") as f:
        rows = f.read().splitlines()
    with open(tmp_path / "img.csv") as f:
        (row,) = list(csv.DictReader(f))
    assert len(rows) == 2 and row["precision"] == tier
    assert float(row["test_accuracy"]) > 20.0
    assert "TNF_AUX_PRECISION" not in os.environ
    for layer in built[0].layers:
        assert all(bool(torch.isfinite(v).all()) for v in layer.params.values())


def test_reproduce_digits_one_seed_cpu(monkeypatch, tmp_path, capsys):
    """The digits protocol on the CPU at N=2, r=4, one swipe, one seed: it
    reads the committed digits, beats chance by far, prints the seed's
    accuracy and the summary line with the noise floor, writes its row under
    build/ and leaves the environment as it found it."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(trr.HEADLINE, "digits", dict(
        trr.HEADLINE["digits"], N="2", R="4", NUM_SWIPES="1"))
    monkeypatch.setenv("DEVICE", "cpu")
    before = dict(os.environ)
    res = trr.main("digits", seeds=(42,))
    assert dict(os.environ) == before
    assert len(res) == 1 and res[0]["dataset"] == "digits"
    assert res[0]["N"] == 2 and res[0]["r"] == 4 and res[0]["CB"] == 8
    assert res[0]["test_accuracy"] > 70.0
    out = capsys.readouterr().out
    assert "seed 42: test_accuracy" in out
    assert "test-set binomial noise floor" in out
    assert (tmp_path / "build" / "reproduce_digits.csv").exists()
    mean, std, floor, line = trr.summarize("digits", res)
    assert mean == res[0]["test_accuracy"] and std == 0.0
    assert floor == pytest.approx(100 * np.sqrt(mean / 100 * (1 - mean / 100) / 359))


@pytest.mark.parametrize("env,match", [
    ({"METHOD": "minres"}, "ROADMAP item 11"),
    ({"METHOD": "cg"}, "ROADMAP item 11"),
    ({"PRESET": "cifar_minres"}, "ROADMAP item 11"),
])
def test_unported_image_options_raise(env, match, monkeypatch):
    """These options raised NotImplementedError naming `match` until the
    matrix-free tier was ported; now they resolve to the JAX package's
    configuration, key for key (the preset's TNF_* variables are set first,
    so its setdefault leaves them and monkeypatch restores them)."""
    for k in ("PRESET", "METHOD", "DATASET", "KERNEL_SIZE", "KERNEL_STRIDE",
              "BATCH_SIZE", "MAX_ITER", "RESULTS_FILE", "DEVICE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TNF_GRAM_DTYPE", "bf16")
    monkeypatch.setenv("TNF_AUX_PRECISION", "default")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t = tti.get_config_from_env()
    assert t["method"] == env.get("METHOD", "minres")
    j = jti.get_config_from_env()
    for k in j:
        if k != "results_file":
            assert t[k] == j[k], (k, match)


@pytest.mark.parametrize("env", [{"TNF_AUX_PRECISION": "high"},
                                 {"TNF_PRECISION": "default"}])
def test_unported_precisions_raise_in_train_image(env, monkeypatch, tmp_path):
    """These precisions raised until the port ran them: train_image now
    trains under TNF_AUX_PRECISION=high (read on every call) and under
    TNF_PRECISION=default, which both packages read once, at import, so
    that a value set later leaves the networks' precision as it was."""
    from tensornetworksfork_tpu_torch.core import engine
    for k, v in dict(SMALL, DEVICE="cpu", DATA_PATH=str(tmp_path), **env).items():
        monkeypatch.setenv(k, v)
    res = tti.train_model(tti.get_config_from_env())
    assert np.isfinite(res["test_accuracy"]) and res["test_accuracy"] > 0
    assert engine.DEFAULT_PRECISION == "highest"


def test_digits_flat_raises(monkeypatch, tmp_path):
    """digits_flat raised until item 18 wrote out the quantile transform;
    now main("digits_flat") runs its fits (one seed at 2 swipes here;
    tests/test_torch_utils.py holds it to the JAX package) and appends its
    rows under build/."""
    from tensornetworksfork_tpu_torch.experiments import train_tabular as ttt
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DEVICE", "cpu")
    run = ttt.run

    def short(cfg, overrides=None, data=None):
        cfg.num_swipes = 2
        return run(cfg, overrides, data=data)
    monkeypatch.setattr(ttt, "run", short)
    accs = trr.main("digits_flat", seeds=(43,))
    assert len(accs) == 1 and 10.0 < accs[0] <= 100.0
    with open(tmp_path / "build" / "reproduce_digits_flat.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["seed"] for r in rows] == ["43"] and rows[0]["model_type"] == "tt"


def test_train_image_needs_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DATA_PATH", str(tmp_path))
    monkeypatch.delenv("DEVICE", raising=False)
    config = tti.get_config_from_env()
    assert config["device"] == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tti.train_model(config)


def test_config_keys_match_jax(monkeypatch):
    """The same configuration keys and defaults as the JAX driver, DEVICE
    added; results default under build/."""
    for k in ("PRESET", "METHOD", "RESULTS_FILE", "DEVICE"):
        monkeypatch.delenv(k, raising=False)
    t, j = tti.get_config_from_env(), jti.get_config_from_env()
    assert set(t) - set(j) == {"device"} and set(j) <= set(t)
    for k in j:
        if k != "results_file":
            assert t[k] == j[k], k
    assert t["results_file"] == "build/image_results.csv"
    assert trr.HEADLINE == jrr.HEADLINE
