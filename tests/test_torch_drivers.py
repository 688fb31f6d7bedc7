"""The experiment drivers (experiments/{sweep,grid_search,image_sweep,
prepare_data,reporting,plots}.py, utils/viz.py) against the JAX package's.

The search and the tables are numpy and pandas in both packages, so they are
held to equality. The fits inside a driver start from other initial draws in
the two packages (a torch.Generator against JAX's PRNG), so the drivers'
logic is held with the inner fit replaced by the same deterministic stub in
both, and one real run of each is held to the JAX test's own bounds
(tests/test_experiments.py, line numbers below).
"""
import ast
import builtins
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pd = pytest.importorskip("pandas")

from tensornetworksfork_tpu.experiments import grid_search as jgs  # noqa: E402
from tensornetworksfork_tpu.experiments import prepare_data as jprep  # noqa: E402
from tensornetworksfork_tpu.experiments import reporting as jrep  # noqa: E402
from tensornetworksfork_tpu.experiments import sweep as jsw  # noqa: E402
from tensornetworksfork_tpu.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as JConv)
from tensornetworksfork_tpu.utils import viz as jviz  # noqa: E402
from tensornetworksfork_tpu.utils.config import RunConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import grid_search as tgs  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import image_sweep as tis  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import plots as tplots  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import prepare_data as tprep  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import reporting as trep  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import sweep as tsw  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as TConv)
from tensornetworksfork_tpu_torch.utils import viz as tviz  # noqa: E402
from tensornetworksfork_tpu_torch.utils.config import RunConfig as TConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
NEW_MODULES = ["parallel/__init__.py", "parallel/mesh.py", "parallel/dryrun.py",
               "experiments/sweep.py", "experiments/grid_search.py",
               "experiments/image_sweep.py", "experiments/prepare_data.py",
               "experiments/reporting.py", "experiments/plots.py", "utils/viz.py"]


def _toy(c):
    """test_experiments.py:133: maximised at N=8, r=12, eps=1e-4."""
    return (-(c["N"] - 8) ** 2 / 36.0 - (c["r"] - 12) ** 2 / 100.0
            - (np.log10(c["eps"]) + 4) ** 2 / 16.0)


# ---------------------------------------------------------------- search
@pytest.mark.parametrize("seed", range(10))
def test_sample_config_matches_jax(seed):
    assert (tsw.sample_config(np.random.default_rng(seed))
            == jsw.sample_config(np.random.default_rng(seed)))


@pytest.mark.parametrize("seed", range(3))
def test_bayes_search_proposals_match_jax(seed):
    """30 ask/tell rounds on the toy objective: every proposal equal."""
    ts, js = tsw.BayesSearch(seed=seed), jsw.BayesSearch(seed=seed)
    for _ in range(30):
        c = ts.ask()
        assert c == js.ask()
        ts.tell(c, _toy(c))
        js.tell(c, _toy(c))


def test_bayes_search_converges_on_toy():
    """test_experiments.py:128-163's assertions on the port's search."""
    def run(searcher, n=30):
        best = -np.inf
        for _ in range(n):
            c = searcher.ask()
            searcher.tell(c, _toy(c))
            best = max(best, _toy(c))
        return best

    class RandomSearch:
        def __init__(self, seed):
            self.rng = np.random.default_rng(seed)

        def ask(self):
            return tsw.sample_config(self.rng)

        def tell(self, c, s):
            pass

    bayes = np.mean([run(tsw.BayesSearch(seed=s)) for s in range(3)])
    rand = np.mean([run(RandomSearch(seed=s)) for s in range(3)])
    assert bayes >= rand - 1e-9, (bayes, rand)
    assert bayes > -0.15, bayes


class StubEstimator:
    """The same deterministic stand-in for TensorTrainRegressor in both
    packages: predictions from the features and the config; N = 5 fails."""

    def __init__(self, **kw):
        self.kw = kw

    def fit(self, X, y, X_val=None, y_val=None):
        if self.kw["N"] == 5:
            raise RuntimeError("stub: singular")
        self.w = float(np.mean(y)) + 0.01 * self.kw["r"]
        return self

    def predict(self, X):
        X = np.asarray(X)
        out = self.w + 0.1 * X[:, :1] * np.log10(self.kw["eps_start"] + 1.0)
        if self.kw["task"] == "classification":
            return np.eye(3)[(np.abs(X[:, 0] * 7).astype(int) + self.kw["N"]) % 3]
        return out


def _both(monkeypatch, what, value):
    monkeypatch.setattr(tsw, what, value)
    monkeypatch.setattr(jsw, what, value)


def test_cv_score_guards_match_jax(monkeypatch):
    """test_experiments.py:327-351's corners: infeasible alike (the byte
    cap, the node cap, the cum_sum cap); the feasible CPD corner scored
    alike with the stub estimator."""
    _both(monkeypatch, "TensorTrainRegressor", StubEstimator)
    # the JAX test's shapes; random values, so the stub's r2 is finite
    rng = np.random.default_rng(2)
    X = rng.standard_normal((32, 64)).astype(np.float32)
    y = rng.standard_normal((32, 1)).astype(np.float32)
    base = dict(eps=1.0, num_swipes=1, cum_sum=False)
    cases = [dict(base, N=3, r=24, model_type="tt"),
             dict(base, N=16, r=2, model_type="tt_type1"),
             dict(base, N=2, r=24, model_type="cpd"),
             dict(base, N=4, r=2, model_type="tt", cum_sum=True)]
    for ov in cases:
        t = tsw.cv_score(TConfig(task="regression", verbose=0, device="cpu"), ov, X, y)
        j = jsw.cv_score(JConfig(task="regression", verbose=0), ov, X, y)
        assert t == j, ov
    assert tsw.cv_score(TConfig(task="regression", device="cpu"), cases[0], X, y)["infeasible"]
    assert not tsw.cv_score(TConfig(task="regression", device="cpu"), cases[2], X,
                            y).get("infeasible")


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_cv_score_matches_jax_with_a_stub(task, monkeypatch):
    _both(monkeypatch, "TensorTrainRegressor", StubEstimator)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((50, 4)).astype(np.float32)
    y = (np.eye(3, dtype=np.float32)[rng.integers(0, 3, 50)] if task == "classification"
         else rng.standard_normal((50, 1)).astype(np.float32))
    for ov in (dict(N=2, r=4, eps=0.5), dict(N=5, r=4, eps=0.5), dict(N=3, r=2, eps=3.0)):
        t = tsw.cv_score(TConfig(task=task, device="cpu"), ov, X, y)
        j = jsw.cv_score(JConfig(task=task), ov, X, y)
        assert t == j, ov


def _rows(path):
    return pd.read_csv(path).drop(columns=["timestamp"])


@pytest.mark.parametrize("search", ["bayes", "random"])
def test_run_sweep_matches_jax_with_a_stub(search, tmp_path, monkeypatch):
    """The local search, trial for trial: the same proposals, scores, best
    and CSV rows in both packages (8 trials: past BayesSearch's 5 random
    ones)."""
    _both(monkeypatch, "TensorTrainRegressor", StubEstimator)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((40, 3)).astype(np.float32)
    y = rng.standard_normal((40, 1)).astype(np.float32)
    t = tsw.run_sweep(TConfig(verbose=0, device="cpu"), X, y, n_trials=8,
                      results_file=str(tmp_path / "t.csv"), use_wandb=False, search=search)
    j = jsw.run_sweep(JConfig(verbose=0), X, y, n_trials=8,
                      results_file=str(tmp_path / "j.csv"), use_wandb=False, search=search)
    assert t == j
    pd.testing.assert_frame_equal(_rows(tmp_path / "t.csv"), _rows(tmp_path / "j.csv"))


def test_sweep_main_feeds_the_jax_data(monkeypatch):
    """main's data: the synthetic regression and the quantile-transformed
    digits (the port's bundled copy and transform against sklearn's) equal
    the JAX driver's, with the same config fields."""
    seen = {}

    def capture(pkg):
        def run_sweep(cfg, X, y, **kw):
            seen[pkg] = (cfg, X, y, kw["n_trials"])
        return run_sweep
    monkeypatch.setattr(tsw, "run_sweep", capture("torch"))
    monkeypatch.setattr(jsw, "run_sweep", capture("jax"))
    monkeypatch.setenv("TNF_SWEEP_TRIALS", "3")
    for dataset in ("synthetic", "digits"):
        tsw.main(["--dataset", dataset, "--device", "cpu"])
        jsw.main(["--dataset", dataset])
        (tc, tX, ty, tn), (jc, jX, jy, jn) = seen["torch"], seen["jax"]
        np.testing.assert_array_equal(tX, jX)
        np.testing.assert_array_equal(ty, jy)
        assert tn == jn == 3
        for k in ("task", "output_dim", "timeout", "seed"):
            assert getattr(tc, k) == getattr(jc, k), (dataset, k)


# ---------------------------------------------------------- grid search
def _stub_run(cfg, overrides=None):
    c = cfg.merge(overrides or {})
    out = {"dataset": c.dataset, "model_type": c.model_type, "N": c.N, "r": c.r,
           "seed": c.seed, "singular": c.r == 5 and c.seed == 43}
    if c.N != 4:
        out["val_rmse"] = 1.0 / (c.N * c.r) + 0.001 * (c.seed - 42)
    return out


def test_grid_search_matches_jax_with_a_stub(tmp_path, monkeypatch):
    """The grid, the best point, the test rows and the ablation CSV, with
    train_tabular.run replaced by the same stub in both packages (r = 5 at
    seed 43 singular, N = 4 without a metric)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tgs.train_tabular, "run", _stub_run)
    monkeypatch.setattr(jgs.train_tabular, "run", _stub_run)
    grid = {"N": [2, 3, 4], "r": [3, 5]}
    t = tgs.grid_search(TConfig(device="cpu"), grid, val_seeds=[42, 43], test_seeds=[52, 53])
    j = jgs.grid_search(JConfig(), grid, val_seeds=[42, 43], test_seeds=[52, 53])
    assert t == j
    pd.testing.assert_frame_equal(_rows("build/synthetic_ablation_results_tt.csv"),
                                  _rows("synthetic_ablation_results_tt.csv"))
    ta = tgs.run_ablation(TConfig(device="cpu"), "cpd_type1", N=[2], r=[3])
    ja = jgs.run_ablation(JConfig(), "cpd_type1", N=[2], r=[3])
    assert ta == ja and tgs.ABLATIONS == jgs.ABLATIONS


def test_grid_search_small(tmp_path, monkeypatch):
    """test_experiments.py:193-204 on the port, on the CPU."""
    monkeypatch.chdir(tmp_path)
    cfg = TConfig(dataset="synthetic", model_type="tt", num_swipes=2, eps=1e-3,
                  eps_decay=0.7, batch_size=512, verbose=0, device="cpu")
    out = tgs.grid_search(cfg, {"N": [2], "r": [3, 5]}, val_seeds=[42], test_seeds=[52, 53])
    assert "best_overrides" in out
    assert len(out["test_rows"]) == 2
    assert (tmp_path / "build" / "synthetic_ablation_results_tt.csv").exists()
    assert all(np.isfinite(r["test_rmse"]) and r["test_r2"] > 0.5 for r in out["test_rows"])


# ---------------------------------------------------------- image sweep
IMAGE_ENV = dict(N="2", R="3", CB="2", NUM_SWIPES="1", EARLY_STOPPING="4",
                 SYNTHETIC_SAMPLES="256", BATCH_SIZE="128", VERBOSE="0", DEVICE="cpu")


def test_image_sweep_in_process(tmp_path, monkeypatch):
    """run_config in-process on the synthetic stand-in: train_image's
    result row, the caller's environment restored; sweep() appends rows."""
    env = dict(IMAGE_ENV, DATA_PATH=str(tmp_path / "nodata"),
               RESULTS_FILE=str(tmp_path / "unused.csv"))
    monkeypatch.delenv("N", raising=False)
    res = tis.run_config(env)
    assert res["dataset"] == "MNIST-synthetic" and res["N"] == 2 and res["r"] == 3
    assert 0 <= res["test_accuracy"] <= 100 and not res["singular"]
    assert "N" not in os.environ
    monkeypatch.setattr(tis, "run_config", lambda ov, **kw: dict(ov, completed=True))
    rows = tis.sweep("CIFAR100", Ns=(2,), rs=(3,), CBs=(2, 4),
                     results_file=str(tmp_path / "rows.csv"))
    assert len(rows) == 4 and len(pd.read_csv(tmp_path / "rows.csv")) == 4
    assert tis.KERNEL_GRIDS == __import__(
        "tensornetworksfork_tpu.experiments.image_sweep", fromlist=["x"]).KERNEL_GRIDS


def test_image_sweep_subprocess_times_out(tmp_path):
    """subprocess mode with a timeout it cannot meet."""
    res = tis.run_config(dict(IMAGE_ENV, DATA_PATH=str(tmp_path)), timeout=0.01,
                         subprocess_mode=True)
    assert res["completed"] is False and res["timeout"] is True and res["N"] == "2"


# -------------------------------------------------- data prep and tables
def test_prepare_csv_matches_jax(tmp_path):
    """test_experiments.py:175-190's frame through both packages: the same
    npz arrays."""
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"len": rng.uniform(0, 1, 100),
                       "sex": rng.choice(["M", "F", "I"], 100),
                       "rings": rng.integers(1, 20, 100)})
    csv = str(tmp_path / "abalone.csv")
    df.to_csv(csv, index=False)
    t = tprep.prepare_csv(csv, "rings", "abalone", out_dir=str(tmp_path / "t"))
    j = jprep.prepare_csv(csv, "rings", "abalone", out_dir=str(tmp_path / "j"))
    assert t["X_train"].shape[1] == 4
    with np.load(tmp_path / "t" / "abalone_tensor.npz") as a, \
            np.load(tmp_path / "j" / "abalone_tensor.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


def _results_frame():
    rng = np.random.default_rng(4)
    n = 40
    return pd.DataFrame({"model_type": rng.choice(["tt", "cpd"], n),
                         "N": rng.integers(2, 4, n), "seed": np.arange(n),
                         "num_parameters": rng.integers(10, 400, n),
                         "test_accuracy": rng.uniform(0.5, 1.0, n)})


def test_reporting_matches_jax(tmp_path):
    df = _results_frame()
    for fn, args in ((lambda m: m.seed_averaged_table(df, ["model_type", "N"]), ()),
                     (lambda m: m.pareto_frontier(df), ()),
                     (lambda m: m.convergence_table(
                         [{"epoch": i, "val_rmse": 1.0 / (i + 1)} for i in range(5)]), ())):
        pd.testing.assert_frame_equal(fn(trep), fn(jrep))
    tab = jrep.seed_averaged_table(df, ["model_type", "N"])
    assert trep.to_latex_table(tab, caption="c_1") == jrep.to_latex_table(tab, caption="c_1")
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"r{i}.csv"))
        df.iloc[i * 20:(i + 1) * 20].to_csv(paths[-1], index=False)
    pd.testing.assert_frame_equal(trep.combine_result_files(paths),
                                  jrep.combine_result_files(paths))


def test_plots_write_their_files(tmp_path):
    df = _results_frame()
    traj = [[{"epoch": i, "val_rmse": 1.0 / (i + 1 + k)} for i in range(5)] for k in range(2)]
    tplots.convergence_plot(traj, labels=["a", "b"], path=str(tmp_path / "conv.png"))
    tplots.frontier_plot(df, group="model_type", path=str(tmp_path / "front.png"))
    tplots.seed_table_plot(df, ["model_type", "N"], path=str(tmp_path / "bars.png"))
    for name in ("conv.png", "front.png", "bars.png"):
        assert (tmp_path / name).stat().st_size > 1000, name


def test_reporting_and_plots_import_without_pandas_or_matplotlib():
    """The card's machine has neither: both modules import there."""
    code = ("import sys; sys.modules.update(pandas=None, matplotlib=None); "
            "import tensornetworksfork_tpu_torch.experiments.reporting, "
            "tensornetworksfork_tpu_torch.experiments.plots, "
            "tensornetworksfork_tpu_torch.experiments.prepare_data, "
            "tensornetworksfork_tpu_torch.utils.viz; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------------------------ viz
def _flagship_topologies():
    kw = dict(num_carriages=4, bond_dim=18, num_patches=50, patch_pixels=17,
              output_shape=(9,), convolution_bond=8, seed=0)
    return TConv(**kw, device="cpu").topology, JConv(**kw).topology


def test_visualize_topology_text_matches_jax(monkeypatch, tmp_path):
    """With matplotlib's import failing, both print the same listing."""
    real = builtins.__import__

    def no_plotting(name, *args, **kwargs):
        if name.split(".")[0] in ("matplotlib", "networkx"):
            raise ImportError(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_plotting)
    tt, jt = _flagship_topologies()
    text = tviz.visualize_topology(tt, path=str(tmp_path / "t.txt"))
    assert text == jviz.visualize_topology(jt)
    assert (tmp_path / "t.txt").read_text() == text
    assert text.startswith("topology:\n  column 0:") and "--" in text


def test_visualize_topology_graph_matches_jax(monkeypatch, tmp_path):
    """With networkx, both draw a graph of the same nodes and edges."""
    nx = pytest.importorskip("networkx")
    graphs = []
    monkeypatch.setattr(nx, "draw", lambda g, **kw: graphs.append(g))
    tt, jt = _flagship_topologies()
    tviz.visualize_topology(tt, path=str(tmp_path / "t.png"))
    jviz.visualize_topology(jt)
    tg, jg = graphs
    assert sorted(tg.nodes) == sorted(jg.nodes)
    assert sorted(map(sorted, tg.edges)) == sorted(map(sorted, jg.edges))
    assert (tmp_path / "t.png").exists()


# --------------------------------------------------------------- imports
@pytest.mark.parametrize("rel", NEW_MODULES)
def test_new_modules_import_no_jax(rel):
    """None of this slice's modules imports jax or the JAX package."""
    tree = ast.parse((ROOT / "tensornetworksfork_tpu_torch" / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "tensornetworksfork_tpu")]
    assert not bad, (rel, bad)
