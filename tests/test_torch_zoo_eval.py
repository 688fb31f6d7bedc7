"""The zoo gate's pieces in the port held against the JAX package: the
bundled datasets, the polynomial baseline, `train_tabular` over every new
family and dataset, and `zoo_eval` (its table and its `compare_tables`
verdicts).

- `load_sklearn_dataset` reads the committed `data/{name}.npz` copies, which
  must equal sklearn's arrays, and splits and standardises them with the
  JAX package's numpy code: every split bit-equal.
- `PolynomialRegressionWrapper` (sklearn's PolynomialFeatures + Ridge in
  the JAX package, torch here): the features bit-equal, and the
  predictions within (1e-4 + e) x max|pred| of sklearn's on every zoo
  dataset, e being sklearn's own float32 error (its distance from a
  float64 solve of the same system). Both solve in float32, as sklearn
  does for these inputs; on breast_cancer and diabetes (kernel systems of
  condition ~1e5-3e7) two float32 Cholesky solves differ by a few 1e-4,
  which is what e measures.
"""
import csv
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tensornetworksfork_tpu.data import tabular as jtab  # noqa: E402
from tensornetworksfork_tpu_torch.data import tabular as ttab  # noqa: E402

ZOO = ("iris", "wine", "breast_cancer", "diabetes")


@pytest.mark.parametrize("name", ZOO)
def test_committed_arrays_equal_sklearn(name):
    sk = pytest.importorskip("sklearn.datasets")
    ds = getattr(sk, f"load_{name}")()
    data, target = ttab.sklearn_arrays(name)
    assert data.dtype == ds.data.dtype and np.array_equal(data, ds.data)
    assert target.dtype == ds.target.dtype and np.array_equal(target, ds.target)


@pytest.mark.parametrize("name", ZOO + ("digits",))
@pytest.mark.parametrize("seed", [42, 7])
def test_splits_bit_equal_to_jax(name, seed):
    want = jtab.load_sklearn_dataset(name, seed=seed)
    got = ttab.load_sklearn_dataset(name, seed=seed)
    assert got.pop("task") == want.pop("task")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _zoo_data(name, seed):
    if name == "synthetic":
        from tensornetworksfork_tpu_torch.data.synthetic import make_regression
        X, y = make_regression(S=4096, d=6, degree=3, seed=seed)
        return ttab.split_train_val_test(X, y, seed=seed), "regression"
    d = ttab.load_sklearn_dataset(name, seed=seed)
    return d, d.pop("task")


def _float64_ridge(X, Y, Xt, alpha, degree):
    from tensornetworksfork_tpu_torch.models.baselines import polynomial_features
    Xp = polynomial_features(torch.tensor(X, dtype=torch.float64), degree)
    Tp = polynomial_features(torch.tensor(Xt, dtype=torch.float64), degree)
    Y = torch.tensor(Y, dtype=torch.float64)
    Xc, Yc = Xp - Xp.mean(0), Y - Y.mean(0)
    n, p = Xc.shape
    if p > n:
        coef = Xc.T @ torch.linalg.solve(Xc @ Xc.T + alpha * torch.eye(n, dtype=Xc.dtype), Yc)
    else:
        coef = torch.linalg.solve(Xc.T @ Xc + alpha * torch.eye(p, dtype=Xc.dtype), Xc.T @ Yc)
    return (Tp @ coef + (Y.mean(0) - Xp.mean(0) @ coef)).numpy()


@pytest.mark.parametrize("name", ZOO + ("synthetic",))
@pytest.mark.parametrize("seed", [42, 43, 44])
def test_polynomial_matches_sklearn_wrapper(name, seed):
    pytest.importorskip("sklearn")
    from sklearn.preprocessing import PolynomialFeatures
    from tensornetworksfork_tpu.models.baselines import PolynomialRegressionWrapper as JP
    from tensornetworksfork_tpu_torch.models.baselines import (
        PolynomialRegressionWrapper as TP, polynomial_features)
    d, task = _zoo_data(name, seed)
    y = d["y_train"]
    if task == "classification":
        y = np.eye(int(y.max()) + 1, dtype=np.float32)[y.reshape(-1).astype(int)]
    Xt = d["X_test"]
    assert np.array_equal(polynomial_features(torch.tensor(Xt), 3).numpy(),
                          PolynomialFeatures(3).fit_transform(Xt))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # scipy's ill-conditioning warning
        pj = np.asarray(JP(degree=3, regularization="l2", alpha=0.5)
                        .fit(d["X_train"], y).predict(Xt))
    pt = TP(degree=3, regularization="l2", alpha=0.5, device="cpu").fit(
        d["X_train"], y).predict(Xt)
    assert pt.shape == pj.shape and pt.dtype == pj.dtype == np.float32
    scale = np.abs(pj).max()
    e_sk = np.abs(pj - _float64_ridge(d["X_train"], y, Xt, 0.5, 3).reshape(pj.shape)).max() / scale
    assert np.abs(pt - pj).max() <= (1e-4 + e_sk) * scale


def test_polynomial_pinv_matches_and_lasso_raises():
    """regularization=None fits the pseudo-inverse (no intercept), as the
    JAX package's numpy pinv; "l1" (Lasso), which raised until it was
    ported, fits as the JAX package's sklearn Lasso does
    (tests/test_torch_baselines_nn.py holds it to sklearn on iris and
    diabetes); another regularization raises."""
    from tensornetworksfork_tpu.models.baselines import PolynomialRegressionWrapper as JP
    from tensornetworksfork_tpu_torch.models.baselines import PolynomialRegressionWrapper as TP
    d, _ = _zoo_data("synthetic", 42)
    pj = JP(degree=2).fit(d["X_train"], d["y_train"]).predict(d["X_test"])
    pt = TP(degree=2, device="cpu").fit(d["X_train"], d["y_train"]).predict(d["X_test"])
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4 * np.abs(pj).max())
    lj = JP(degree=2, regularization="l1", alpha=0.01).fit(
        d["X_train"], d["y_train"]).predict(d["X_test"])
    lt = TP(degree=2, regularization="l1", alpha=0.01, device="cpu").fit(
        d["X_train"], d["y_train"]).predict(d["X_test"])
    assert lt.shape == lj.shape
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4 * np.abs(lj).max())
    with pytest.raises(ValueError, match="regularization"):
        TP(regularization="l3", device="cpu")


@pytest.mark.parametrize("dataset", ZOO + ("synthetic",))
def test_train_tabular_runs_every_new_family(dataset, tmp_path):
    """cpd, cpd_type1, tnml, polynomial, cum_sum and linear_dim through
    train_tabular.run on the CPU: each row has finite test metrics."""
    from tensornetworksfork_tpu_torch.experiments.train_tabular import run
    from tensornetworksfork_tpu_torch.utils.config import RunConfig
    for over in (dict(model_type="cpd"), dict(model_type="cpd_type1"),
                 dict(model_type="tnml"), dict(model_type="polynomial"),
                 dict(model_type="tt", cum_sum=True),
                 dict(model_type="tt", linear_dim=4)):
        cfg = RunConfig(dataset=dataset, N=3, r=4, num_swipes=1, device="cpu",
                        verbose=0, results_file=str(tmp_path / "r.csv"))
        res = run(cfg, overrides=over)
        key = "test_r2" if res["task"] == "regression" else "test_accuracy"
        assert np.isfinite(res[key]), (dataset, over, res)


def test_train_tabular_cli_needs_a_card_or_the_cpu(tmp_path):
    from tensornetworksfork_tpu_torch.experiments import train_tabular
    out = tmp_path / "r.csv"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_tabular.main(["--dataset", "iris", "--model_type", "tnml",
                                "--results_file", str(out)])
    train_tabular.main(["--dataset", "iris", "--model_type", "cpd_type1",
                        "--num_swipes", "1", "--device", "cpu",
                        "--results_file", str(out)])
    rows = list(csv.DictReader(open(out)))
    assert len(rows) == 1 and rows[0]["model_type"] == "cpd_type1"
    assert float(rows[0]["test_accuracy"]) > 0.5


def _perturbed(src, dst, family=None, cell=None, delta=0.0, drop=None):
    rows = list(csv.DictReader(open(src)))
    fields = list(rows[0])
    out = []
    for r in rows:
        key = (r["dataset"], r["family"])
        if drop is not None and key == drop:
            continue
        if (family is not None and r["family"] == family) or key == cell:
            for k in ("test_accuracy", "test_r2"):
                if r[k] not in ("", None):
                    r[k] = str(float(r[k]) + delta)
        out.append(r)
    with open(dst, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(out)
    return dst


@pytest.mark.parametrize("kind", ["same", "family_small", "family_large",
                                  "cell_large", "dropped"])
def test_compare_tables_gives_the_jax_verdicts(kind, tmp_path):
    from tensornetworksfork_tpu.experiments import zoo_eval as jz
    from tensornetworksfork_tpu_torch.experiments import zoo_eval as tz
    base = "results/zoo_eval.csv"
    kw = {"same": {}, "family_small": dict(family="tt", delta=0.003),
          "family_large": dict(family="cpd", delta=-0.02),
          "cell_large": dict(cell=("wine", "tnml"), delta=0.03),
          "dropped": dict(drop=("iris", "polynomial"))}[kind]
    other = _perturbed(base, str(tmp_path / "o.csv"), **kw)
    want = jz.compare_tables(base, other)
    assert tz.compare_tables(base, other) == want
    assert (want == []) == (kind in ("same", "family_small"))
    assert tz._load_metrics(other) == jz._load_metrics(other)


def test_zoo_eval_quick_on_the_cpu(tmp_path):
    """--quick: iris x all eight families x seed 42, 0 failed fits, one row
    each; the table's families and datasets are the JAX package's."""
    from tensornetworksfork_tpu.experiments import zoo_eval as jz
    from tensornetworksfork_tpu_torch.experiments import zoo_eval as tz
    assert tz.DATASETS == jz.DATASETS and tz.SEEDS == jz.SEEDS
    assert tz.FAMILIES == jz.FAMILIES
    out = tmp_path / "z.csv"
    assert tz.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    rows = list(csv.DictReader(open(out)))
    assert sorted(r["family"] for r in rows) == sorted(tz.FAMILIES)
    assert all(r["dataset"] == "iris" and float(r["test_accuracy"]) > 0.5
               for r in rows)
    assert tz.main(["--compare", str(out), str(out)]) == 0


def _chip_smoke():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_zoo_floors():
    """chip_smoke's family floors on the committed table: 2 x the committed
    table's pooled within-cell seed sd x sqrt(1/15 + 1/15) for every family
    (the stated values, to their 0.05-point rounding), and for tt_linear 2 x
    the sd pooled from studies/zoo_seed_sd.json's per-cell sds (the JAX
    package over 60 seeds) x the same root."""
    import json
    cs = _chip_smoke()
    from tensornetworksfork_tpu_torch.experiments import zoo_eval as tz
    base = tz._load_metrics("results/zoo_eval.csv")
    with open(cs.ZOO_SEED_SD) as f:
        sd = json.load(f)
    assert sd["family"] == "tt_linear" and sd["seeds"] == [42, 101]
    assert sorted(sd["cells"]) == sorted(tz.DATASETS)
    assert all(c["n"] == 60 for c in sd["cells"].values())
    floors = cs.zoo_floors(base, 15, sd)
    stated = dict(cpd=4.9, cpd_type1=2.1, tnml=4.6, tt=3.1, tt_cumsum=3.8,
                  tt_linear=1.8, tt_type1=3.6)
    for fam, want in stated.items():
        assert abs(floors[fam][1] - want) <= 0.051, (fam, floors[fam])
        if fam != "tt_linear":
            assert floors[fam][0] == floors[fam][1]
    var = np.mean([c["sd"] ** 2 for c in sd["cells"].values()])
    want = 200.0 * np.sqrt(var) * np.sqrt(2.0 / 15.0)
    assert floors["tt_linear"][0] == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("rows,D", [(65536, 32), (512, 96)])
def test_chip_smoke_weighted_float64_check_sees_rounding(rows, D):
    """chip_smoke's float64 check of K7 and K9 at the zoo's shapes
    (weighted_to_float64) passes the plain f32 weighted Gram and fails the
    same Gram of operands rounded to bf16 or to TF32."""
    cs = _chip_smoke()
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    rng = np.random.default_rng(rows + D)
    X = torch.tensor(rng.standard_normal((rows, D), np.float32))
    h = torch.tensor(rng.uniform(0.5, 2.0, rows).astype(np.float32))
    cs.weighted_to_float64("plain", kg.mirror_gram(kg.weighted_gram_plain(X, h)), X, h)
    for rounded in (X.to(torch.bfloat16), cs.tf32_round(X)):
        A = kg.mirror_gram(kg.weighted_gram_plain(rounded, h))
        with pytest.raises(AssertionError, match="float64 ratios"):
            cs.weighted_to_float64("rounded", A, X, h)
