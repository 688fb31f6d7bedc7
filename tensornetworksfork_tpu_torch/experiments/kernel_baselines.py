"""The kernel baselines on the tabular CLI's six tables.

The SVM runs through the tabular CLI (`train_tabular.run(model_type="svm")`,
sklearn's SVC / SVR at their defaults, written out in torch); the Gaussian
processes through `GaussianProcessWrapper` on the same splits (regression
on diabetes and synthetic, classification on the four labelled tables).
Each table reports the val/test metrics the CLI reports: accuracy, or rmse
and r2.

`results/kernel_baselines.json` holds sklearn's metrics on the same splits,
written by `studies/kernel_baselines_ref.py` on a machine with the JAX
package and sklearn; `compare` holds a run to it: accuracy within one row
of its split, rmse within `RMSE_RTOL` of sklearn's.

The wrappers' sklearn options (`OPTIONS`: SVC class_weight="balanced" and
break_ties, GPR restarts, GPC one_vs_one and warm_start) run on the tables
each applies to, through the wrappers on the same splits;
`results/kernel_baselines_options.json` holds sklearn's metrics for them,
written by `studies/kernel_baselines_options_ref.py`.

The GP kernel objects (`KERNEL_OPTIONS`: Matern, RationalQuadratic and RBF
kernels with free hyperparameters, in sums and products) run the same way
(`run_gp_kernels`); `results/gp_kernels.json` holds sklearn's metrics,
fitted θ and log-marginal likelihoods for them, written by
`studies/gp_kernels_ref.py`.

The last kernel options (`MORE_KERNEL_OPTIONS`: Matern at ν 1 and 0.75,
PairwiseKernel, SVC / SVR with a precomputed or a callable kernel, and a
user-written string kernel, `SequenceKernel`, on short DNA sequences) run
through the wrappers (`run_more`); `results/gp_kernels_more.json` holds
sklearn's metrics, fitted θ, log-marginal likelihoods, support sets and
decision values for them, and scipy's kv at `KV_NUS` x `kv_grid()`,
written by `studies/gp_kernels_more_ref.py`.

Run:  python -m tensornetworksfork_tpu_torch.experiments.kernel_baselines --device cpu
      python -m tensornetworksfork_tpu_torch.experiments.kernel_baselines --compare results/kernel_baselines.json
      python -m tensornetworksfork_tpu_torch.experiments.kernel_baselines --options --compare results/kernel_baselines_options.json
      python -m tensornetworksfork_tpu_torch.experiments.kernel_baselines --kernels --compare results/gp_kernels.json
      python -m tensornetworksfork_tpu_torch.experiments.kernel_baselines --more --compare results/gp_kernels_more.json

It runs on the card; `--device cpu` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict

import numpy as np

from ..utils.config import RunConfig
from ..utils.metrics import accuracy, r2_score, rmse
from . import train_tabular

TABLES = ("synthetic", "iris", "wine", "breast_cancer", "diabetes", "digits")
GP_TABLES = ("diabetes", "synthetic", "iris", "wine", "breast_cancer", "digits")
REFERENCE = "results/kernel_baselines.json"
# rmse against sklearn's, relative. The SVM follows libsvm's iterates; the
# card rounds a few kernel entries to the other float32 neighbour, which
# moves the solution by about the solver's tolerance at most. The GP
# regression on synthetic interpolates a noiseless polynomial (alpha 1e-10,
# lml ~ +17,600): its rmse, ~2.3e-5, is rounding in an ill-conditioned
# solve, and moves by ~4e-4 of itself between sklearn's LAPACK and torch's
RMSE_RTOL = {"svm": 1e-3, "gp": 1e-2}
# the options: (family, the wrapper's parameters, the tables it runs on).
# GPR restarts run on diabetes alone: on synthetic (a noiseless polynomial
# at alpha 1e-10) a restart climbs to θ ≈ (6.7, 1.9), where K's Cholesky is
# rounding: there the card and the CPU stop L-BFGS 4.3e-3 apart in θ and
# 3.2e-4 in lml (NVIDIA H100 80GB HBM3, 700 W), and sklearn's own answer
# moves with its BLAS thread count (θ (2.77, 1.50) by default, (6.71,
# 1.92) on one thread), so no reference holds there
OPTIONS = {
    "class_weight balanced": ("svm", {"class_weight": "balanced"}, ("wine", "digits", "iris")),
    "break_ties": ("svm", {"break_ties": True}, ("wine", "digits", "iris")),
    "n_restarts_optimizer 3": ("gp", {"n_restarts_optimizer": 3, "random_state": 0},
                               ("diabetes",)),
    "one_vs_one": ("gp", {"multi_class": "one_vs_one"}, ("iris", "wine", "digits")),
    "warm_start": ("gp", {"warm_start": True}, ("iris", "wine", "digits")),
}
OPTIONS_REFERENCE = "results/kernel_baselines_options.json"
# the GP kernel objects: (the kernel as one expression, the wrapper's other
# parameters, the tables it runs on). The expression is evaluated in
# sklearn's namespace by studies/gp_kernels_ref.py and in the port's
# (`kernel_from_expression`) here, so both sides build the same kernel
# from one text. Every kernel has free hyperparameters, so the optimiser
# runs: for the classifiers on each binary problem's own θ. Two diabetes
# cells have no reference and stay out (the kernels themselves are held to
# sklearn in tests/test_torch_gp_kernels.py):
# - C(1) * RBF([1.0] * 10): one length scale runs off to ~e^7.4 (a feature
#   the fit ignores), along which the lml is flat; sklearn's own θ moves
#   by 5.4e-5 between one BLAS thread and eight, and by 6.4e-2 between the
#   float32 table and its float64 copy (its gradient takes the feature
#   differences in X's dtype);
# - DotProduct(1) ** 2 + WhiteKernel(1): on the float32 table sklearn
#   forms X Xᵀ in float32, its first L-BFGS step's Cholesky fails there,
#   and it stops at θ = (0, 0) (lml -443.69); the port, in float64, and
#   sklearn on the table's float64 copy both reach θ = (-1.973, -0.784)
#   (lml -405.81).
# digits under C(1) * RBF(1) free stays out: sklearn's one-thread fit of
# its ten binary problems takes 53.7 s (one core of an AMD EPYC), past
# the 40 s that chip_smoke.py's phase 14 (v) may take. The readings come
# from `python studies/port_repairs_study.py cells --digits`
KERNEL_OPTIONS = {
    "matern 2.5 + white": ("C(1.0) * Matern(length_scale=1.0, nu=2.5) + WhiteKernel(1.0)",
                           {}, ("diabetes",)),
    "rational quadratic": ("C(1.0) * RationalQuadratic(length_scale=1.0, alpha=1.0)",
                           {}, ("diabetes",)),
    "rbf free": ("C(1.0) * RBF(1.0)", {}, ("iris", "wine")),
    "rbf free one_vs_one": ("C(1.0) * RBF(1.0)", {"multi_class": "one_vs_one"}, ("iris",)),
    "matern 1.5": ("C(1.0) * Matern(length_scale=1.0, nu=1.5)", {}, ("breast_cancer",)),
}
KERNELS_REFERENCE = "results/gp_kernels.json"
# the last kernel options: (family, the kernel, the wrapper's other
# parameters, the tables, the split). The kernel is an expression as in
# KERNEL_OPTIONS, "precomputed" (the fit takes `rbf_gram` of the training
# rows and predict the test rows' against them) or the name of a function
# here (a callable SVM kernel). "cli" is the CLI's split as it is (float32
# features); "cli float64" its float64 copy; "seed 0" `sequence_table`'s.
# Bounds: a finite-difference gradient (general-ν Matern, PairwiseKernel)
# moves θ by FD_THETA_ATOL at most, the others follow KERNEL_OPTIONS'.
# PairwiseKernel(metric="rbf") runs on iris's float64 copy: on the float32
# split sklearn's pairwise functions compute in float32, where a step of
# 1e-10 in log γ changes no entry, so its gradient is 0 and L-BFGS stops at
# θ₀ (lml -35.84), while the port computes in float64, as it does for every
# kernel (ROADMAP queue 3). A cell would leave the table only where
# sklearn's own θ moves between one BLAS thread and eight by more than its
# bound (the reference records that move)
MORE_KERNEL_OPTIONS = {
    "pairwise rbf": ("gp", "PairwiseKernel(metric='rbf')", {}, ("iris",), "cli float64"),
    "pairwise laplacian": ("gp", "C(1.0) * PairwiseKernel(metric='laplacian')", {},
                           ("iris", "wine"), "cli"),
    "matern nu 1": ("gp", "C(1.0) * Matern(length_scale=1.0, nu=1.0)", {}, ("iris",), "cli"),
    "matern nu 0.75 + white": ("gp", "C(1.0) * Matern(length_scale=1.0, nu=0.75) "
                                     "+ WhiteKernel(1.0)", {}, ("diabetes",), "cli"),
    "svc precomputed": ("svm", "precomputed", {}, ("iris", "digits"), "cli"),
    "svc callable linear": ("svm", "linear_gram", {}, ("iris", "digits"), "cli"),
    "svr precomputed": ("svm", "precomputed", {}, ("synthetic",), "cli"),
    "string kernel": ("gp", "SequenceKernel() + WhiteKernel(0.01)", {},
                      ("sequences", "sequence_labels"), "seed 0"),
}
MORE_REFERENCE = "results/gp_kernels_more.json"
# a fit through a finite-difference gradient (ε = 1e-10 multiplies K's
# rounding by 1e10): θ against sklearn's, the lml relative
FD_THETA_ATOL = 1e-3
FD_LML_RTOL = 1e-6
# the orders and the arguments at which kv is held to scipy's
KV_NUS = (0.3, 0.75, 1.0, 1.25, 3.7, 8.5)
# the SVM cells' decision values kept in the reference: the first test rows
SVM_DECISION_ROWS = 20
# the string kernel's tables and their tasks
SEQUENCE_TABLES = {"sequences": "regression", "sequence_labels": "classification"}


def kv_grid() -> np.ndarray:
    """x from 1e-12 to 700, and around 697.9, where scipy's kv falls to 0."""
    return np.concatenate([np.logspace(-12, np.log10(700.0), 64),
                           [1.9999, 2.0, 2.0001, 697.85, 697.9, 698.2, 699.0]])


class SequenceKernel:
    """A user's kernel on strings, after sklearn's example "Gaussian
    processes on discrete data structures": k(a, b) = Σ over every pair of
    characters of 1 where they match, else b = baseline_similarity (its one
    hyperparameter, in (1e-5, 1)); its gradient in log b is b times the
    number of pairs that differ (the example returns the number itself, the
    gradient in b, which L-BFGS-B then follows along a flat lml to
    different ends on different machines). Plain numpy with sklearn's kernel API (not a
    subclass of sklearn's Kernel, since the card's machine has no sklearn):
    the wrappers take it as a user-written kernel, run on the host."""

    def __init__(self, baseline_similarity=0.5, baseline_similarity_bounds=(1e-5, 1)):
        self.baseline_similarity = baseline_similarity
        self.baseline_similarity_bounds = baseline_similarity_bounds

    def get_params(self, deep=True):
        return dict(baseline_similarity=self.baseline_similarity,
                    baseline_similarity_bounds=self.baseline_similarity_bounds)

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self

    @property
    def hyperparameter_baseline_similarity(self):
        from ..models._gp_kernels import Hyperparameter
        return Hyperparameter("baseline_similarity", "numeric",
                              self.baseline_similarity_bounds)

    @property
    def hyperparameters(self):
        return [self.hyperparameter_baseline_similarity]

    @property
    def theta(self):
        h = self.hyperparameter_baseline_similarity
        return np.array([]) if h.fixed else np.log(np.hstack([self.baseline_similarity]))

    @theta.setter
    def theta(self, theta):
        if not self.hyperparameter_baseline_similarity.fixed:
            self.baseline_similarity = np.exp(theta[0])

    @property
    def bounds(self):
        h = self.hyperparameter_baseline_similarity
        return np.array([]) if h.fixed else np.log(np.vstack([h.bounds]))

    @property
    def n_dims(self):
        return self.theta.shape[0]

    @property
    def requires_vector_input(self):
        return False

    def is_stationary(self):
        return False

    def clone_with_theta(self, theta):
        cloned = type(self)(**self.get_params())
        cloned.theta = theta
        return cloned

    def _f(self, s1, s2):
        return sum(1.0 if c1 == c2 else self.baseline_similarity for c1 in s1 for c2 in s2)

    def _g(self, s1, s2):
        return self.baseline_similarity * sum(0.0 if c1 == c2 else 1.0
                                              for c1 in s1 for c2 in s2)

    def __call__(self, X, Y=None, eval_gradient=False):
        if Y is None:
            Y = X
        K = np.array([[self._f(x, y) for y in Y] for x in X])
        if eval_gradient:
            return K, np.array([[[self._g(x, y)] for y in Y] for x in X])
        return K

    def diag(self, X):
        return np.array([self._f(x, x) for x in X])

    def __eq__(self, b):
        return type(self) is type(b) and self.get_params() == b.get_params()

    def __repr__(self):
        return f"{type(self).__name__}(baseline_similarity={self.baseline_similarity:.3g})"


def sequence_table(task: str, seed: int = 0) -> dict:
    """Short DNA sequences (2-6 letters of ACGT) from a numpy seed, split
    40 / 20 / 20: regression on count(A) + count(G) / 2 plus noise 0.1, or
    classification on count(A) > count(T)."""
    rng = np.random.default_rng(seed)
    seqs = np.array(["".join(rng.choice(list("ACGT"), rng.integers(2, 7)))
                     for _ in range(80)])
    a = np.array([s.count("A") for s in seqs], float)
    if task == "classification":
        y = (a > np.array([s.count("T") for s in seqs])).astype(np.int64)
    else:
        y = a + 0.5 * np.array([s.count("G") for s in seqs]) + 0.1 * rng.normal(size=80)
    parts = (slice(0, 40), slice(40, 60), slice(60, 80))
    return {f"{k}_{split}": v[part] for split, part in zip(("train", "val", "test"), parts)
            for k, v in (("X", seqs), ("y", y))}


def rbf_gram(A, B, gamma: float) -> np.ndarray:
    """A precomputed kernel matrix (numpy, on the host): exp(-γ ‖a - b‖²)
    with ‖a‖² - 2 a·b + ‖b‖² clipped at 0, in float64."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    D = (A * A).sum(1)[:, None] - 2 * A @ B.T + (B * B).sum(1)[None, :]
    return np.exp(-gamma * np.maximum(D, 0))


def linear_gram(A, B) -> np.ndarray:
    """A callable SVM kernel (user code, numpy): the float64 dot products."""
    return np.asarray(A, np.float64) @ np.asarray(B, np.float64).T


def more_table(option: str, name: str):
    """`table(name)` under `option`'s split, its task, and the arrays the
    model takes: a precomputed option's X_* are `rbf_gram` of the rows
    against the training rows, γ = 1 / (n_features var(X_train))
    (sklearn's "scale")."""
    split = MORE_KERNEL_OPTIONS[option][4]
    data, task = table(name)
    if split == "cli float64":
        data = {k: np.asarray(v, np.float64) if k.startswith("X_") else v
                for k, v in data.items()}
    if MORE_KERNEL_OPTIONS[option][1] == "precomputed":
        Xtr = np.asarray(data["X_train"], np.float64)
        gamma = 1.0 / (Xtr.shape[1] * Xtr.var())
        data = dict(data, **{f"X_{s}": rbf_gram(data[f"X_{s}"], Xtr, gamma)
                             for s in ("train", "val", "test")})
    return data, task


def more_kernel(option: str, namespace=None):
    """The kernel of a MORE_KERNEL_OPTIONS entry: an expression evaluated
    with `namespace` (default the port's; SequenceKernel where it has none),
    or an SVM kernel ("precomputed" or the function of that name here)."""
    fam, kernel = MORE_KERNEL_OPTIONS[option][:2]
    if fam == "svm":
        return kernel if kernel == "precomputed" else globals()[kernel]
    if namespace is None:
        from ..models._gp_kernels import NAMESPACE as namespace
    return kernel_from_expression(kernel, dict({"SequenceKernel": SequenceKernel}, **namespace))


def more_model(option: str, task: str, device="cuda"):
    """The port's wrapper of a MORE_KERNEL_OPTIONS entry."""
    from ..models.baselines import GaussianProcessWrapper, SVMClfWrapper, SVMRegWrapper
    fam, _, params = MORE_KERNEL_OPTIONS[option][:3]
    if fam == "gp":
        return GaussianProcessWrapper(dict(params, kernel=more_kernel(option)), task=task,
                                      device=device)
    wrapper = SVMClfWrapper if task == "classification" else SVMRegWrapper
    return wrapper(dict(params, kernel=more_kernel(option)), device=device)


def svm_decision(model, X, task) -> np.ndarray:
    """An SVM's decision values (sklearn's decision_function for SVC,
    predict for SVR) on X's first SVM_DECISION_ROWS rows."""
    X = X[:SVM_DECISION_ROWS]
    return np.asarray(model.decision_function(X) if task == "classification"
                      else model.predict(X), np.float64)


def more_fit_record(option: str, model, data, task) -> dict:
    """A fitted model's val/test metrics and, for a GP, θ and the lml (as
    kernel_fit_record), for an SVM its SMO iterations, support_ and the
    decision values of the first test rows."""
    if MORE_KERNEL_OPTIONS[option][0] == "gp":
        return kernel_fit_record(model, data, task)
    return dict(metrics(model, data, task), n_iter=[int(v) for v in model.n_iter_],
                support=[int(v) for v in model.support_],
                decision=svm_decision(model, data["X_test"], task).tolist())


def run_more(device="cuda") -> dict:
    """{option: {table: more_fit_record}} over MORE_KERNEL_OPTIONS."""
    out = {}
    for option, (_, _, _, names, _) in MORE_KERNEL_OPTIONS.items():
        out[option] = {}
        for name in names:
            data, task = more_table(option, name)
            model = more_model(option, task, device)
            model.fit(data["X_train"], data["y_train"])
            out[option][name] = more_fit_record(option, model, data, task)
    return out


def compare_more(got: dict, want: dict) -> list:
    """The metrics at compare()'s bounds, and for a GP θ and the lml (within
    FD_THETA_ATOL and FD_LML_RTOL), for an SVM support_ equal and the
    decision values within sklearn's tol (1e-3), against the reference.
    Returns (option, table, what, got, want)."""
    bad = []
    for option, tables in got.items():
        fam = MORE_KERNEL_OPTIONS[option][0]
        ref = want["options"][option]
        mets = {t: {k: v for k, v in r.items() if k.startswith(("val_", "test_"))}
                for t, r in tables.items()}
        bad += [(option,) + b[1:] for b in compare(
            {fam: mets}, {fam: ref, "rows": want["rows"]})]
        for name, rec in tables.items():
            w = ref[name]
            if fam == "gp":
                checks = (("theta", np.abs(np.subtract(rec["theta"], w["theta"])).max(
                    initial=0.0) <= FD_THETA_ATOL),
                          ("lml", abs(rec["lml"] - w["lml"]) <= FD_LML_RTOL * abs(w["lml"])))
            else:
                checks = (("support", rec["support"] == w["support"]),
                          ("decision", np.abs(np.subtract(rec["decision"], w["decision"])).max()
                           <= 1e-3))
            bad += [(option, name, k, rec[k], w[k]) for k, ok in checks if not ok]
    return bad


def table(name: str, seed: int = 42):
    """The CLI's split of a table, its task, and the labels as 1-D ints for
    a classification table; "sequences" and "sequence_labels" are
    `sequence_table`'s regression and classification tables."""
    if name in SEQUENCE_TABLES:
        return sequence_table(SEQUENCE_TABLES[name]), SEQUENCE_TABLES[name]
    cfg = RunConfig(dataset=name, seed=seed, device="cpu")
    data = train_tabular.load_data(cfg)
    task = cfg.task
    if task == "classification":
        for k in ("y_train", "y_val", "y_test"):
            data[k] = np.asarray(data[k]).reshape(-1).astype(np.int64)
    return data, task


def scores(model, data, task) -> Dict[str, float]:
    """Fit `model` on the train split; its val/test metrics."""
    model.fit(data["X_train"], data["y_train"])
    return metrics(model, data, task)


def metrics(model, data, task) -> Dict[str, float]:
    """A fitted model's val/test metrics, as the CLI computes them."""
    out = {}
    for split in ("val", "test"):
        y, pred = data[f"y_{split}"], model.predict(data[f"X_{split}"])
        if task == "regression":
            pred = np.asarray(pred).reshape(y.shape[0], -1)
            out[f"{split}_rmse"] = rmse(y.reshape(pred.shape), pred)
            out[f"{split}_r2"] = r2_score(y.reshape(pred.shape), pred)
        else:
            out[f"{split}_accuracy"] = accuracy(y, np.asarray(pred))
    return out


def svm_scores(name: str, device="cuda") -> Dict[str, float]:
    res = train_tabular.run(RunConfig(dataset=name, model_type="svm", device=device))
    return {k: v for k, v in res.items() if k.startswith(("val_", "test_"))}


def gp_scores(name: str, device="cuda") -> Dict[str, float]:
    from ..models.baselines import GaussianProcessWrapper
    data, task = table(name)
    return scores(GaussianProcessWrapper(task=task, device=device), data, task)


def option_model(option: str, task: str, device="cuda"):
    """The port's wrapper of `option`'s family with its parameters."""
    from ..models.baselines import GaussianProcessWrapper, SVMClfWrapper, SVMRegWrapper
    fam, params = OPTIONS[option][:2]
    if fam == "gp":
        return GaussianProcessWrapper(dict(params), task=task, device=device)
    wrapper = SVMClfWrapper if task == "classification" else SVMRegWrapper
    return wrapper(dict(params), device=device)


def kernel_from_expression(expression: str, namespace=None):
    """A kernel expression of KERNEL_OPTIONS evaluated with the names of
    `namespace` (default: the port's kernels, `_gp_kernels.NAMESPACE`) and
    `inf`, nothing else."""
    if namespace is None:
        from ..models._gp_kernels import NAMESPACE as namespace
    return eval(expression, {"__builtins__": {}, "inf": math.inf}, dict(namespace))


def kernel_model(option: str, task: str, device="cuda"):
    """The port's GaussianProcessWrapper of a KERNEL_OPTIONS entry."""
    from ..models.baselines import GaussianProcessWrapper
    expression, params = KERNEL_OPTIONS[option][:2]
    return GaussianProcessWrapper(dict(params, kernel=kernel_from_expression(expression)),
                                  task=task, device=device)


def kernel_fit_record(model, data, task) -> dict:
    """A fitted kernel model's val/test metrics, its θ (each binary
    problem's in turn) and its log-marginal likelihood."""
    return dict(metrics(model, data, task), theta=[float(v) for v in model.theta_],
                lml=float(model.log_marginal_likelihood_value_))


def run_gp_kernels(device="cuda") -> dict:
    """{option: {table: kernel_fit_record}} over KERNEL_OPTIONS."""
    out = {}
    for option, (_, _, names) in KERNEL_OPTIONS.items():
        out[option] = {}
        for name in names:
            data, task = table(name)
            model = kernel_model(option, task, device)
            model.fit(data["X_train"], data["y_train"])
            out[option][name] = kernel_fit_record(model, data, task)
    return out


def compare_kernels(got: dict, want: dict) -> list:
    """compare() for {option: {table: record}} against the kernels'
    reference at the GP's bounds (the metrics only). Returns (option,
    table, metric, got, want)."""
    bad = []
    for option, tables in got.items():
        mets = {t: {k: v for k, v in r.items() if k not in ("theta", "lml")}
                for t, r in tables.items()}
        bad += [(option,) + b[1:] for b in compare(
            {"gp": mets}, {"gp": want["kernels"][option], "rows": want["rows"]})]
    return bad


def option_scores(option: str, name: str, device="cuda") -> Dict[str, float]:
    data, task = table(name)
    return scores(option_model(option, task, device), data, task)


def run_options(device="cuda") -> dict:
    """{option: {table: metrics}} over OPTIONS."""
    return {o: {t: option_scores(o, t, device) for t in tables}
            for o, (_, _, tables) in OPTIONS.items()}


def compare_options(got: dict, want: dict) -> list:
    """compare() for {option: {table: metrics}} against the options
    reference, each option at its family's bounds. Returns (option, table,
    metric, got, want)."""
    bad = []
    for option, tables in got.items():
        fam = OPTIONS[option][0]
        bad += [(option,) + b[1:] for b in compare(
            {fam: tables}, {fam: want["options"][option], "rows": want["rows"]})]
    return bad


def rows(name: str) -> Dict[str, int]:
    data, _ = table(name)
    return {s: int(len(data[f"y_{s}"])) for s in ("val", "test")}


def run(device="cuda") -> dict:
    return {"svm": {t: svm_scores(t, device) for t in TABLES},
            "gp": {t: gp_scores(t, device) for t in GP_TABLES}}


def compare(got: dict, want: dict) -> list:
    """The metrics of `got` ({"svm": {table: metrics}, "gp": ...}) that part
    from `want`'s: accuracy by more than one row of its split, rmse by more
    than RMSE_RTOL of want's. Returns (family, table, metric, got, want)."""
    bad = []
    for fam, tables in got.items():
        for name, metrics in tables.items():
            ref = want[fam][name]
            for key, value in metrics.items():
                w = ref[key]
                if key.endswith("_accuracy"):
                    n = want["rows"][name][key.split("_")[0]]
                    ok = abs(value - w) <= 1.0 / n + 1e-12
                elif key.endswith("_rmse"):
                    ok = abs(value - w) <= RMSE_RTOL[fam] * abs(w)
                else:                   # r2 follows rmse
                    continue
                if not ok:
                    bad.append((fam, name, key, value, w))
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--options", action="store_true",
                      help="run the wrappers' options (OPTIONS) instead of the defaults")
    what.add_argument("--kernels", action="store_true",
                      help="run the GP kernel objects (KERNEL_OPTIONS) instead of the defaults")
    what.add_argument("--more", action="store_true",
                      help="run the last kernel options (MORE_KERNEL_OPTIONS) instead of the "
                           "defaults")
    ap.add_argument("--compare", default=None,
                    help=f"a reference file to hold the run to (e.g. {REFERENCE}, "
                         f"{OPTIONS_REFERENCE} with --options, {KERNELS_REFERENCE} with "
                         f"--kernels, {MORE_REFERENCE} with --more)")
    args = ap.parse_args(argv)
    run_fn, compare_fn = ((run_options, compare_options) if args.options else
                          (run_gp_kernels, compare_kernels) if args.kernels else
                          (run_more, compare_more) if args.more else (run, compare))
    got = run_fn(args.device)
    print(json.dumps(got, indent=1))
    if args.compare:
        with open(args.compare) as f:
            bad = compare_fn(got, json.load(f))
        for b in bad:
            print("differs:", *b)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
