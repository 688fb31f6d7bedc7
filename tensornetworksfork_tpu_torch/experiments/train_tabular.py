"""Tabular training CLI (port of tensornetworksfork_tpu/experiments/train_tabular.py).

Fits a model family on synthetic data, one of sklearn's bundled datasets
(iris, wine, breast_cancer, diabetes, digits: read from the copies in
`data/`, so no sklearn is needed) or a prepared `.npz`, and reports val/test
rmse and r2 (or accuracy), appending one row to `results_file`. Families:
`TensorTrainRegressor` (model_type tt | tt_type1 | cpd | cpd_type1, with
--cum_sum / --linear_dim), `tnml` (TNMLRegressor, min-max scaled sin-cos
features), `tt_batch` (TensorTrainBatchRegressor, --swipe_method), `mlp`
(MLPWrapper), `polynomial` (degree N, Ridge with alpha = eps) and `svm`
(SVMClfWrapper / SVMRegWrapper: sklearn's SVC / SVR at their defaults, that
is libsvm's SMO written out in torch; skipped, as in the JAX package, on a
classification table of more than 10,000 training rows). xgboost raises
NotImplementedError: xgboost is missing on the card's machine.

Run:  python -m tensornetworksfork_tpu_torch.experiments.train_tabular --dataset synthetic
      python -m tensornetworksfork_tpu_torch.experiments.train_tabular --dataset iris --model_type tnml
      python -m tensornetworksfork_tpu_torch.experiments.train_tabular --dataset digits --model_type svm
      python -m tensornetworksfork_tpu_torch.experiments.train_tabular --model_type tt_batch --swipe_method batch_block
      python -m tensornetworksfork_tpu_torch.experiments.train_tabular --dataset path/to/name_tensor.npz

It runs on the card; `--device cpu` runs it on the CPU. Without a visible
card and without `--device cpu` it raises RuntimeError.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..data.synthetic import make_regression
from ..data.tabular import (SKLEARN_DATASETS, load_sklearn_dataset,
                            load_tabular_data, split_train_val_test)
from ..models.baselines import (MLPWrapper, PolynomialRegressionWrapper, SVMClfWrapper,
                                SVMRegWrapper)
from ..models.estimators import TensorTrainRegressor
from ..models.module import TensorTrainBatchRegressor
from ..models.tnml import TNMLRegressor
from ..ops.bregman import XEBregman
from ..utils.config import RunConfig
from ..utils.device import resolve_device
from ..utils.metrics import accuracy, append_results_csv, r2_score, rmse

# model families of the JAX package's CLI that are not ported: the library
# each wraps is missing on the card's machine
_NOT_PORTED = {"xgboost": "xgboost"}
# the JAX package's CLI skips SVM classification above this many training rows
SVM_MAX_CLASSIFICATION_ROWS = 10_000


def build_model(cfg: RunConfig, input_dim: int):
    mt = cfg.model_type
    if mt in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported: it wraps {_NOT_PORTED[mt]}, "
            "which the card's machine does not have")
    device = resolve_device(cfg.device)
    if mt == "tnml":
        # the loaders standardize features; the sin-cos map wants [0, 1]
        return TNMLRegressor(
            input_scale="minmax",
            r=cfg.r, output_dim=cfg.output_dim, seed=cfg.seed, lr=cfg.lr,
            eps_start=cfg.eps, eps_decay=cfg.eps_decay, abs_err=cfg.abs_err,
            rel_err=cfg.rel_err, batch_size=cfg.batch_size, method=cfg.method,
            num_swipes=cfg.num_swipes, task=cfg.task,
            early_stopping=cfg.early_stopping, verbose=cfg.verbose,
            device=device)
    if mt == "tt_batch":
        return TensorTrainBatchRegressor(
            N=cfg.N, r=cfg.r, output_dim=cfg.output_dim,
            linear_dim=cfg.linear_dim, constrict_bond=cfg.constrict_bond,
            seed=cfg.seed, lr=cfg.lr, eps_start=cfg.eps,
            batch_size=cfg.batch_size, method=cfg.method,
            num_swipes=cfg.num_swipes, verbose=cfg.verbose,
            swipe_method=cfg.swipe_method, stream=cfg.stream, device=device)
    if mt == "mlp":
        # one logit per class: the JAX package passes the tensor networks'
        # C-1 (output_dim), which leaves the MLP no logit for the last class
        n_out = cfg.output_dim + 1 if cfg.task == "classification" else cfg.output_dim
        return MLPWrapper(input_dim, n_out, task=cfg.task, device=device)
    if mt == "polynomial":
        return PolynomialRegressionWrapper(degree=cfg.N, regularization="l2",
                                           alpha=cfg.eps, device=device)
    if mt == "svm":
        return (SVMClfWrapper(device=device) if cfg.task == "classification"
                else SVMRegWrapper(device=device))
    if mt not in ("tt", "tt_type1", "cpd", "cpd_type1"):
        raise ValueError(f"unknown model_type {mt!r}")
    return TensorTrainRegressor(
        N=cfg.N, r=cfg.r, output_dim=cfg.output_dim,
        linear_dim=cfg.linear_dim, constrict_bond=cfg.constrict_bond,
        perturb=cfg.perturb, seed=cfg.seed,
        bf=XEBregman(w=1.0) if cfg.task == "classification" else None,
        lr=cfg.lr, eps_start=cfg.eps, eps_decay=cfg.eps_decay,
        abs_err=cfg.abs_err, rel_err=cfg.rel_err,
        batch_size=cfg.batch_size, method=cfg.method,
        num_swipes=cfg.num_swipes, model_type=mt, task=cfg.task,
        train_operator=cfg.train_operator, cum_sum=cfg.cum_sum,
        early_stopping=cfg.early_stopping, verbose=cfg.verbose,
        timeout=cfg.timeout, precision=cfg.precision, refine=cfg.refine,
        solve_dtype=cfg.solve_dtype, device=device)


def load_data(cfg: RunConfig, data=None):
    """The split dict for cfg.dataset: synthetic (a RandomPolynomialRange
    target over 6 features, 4096 rows, from cfg.seed), a bundled dataset
    (which also sets cfg.task) or a prepared .npz."""
    if data is not None:
        if "task" in data:
            cfg.task = data.pop("task")
        return data
    if cfg.dataset == "synthetic":
        X, y = make_regression(S=4096, d=6, degree=3, seed=cfg.seed)
        return split_train_val_test(X, y, seed=cfg.seed)
    if cfg.dataset in SKLEARN_DATASETS:
        data = load_sklearn_dataset(cfg.dataset, seed=cfg.seed)
        cfg.task = data.pop("task")
        return data
    return load_tabular_data(cfg.dataset, cfg.data_path)


def run(cfg: RunConfig, overrides=None, data=None) -> dict:
    if overrides:
        cfg = cfg.merge(overrides)
    data = load_data(cfg, data)
    X_tr, y_tr = data["X_train"], data["y_train"]
    X_val, y_val = data["X_val"], data["y_val"]
    X_te, y_te = data["X_test"], data["y_test"]

    if cfg.task == "classification" and (y_tr.ndim == 1
                                         or y_tr.shape[-1] == 1):
        y_tr, y_val, y_te = (np.asarray(a).reshape(-1)
                             for a in (y_tr, y_val, y_te))
        n_cls = int(max(y_tr.max(), y_val.max(), y_te.max())) + 1
        eye = np.eye(n_cls, dtype=np.float32)
        y_tr, y_val, y_te = (eye[y_tr.astype(int)], eye[y_val.astype(int)],
                             eye[y_te.astype(int)])
        cfg.output_dim = n_cls - 1

    if (cfg.task == "classification" and cfg.model_type == "svm"
            and X_tr.shape[0] > SVM_MAX_CLASSIFICATION_ROWS):
        return {"skipped": True, "model_type": "svm"}

    model = build_model(cfg, X_tr.shape[1])
    t0 = time.time()
    raised = False
    try:
        if isinstance(model, (PolynomialRegressionWrapper, MLPWrapper, SVMClfWrapper,
                              SVMRegWrapper)):
            model.fit(X_tr, y_tr)
        else:
            model.fit(X_tr, y_tr, X_val=X_val, y_val=y_val)
    except torch.linalg.LinAlgError as e:
        print(f"training failed: {e}", file=sys.stderr)
        raised = True
    train_s = time.time() - t0

    # `singular` also records a sweep that stopped at a singular solve (the
    # JAX package's estimator drops that flag); such a model, the params it
    # stopped with or early stopping's best state, is still scored, as the
    # JAX package scores it
    results = dict(cfg.to_dict(),
                   singular=raised or not getattr(model, "fit_ok_", True),
                   train_seconds=round(train_s, 2))
    if not raised:
        for split, Xs, ys in (("val", X_val, y_val), ("test", X_te, y_te)):
            y_pred = model.predict(Xs)
            if cfg.task == "regression":
                yp = np.asarray(y_pred).reshape(ys.shape[0], -1)
                results[f"{split}_rmse"] = rmse(ys.reshape(yp.shape), yp)
                results[f"{split}_r2"] = r2_score(ys.reshape(yp.shape), yp)
            else:
                results[f"{split}_accuracy"] = accuracy(ys, y_pred)
    if cfg.verbose:
        print({k: v for k, v in results.items()
               if k.startswith(("val_", "test_", "train_", "singular"))})
    return results


def main(argv=None):
    cfg = RunConfig.from_args(argv)
    results = run(cfg)
    append_results_csv(results, cfg.results_file)


if __name__ == "__main__":
    main()
