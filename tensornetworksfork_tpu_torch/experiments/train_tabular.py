"""Tabular training CLI (port of tensornetworksfork_tpu/experiments/train_tabular.py).

Fits a `TensorTrainRegressor` (model_type `tt` or `tt_type1`) on synthetic
data or a prepared `.npz` and reports val/test rmse and r2 (or accuracy),
appending one row to `results_file`. The other model families raise
NotImplementedError naming their ROADMAP item, as do the sklearn-bundled
datasets (the GPU machine has no sklearn).

Run:  python -m tensornetworksfork_tpu_torch.experiments.train_tabular --dataset synthetic
      python -m tensornetworksfork_tpu_torch.experiments.train_tabular --dataset path/to/name_tensor.npz
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..data.synthetic import make_regression
from ..data.tabular import load_tabular_data, split_train_val_test
from ..models.estimators import TensorTrainRegressor
from ..ops.bregman import XEBregman
from ..utils.config import RunConfig
from ..utils.metrics import accuracy, append_results_csv, r2_score, rmse

# model families of the JAX package's CLI that are not ported yet
_NOT_PORTED = {"cpd": 14, "cpd_type1": 14, "tnml": 15, "tt_batch": 15,
               "mlp": 15, "xgboost": 15, "svm": 15, "polynomial": 15}
SKLEARN_DATASETS = ("iris", "wine", "breast_cancer", "diabetes", "digits")


def resolve_device(cfg: RunConfig) -> torch.device:
    if cfg.device is not None:
        return torch.device(cfg.device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def build_model(cfg: RunConfig, input_dim: int):
    mt = cfg.model_type
    if mt in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported (ROADMAP item {_NOT_PORTED[mt]})")
    if mt not in ("tt", "tt_type1"):
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
        solve_dtype=cfg.solve_dtype, device=resolve_device(cfg))


def load_data(cfg: RunConfig, data=None):
    """The split dict for cfg.dataset: synthetic (a RandomPolynomialRange
    target over 6 features, 4096 rows, from cfg.seed) or a prepared .npz."""
    if data is not None:
        if "task" in data:
            cfg.task = data.pop("task")
        return data
    if cfg.dataset == "synthetic":
        X, y = make_regression(S=4096, d=6, degree=3, seed=cfg.seed)
        return split_train_val_test(X, y, seed=cfg.seed)
    if cfg.dataset in SKLEARN_DATASETS:
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} needs sklearn's bundled loaders, which "
            "are not ported (ROADMAP item 18); prepare an .npz instead")
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

    model = build_model(cfg, X_tr.shape[1])
    t0 = time.time()
    singular = False
    try:
        model.fit(X_tr, y_tr, X_val=X_val, y_val=y_val)
    except torch.linalg.LinAlgError as e:
        print(f"training failed: {e}", file=sys.stderr)
        singular = True
    singular = singular or not model.fit_ok_
    train_s = time.time() - t0

    results = dict(cfg.to_dict(), singular=singular,
                   train_seconds=round(train_s, 2))
    if not singular:
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
