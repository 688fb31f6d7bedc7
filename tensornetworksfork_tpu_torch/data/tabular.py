"""Tabular dataset preparation (port of tensornetworksfork_tpu/data/tabular.py:
standardize, split, persist and load; numpy only).

A prepared dataset is an `.npz` dict with X/y x train/val/test, written by
`prepare_dataset` as `{name}_tensor.npz`.

sklearn's bundled datasets (iris, wine, breast_cancer, diabetes) are read
from copies committed beside this module, `{name}.npz` (digits from
`digits.npz`, see `images.py`), so that a machine without sklearn loads the
same arrays; `load_sklearn_dataset` splits and standardises them with the
JAX package's numpy code. Rewrite the copies with

    python -m tensornetworksfork_tpu_torch.data.tabular --write-sklearn

which needs sklearn. `one_hot_with_cap` and `combine_datasets` (with
`padw`) are the JAX package's numpy code. `QuantileTransformer` is
sklearn's quantile transform to a uniform output written out in numpy (the
card's machine has no sklearn), for `reproduce_result digits_flat`. The UCI
fetch (`load_ucirepo`) is not ported: it needs the network.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

DATA_DIR = os.path.dirname(os.path.abspath(__file__))
# name -> task, for the bundled datasets
SKLEARN_DATASETS = {"iris": "classification", "wine": "classification",
                    "breast_cancer": "classification",
                    "diabetes": "regression", "digits": "classification"}


def one_hot_with_cap(df_columns, max_total_width: int = 128):
    """Given a list of (name, values, is_categorical), one-hot encode the
    categoricals with the total encoded width capped: categories are added
    in frequency order until the cap, the rest map to an 'other' column.
    Returns (X f32, column names)."""
    pieces = []
    names = []
    width = sum(1 for _, _, cat in df_columns if not cat)
    for name, values, cat in df_columns:
        if not cat:
            pieces.append(np.asarray(values, np.float32).reshape(-1, 1))
            names.append(name)
            continue
        values = np.asarray(values)
        uniq, counts = np.unique(values, return_counts=True)
        order = uniq[np.argsort(-counts)]
        budget = max(1, max_total_width - width)
        kept = list(order[:budget])
        other = len(kept) < len(order)
        width += len(kept) + (1 if other else 0)
        cols = np.zeros((len(values), len(kept) + (1 if other else 0)), np.float32)
        for j, cat_val in enumerate(kept):
            cols[values == cat_val, j] = 1.0
        if other:
            cols[~np.isin(values, kept), -1] = 1.0
            names += [f"{name}={v}" for v in kept] + [f"{name}=<other>"]
        else:
            names += [f"{name}={v}" for v in kept]
        pieces.append(cols)
    return np.concatenate(pieces, axis=1), names


def standardize(X: np.ndarray, mean=None, std=None):
    mean = X.mean(axis=0) if mean is None else mean
    std = X.std(axis=0) if std is None else std
    std = np.where(std == 0, 1.0, std)
    return (X - mean) / std, mean, std


def split_train_val_test(X, y, seed: int = 42, fractions=(0.6, 0.2, 0.2)):
    """Shuffled 60/20/20 split."""
    n = X.shape[0]
    idx = np.random.RandomState(seed).permutation(n)
    n_tr = int(fractions[0] * n)
    n_va = int(fractions[1] * n)
    tr, va, te = idx[:n_tr], idx[n_tr:n_tr + n_va], idx[n_tr + n_va:]
    return {
        "X_train": X[tr], "y_train": y[tr],
        "X_val": X[va], "y_val": y[va],
        "X_test": X[te], "y_test": y[te],
    }


def prepare_dataset(X, y, name: str, out_dir: str = "data", seed: int = 42
                    ) -> Dict[str, np.ndarray]:
    """Split, standardize X (fitted on train), save {name}_tensor.npz."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    if y.ndim == 1:
        y = y[:, None]
    splits = split_train_val_test(X, y, seed=seed)
    Xtr, mean, std = standardize(splits["X_train"])
    splits["X_train"] = Xtr
    splits["X_val"] = standardize(splits["X_val"], mean, std)[0]
    splits["X_test"] = standardize(splits["X_test"], mean, std)[0]
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{name}_tensor.npz"), **splits)
    return splits


def load_tabular_data(path_or_name: str, data_dir: str = "data"
                      ) -> Dict[str, np.ndarray]:
    """Loads a prepared dataset: a path to an .npz, or a name looked up as
    {data_dir}/{name}_tensor.npz."""
    path = path_or_name
    if not os.path.exists(path):
        path = os.path.join(data_dir, f"{path_or_name}_tensor.npz")
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def padw(X, width: int) -> np.ndarray:
    """X as f32, right-padded with zero columns to `width`."""
    X = np.asarray(X, np.float32)
    if X.shape[1] < width:
        X = np.concatenate(
            [X, np.zeros((X.shape[0], width - X.shape[1]), np.float32)], 1)
    return X


def combine_datasets(datasets, seed: int = 42):
    """Concatenates prepared split dicts into one: feature widths
    right-padded with zeros to the widest (`padw`), each split concatenated
    and reshuffled by RandomState(seed)."""
    keys = ["X_train", "y_train", "X_val", "y_val", "X_test", "y_test"]
    width = max(d["X_train"].shape[1] for d in datasets)
    out = {}
    for k in keys:
        parts = [padw(d[k], width) if k.startswith("X") else np.asarray(d[k])
                 for d in datasets]
        out[k] = np.concatenate(parts, axis=0)
    rng = np.random.RandomState(seed)
    for prefix in ("train", "val", "test"):
        idx = rng.permutation(out[f"X_{prefix}"].shape[0])
        out[f"X_{prefix}"] = out[f"X_{prefix}"][idx]
        out[f"y_{prefix}"] = out[f"y_{prefix}"][idx]
    return out


class QuantileTransformer:
    """sklearn.preprocessing.QuantileTransformer with
    output_distribution="uniform", on dense arrays: each feature mapped
    through its empirical CDF onto [0, 1].

    fit: n_quantiles_ = min(n_quantiles, rows) references evenly spaced on
    [0, 1], and each column's percentiles at them (`np.nanpercentile`,
    linear), over a subsample of `subsample` rows (drawn without
    replacement by shuffling, as `sklearn.utils.resample`) when there are
    more rows than that. transform: the mean of the forward and the
    reversed linear interpolation (repeated quantiles map to the middle of
    their run), values at or past the ends clipped to 0 and 1 (np.interp
    holds the end values), NaN kept. f32 and f64 inputs keep their type,
    others become f64."""

    def __init__(self, n_quantiles: int = 1000, output_distribution: str = "uniform",
                 subsample: int = 10_000, random_state=None):
        if output_distribution != "uniform":
            raise ValueError("only output_distribution='uniform' is written out")
        self.n_quantiles = int(n_quantiles)
        self.output_distribution = output_distribution
        self.subsample = subsample
        self.random_state = random_state

    @staticmethod
    def _float(X, copy: bool) -> np.ndarray:
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            return X.astype(np.float64)
        return X.copy() if copy else X

    def fit(self, X):
        if self.subsample is not None and self.n_quantiles > self.subsample:
            raise ValueError(f"n_quantiles {self.n_quantiles} > subsample {self.subsample}")
        X = self._float(X, copy=False)
        n = X.shape[0]
        self.n_quantiles_ = max(1, min(self.n_quantiles, n))
        self.references_ = np.linspace(0, 1, self.n_quantiles_, endpoint=True)
        if self.subsample is not None and self.subsample < n:
            rs = self.random_state
            rng = (rs if isinstance(rs, np.random.RandomState)
                   else np.random.mtrand._rand if rs is None
                   else np.random.RandomState(rs))
            idx = np.arange(n)
            rng.shuffle(idx)
            X = X[idx[:self.subsample]]
        self.quantiles_ = np.nanpercentile(X, self.references_ * 100, axis=0)
        return self

    def transform(self, X) -> np.ndarray:
        X = self._float(X, copy=True)
        refs = self.references_
        for j in range(X.shape[1]):
            col, q = X[:, j], self.quantiles_[:, j]
            lower, upper = col == q[0], col == q[-1]
            finite = ~np.isnan(col)
            xf = col[finite]
            col[finite] = 0.5 * (np.interp(xf, q, refs)
                                 - np.interp(-xf, -q[::-1], -refs[::-1]))
            col[upper] = 1
            col[lower] = 0
            X[:, j] = col
        return X

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)


def sklearn_file(name: str) -> str:
    return os.path.join(DATA_DIR, f"{name}.npz")


def write_sklearn(names=("iris", "wine", "breast_cancer", "diabetes")) -> None:
    """Store the `data` and `target` arrays of sklearn's bundled loaders,
    as they come, in `{name}.npz` beside this module."""
    from sklearn import datasets as skd
    for name in names:
        ds = getattr(skd, f"load_{name}")()
        np.savez_compressed(sklearn_file(name), data=ds.data, target=ds.target)


def sklearn_arrays(name: str):
    """(data, target) of a bundled dataset, read from its committed copy."""
    if name == "digits":
        from .images import load_digits_arrays
        images, target = load_digits_arrays()
        return images.reshape(len(images), -1), target
    with np.load(sklearn_file(name)) as d:
        return d["data"], d["target"]


def load_sklearn_dataset(name: str, seed: int = 42) -> Dict[str, np.ndarray]:
    """A bundled dataset, standardized (on the train split) and split
    60/20/20; a regression target is standardized first. `task` names the
    task."""
    if name not in SKLEARN_DATASETS:
        raise ValueError(f"unknown bundled dataset {name!r}")
    task = SKLEARN_DATASETS[name]
    data, target = sklearn_arrays(name)
    X = np.asarray(data, np.float32)
    y = np.asarray(target, np.float32)
    if task == "regression":
        y = (y - y.mean()) / y.std()
    splits = split_train_val_test(X, y.reshape(-1, 1), seed=seed)
    Xtr, mean, std = standardize(splits["X_train"])
    splits["X_train"] = Xtr
    splits["X_val"] = standardize(splits["X_val"], mean, std)[0]
    splits["X_test"] = standardize(splits["X_test"], mean, std)[0]
    splits["task"] = task
    return splits


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--write-sklearn", action="store_true",
                    help="store sklearn's iris, wine, breast_cancer and diabetes "
                         f"as {DATA_DIR}/<name>.npz (needs sklearn)")
    if ap.parse_args().write_sklearn:
        write_sklearn()
