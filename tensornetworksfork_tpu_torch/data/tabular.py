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

which needs sklearn. The UCI fetch (`load_ucirepo`) is not ported.
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
