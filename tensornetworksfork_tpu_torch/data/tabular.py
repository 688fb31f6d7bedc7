"""Tabular dataset preparation (port of tensornetworksfork_tpu/data/tabular.py:
standardize, split, persist and load; numpy only).

A prepared dataset is an `.npz` dict with X/y x train/val/test, written by
`prepare_dataset` as `{name}_tensor.npz`. The sklearn-bundled loaders
(`load_sklearn_dataset`) and the UCI fetch (`load_ucirepo`) are not ported
yet.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


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
