"""Dataset preparation CLI (port of
tensornetworksfork_tpu/experiments/prepare_data.py).

The reference's `prep_file/prepare_*.py` family as one command: read a CSV
(pandas, imported inside the functions: the card's machine has none),
standardise numerics, one-hot categoricals with a total-width cap, 60/20/20
split, save `{name}_tensor.npz`.

Run:  python -m tensornetworksfork_tpu_torch.experiments.prepare_data \
          --csv abalone.csv --target rings --name abalone
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.tabular import one_hot_with_cap, prepare_dataset


def load_csv(path: str):
    """The CSV as a pandas DataFrame."""
    import pandas as pd

    return pd.read_csv(path)


def prepare_csv(csv_path: str, target: str, name: str, out_dir: str = "data",
                max_one_hot: int = 128, seed: int = 42,
                classification: bool = False):
    import pandas as pd

    df = load_csv(csv_path)
    if target not in df.columns:
        raise ValueError(f"target column {target!r} not in {list(df.columns)}")
    y = df[target].values
    feats = df.drop(columns=[target])
    cols = []
    for cname in feats.columns:
        col = feats[cname]
        cat = not pd.api.types.is_numeric_dtype(col)
        cols.append((cname, np.asarray(col.values), cat))
    X, names = one_hot_with_cap(cols, max_total_width=max_one_hot)
    if classification or y.dtype == object:
        classes, y = np.unique(y, return_inverse=True)
        print(f"classes: {list(classes)}")
    y = np.asarray(y, np.float32)
    splits = prepare_dataset(X, y, name, out_dir=out_dir, seed=seed)
    print(f"saved {os.path.join(out_dir, name + '_tensor.npz')}: "
          f"X {X.shape}, features: {len(names)}")
    return splits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--out_dir", default="data")
    ap.add_argument("--max_one_hot", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--classification", action="store_true")
    a = ap.parse_args(argv)
    prepare_csv(a.csv, a.target, a.name, a.out_dir, a.max_one_hot, a.seed,
                a.classification)


if __name__ == "__main__":
    main()
