"""Headline-result reproduction runner (port of
tensornetworksfork_tpu/experiments/reproduce_result.py).

Pins the protocol of the repository's accuracy anchors: the type-I conv-TT
at the reference's headline configuration (N=4, r=18, CB=8, kernel 4/4,
batch 2048, eps 5.0 x 0.25, patience 10) on MNIST staged under DATA_PATH
(`mnist`; train_image's synthetic stand-in where none is staged), and
sklearn's 8x8 digits at kernel 2/2 (`digits`, the 10-seed gate of
RESULTS.md: 96.55 +/- 1.13 %). Each seed runs `train_image.train_model`
with the headline's variables set for its duration (the ambient
environment comes back after); DEVICE and PRECISION are read from the
environment as train_image reads them. Rows go to
`build/reproduce_<which>.csv`.

`digits_flat` is the second real-data anchor (RESULTS.md: 94.36 +/- 1.17 %
over seeds 42-51): the flat 64 pixels of digits, scaled to [0, 1] and
quantile-transformed to uniform (`data/tabular.py` QuantileTransformer,
sklearn's transform written out), through the TT regressor (N=3, r=8, 20
swipes) on a fixed split, on DEVICE (the card unless DEVICE=cpu).

Run:  python -m tensornetworksfork_tpu_torch.experiments.reproduce_result [digits|mnist|digits_flat]
"""
from __future__ import annotations

import os
import sys

import numpy as np

HEADLINE = {
    "mnist": dict(DATASET="MNIST", MODEL_TYPE="tt_type1", N="4", R="18",
                  CB="8", KERNEL_SIZE="4", KERNEL_STRIDE="4", NUM_SWIPES="5",
                  EPS="5.0", EPS_DECAY="0.25", EARLY_STOPPING="10",
                  BATCH_SIZE="2048"),
    # the real-image benchmark available offline (8x8 digits: kernel 2/2)
    "digits": dict(DATASET="digits", MODEL_TYPE="tt_type1", N="4", R="16",
                   CB="8", KERNEL_SIZE="2", KERNEL_STRIDE="2", NUM_SWIPES="6",
                   EPS="5.0", EPS_DECAY="0.25", EARLY_STOPPING="10",
                   BATCH_SIZE="512"),
}
# rows of each fixed test set: digits' 20 % of 1,797; MNIST's 10k
TEST_ROWS = {"digits": 359, "mnist": 10000}
SEEDS = (42, 43, 44, 45, 46, 47, 48, 49, 50, 51)


def summarize(which: str, results):
    """(mean, std, noise floor, summary line) of the test accuracies. The
    floor is the test set's binomial sampling noise at the mean: the
    seed-to-seed std cannot meaningfully drop below it."""
    accs = [r["test_accuracy"] for r in results]
    mean = float(np.mean(accs))
    p = mean / 100.0
    floor = float(100.0 * np.sqrt(p * (1 - p) / TEST_ROWS[which]))
    line = (f"{which}: {mean:.2f} +/- {np.std(accs):.2f} % over "
            f"{len(results)} seeds ({results[0]['num_parameters']} params); "
            f"test-set binomial noise floor ~{floor:.2f} %")
    return mean, float(np.std(accs)), floor, line


def main(which: str = "digits", seeds=SEEDS):
    """Runs the protocol of `which` once per seed and prints each seed's
    accuracy and the summary line. Returns the result dicts."""
    from ..utils.metrics import append_results_csv
    from . import train_image

    if which == "digits_flat":
        return run_digits_flat(seeds)
    saved = dict(os.environ)
    results = []
    try:
        for seed in seeds:
            os.environ.update(HEADLINE[which])
            os.environ["SEED"] = str(seed)
            os.environ.setdefault("VERBOSE", "0")
            config = train_image.get_config_from_env()
            res = train_image.train_model(config)
            append_results_csv(res, f"build/reproduce_{which}.csv")
            results.append(res)
            print(f"seed {seed}: test_accuracy {res['test_accuracy']}%",
                  flush=True)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    print(summarize(which, results)[3], flush=True)
    return results


def digits_flat_data():
    """The fixed split (seed 42) of digits' flat 64 pixels scaled by 1/16,
    each feature quantile-transformed to uniform, fitted on the train
    split."""
    from ..data.tabular import QuantileTransformer, sklearn_arrays, split_train_val_test
    data, target = sklearn_arrays("digits")
    X = np.asarray(data, np.float32) / 16.0
    y = np.asarray(target, np.float32)
    out = split_train_val_test(X, y.reshape(-1, 1), seed=42)
    qt = QuantileTransformer(n_quantiles=min(1000, len(out["X_train"])))
    out["X_train"] = qt.fit_transform(out["X_train"]).astype(np.float32)
    out["X_val"] = qt.transform(out["X_val"]).astype(np.float32)
    out["X_test"] = qt.transform(out["X_test"]).astype(np.float32)
    return out


def run_digits_flat(seeds=SEEDS, num_swipes: int = 20):
    """Flat-64 digits through the TT regressor (the reference's flat-MNIST
    protocol: bounded features keep a degree-N polynomial TT stable), one
    fit per seed on the fixed split; prints each seed's test accuracy and
    the mean. Returns the accuracies in percent."""
    from ..utils.config import RunConfig
    from ..utils.metrics import append_results_csv
    from .train_tabular import run

    data0 = digits_flat_data()
    accs = []
    for seed in seeds:
        data = {k: v.copy() for k, v in data0.items()}
        data["task"] = "classification"
        cfg = RunConfig(dataset="digits", model_type="tt", N=3, r=8,
                        num_swipes=num_swipes, eps=5.0, eps_decay=0.25,
                        batch_size=512, early_stopping=10, seed=seed, verbose=0,
                        results_file="build/reproduce_digits_flat.csv",
                        device=os.environ.get("DEVICE", "cuda"))
        res = run(cfg, data=data)
        accs.append(res["test_accuracy"] * 100)
        append_results_csv({**res, "seed": seed}, cfg.results_file)
        print(f"seed {seed}: test_accuracy {accs[-1]:.2f}%", flush=True)
    print(f"digits_flat: {np.mean(accs):.2f} +/- {np.std(accs):.2f} % "
          f"over {len(seeds)} seeds", flush=True)
    return accs


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "digits")
