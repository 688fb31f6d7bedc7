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

`digits_flat` needs sklearn's QuantileTransformer, which the card's machine
lacks, and is not ported (ROADMAP item 18).

Run:  python -m tensornetworksfork_tpu_torch.experiments.reproduce_result [digits|mnist]
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
        raise NotImplementedError(
            "digits_flat needs sklearn's QuantileTransformer, which the "
            "card's machine lacks (ROADMAP item 18)")
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


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "digits")
