"""Model-zoo breadth table over the bundled tabular datasets (port of
tensornetworksfork_tpu/experiments/zoo_eval.py).

Every model family x dataset x seed, one CSV row each, through the same
`train_tabular.run()` path users call: a fixed small config (N=3, r=6, 10
swipes, eps 0.5 x 0.5, 512-row chunks), a capability table, not a tuned
accuracy benchmark. The JAX package's committed table is
`results/zoo_eval.csv`; `--compare BASE OTHER` gates one table against
another without fitting.

    python -m tensornetworksfork_tpu_torch.experiments.zoo_eval [--quick]
        [--out build/zoo_eval.csv] [--seeds 3] [--device cpu]
    python -m tensornetworksfork_tpu_torch.experiments.zoo_eval \\
        --compare results/zoo_eval.csv build/zoo_eval.csv

It runs on the card; `--device cpu` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import collections
import csv
import math
import sys
import time

from ..utils.config import RunConfig
from ..utils.metrics import append_results_csv
from .train_tabular import run

DATASETS = ("iris", "wine", "breast_cancer", "diabetes", "synthetic")

# name -> RunConfig overrides (model family selectors)
FAMILIES = {
    "tt": dict(model_type="tt"),
    "tt_type1": dict(model_type="tt_type1"),
    "cpd": dict(model_type="cpd"),
    "cpd_type1": dict(model_type="cpd_type1"),
    "tt_cumsum": dict(model_type="tt", cum_sum=True),
    "tt_linear": dict(model_type="tt", linear_dim=6),
    "tnml": dict(model_type="tnml"),
    "polynomial": dict(model_type="polynomial"),
}

SEEDS = (42, 43, 44)
# the table's config, as the JAX package's
ZOO_CONFIG = dict(N=3, r=6, num_swipes=10, eps=0.5, eps_decay=0.5,
                  batch_size=512, verbose=0)


def _load_metrics(path):
    """CSV -> {(dataset, family): [metric per row]} using the task's headline
    metric (test_accuracy for classification, test_r2 for regression)."""
    cells = collections.defaultdict(list)
    with open(path) as f:
        for r in csv.DictReader(f):
            for k in ("test_accuracy", "test_r2"):
                v = r.get(k)
                if v not in (None, ""):
                    cells[(r["dataset"], r["family"])].append(float(v))
                    break
    return cells


def compare_tables(base_csv, other_csv, family_tol_pp=0.5, cell_tol_pp=2.0):
    """The other table's per-family mean metric must track the base within
    family_tol_pp percentage points, and each (dataset, family) cell (a
    mean over its seeds) within cell_tol_pp. Returns a list of violation
    strings (empty = pass)."""
    base = _load_metrics(base_csv)
    other = _load_metrics(other_csv)
    violations = []
    fams = collections.defaultdict(lambda: ([], []))
    for key in sorted(base):
        if key not in other:
            violations.append(f"missing cell in {other_csv}: {key}")
            continue
        a, b = base[key], other[key]
        fams[key[1]][0].extend(a)
        fams[key[1]][1].extend(b)
        d = (sum(b) / len(b) - sum(a) / len(a)) * 100
        if abs(d) > cell_tol_pp:
            violations.append(
                f"cell {key[0]}/{key[1]}: delta {d:+.2f} pp "
                f"(tol {cell_tol_pp})")
    for fam, (a, b) in sorted(fams.items()):
        if not a or not b:
            continue
        d = (sum(b) / len(b) - sum(a) / len(a)) * 100
        if abs(d) > family_tol_pp:
            violations.append(
                f"family {fam}: mean delta {d:+.2f} pp (tol {family_tol_pp})")
    return violations


def headline(res):
    """The row's test accuracy or test r2, or None."""
    return res.get("test_accuracy", res.get("test_r2"))


def fit_failed(res) -> bool:
    """A fit fails when it raised or scored no finite test metric, the JAX
    package's count (its rows never record a sweep that stopped at a
    singular solve; the port's `singular` column does, and such a row,
    scored from the params it stopped with, is no failure)."""
    m = headline(res)
    return bool(res.get("skipped")) or m is None or not math.isfinite(m)


def run_table(datasets, seeds, out, device="cuda", log=print):
    """Every family on `datasets` x `seeds`, each row appended to `out`.
    Returns (rows, failed fits)."""
    rows, n_fail = [], 0
    for ds in datasets:
        for fam, over in FAMILIES.items():
            for seed in seeds:
                cfg = RunConfig(dataset=ds, seed=seed, results_file=out,
                                device=device, **ZOO_CONFIG)
                t0 = time.time()
                res = run(cfg, overrides=over)
                res["family"] = fam
                append_results_csv(res, out)
                rows.append(res)
                bad = fit_failed(res)
                n_fail += bad
                stop = ", sweep stopped at a singular solve" if res["singular"] else ""
                log(f"{ds:13s} {fam:10s} seed {seed}: "
                    f"{'FAIL' if bad else headline(res)} "
                    f"({time.time() - t0:.1f}s{stop})")
    return rows, n_fail


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="one dataset (iris) x all families x one seed")
    ap.add_argument("--out", default="build/zoo_eval.csv")
    ap.add_argument("--seeds", type=int, default=len(SEEDS))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; no card raises unless "
                         "the CPU is asked for")
    ap.add_argument("--compare", nargs=2, metavar=("BASE", "OTHER"),
                    help="no fits: gate OTHER csv against BASE (per-family "
                         "and per-cell mean deltas); exit 1 and print the "
                         "offending rows on violation")
    ap.add_argument("--family_tol_pp", type=float, default=0.5)
    ap.add_argument("--cell_tol_pp", type=float, default=2.0)
    args = ap.parse_args(argv)

    if args.compare:
        violations = compare_tables(args.compare[0], args.compare[1],
                                    args.family_tol_pp, args.cell_tol_pp)
        for v in violations:
            print("VIOLATION:", v)
        print(f"zoo compare: {args.compare[1]} vs {args.compare[0]} -> "
              f"{'FAIL' if violations else 'OK'}")
        return 1 if violations else 0

    datasets = ("iris",) if args.quick else DATASETS
    seeds = SEEDS[:1] if args.quick else SEEDS[:args.seeds]
    rows, n_fail = run_table(datasets, seeds, args.out, args.device,
                             log=lambda m: print(m, flush=True))
    n_stop = sum(bool(r["singular"]) for r in rows)
    print(f"zoo_eval: {len(rows) - n_fail} ok, {n_fail} failed ({n_stop} "
          f"sweeps stopped at a singular solve) -> {args.out}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
