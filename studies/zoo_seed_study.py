"""Seed noise of the zoo's cells, in the JAX package and in the port, on the CPU.

The zoo table (experiments/zoo_eval.py) holds each family's mean to a noise
floor built from the committed table's spread over 3 seeds a cell. This
script measures a cell's spread over many seeds, and whether the port,
started from the JAX package's initial params, fits the cell's rows as the
JAX package does (so that what differs between the tables is the initial
draw alone). Run from the repository's root:

    python studies/zoo_seed_study.py spread diabetes tt_linear 42 102
    python studies/zoo_seed_study.py jax-inits diabetes tt_linear 42 44
    python studies/zoo_seed_study.py sd all tt_linear 42 102 studies/zoo_seed_sd.json

`spread` prints each package's mean, sd and median of the test metric over
the seeds [first, last); `jax-inits` prints, per seed, both packages' test
metric and the port's largest prediction difference from the JAX
package's over max|pred|; `sd` fits the JAX package alone on every zoo
dataset (or the one named) over the seeds, one process a dataset, prints
each cell's n, mean and sd, and writes them to the JSON file named last
(chip_smoke.py reads studies/zoo_seed_sd.json). The zoo's config throughout
(zoo_eval.ZOO_CONFIG).
"""
import json
import multiprocessing
import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("TNF_FIT_PRECOMPILE", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def spread(dataset, family, seeds):
    from tensornetworksfork_tpu.experiments import train_tabular as jt
    from tensornetworksfork_tpu.utils.config import RunConfig as JConfig
    from tensornetworksfork_tpu_torch.experiments import train_tabular as tt
    from tensornetworksfork_tpu_torch.experiments import zoo_eval
    from tensornetworksfork_tpu_torch.utils.config import RunConfig as TConfig
    over = zoo_eval.FAMILIES[family]
    for name, run, cfg in (("jax", jt.run, lambda s: JConfig(dataset=dataset, seed=s,
                                                             **zoo_eval.ZOO_CONFIG)),
                           ("port", tt.run, lambda s: TConfig(dataset=dataset, seed=s,
                                                              device="cpu",
                                                              **zoo_eval.ZOO_CONFIG))):
        vals = np.array([zoo_eval.headline(run(cfg(s), overrides=over)) for s in seeds])
        print(f"{name} {dataset}/{family} seeds {seeds[0]}-{seeds[-1]}: n {len(vals)} "
              f"mean {vals.mean():.4f} sd {vals.std(ddof=1):.4f} "
              f"median {np.median(vals):.4f}", flush=True)


def jax_inits(dataset, family, seeds):
    """The estimator families only (TensorTrainRegressor)."""
    from tensornetworksfork_tpu.models.estimators import TensorTrainRegressor as JT
    from tensornetworksfork_tpu_torch.data.tabular import load_sklearn_dataset
    from tensornetworksfork_tpu_torch.experiments import zoo_eval
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor as TT
    from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy
    c = zoo_eval.ZOO_CONFIG
    over = dict(zoo_eval.FAMILIES[family])
    model_type = over.pop("model_type")
    for seed in seeds:
        d = load_sklearn_dataset(dataset, seed=seed)
        if d.pop("task") != "regression":
            raise SystemExit("jax-inits takes a regression dataset")
        kw = dict(N=c["N"], r=c["r"], eps_start=c["eps"], eps_decay=c["eps_decay"],
                  batch_size=c["batch_size"], num_swipes=c["num_swipes"],
                  early_stopping=10, seed=seed, model_type=model_type, **over)
        j, t = JT(**kw), TT(**kw, device="cpu")
        for e in (j, t):
            e.input_dim = d["X_train"].shape[1] + 1
            e._initialize_model()
        jl = getattr(j._model, "layers", [j._model])
        for a, b in zip(jl, getattr(t._model, "layers", [t._model])):
            b.params = params_from_numpy({k: np.asarray(v) for k, v in a.params.items()},
                                         device="cpu")
        for e in (j, t):
            e.fit(d["X_train"], d["y_train"], X_val=d["X_val"], y_val=d["y_val"])
        pj, pt = np.asarray(j.predict(d["X_test"])), t.predict(d["X_test"])
        print(f"seed {seed}: test r2 jax {j.score(d['X_test'], d['y_test']):.6f} "
              f"port {t.score(d['X_test'], d['y_test']):.6f}, max|d pred| / max|pred| "
              f"{np.abs(pj - pt).max() / np.abs(pj).max():.3g}", flush=True)


def _jax_cell(job):
    """The JAX package's test metric per seed of one (dataset, family)."""
    dataset, family, seeds = job
    warnings.simplefilter("ignore")
    from tensornetworksfork_tpu.experiments import train_tabular as jt
    from tensornetworksfork_tpu.utils.config import RunConfig as JConfig
    from tensornetworksfork_tpu_torch.experiments import zoo_eval
    return [zoo_eval.headline(jt.run(JConfig(dataset=dataset, seed=s,
                                             **zoo_eval.ZOO_CONFIG),
                                     overrides=zoo_eval.FAMILIES[family]))
            for s in seeds]


def sd(dataset, family, seeds, out):
    from tensornetworksfork_tpu_torch.experiments import zoo_eval
    datasets = zoo_eval.DATASETS if dataset == "all" else (dataset,)
    with multiprocessing.get_context("spawn").Pool(len(datasets)) as pool:
        per = pool.map(_jax_cell, [(d, family, seeds) for d in datasets])
    cells = {}
    for d, vals in zip(datasets, per):
        v = np.array(vals, dtype=np.float64)
        cells[d] = dict(n=len(v), mean=float(v.mean()), sd=float(v.std(ddof=1)))
        print(f"jax {d}/{family} seeds {seeds[0]}-{seeds[-1]}: n {len(v)} "
              f"mean {v.mean():.4f} sd {v.std(ddof=1):.4f}", flush=True)
    with open(out, "w") as f:
        json.dump(dict(package="tensornetworksfork_tpu", family=family,
                       seeds=[seeds[0], seeds[-1]], config=zoo_eval.ZOO_CONFIG,
                       command=" ".join(["python", "studies/zoo_seed_study.py"]
                                        + sys.argv[1:]),
                       cells=cells), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    what, dataset, family, first, last = sys.argv[1:6]
    warnings.simplefilter("ignore")
    seeds = list(range(int(first), int(last)))
    if what == "sd":
        sd(dataset, family, seeds, sys.argv[6])
    else:
        {"spread": spread, "jax-inits": jax_inits}[what](dataset, family, seeds)
