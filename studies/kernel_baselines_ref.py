"""sklearn's metrics for the kernel baselines, the reference the port is held to.

Runs the JAX package's SVM wrappers through its tabular CLI
(`train_tabular.run(model_type="svm")`) and its `GaussianProcessWrapper`
(both sklearn) on the six tables of the port's
`experiments/kernel_baselines.py`, on the splits that module gives, and
writes their val/test metrics with the rows of each split to the JSON file
named (default results/kernel_baselines.json; chip_smoke.py phase 14 and
tests/test_torch_kernel_baselines.py read it). BLAS runs on one thread:
the GP regression on synthetic is an ill-conditioned solve whose rmse moves
by ~4e-4 of itself with the thread count. Needs the JAX package and sklearn
(and its threadpoolctl). Run from the repository's root:

    python studies/kernel_baselines_ref.py [results/kernel_baselines.json]
"""
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reference() -> dict:
    import sklearn
    from threadpoolctl import threadpool_limits
    from tensornetworksfork_tpu.experiments import train_tabular as jax_tabular
    from tensornetworksfork_tpu.models.baselines import GaussianProcessWrapper
    from tensornetworksfork_tpu.utils.config import RunConfig
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb

    def svm(name):
        res = jax_tabular.run(RunConfig(dataset=name, model_type="svm", verbose=False))
        return {k: v for k, v in res.items() if k.startswith(("val_", "test_"))}

    def gp(name):
        data, task = kb.table(name)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return kb.scores(GaussianProcessWrapper(task=task), data, task)

    with threadpool_limits(1):
        return {"sklearn": sklearn.__version__,
                "svm": {t: svm(t) for t in kb.TABLES},
                "gp": {t: gp(t) for t in kb.GP_TABLES},
                "rows": {t: kb.rows(t) for t in kb.TABLES}}


if __name__ == "__main__":
    path = sys.argv[1] if len(sys.argv) > 1 else "results/kernel_baselines.json"
    ref = reference()
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(json.dumps(ref, indent=1))
