"""sklearn's metrics for the kernel baselines' options, the reference the
port is held to.

Runs the JAX package's SVMClfWrapper and GaussianProcessWrapper (both
sklearn) with each option of the port's `experiments/kernel_baselines.py`
`OPTIONS` (SVC class_weight="balanced" and break_ties, GPR restarts, GPC
one_vs_one and warm_start) on the tables it names, on the splits that
module gives, and writes their val/test metrics with the rows of each split
to the JSON file named (default results/kernel_baselines_options.json;
chip_smoke.py phase 14 (iv) and tests/test_torch_svm_gp_options.py read
it). BLAS runs on one thread, as in studies/kernel_baselines_ref.py. Needs
the JAX package and sklearn (and its threadpoolctl). Run from the
repository's root:

    python studies/kernel_baselines_options_ref.py [results/kernel_baselines_options.json]
"""
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reference() -> dict:
    import sklearn
    from threadpoolctl import threadpool_limits
    from tensornetworksfork_tpu.models.baselines import (GaussianProcessWrapper,
                                                         SVMClfWrapper, SVMRegWrapper)
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb

    def model(option, task):
        fam, params = kb.OPTIONS[option][:2]
        if fam == "gp":
            return GaussianProcessWrapper(dict(params), task=task)
        return (SVMClfWrapper if task == "classification" else SVMRegWrapper)(dict(params))

    def scores(option, name):
        data, task = kb.table(name)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return kb.scores(model(option, task), data, task)

    tables = sorted({t for o in kb.OPTIONS.values() for t in o[2]})
    with threadpool_limits(1):
        return {"sklearn": sklearn.__version__,
                "params": {o: v[1] for o, v in kb.OPTIONS.items()},
                "options": {o: {t: scores(o, t) for t in v[2]}
                            for o, v in kb.OPTIONS.items()},
                "rows": {t: kb.rows(t) for t in tables}}


if __name__ == "__main__":
    path = sys.argv[1] if len(sys.argv) > 1 else "results/kernel_baselines_options.json"
    ref = reference()
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(json.dumps(ref, indent=1))
