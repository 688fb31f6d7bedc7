"""sklearn's fits of the GP kernel objects, the reference the port is held to.

Runs the JAX package's GaussianProcessWrapper (sklearn's
GaussianProcessRegressor / GaussianProcessClassifier) with each kernel of
the port's `experiments/kernel_baselines.py` `KERNEL_OPTIONS`, its
expression evaluated in sklearn.gaussian_process.kernels' namespace, on
the tables it names and the splits that module gives, and writes their
val/test metrics, the fitted θ (a classifier's binary problems in turn)
and the log-marginal likelihood, with the rows of each split, to the JSON
file named (default results/gp_kernels.json; chip_smoke.py phase 14 (v)
and tests/test_torch_gp_kernels.py read it). BLAS runs on one thread, as
in studies/kernel_baselines_ref.py. Needs the JAX package and sklearn (and
its threadpoolctl). Run from the repository's root:

    python studies/gp_kernels_ref.py [results/gp_kernels.json]
"""
import json
import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sklearn_namespace() -> dict:
    """The names a KERNEL_OPTIONS expression uses, as sklearn's kernels."""
    import sklearn.gaussian_process.kernels as skk
    from tensornetworksfork_tpu_torch.models._gp_kernels import NAMESPACE
    return {name: getattr(skk, cls.__name__) for name, cls in NAMESPACE.items()}


def fitted_theta(model) -> np.ndarray:
    """θ of a fitted sklearn GP: the regressor's kernel_, or each binary
    estimator's in turn."""
    base = getattr(model, "base_estimator_", None)
    if base is None:
        return model.kernel_.theta
    return np.hstack([e.kernel_.theta for e in getattr(base, "estimators_", [base])])


def reference(options=None) -> dict:
    """The reference over KERNEL_OPTIONS (the options named, where given)."""
    import sklearn
    from threadpoolctl import threadpool_limits
    from tensornetworksfork_tpu.models.baselines import GaussianProcessWrapper
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    ns = sklearn_namespace()
    options = {o: v for o, v in kb.KERNEL_OPTIONS.items() if options is None or o in options}

    def record(option, name):
        expression, params = kb.KERNEL_OPTIONS[option][:2]
        data, task = kb.table(name)
        model = GaussianProcessWrapper(
            dict(params, kernel=kb.kernel_from_expression(expression, ns)), task=task)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mets = kb.scores(model, data, task)
        return dict(mets, theta=[float(v) for v in fitted_theta(model.model)],
                    lml=float(model.model.log_marginal_likelihood_value_))

    tables = sorted({t for v in options.values() for t in v[2]})
    with threadpool_limits(1):
        return {"sklearn": sklearn.__version__,
                "kernels_as_written": {o: v[0] for o, v in options.items()},
                "params": {o: v[1] for o, v in options.items()},
                "kernels": {o: {t: record(o, t) for t in v[2]} for o, v in options.items()},
                "rows": {t: kb.rows(t) for t in tables}}


if __name__ == "__main__":
    path = sys.argv[1] if len(sys.argv) > 1 else "results/gp_kernels.json"
    ref = reference()
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(json.dumps(ref, indent=1))
