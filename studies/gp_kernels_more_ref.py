"""sklearn's fits of the last kernel options, the reference the port is held to.

Runs the JAX package's wrappers (sklearn's GaussianProcessRegressor /
GaussianProcessClassifier, SVC and SVR) on each cell of the port's
`experiments/kernel_baselines.py` `MORE_KERNEL_OPTIONS`, with the split
and the arrays `more_table` gives (a precomputed option's Gram matrices, a
string table's sequences), a GP kernel's expression evaluated in
sklearn.gaussian_process.kernels' namespace (the string kernel as
`SequenceKernel` on sklearn's Kernel base, which sklearn's parameter
checks need), and writes to the JSON file named (default
results/gp_kernels_more.json; chip_smoke.py phase 14 (vi) and
tests/test_torch_kernel_options_more.py read it):

- each cell's val/test metrics; a GP's fitted θ (a classifier's binary
  problems in turn), its log-marginal likelihood and how far its θ moves
  when BLAS runs on eight threads (`theta_moved_on_8_threads`); an SVM's
  SMO iterations, support_ and the decision values of its first
  SVM_DECISION_ROWS test rows;
- scipy.special.kv at `KV_NUS` x `kv_grid()`;
- the rows of each split.

BLAS runs on one thread, as in studies/kernel_baselines_ref.py. Needs the
JAX package and sklearn (and its threadpoolctl). Run from the
repository's root:

    python studies/gp_kernels_more_ref.py [results/gp_kernels_more.json]
"""
import json
import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sklearn_namespace() -> dict:
    """The names a MORE_KERNEL_OPTIONS expression uses, as sklearn's
    kernels, with SequenceKernel on sklearn's Kernel base."""
    import sklearn.gaussian_process.kernels as skk
    from tensornetworksfork_tpu_torch.experiments.kernel_baselines import SequenceKernel
    from tensornetworksfork_tpu_torch.models._gp_kernels import NAMESPACE

    class SklearnSequenceKernel(SequenceKernel, skk.GenericKernelMixin, skk.Kernel):
        pass
    ns = {name: getattr(skk, cls.__name__) for name, cls in NAMESPACE.items()}
    return dict(ns, SequenceKernel=SklearnSequenceKernel)


def fitted_theta(model) -> np.ndarray:
    """θ of a fitted sklearn GP: the regressor's kernel_, or each binary
    estimator's in turn."""
    base = getattr(model, "base_estimator_", None)
    if base is None:
        return model.kernel_.theta
    return np.hstack([e.kernel_.theta for e in getattr(base, "estimators_", [base])])


def fit(option, name, ns):
    """The JAX package's wrapper of a cell, fitted; its data and task."""
    from tensornetworksfork_tpu.models.baselines import (GaussianProcessWrapper,
                                                         SVMClfWrapper, SVMRegWrapper)
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    fam, _, params = kb.MORE_KERNEL_OPTIONS[option][:3]
    data, task = kb.more_table(option, name)
    if fam == "gp":
        model = GaussianProcessWrapper(dict(params, kernel=kb.more_kernel(option, ns)),
                                       task=task)
    else:
        wrapper = SVMClfWrapper if task == "classification" else SVMRegWrapper
        model = wrapper(dict(params, kernel=kb.more_kernel(option)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.fit(data["X_train"], data["y_train"])
    return model, data, task


def record(option, name, ns) -> dict:
    from threadpoolctl import threadpool_limits
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    model, data, task = fit(option, name, ns)
    out = kb.metrics(model, data, task)
    if kb.MORE_KERNEL_OPTIONS[option][0] == "gp":
        theta = fitted_theta(model.model)
        with threadpool_limits(8):
            moved = np.abs(fitted_theta(fit(option, name, ns)[0].model) - theta).max(initial=0)
        return dict(out, theta=[float(v) for v in theta],
                    lml=float(model.model.log_marginal_likelihood_value_),
                    theta_moved_on_8_threads=float(moved))
    sk = model.svm_object
    X = data["X_test"][:kb.SVM_DECISION_ROWS]
    dec = sk.decision_function(X) if task == "classification" else sk.predict(X)
    return dict(out, n_iter=np.atleast_1d(sk.n_iter_).tolist(),
                support=[int(v) for v in sk.support_],
                decision=np.asarray(dec, np.float64).tolist())


def reference(options=None) -> dict:
    """The reference over MORE_KERNEL_OPTIONS (the options named, where
    given) and scipy's kv at the test grid."""
    import scipy
    import scipy.special
    import sklearn
    from threadpoolctl import threadpool_limits
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    ns = sklearn_namespace()
    options = {o: v for o, v in kb.MORE_KERNEL_OPTIONS.items()
               if options is None or o in options}
    tables = sorted({t for v in options.values() for t in v[3]})
    x = kb.kv_grid()
    with threadpool_limits(1):
        return {"sklearn": sklearn.__version__, "scipy": scipy.__version__,
                "as_written": {o: [str(e) for e in v] for o, v in options.items()},
                "options": {o: {t: record(o, t, ns) for t in v[3]}
                            for o, v in options.items()},
                "rows": {t: kb.rows(t) for t in tables},
                "kv": {"x": x.tolist(),
                       "values": {repr(nu): scipy.special.kv(nu, x).tolist()
                                  for nu in kb.KV_NUS}}}


if __name__ == "__main__":
    path = sys.argv[1] if len(sys.argv) > 1 else "results/gp_kernels_more.json"
    ref = reference()
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in ref.items() if k != "kv"}, indent=1))
