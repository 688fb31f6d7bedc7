"""Params crossing between the JAX package and this one (the tensor
networks' params dicts, the baselines' flax trees, and the fitted state of
sklearn's SVMs and Gaussian processes, read by attribute: no sklearn import).

Both packages build a model's topology with the same calls, so the params
dicts have the same names and shapes; JAX params go in as
`{k: np.asarray(v)}`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import _gp, _gp_kernels, _libsvm
from ..models.baselines import GaussianProcessWrapper, SVMClfWrapper, SVMRegWrapper
from .device import resolve_device


def params_from_numpy(params: Dict[str, np.ndarray], device="cuda",
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """numpy arrays -> tensors of `dtype` on `device` (copies). Defaults to
    the card and raises RuntimeError where none is visible (utils/device.py);
    pass device="cpu" for the CPU."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=dev)
            for k, v in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """tensors (any device) -> numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def mlp_params_from_flax(params, spatial=None) -> Dict[str, torch.Tensor]:
    """A flax param tree of the JAX package's MLP / PINet / ResMLP /
    SimpleCNN (numpy leaves; the top "params" level optional) -> the
    `state_dict` of the port's module (models/baselines.py), on the CPU.

    Dense_i -> dense.i (weight = kernelᵀ), Conv_i -> conv.i (HWIO kernel ->
    OIHW weight). Where convolutions come first, Dense_0 reads flax's NHWC
    flatten order (h, w, c); its rows are permuted to the port's NCHW order
    (c, h, w). `spatial` = (H, W) of the last feature map (default: square,
    from Dense_0's rows and the last conv's channels)."""
    tree = params.get("params", params)
    out = {}

    def index(name):
        return int(name.rsplit("_", 1)[1])

    convs = sorted((k for k in tree if k.startswith("Conv_")), key=index)
    for name in convs:
        k = np.asarray(tree[name]["kernel"])
        out[f"conv.{index(name)}.weight"] = torch.tensor(k.transpose(3, 2, 0, 1).copy())
        out[f"conv.{index(name)}.bias"] = torch.tensor(np.asarray(tree[name]["bias"]))
    for name in sorted((k for k in tree if k.startswith("Dense_")), key=index):
        k = np.asarray(tree[name]["kernel"])
        if convs and index(name) == 0:
            C = np.asarray(tree[convs[-1]]["kernel"]).shape[-1]
            H, W = spatial or (int(round(np.sqrt(k.shape[0] // C))),) * 2
            k = k.reshape(H, W, C, -1).transpose(2, 0, 1, 3).reshape(C * H * W, -1)
        out[f"dense.{index(name)}.weight"] = torch.tensor(k.T.copy())
        out[f"dense.{index(name)}.bias"] = torch.tensor(np.asarray(tree[name]["bias"]))
    return out


def svm_from_sklearn(fitted, device="cuda"):
    """A fitted sklearn SVC or SVR -> the port's SVMClfWrapper /
    SVMRegWrapper on `device`, predicting as `fitted` does. Reads
    support_vectors_, support_, dual_coef_, intercept_, n_support_,
    classes_, shape_fit_ and _gamma (and get_params(); a callable kernel's
    fitted X too); for two classes sklearn's public dual_coef_ and
    intercept_ carry the flipped sign, which is undone."""
    classifier = hasattr(fitted, "classes_")
    wrapper = (SVMClfWrapper if classifier else SVMRegWrapper)(fitted.get_params(),
                                                              device=device)
    dev = wrapper.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    dual, intercept = t(fitted.dual_coef_), t(fitted.intercept_)
    n_support = []
    if classifier:
        classes = np.asarray(fitted.classes_)
        n_support = [int(c) for c in fitted.n_support_]
        if classes.size == 2:
            dual, intercept = -dual, -intercept
        wrapper._labels = classes
        wrapper.translation_dict = {l: i for i, l in enumerate(classes)}
        wrapper.retranslation_dict = dict(enumerate(classes))
    s = wrapper.settings
    wrapper.model_ = _libsvm.SVMModel(
        support_vectors=t(fitted.support_vectors_), dual_coef=dual, intercept=intercept,
        n_support=n_support, kernel="precomputed" if wrapper._precomputed else s["kernel"],
        gamma=float(fitted._gamma), coef0=float(s["coef0"]), degree=int(s["degree"]),
        n_iter=np.atleast_1d(fitted.n_iter_).tolist(),
        support=torch.as_tensor(np.asarray(fitted.support_, np.int64), device=dev))
    wrapper.shape_fit_ = fitted.shape_fit_
    if callable(s["kernel"]):
        wrapper._X_fit = fitted._BaseLibSVM__Xfit      # SVC's fitted X, name-mangled
    return wrapper


def gp_kernel_from_sklearn(kernel):
    """An sklearn Gaussian-process kernel object (any class of
    sklearn.gaussian_process.kernels, and their sums, products, powers and
    CompoundKernels) -> the port's kernel with the same parameters
    (`models/_gp_kernels.py`), read by class name and get_params(); a kernel
    the user wrote with sklearn's kernel API becomes a HostKernel, run on
    the host; anything else raises ValueError."""
    return _gp_kernels.from_sklearn(kernel)


def gp_from_sklearn(fitted, device="cuda"):
    """A fitted sklearn GaussianProcessRegressor or GaussianProcessClassifier
    (any kernel `gp_kernel_from_sklearn` takes) -> the port's
    GaussianProcessWrapper on `device`, predicting as `fitted` does. The
    regressor's X_train_, alpha_, L_, kernel_ and _y_train_mean /
    _y_train_std; the classifier's binary estimators' (one, one a class
    under one-vs-rest, one a pair under one-vs-one) X_train_, y_train_, pi_,
    W_sr_, L_ and kernel_."""
    if hasattr(fitted, "alpha_"):
        wrapper = GaussianProcessWrapper(task="regression", device=device)
        dev = wrapper.device
        alpha = np.asarray(fitted.alpha_, np.float64)
        wrapper._ravel = alpha.ndim == 1
        wrapper.fit_ = _gp.GPRFit(
            kernel=gp_kernel_from_sklearn(fitted.kernel_),
            lml=float(fitted.log_marginal_likelihood_value_),
            X=torch.as_tensor(np.asarray(fitted.X_train_, np.float64), device=dev),
            L=torch.as_tensor(np.asarray(fitted.L_), device=dev),
            alpha=torch.as_tensor(alpha.reshape(alpha.shape[0], -1), device=dev),
            y_mean=np.atleast_1d(np.asarray(fitted._y_train_mean, np.float64)),
            y_std=np.atleast_1d(np.asarray(fitted._y_train_std, np.float64)))
        wrapper.log_marginal_likelihood_value_ = wrapper.fit_.lml
        return wrapper
    wrapper = GaussianProcessWrapper({"multi_class": fitted.multi_class},
                                     task="classification", device=device)
    dev = wrapper.device
    base = fitted.base_estimator_
    estimators = getattr(base, "estimators_", [base])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    fits = [_gp.LaplaceFit(X=t(e.X_train_), y=t(e.y_train_)[None], pi=t(e.pi_)[None],
                           W_sr=t(e.W_sr_)[None], L=t(e.L_)[None],
                           kernel=gp_kernel_from_sklearn(e.kernel_),
                           lml=[float(e.log_marginal_likelihood_value_)], n_iter=[0])
            for e in estimators]
    n = len(fits)
    wrapper.classes_ = np.asarray(fitted.classes_)
    wrapper.fit_ = _gp.BinaryFits(fits=fits, lml=[f.lml[0] for f in fits], n_eval=[0] * n,
                                  optima=[[] for _ in fits], chosen=[0] * n)
    wrapper.log_marginal_likelihood_value_ = float(fitted.log_marginal_likelihood_value_)
    return wrapper
