"""TNML-style estimator (port of tensornetworksfork_tpu/models/tnml.py):
per-feature basis maps feeding a tensor train with one carriage per feature.

Each feature goes through the sin-cos map [cos(pi/2 x), sin(pi/2 x)] or the
powers [1, x, ..., x^degree]; the train starts left-orthonormalized and
sweeps with orthonormalize=True (`core/gauges.py`). `input_scale="minmax"`
fits a per-feature [0, 1] rescale on the training rows (the sin-cos map
wants inputs in [0, 1]). It runs on `device`, the card unless the caller
passes device="cpu"; `export` writes a serving artifact with the rescale
and the basis map traced in (`utils/serving.py`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import gauges
from ..core.sweep import SweepConfig, Sweeper
from ..utils.device import resolve_device
from ..utils.metrics import r2_score as r2_score_np, rmse
from .estimators import (BaseEstimator, EarlyStopping, RegressorMixin,
                         default_loss, error_rate, one_hot_labels,
                         prepare_classification_targets)
from .layers import TensorTrainLayer


def fbasis(X: torch.Tensor):
    """Per-feature [cos(pi/2 x), sin(pi/2 x)]: a list of (B, 2) tensors."""
    return [torch.stack([torch.cos(0.5 * math.pi * X[:, i]),
                         torch.sin(0.5 * math.pi * X[:, i])], dim=-1)
            for i in range(X.shape[-1])]


def polynomial_basis(X: torch.Tensor, degree: int = 3):
    """Per-feature powers [1, x, ..., x^degree]: a list of (B, degree+1)."""
    return [torch.stack([X[:, i] ** d for d in range(degree + 1)], dim=-1)
            for i in range(X.shape[-1])]


class TNMLRegressor(BaseEstimator, RegressorMixin):
    def __init__(self, r=8, output_dim=1, seed=42, bf=None, lr=1.0,
                 eps_start=1.0, eps_decay=0.5, abs_err=1e-6, rel_err=1e-4,
                 batch_size=512, method="ridge_cholesky", num_swipes=30,
                 task="regression", early_stopping=0, basis="sin-cos",
                 degree=3, verbose=0, constrict_bond=True, dtype=torch.float32,
                 input_scale="none", device="cuda"):
        self.r = r
        self.input_dim = degree + 1 if basis == "polynomial" else 2
        self.output_dim = output_dim
        self.constrict_bond = constrict_bond
        self.seed = seed
        self.bf = bf
        self.lr = lr
        self.eps = eps_start
        self.eps_decay = eps_decay
        self.abs_err = abs_err
        self.rel_err = rel_err
        self.batch_size = batch_size
        self.method = method
        self.num_swipes = num_swipes
        self.task = task
        self.early_stopping = early_stopping
        self.basis = basis
        self.degree = degree
        self.verbose = verbose
        self.dtype = dtype
        self.input_scale = input_scale
        self.device = resolve_device(device)
        self._scale_min = None
        self._scale_rng = None
        self._model = None

    def _embed(self, X):
        return self._embed_tensor(
            torch.as_tensor(np.asarray(X, np.float32), device=self.device))

    def _embed_tensor(self, X):
        """The minmax rescale and the basis map of a tensor of rows: torch
        ops only, so that `export` traces them into the artifact."""
        if self._scale_min is not None:
            X = torch.clamp((X - self._scale_min) / self._scale_rng, 0.0, 1.0)
        if self.basis == "sin-cos":
            return fbasis(X)
        if self.basis == "polynomial":
            return polynomial_basis(X, degree=self.degree)
        raise ValueError(f"unknown basis {self.basis!r}")

    def _predict_arr(self, X_emb):
        y = self._model.forward_batch(X_emb, self.batch_size)
        if self.task == "classification":
            y = torch.cat([y, torch.zeros_like(y[..., :1])], dim=-1)
        return y

    def fit(self, X, y, X_val=None, y_val=None, validation_split=0.1,
            split_train=True):
        X = np.asarray(X, np.float32)
        if self.task == "classification":
            if self._model is None:
                y, y_val, self.output_dim = prepare_classification_targets(
                    y, y_val, self.output_dim, perturb=False)
            else:  # continued fit: output_dim frozen by the built model
                y, _ = one_hot_labels(y, self.output_dim + 1)
                if y_val is not None:
                    y_val, _ = one_hot_labels(y_val, self.output_dim + 1)
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        self.N = X.shape[1]
        if self._model is None:
            self._model = TensorTrainLayer(
                self.N, self.r, self.input_dim, output_shape=self.output_dim,
                constrict_bond=self.constrict_bond, dtype=self.dtype,
                seed=self.seed, device=self.device)

        if X_val is None or y_val is None:
            if split_train:
                n = X.shape[0]
                idx = np.arange(n)
                np.random.RandomState(self.seed).shuffle(idx)
                split = int(n * (1 - validation_split))
                tr, va = idx[:split], idx[split:]
                X, X_val = X[tr], X[va]
                y, y_val = y[tr], y[va]
            else:
                X_val, y_val = X, y
        else:
            y_val = np.asarray(y_val, np.float32)
            if y_val.ndim == 1:
                y_val = y_val[:, None]

        if self.input_scale == "minmax":
            lo = X.min(axis=0, keepdims=True)
            rng = X.max(axis=0, keepdims=True) - lo
            self._scale_min = torch.as_tensor(lo, device=self.device)
            self._scale_rng = torch.as_tensor(
                np.where(rng > 0, rng, 1.0).astype(np.float32), device=self.device)
        X_emb = self._embed(X)
        X_val_emb = self._embed(X_val)
        bf = default_loss(self.task, self.bf)

        # initial gauge: every core left-orthonormalized
        self._model.params = gauges.orthonormalize_all_left(
            self._model.network, self._model.params)

        cfg = SweepConfig(num_swipes=self.num_swipes, batch_size=self.batch_size,
                          method=self.method, eps=self.eps,
                          eps_decay=self.eps_decay, lr=self.lr,
                          orthonormalize=True, verbose=self.verbose)
        sweeper = Sweeper(self._model.network, bf, cfg)

        def _sync():
            pl = getattr(sweeper, "params_list", None)
            if pl is not None:
                self._model.params = pl[0]

        def model_predict(Xe):
            _sync()
            return self._predict_arr(Xe).cpu().numpy()

        def get_weights():
            _sync()
            return self._model.node_states()

        self._early_stopper = EarlyStopping(
            X_val_emb, np.asarray(y_val), model_predict=model_predict,
            get_model_weights=get_weights,
            loss_fn=rmse if self.task == "regression" else error_rate,
            abs_err=self.abs_err, rel_err=self.rel_err,
            early_stopping=self.early_stopping, verbose=self.verbose)

        self.sweeper_ = sweeper
        out, self.fit_ok_ = sweeper.run(
            [self._model.params], X_emb,
            torch.as_tensor(y, dtype=self.dtype, device=self.device),
            convergence_criterion=self._early_stopper.convergence_criterion
            if self.early_stopping > 0 else None)
        self._model.params = out[0]
        if (self.early_stopping > 0
                and self._early_stopper.best_state_dict is not None):
            self._model.load_node_states(self._early_stopper.best_state_dict)
        return self

    def predict(self, X):
        return self._predict_arr(self._embed(X)).cpu().numpy()

    def score(self, X, y_true):
        y_pred = self.predict(X)
        y_true = np.asarray(y_true)
        if self.task == "regression":
            if y_true.ndim == 1:
                y_true = y_true[:, None]
            return r2_score_np(y_true, y_pred)
        return 1.0 - error_rate(y_true, y_pred)

    def export(self, path=None, **kw):
        """Serving export: raw feature rows in, predict() semantics out; the
        minmax rescale and the basis embedding are traced into the artifact,
        so serving needs no feature-map code. Returns the bytes; also writes
        them to `path` when given."""
        from ..utils.serving import ServingModule, export_module, save_forward
        if self._model is None:
            raise ValueError("estimator must be fitted before export")
        device = kw.pop("device", self.device)
        mod = ServingModule(self._model, classification=(self.task == "classification"),
                            device=device, embed=self._embed_tensor)
        blob = export_module(mod, (self.N,), dtype=self.dtype, device=device, **kw)
        if path is not None:
            save_forward(path, blob)
        return blob
