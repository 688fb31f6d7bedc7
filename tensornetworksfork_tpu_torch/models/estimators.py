"""sklearn-style estimators over the sweep engine (port of
tensornetworksfork_tpu/models/estimators.py).

`TensorTrainRegressor` for model_type `tt` and `tt_type1` (a type-I sum of
degree-1..N tensor trains): bias-column augmentation, validation split,
`EarlyStopping` with abs/rel improvement thresholds and best-state
restore, the C-1-logit classification convention (a zero logit appended at
evaluation), and numerics tiers. It runs on an explicit `device`; data
goes there once per fit.

Not ported yet, each raising NotImplementedError: model_type `cpd` /
`cpd_type1`, `cum_sum` and `linear_dim` (ROADMAP item 14), the float64
solve tier (item 10) and `export` (item 18). The JAX package's concurrent
pre-compilation before the sweep has no counterpart: nothing compiles.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.sweep import Member, SweepConfig, Sweeper
from ..ops.bregman import SquareBregFunction, XEBregman
from ..utils.metrics import r2_score as r2_score_np, rmse
from ..utils.precision import numerics_tier, validate_tier
from .layers import SumLayer, TensorTrainLayer, TNLayer

try:  # sklearn is optional (the GPU machine has none)
    from sklearn.base import BaseEstimator, RegressorMixin
except ImportError:  # pragma: no cover
    class BaseEstimator:  # type: ignore
        pass

    class RegressorMixin:  # type: ignore
        pass


def one_hot_labels(y, n_cls=None):
    """1-D (or single-column) integer labels 0..C-1 -> one-hot (n, C);
    targets already one-hot pass through. Returns (encoded_y, n_classes),
    n_classes None on the pass-through path. A negative label, or one
    >= n_cls, raises ValueError."""
    y = np.asarray(y)
    if y.ndim > 1 and y.shape[-1] > 1:
        return y, n_cls
    flat = y.reshape(-1)
    if flat.size and float(flat.min()) < 0:
        raise ValueError(
            "classification labels must be 0..C-1 integers, got negative "
            f"label {flat.min()} (remap {{-1,+1}}-style labels to {{0,1}})")
    if n_cls is None:
        n_cls = int(flat.max()) + 1
    elif flat.size and int(flat.max()) >= n_cls:
        raise ValueError(
            f"label {int(flat.max())} out of range for the {n_cls} classes "
            "seen in the training labels (pass one-hot targets or ensure "
            "every class appears in y_train)")
    return np.eye(n_cls, dtype=np.float32)[flat.astype(int)], n_cls


def prepare_classification_targets(y, y_val, output_dim, perturb):
    """One-hot raw label vectors (y_val with the train-derived class count)
    and infer output_dim = C-1 (the C-1-logit convention). Perturb init
    needs a single output. Returns (y, y_val, output_dim)."""
    y, n_cls = one_hot_labels(y)
    if y_val is not None:
        y_val, _ = one_hot_labels(y_val, n_cls)
    if n_cls is not None:
        output_dim = n_cls - 1
        if perturb and output_dim > 1:
            raise ValueError("perturb not supported for output dim > 1 "
                             f"(raw labels imply {n_cls} classes -> "
                             f"output_dim {output_dim})")
    return y, y_val, output_dim


def default_loss(task, bf):
    """The loss when bf is None: XE on C-1 logits for classification,
    squared error otherwise."""
    if bf is not None:
        return bf
    if task == "classification":
        return XEBregman(w=1.0)
    return SquareBregFunction()


def error_rate(y_true, y_pred):
    """1 - accuracy from (possibly one-hot) targets and logit predictions."""
    y_pred_labels = np.argmax(np.asarray(y_pred), axis=1)
    y_true = np.asarray(y_true)
    if y_true.ndim > 1 and y_true.shape[1] > 1:
        y_true = np.argmax(y_true, axis=1)
    return float(np.mean(y_true != y_pred_labels))


class EarlyStopping:
    """Validation-loss patience with best-state snapshots. An improvement
    must beat abs_err or rel_err * |best| to reset patience; any
    improvement updates the best snapshot. `model_predict` returns numpy
    predictions for `X_val`; `loss_fn(y_val, pred)` is a float."""

    def __init__(self, X_val, y_val, model_predict, get_model_weights=None,
                 loss_fn=None, abs_err=0.0, rel_err=0.0, early_stopping=5,
                 verbose=0):
        self.X_val = X_val
        self.y_val = y_val
        self.model_predict = model_predict
        self.get_model_weights = get_model_weights
        self.loss_fn = loss_fn
        self.abs_err = abs_err
        self.rel_err = rel_err
        self.early_stopping = early_stopping
        self.verbose = verbose
        self.early_stop_count = 0
        self.best_val_loss = np.inf
        self.val_history = {}
        self.time_history = {}
        self.best_state_dict = (
            get_model_weights() if get_model_weights is not None else None)
        self.start_time = time.time()
        self.epoch = 0

    def convergence_criterion(self) -> bool:
        elapsed = time.time() - self.start_time
        self.epoch += 1
        y_pred_val = self.model_predict(self.X_val)
        val_loss = float(self.loss_fn(self.y_val, y_pred_val))
        self.val_history[self.epoch] = val_loss
        self.time_history[self.epoch] = elapsed

        prev_best = self.best_val_loss
        improvement = prev_best - val_loss
        meets = (improvement >= self.abs_err
                 or improvement >= self.rel_err * abs(prev_best))
        if improvement > 0:
            self.best_val_loss = val_loss
            if self.get_model_weights is not None:
                self.best_state_dict = self.get_model_weights()
            self.early_stop_count = 0 if meets else self.early_stop_count + 1
            if self.verbose > 0:
                print(f"Epoch {self.epoch}: val loss {val_loss:.4f} "
                      f"(diff: {improvement:.4f})")
        else:
            self.early_stop_count += 1

        if self.early_stop_count >= self.early_stopping:
            if self.verbose > 0:
                print(f"Converged with best loss: {self.best_val_loss:.4f}")
            return True
        return False


class TensorTrainRegressor(BaseEstimator, RegressorMixin):
    """The canonical estimator. model_type 'tt' is one tensor train over
    the bias-augmented features; 'tt_type1' a sum of degree-1..N trains
    whose members beyond degree 1 drop the bias column."""

    def __init__(self, N=3, r=8, output_dim=1, linear_dim=None,
                 constrict_bond=False, perturb=False, seed=42,
                 bf=None, lr=1.0, eps_start=1.0, eps_decay=0.5,
                 abs_err=1e-4, rel_err=1e-3, batch_size=512,
                 method="ridge_cholesky", num_swipes=30, model_type="tt",
                 task="regression", train_operator=False, cum_sum=False,
                 early_stopping=0, dtype=torch.float32, verbose=0,
                 timeout=None, precision=None, refine=False,
                 solve_dtype=None, device="cpu"):
        self.N = N
        self.r = r
        self.output_dim = output_dim
        self.linear_dim = linear_dim if linear_dim is not None and linear_dim > 0 else None
        self.constrict_bond = constrict_bond
        self.perturb = perturb
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
        self.model_type = model_type
        self.task = task
        self.train_operator = train_operator
        self.cum_sum = cum_sum
        self.early_stopping = early_stopping
        self.dtype = dtype
        self.verbose = verbose
        self.timeout = timeout  # wall-clock abort in seconds, for the sweep
        # numerics tier: "reference" | "fast" | "fastest" | None (respect
        # the ambient TNF_* env), scoped around fit/predict
        self.precision = validate_tier(precision)
        self.refine = refine
        self.solve_dtype = solve_dtype
        self.device = torch.device(device)
        self._model = None
        self.input_dim = None
        if model_type not in ("tt", "tt_type1"):
            raise NotImplementedError(
                f"model_type {model_type!r}: only 'tt' and 'tt_type1' are "
                "ported (ROADMAP item 14)")
        if cum_sum or self.linear_dim is not None:
            raise NotImplementedError(
                "cum_sum and linear_dim layers are not ported (ROADMAP item 14)")
        if solve_dtype is not None and str(solve_dtype) not in ("float32", "f32"):
            raise NotImplementedError(
                "the float64 solve tier is not ported (ROADMAP item 10)")
        if self.perturb and self.output_dim > 1:
            raise ValueError("perturb not supported for output dim > 1")

    # ----------------------------------------------------------- model build
    def _make_single(self, n, f, seed) -> TNLayer:
        return TensorTrainLayer(n, self.r, f, output_shape=self.output_dim,
                                constrict_bond=self.constrict_bond,
                                perturb=self.perturb, dtype=self.dtype,
                                seed=seed, device=self.device)

    def _initialize_model(self):
        if self.input_dim is None:
            raise ValueError("input_dim must be set")
        if "type1" in self.model_type:
            # degree-1..N members; members > 1 drop the bias column
            layers = [
                self._make_single(
                    i, self.input_dim if i == 1 else self.input_dim - 1,
                    self.seed + i)
                for i in range(1, self.N + 1)
            ]
            self._model = SumLayer(layers)
        else:
            self._model = self._make_single(self.N, self.input_dim, self.seed)

    # ------------------------------------------------------------------- fit
    def _as_tensor(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    @staticmethod
    def _add_bias(X):
        return torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                        device=X.device)], dim=1)

    def _predict_arr(self, X):
        y = self._model.forward_batch(X, self.batch_size)
        if self.task == "classification":
            y = torch.cat([y, torch.zeros_like(y[..., :1])], dim=-1)
        return y

    def fit(self, X, y, X_val=None, y_val=None, validation_split=0.1,
            split_train=True):
        with numerics_tier(self.precision):
            return self._fit(X, y, X_val, y_val, validation_split,
                             split_train)

    def _fit(self, X, y, X_val=None, y_val=None, validation_split=0.1,
             split_train=True):
        X = self._add_bias(self._as_tensor(X))
        if self.task == "classification":
            # on a continued fit (model already built) output_dim is frozen
            if self._model is None:
                y, y_val, self.output_dim = prepare_classification_targets(
                    y, y_val, self.output_dim, self.perturb)
            else:
                y, _ = one_hot_labels(y, self.output_dim + 1)
                if y_val is not None:
                    y_val, _ = one_hot_labels(y_val, self.output_dim + 1)
        y = self._as_tensor(y)
        if y.ndim == 1:
            y = y[:, None]

        if self._model is None:
            self.input_dim = int(X.shape[1])
            self._initialize_model()
        if self.verbose > 0:
            print("Number of parameters:", self._model.num_parameters())

        if X_val is None or y_val is None:
            if split_train:
                n = X.shape[0]
                idx = np.arange(n)
                np.random.RandomState(self.seed).shuffle(idx)
                split = int(n * (1 - validation_split))
                tr = torch.as_tensor(idx[:split], device=self.device)
                va = torch.as_tensor(idx[split:], device=self.device)
                X, X_val = X[tr], X[va]
                y, y_val = y[tr], y[va]
            else:
                X_val, y_val = X, y
        else:
            X_val = self._as_tensor(X_val)
            y_val = self._as_tensor(y_val)
            if y_val.ndim == 1:
                y_val = y_val[:, None]
            if X_val.shape[1] != X.shape[1]:
                X_val = self._add_bias(X_val)

        bf = default_loss(self.task, self.bf)
        cfg = SweepConfig(
            num_swipes=self.num_swipes, batch_size=self.batch_size,
            method=self.method, eps=self.eps, eps_decay=self.eps_decay,
            lr=self.lr, verbose=self.verbose, timeout=self.timeout,
            refine=self.refine, solve_dtype=self.solve_dtype)
        is_sum = isinstance(self._model, SumLayer)
        if is_sum:
            # train_operator: True trains each member's train nodes, False
            # only the main cores
            members = [Member(l.network, fn,
                              train="train" if self.train_operator else "main")
                       for l, fn in zip(self._model.layers, self._model.input_fns)]
            sweeper = Sweeper(members, bf, cfg)
            init_params = self._model.params_list
        else:
            sweeper = Sweeper(self._model.network, bf, cfg)
            init_params = [self._model.params]

        def _sync():
            pl = getattr(sweeper, "params_list", None)
            if pl is not None:
                if is_sum:
                    self._model.set_params_list(pl)
                else:
                    self._model.params = pl[0]

        def model_predict(Xb):
            _sync()
            return self._predict_arr(Xb).cpu().numpy()

        def get_weights():
            _sync()
            return self._model.node_states()

        self._early_stopper = EarlyStopping(
            X_val, y_val.cpu().numpy(),
            model_predict=model_predict,
            get_model_weights=get_weights,
            loss_fn=rmse if self.task == "regression" else error_rate,
            abs_err=self.abs_err, rel_err=self.rel_err,
            early_stopping=self.early_stopping, verbose=self.verbose)

        # the sweeper stays readable after the fit (its TNF_SWEEP_TIMERS
        # phase report); fit_ok_ is False after a singular solve or timeout
        self.sweeper_ = sweeper
        out, self.fit_ok_ = sweeper.run(
            init_params, X, y,
            convergence_criterion=self._early_stopper.convergence_criterion
            if self.early_stopping > 0 else None)
        if is_sum:
            self._model.set_params_list(out)
        else:
            self._model.params = out[0]

        if (self.early_stopping > 0
                and self._early_stopper.best_state_dict is not None):
            self._model.load_node_states(self._early_stopper.best_state_dict)
        return self

    def predict(self, X):
        with numerics_tier(self.precision):
            X = self._add_bias(self._as_tensor(X))
            return self._predict_arr(X).cpu().numpy()

    def score(self, X, y_true):
        y_pred = self.predict(X)
        y_true = np.asarray(y_true)
        if self.task == "regression":
            if y_true.ndim == 1:
                y_true = y_true[:, None]
            return r2_score_np(y_true, y_pred)
        return 1.0 - error_rate(y_true, y_pred)

    def export(self, path=None, **kw):
        raise NotImplementedError(
            "serving export is not ported (ROADMAP item 18)")
