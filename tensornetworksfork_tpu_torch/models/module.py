"""Older-generation estimator variants (port of
tensornetworksfork_tpu/models/module.py).

- `TensorTrainRegressor`: eps follows a geomspace from eps_start to eps_end
  over the 2·num_swipes half-sweeps (per node when num_swipes == 1), and
  every node update appends validation metrics to `trajectory`;
- `TensorTrainBatchRegressor`: stochastic block-coordinate training over
  minibatches, swipe_method batch_unique (one node per minibatch, mirrored
  round robin), batch_same (a whole sweep per minibatch) or batch_block
  (one node over every minibatch, mirrored cycle); minibatches are drawn
  from `np.random.RandomState(seed)`, as in the JAX package;
- `TensorTrainRegressorEarlyStopping`: one left-to-right pass with per-node
  eps that stops on the node count ("degree") and restores the best state.

They run on `device` (the card unless the caller asks for the CPU).
`TensorTrainBatchRegressor(stream="native")` takes its minibatches from the
native prefetcher (`utils/data_stream.py`) in the JAX package's sequence.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.sweep import Member, SweepConfig, Sweeper
from ..ops.bregman import SquareBregFunction
from ..utils.device import resolve_device
from .estimators import error_rate, r2_score_np, rmse
from .layers import CPDLayer, SumLayer, TensorTrainLayer, TensorTrainLinearLayer

try:  # sklearn is optional (the GPU machine has none)
    from sklearn.base import BaseEstimator, RegressorMixin
except ImportError:  # pragma: no cover
    class BaseEstimator:  # type: ignore
        pass

    class RegressorMixin:  # type: ignore
        pass


def mirrored_cycle(seq, one_cycle: bool = False):
    """1,2,3,2,1,2,3,... over seq (one_cycle: 1,2,3,2,1 once)."""
    if not seq:
        return
    if one_cycle:
        yield from (list(seq) + list(reversed(seq[:-1])))
        return
    forward = list(seq)
    pattern = forward + forward[-2:0:-1]
    while True:
        yield from pattern


class TensorTrainRegressor(BaseEstimator, RegressorMixin):
    """Geomspace-eps trajectory regressor: model_type tt, cpd or
    tt_type1[_bias_first][_no_train_linear], with linear_dim."""

    def __init__(self, N=2, r=2, output_dim=1, linear_dim=None,
                 constrict_bond=True, perturb=True, seed=42, bf=None, lr=1.0,
                 eps_start=1e-12, eps_end=1e-12, batch_size=512,
                 method="ridge_cholesky", num_swipes=5, model_type="tt",
                 dtype=torch.float32, verbose=0, device="cuda"):
        self.N = N
        self.r = r
        self.output_dim = output_dim
        self.linear_dim = linear_dim if linear_dim is not None and linear_dim > 0 else None
        self.constrict_bond = constrict_bond
        self.perturb = perturb
        self.seed = seed
        self.bf = bf
        self.lr = lr
        if num_swipes > 1:
            self.epss = (np.geomspace(eps_start, eps_end, 2 * num_swipes).tolist()
                         if eps_end != eps_start else [eps_end] * (2 * num_swipes))
        else:
            self.epss = np.geomspace(eps_start, eps_end, N).tolist()
        self.batch_size = batch_size
        self.method = method
        self.num_swipes = num_swipes
        self.model_type = model_type
        self.dtype = dtype
        self.verbose = verbose
        self.device = resolve_device(device)
        self._model = None
        self.input_dim = None
        self.trajectory: List[dict] = []

    def _initialize_model(self):
        kw = dict(output_shape=self.output_dim, perturb=self.perturb,
                  dtype=self.dtype, device=self.device)
        linear = self.linear_dim is not None and self.linear_dim < self.input_dim
        if self.model_type == "cpd":
            self._model = CPDLayer(self.N, self.r, self.input_dim, seed=self.seed, **kw)
        elif self.model_type.startswith("tt_type1"):
            drop_bias = "bias_first" in self.model_type
            train_linear = "_no_train_linear" not in self.model_type
            layers = []
            for i in range(1, self.N + 1):
                f = self.input_dim - 1 if (drop_bias and i != 1) else self.input_dim
                ikw = dict(kw, constrict_bond=self.constrict_bond, seed=self.seed + i)
                if linear:
                    layers.append(TensorTrainLinearLayer(
                        i, self.r, f, self.linear_dim, train_linear=train_linear, **ikw))
                else:
                    layers.append(TensorTrainLayer(i, self.r, f, **ikw))
            self._model = SumLayer(layers)
        elif linear:
            self._model = TensorTrainLinearLayer(
                self.N, self.r, self.input_dim, self.linear_dim,
                constrict_bond=self.constrict_bond, seed=self.seed, **kw)
        else:
            self._model = TensorTrainLayer(
                self.N, self.r, self.input_dim, constrict_bond=self.constrict_bond,
                seed=self.seed, **kw)

    # -------------------------------------------------------------- plumbing
    def _prep_xy(self, X, y):
        X = torch.as_tensor(np.asarray(X), dtype=self.dtype, device=self.device)
        X = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)],
                      dim=1)
        if y is not None:
            y = torch.as_tensor(np.asarray(y), dtype=self.dtype, device=self.device)
            if y.ndim == 1:
                y = y[:, None]
        return X, y

    def _make_sweeper(self, cfg):
        if isinstance(self._model, SumLayer):
            members = [Member(l.network, fn) for l, fn in
                       zip(self._model.layers, self._model.input_fns)]
            return Sweeper(members, self._bf(), cfg), self._model.params_list
        return Sweeper(self._model.network, self._bf(), cfg), [self._model.params]

    def _store(self, sweeper):
        pl = sweeper.params_list
        if isinstance(self._model, SumLayer):
            self._model.set_params_list(pl)
        else:
            self._model.params = pl[0]

    def _bf(self):
        return self.bf if self.bf is not None else SquareBregFunction()

    def _forward_all(self, X) -> np.ndarray:
        return self._model.forward_batch(X, self.batch_size).cpu().numpy()

    def _split(self, X, y, X_val, y_val, validation_split, split_train):
        if X_val is None or y_val is None:
            if split_train:
                n = X.shape[0]
                idx = np.arange(n)
                np.random.RandomState(self.seed).shuffle(idx)
                split = int(n * (1 - validation_split))
                tr = torch.as_tensor(idx[:split], device=X.device)
                va = torch.as_tensor(idx[split:], device=X.device)
                return X[tr], y[tr], X[va], y[va]
            return X, y, X, y
        X_val, y_val = self._prep_xy(X_val, y_val)
        return X, y, X_val, y_val

    def _val_log(self, epoch, X_val, y_val) -> dict:
        y_pred = self._forward_all(X_val)
        y_np = y_val.cpu().numpy()
        log = {"epoch": epoch, "val_rmse": rmse(y_np, y_pred)}
        if y_val.shape[1] > 1:
            log["val_accuracy"] = 1.0 - error_rate(y_np, y_pred)
        if self.verbose > 0:
            print(", ".join(f"{k}: {v}" for k, v in log.items()))
        self.trajectory.append(log)
        return log

    def _setup(self, X, y, X_val, y_val, validation_split, split_train):
        X, y = self._prep_xy(X, y)
        if self._model is None:
            self.input_dim = int(X.shape[1])
            self._initialize_model()
        return self._split(X, y, X_val, y_val, validation_split, split_train)

    def fit(self, X, y, X_val=None, y_val=None, validation_split=0.1,
            split_train=True):
        X, y, X_val, y_val = self._setup(X, y, X_val, y_val, validation_split,
                                         split_train)
        self.trajectory = []
        epoch = [0]
        cfg = SweepConfig(num_swipes=self.num_swipes, batch_size=self.batch_size,
                          method=self.method, eps=self.epss, lr=self.lr,
                          eps_per_node=(self.num_swipes == 1
                                        and len(self.epss) == self.N),
                          verbose=self.verbose)
        sweeper, init = self._make_sweeper(cfg)

        def convergence_criterion():
            epoch[0] += 1
            self._store(sweeper)
            self._val_log(epoch[0], X_val, y_val)
            return False

        sweeper.run(init, X, y, convergence_criterion=convergence_criterion)
        self._store(sweeper)
        return self

    def predict(self, X):
        X, _ = self._prep_xy(X, None)
        return self._forward_all(X)

    def score(self, X, y_true):
        y_pred = self.predict(X)
        y_true = np.asarray(y_true)
        if y_true.ndim == 1:
            y_true = y_true[:, None]
        return r2_score_np(y_true, y_pred.reshape(y_true.shape))


class TensorTrainBatchRegressor(TensorTrainRegressor):
    """Stochastic block-coordinate training: batch_unique (one node per
    minibatch, mirrored round robin), batch_same (a whole sweep per
    minibatch), batch_block (one node over every minibatch, mirrored
    cycle). Each swipe draws a permutation of the training rows from
    RandomState(seed); batch_block shares one permutation across the
    swipe's blocks.

    stream="native" takes the minibatches from `utils/data_stream.py`'s
    MinibatchStream instead: the native library's worker thread gathers
    each batch's rows of X on the host in its own seeded permutation (the
    JAX package's sequence for the same seed; batch_block draws a fresh
    permutation per block), and each batch then goes to the device. Without
    the native library it raises, carrying g++'s error; it never falls back
    to the numpy permutation, which is another sequence."""

    def __init__(self, *args, batch_size=1024, swipe_method="batch_unique",
                 stream=None, **kwargs):
        if stream not in (None, "native"):
            raise ValueError(f"stream must be None or 'native', not {stream!r}")
        super().__init__(*args, batch_size=batch_size, **kwargs)
        self.swipe_method = swipe_method
        self.stream = stream

    def fit(self, X, y, X_val=None, y_val=None, validation_split=0.1,
            split_train=True):
        X, y, X_val, y_val = self._setup(X, y, X_val, y_val, validation_split,
                                         split_train)
        n_train = int(X.shape[0])
        batch_rng = np.random.RandomState(self.seed)
        self.trajectory = []
        cfg = SweepConfig(num_swipes=1, batch_size=-1, method=self.method,
                          eps=self.epss, lr=self.lr,
                          eps_per_node=len(self.epss) == self.N,
                          verbose=self.verbose)
        sweeper, params = self._make_sweeper(cfg)
        seq = [(mi, ni) for mi, m in enumerate(sweeper.members)
               for ni in m.train_nodes]

        ms = None
        if self.stream == "native":
            from ..native import require_lib
            from ..utils.data_stream import MinibatchStream
            require_lib()  # raises with g++'s error: no numpy permutation
            y_host = y.cpu().numpy()
            ms = MinibatchStream(X.cpu().numpy(), self.batch_size, seed=self.seed)

        def epoch_batches(indices=None):
            """One permutation of the training rows as (xb, yb) pairs: from
            the native stream (gathered on the host, then moved to X's
            device), else by indexing X on its device."""
            if ms is not None:
                for xb, idx in ms.epoch():
                    yield (torch.from_numpy(xb).to(X.device),
                           torch.from_numpy(y_host[idx]).to(X.device))
                return
            if indices is None:
                indices = batch_rng.permutation(n_train)
            for bs in range(0, n_train, self.batch_size):
                bi = torch.as_tensor(indices[bs:bs + self.batch_size], device=X.device)
                yield X[bi], y[bi]

        def step(xb, yb, node_order=None):
            nonlocal params
            params, _ = sweeper.run(params, xb, yb, node_order=node_order)
            self._store(sweeper)

        try:
            for swipe in range(self.num_swipes):
                if self.swipe_method == "batch_unique":
                    block_iter = mirrored_cycle(seq, one_cycle=False)
                    for xb, yb in epoch_batches():
                        step(xb, yb, [next(block_iter)])
                elif self.swipe_method == "batch_same":
                    for xb, yb in epoch_batches():
                        step(xb, yb)
                elif self.swipe_method == "batch_block":
                    swipe_idx = None if ms is not None else batch_rng.permutation(n_train)
                    for block in mirrored_cycle(seq, one_cycle=True):
                        for xb, yb in epoch_batches(swipe_idx):
                            step(xb, yb, [block])
                else:
                    raise ValueError(f"unknown swipe_method {self.swipe_method!r}")
                self._val_log(swipe + 1, X_val, y_val)
        finally:
            if ms is not None:
                ms.close()
        return self


class TensorTrainRegressorEarlyStopping(TensorTrainRegressor):
    """One left-to-right pass with per-node eps; stops after
    `early_stopping` node updates without improvement of the validation
    RMSE and restores the best state. Forces num_swipes=1 and the perturb
    init."""

    def __init__(self, *args, early_stopping=10, rel_err=1e-12, abs_err=1e-13,
                 validation_split=0.1, split_train=False, **kwargs):
        kwargs["num_swipes"] = 1
        kwargs["perturb"] = True
        super().__init__(*args, **kwargs)
        self.early_stopping = early_stopping
        self.rel_err = rel_err
        self.abs_err = abs_err
        self.validation_split = validation_split
        self.split_train = split_train
        self._best_degree = None
        self._singular = False

    def fit(self, X, y, X_val=None, y_val=None):
        X, y, X_val, y_val = self._setup(X, y, X_val, y_val, self.validation_split,
                                         self.split_train)
        cfg = SweepConfig(num_swipes=1, batch_size=self.batch_size,
                          method=self.method, eps=self.epss, lr=self.lr,
                          skip_second=True, eps_per_node=True,
                          verbose=self.verbose)
        sweeper, init = self._make_sweeper(cfg)
        y_val_np = y_val.cpu().numpy()
        state = {"degree": 0, "best": np.inf, "best_state": None,
                 "best_degree": 0, "count": 0}

        def convergence_criterion():
            state["degree"] += 1
            self._store(sweeper)
            val_loss = rmse(y_val_np, self._forward_all(X_val))
            improvement = state["best"] - val_loss
            meets = (improvement >= self.abs_err
                     or improvement >= self.rel_err * abs(state["best"]))
            if improvement > 0:
                state["best"] = val_loss
                state["best_state"] = self._model.node_states()
                state["best_degree"] = state["degree"]
                state["count"] = 0 if meets else state["count"] + 1
            else:
                state["count"] += 1
            return state["count"] >= self.early_stopping

        _, converged = sweeper.run(init, X, y,
                                   convergence_criterion=convergence_criterion)
        self._singular = not converged
        self._best_degree = state["best_degree"]
        if state["best_state"] is not None:
            self._model.load_node_states(state["best_state"])
        return self
