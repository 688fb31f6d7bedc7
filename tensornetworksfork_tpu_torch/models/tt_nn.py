"""A TT inside a gradient-trained model, with natural-gradient (Gauss-Newton)
block updates (port of tensornetworksfork_tpu/models/tt_nn.py).

The loss's output-space gradient and Hessian are passed in at each step
(take them from any loss with ops.bregman.AutogradLoss); the local system
(A, b) of the current block is an exponential moving average with factor
lmb, and `apply_update` solves it (`solve_block`, ridge Cholesky by
default) and moves round robin to the next block. After each full cycle eps
decays x0.7 (floor 4e-4) and lmb anneals toward 0.95.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.contract import contract
from ..core.solve import solve_block
from .layers import TensorTrainLayer


class TTNaturalGradient:
    def __init__(self, input_features: int, output_shape, N: int = 3,
                 r: int = 8, constrict_bond: bool = True,
                 method: str = "ridge_cholesky", eps: float = 1e-2,
                 lmb: float = 0.9, dtype=torch.float32, seed: int = 0,
                 device="cuda"):
        # +1 input feature: the forward appends a bias column
        self.layer = TensorTrainLayer(N, r, input_features + 1,
                                      output_shape=output_shape,
                                      constrict_bond=constrict_bond,
                                      dtype=dtype, seed=seed, device=device)
        self.net = self.layer.network
        self.method = method
        self.eps = eps
        self.lmb = lmb
        self._cur = 0
        self._A: Optional[torch.Tensor] = None
        self._b: Optional[torch.Tensor] = None
        self._train = list(self.net.topology.train_nodes)

    @property
    def params(self):
        return self.layer.params

    @params.setter
    def params(self, p):
        self.layer.params = p

    def _inputs(self, x):
        return self.net.bind_inputs(torch.cat([x, torch.ones_like(x[..., :1])], dim=-1))

    def forward(self, params, x) -> torch.Tensor:
        return self.net.forward(params, self._inputs(x))

    def _system(self, ni, params, x, d_loss, sqd_loss):
        """(A, b) of node ni: J contracts every other node directly."""
        net, t = self.net, self.net.topology
        inputs = self._inputs(x)
        ops = [net.operand(nj, params, inputs) for nj in range(len(t.nodes)) if nj != ni]
        keep = net.jacobian_keep(ni, [ax for ax, _ in ops])
        A, b = net.gram_and_rhs(ni, (keep, contract(ops, keep, net.precision)),
                                d_loss, sqd_loss)
        D = params[t.nodes[ni].name].numel()
        return A.reshape(D, D), b.reshape(D)

    def accumulate(self, params, x, d_loss, sqd_loss):
        """EMA-accumulate the current block's system."""
        A, b = self._system(self._train[self._cur], params, x, d_loss, sqd_loss)
        if self._A is None:
            self._A, self._b = A, b
        else:
            self._A = self.lmb * self._A + (1 - self.lmb) * A
            self._b = self.lmb * self._b + (1 - self.lmb) * b
        return self

    def apply_update(self, params) -> Dict[str, torch.Tensor]:
        """Solve and update the current block, then move to the next."""
        if self._A is None:
            return params
        name = self.net.topology.nodes[self._train[self._cur]].name
        core = params[name]
        step, ok = solve_block(self._A, self._b, core, self.method, self.eps)
        new = dict(params)
        new[name] = torch.where(ok, core + step.reshape(core.shape), core)
        self._cur += 1
        self._A = self._b = None
        if self._cur >= len(self._train):
            self._cur = 0
            self.eps = max(self.eps * 0.7, 4e-4)
            self.lmb = min(1 - (1 - self.lmb) * 0.8, 0.95)
        return new

    def train_step(self, params, x, y, loss_fn) -> Tuple[Dict, torch.Tensor]:
        """Forward, (loss, grad, hess) from a Bregman-style loss_fn,
        accumulate and update. Returns (params, mean loss)."""
        pred = self.forward(params, x)
        loss, g, H = loss_fn(pred, y)
        self.accumulate(params, x, g, H)
        return self.apply_update(params), loss.mean()
