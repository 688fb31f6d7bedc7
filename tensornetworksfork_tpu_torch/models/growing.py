"""DMRG-style growing models (port of tensornetworksfork_tpu/models/growing.py).

- `TensorTrainDMRGInfiLayer`: a tensor train that grows by splicing a fresh
  two-physical-leg block into its middle (`grow_middle`) and SVD-splitting
  it back into two cores with rank or error truncation (`split_node`):
  infinite-DMRG-style growth.
- `grow_cart` for the conv-TT layer: appends a carriage that reads only the
  bias patch, broadcasting the old boundary core and conv block up to the
  new bond.

Shapes change at every growth step, so each step builds a fresh Topology
and carries the params over. The DMRG layer draws its cores from numpy's
`default_rng(seed)`, as the JAX package does, so both start from the same
numbers; `split_node` runs numpy's SVD on the host, as there.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.engine import Network
from ..core.topology import INPUT, PARAM, TopologyBuilder
from .layers import TensorConvolutionTrainLayer, TNLayer


class TensorTrainDMRGInfiLayer(TNLayer):
    """State: an ordered list of cores; entry k has `phys[k]` physical legs
    (1 normally, 2 for a freshly grown middle block). Core 0 carries the
    output leg. Lives on `device` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, bond_dim: int, input_features: int, output_shape=(),
                 dtype=torch.float32, seed: int = 0, device="cuda",
                 use_kernels: Optional[bool] = None):
        self.bond_dim = bond_dim
        self.input_features = input_features
        self.output_shape = (output_shape if isinstance(output_shape, tuple)
                             else (output_shape,))
        self.dtype = dtype
        self._device, self._use_kernels = device, use_kernels
        self._rng = np.random.default_rng(seed)
        f = input_features
        out = self.output_shape[0] if self.output_shape else 1
        r = min(bond_dim, f)
        self._cores: List[Tuple[np.ndarray, int]] = [
            (self._rand((out, f, r)), 1), (self._rand((r, f)), 1)]
        self._grown_idx: Optional[int] = None
        self._rebuild(train_only=None)

    def _rand(self, shape):
        t = self._rng.standard_normal(shape)
        return (t / np.linalg.norm(t)).astype(np.float32)

    @property
    def num_carriages(self):
        return sum(n for _, n in self._cores)

    def _rebuild(self, train_only: Optional[int]):
        """The topology of the current core list; its params are the
        cores."""
        b = TopologyBuilder()
        f = self.input_features
        pos = 0  # physical position counter
        names = []
        for k, (arr, n_phys) in enumerate(self._cores):
            labels, shape = [], []
            if k > 0:
                labels.append(f"r{k}")
                shape.append(arr.shape[0])
            if k == 0:
                labels.append("c1")
                shape.append(arr.shape[0])
            for j in range(n_phys):
                labels.append(f"p{pos + j}")
                shape.append(f)
            if k < len(self._cores) - 1:
                labels.append(f"r{k+1}")
                shape.append(arr.shape[-1])
            name = f"A{k+1}"
            b.node(name, labels, tuple(shape), kind=PARAM, init=arr,
                   left=(f"r{k}",) if k > 0 else (),
                   right=(f"r{k+1}",) if k < len(self._cores) - 1 else ())
            names.append(name)
            for j in range(n_phys):
                b.node(f"X{pos + j}", ("s", f"p{pos + j}"), (None, f), kind=INPUT)
                b.connect(name, f"p{pos + j}", f"X{pos + j}")
            if k > 0:
                b.connect(names[k - 1], f"r{k}", name)
            pos += n_phys
        train = [names[train_only]] if train_only is not None else names
        topo = b.finalize([f"X{j}" for j in range(pos)], names,
                          train_nodes=train, output_labels=("s", "c1"))
        net = Network(topo, device=self._device, use_kernels=self._use_kernels)
        params = {spec.name: torch.as_tensor(spec.init, dtype=self.dtype,
                                             device=net.device)
                  for spec in topo.nodes if spec.kind == PARAM}
        TNLayer.__init__(self, net, params)
        self._names = names

    def bind_x(self, x):
        """x: (S, n_positions, f), or (S, f) shared -> per-position inputs."""
        t = self.topology
        if x.ndim == 2:
            return {t.nodes[ni].name: x for ni in t.input_nodes}
        return {f"X{j}": x[:, j] for j in range(x.shape[1])}

    def _sync_cores_from_params(self):
        self._cores = [(self.params[self._names[k]].detach().cpu().numpy(), n_phys)
                       for k, (_, n_phys) in enumerate(self._cores)]

    def grow_middle(self):
        """Splice a fresh (b1, f, f, b2) block into the middle of the chain
        and make it the only train node."""
        self._sync_cores_from_params()
        mid = len(self._cores) // 2
        b1 = self._cores[mid - 1][0].shape[-1]
        b2 = self._cores[mid][0].shape[0]
        f = self.input_features
        self._cores.insert(mid, (self._rand((b1, f, f, b2)), 2))
        self._grown_idx = mid
        self._rebuild(train_only=mid)

    def split_node(self, rank: int, err: Optional[float] = None,
                   is_last: bool = False) -> float:
        """SVD-split the grown two-site block back into two cores, truncated
        to `rank` or to the cumulative singular-value error `err`. Returns
        the split error."""
        if self._grown_idx is None:
            raise ValueError("no grown block to split; call grow_middle first")
        self._sync_cores_from_params()
        mid = self._grown_idx
        block, n_phys = self._cores[mid]
        assert n_phys == 2
        b1, f, f2, b2 = block.shape
        u, s, v = np.linalg.svd(block.reshape(b1 * f, f2 * b2), full_matrices=False)
        if is_last:
            v = np.diag(s) @ v
        s_cumsum = np.cumsum(s[::-1])
        if err is not None:
            rank = max(min(rank, int((s_cumsum > err).sum())), 1)
        rank = min(rank, len(s))
        split_err = float(s_cumsum[-rank])
        left = u[:, :rank].reshape(b1, f, rank)
        if is_last:
            right = v[:rank].reshape(rank, f2, b2)
        else:
            right = (np.diag(s[:rank]) @ v[:rank]).reshape(rank, f2, b2)
        self._cores[mid] = (left.astype(np.float32), 1)
        self._cores.insert(mid + 1, (right.astype(np.float32), 1))
        self._grown_idx = None
        self._rebuild(train_only=None)
        return split_err


def grow_cart(layer: TensorConvolutionTrainLayer, new_bond: Optional[int] = None,
              new_convolution_bond: Optional[int] = None
              ) -> TensorConvolutionTrainLayer:
    """Append a carriage to a conv-TT layer. Returns a NEW layer (a fresh
    topology, on the old layer's device) carrying the params: cores and conv
    blocks 1..N-1 as they were, the old last core and conv block broadcast
    up to the new right bond, and the new core zero except on the bias
    patch (the last), where it reads 1/new_bond. The new conv block keeps
    the grown layer's own draw. As in the JAX package, the grown layer
    keeps the old bond and conv bond: new_bond sets only the new core's
    value, and new_convolution_bond is not read."""
    N = layer.num_carriages
    r_new = new_bond if new_bond is not None else layer.bond_dim
    net = layer.network
    out_shape = tuple(net.topology.axis_size[a] for a in net.topology.output_axes)
    grown = TensorConvolutionTrainLayer(
        num_carriages=N + 1, bond_dim=layer.bond_dim,
        num_patches=layer.num_patches, patch_pixels=layer.patch_pixels,
        output_shape=out_shape, convolution_bond=layer.convolution_bond, seed=0,
        device=net.device, use_kernels=net.use_kernels)

    def broadcast(old, tgt):
        return old[..., None].expand(tuple(old.shape) + (tgt.shape[-1],)).reshape(
            tgt.shape).clone()

    params = dict(grown.params)
    for i in range(1, N):
        params[f"A{i}"] = layer.params[f"A{i}"]
        params[f"C{i}"] = layer.params[f"C{i}"]
    params[f"A{N}"] = broadcast(layer.params[f"A{N}"], grown.params[f"A{N}"])
    params[f"C{N}"] = broadcast(layer.params[f"C{N}"], grown.params[f"C{N}"])
    # the squeezed last core has axes (r, patches), the bias patch last
    newA = torch.zeros_like(grown.params[f"A{N+1}"])
    newA[..., -1] = 1.0 / max(r_new, 1)
    params[f"A{N+1}"] = newA
    grown.params = params
    return grown
