"""Model zoo: tensor-network layer builders (port of
tensornetworksfork_tpu/models/layers.py: the shared helpers, the tensor
train, the conv-TT classifier and type-I sums so far).

Each builder returns a `TNLayer` holding a `Network` (structure) and a params
dict (state). The topology is built by the same calls as in the JAX package,
so node names, axis ids and shapes agree one to one.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import Network
from ..core.topology import INPUT, PARAM, TopologyBuilder


def tt_rank_profile(N: int, r: int, f, constrict_bond: bool = True
                    ) -> List[Tuple[int, int]]:
    """(left, right) bond sizes per core: constrict_bond clips ranks to
    f^depth from both ends, grown alternately inward. `f` may be an int or a
    per-position list."""
    fs = [f] * N if isinstance(f, int) else list(f)
    if N == 1:
        return [(1, 1)]

    def clip(R, depth_cap):
        return min(R, depth_cap) if constrict_bond else R

    b0 = (1, clip(r, 1 * fs[0]))
    bn = (clip(r, 1 * fs[-1]), 1)
    left_stack = [b0]
    right_stack = [bn]
    middle = [b0, bn]
    for i in range(N - 2):
        left_r = left_stack[-1][1]
        right_r = right_stack[0][0]
        if i == N - 3:
            middle = [*left_stack, (left_r, right_r), *right_stack]
        if i % 2 == 0:
            left_stack.append((left_r, clip(r, left_r * fs[len(left_stack)])))
        else:
            right_stack.insert(0, (clip(r, right_r * fs[N - 1 - len(right_stack)]),
                                   right_r))
    return middle


def perturb_block(rl: int, f: int, rr: int, rng: Optional[np.random.Generator],
                  noise: float = 0.0) -> np.ndarray:
    """(rl, 1, f, rr) core: zero except an identity/ones block on the last
    physical slice."""
    if rl == 1 or rr == 1:
        block = np.ones((rl, rr))
    else:
        block = np.eye(rl, rr)
    core = np.zeros((rl, f, rr))
    core[:, -1, :] = block
    if noise and rng is not None:
        core = core * (1 + noise * rng.standard_normal(core.shape))
    return core[:, None, :, :]


def perturb_profile(N: int, r: int, f: int, constrict_bond: bool,
                    rng: np.random.Generator) -> List[np.ndarray]:
    """Perturb init cores (left-heavy growth; 2% noise on the two boundary
    cores only)."""
    def cap(R, prev):
        return min(R, prev * f) if constrict_bond else R

    if N == 1:
        return [perturb_block(1, f, 1, rng, 0.02)]
    b0 = perturb_block(1, f, cap(r, 1), rng, 0.02)
    bn = perturb_block(b0.shape[-1] if N == 2 else r, f, 1, rng, 0.02)
    if N == 2:
        return [b0, bn]
    left_stack = [b0]
    middle = None
    for i in range(N - 2):
        rl = left_stack[-1].shape[-1]
        rr = bn.shape[0]
        if i == N - 3:
            middle = [*left_stack, perturb_block(rl, f, rr, rng), bn]
        else:
            left_stack.append(perturb_block(rl, f, cap(r, rl), rng))
    return middle


class TNLayer:
    """Structure (Network) + state (params dict): forward, node_states /
    load_node_states, num_parameters."""

    def __init__(self, network: Network, params):
        self.network = network
        self.params = params

    @property
    def topology(self):
        return self.network.topology

    def __call__(self, x, params=None):
        return self.network.forward(self.params if params is None else params,
                                    self.network.bind_inputs(x))

    def forward_batch(self, x, batch_size: int):
        inputs = self.network.bind_inputs(x)
        S = next(iter(inputs.values())).shape[0]
        if batch_size <= 0 or batch_size >= S:
            return self(inputs)
        outs = []
        for b in range(0, S, batch_size):
            outs.append(self({k: v[b:b + batch_size] for k, v in inputs.items()}))
        return torch.cat(outs, dim=0)

    def num_parameters(self) -> int:
        return self.topology.num_parameters(self.params)

    def node_states(self):
        return {k: v for k, v in self.params.items()}

    def load_node_states(self, states):
        self.params = dict(states)


class TensorTrainLayer(TNLayer):
    """Tensor train over per-carriage feature vectors: N cores A_i (left
    bond, output slot, feature, right bond), each contracted with its input
    X_i(s, f). With perturb, the cores start as ~identity on the last
    feature slice (the bias column) with 2% noise on the boundary cores, so
    the TT starts as an approximately constant function."""

    def __init__(self, num_carriages: int, bond_dim: int, input_features: int,
                 output_shape=(), constrict_bond: bool = True,
                 perturb: bool = False, dtype=torch.float32, seed: int = 0,
                 device="cuda", use_kernels: Optional[bool] = None):
        N, r, f = num_carriages, bond_dim, input_features
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        self.num_carriages, self.bond_dim, self.input_features = N, r, f
        self.output_shape = output_shape
        b = TopologyBuilder()
        rng = np.random.default_rng(seed)

        if perturb:
            if any(o > 1 for o in output_shape):
                raise ValueError("perturb init requires output dims of 1")
            inits = perturb_profile(N, 1 if N == 1 else r, f, constrict_bond, rng)
            profile = [(a.shape[0], a.shape[-1]) for a in inits]
        else:
            profile = tt_rank_profile(N, 1 if N == 1 else r, f, constrict_bond)
            inits = [None] * N

        out_labels = ["s"]
        for i in range(1, N + 1):
            left, right = profile[i - 1]
            if i - 1 < len(output_shape):
                up, up_label = output_shape[i - 1], f"c{i}"
                out_labels.append(up_label)
            else:
                up, up_label = 1, "c"
            b.node(f"A{i}", (f"r{i}", up_label, f"p{i}", f"r{i+1}"),
                   (left, up, f, right), kind=PARAM,
                   left=(f"r{i}",), right=(f"r{i+1}",), init=inits[i - 1])
            b.node(f"X{i}", ("s", f"p{i}"), (None, f), kind=INPUT)
            b.connect(f"A{i}", f"p{i}", f"X{i}")
            if i > 1:
                b.connect(f"A{i-1}", f"r{i}", f"A{i}")
        for i in range(1, N + 1):
            b.squeeze(f"A{i}", exclude=out_labels)
        topo = b.finalize([f"X{i}" for i in range(1, N + 1)],
                          [f"A{i}" for i in range(1, N + 1)],
                          output_labels=tuple(out_labels))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


class TensorConvolutionTrainLayer(TNLayer):
    """Conv-TT image classifier: N carriages, each a TT core A_i over the
    patch axis and a conv block C_i over the patch pixels, joined by the TT
    bond r and the conv bond CB."""

    def __init__(self, num_carriages: int, bond_dim: int, num_patches: int,
                 patch_pixels: int, output_shape=(), convolution_bond: int = -1,
                 constrict_bond: bool = True, perturb: bool = False,
                 dtype=torch.float32, seed: int = 0, device="cuda",
                 use_kernels: Optional[bool] = None):
        N, r = num_carriages, bond_dim
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        self.num_carriages, self.bond_dim = N, r
        self.num_patches, self.patch_pixels = num_patches, patch_pixels
        self.convolution_bond = convolution_bond
        b = TopologyBuilder()

        out_labels = ["s"]
        train_order = []
        for i in range(1, N + 1):
            if i - 1 < len(output_shape):
                up, up_label = output_shape[i - 1], f"c{i}"
                out_labels.append(up_label)
            else:
                up, up_label = 1, "c"
            left = 1 if i == 1 else r
            right = 1 if i == N else r
            init = None
            if perturb:
                # random first core, perturb the rest
                if i == 1:
                    rng = np.random.default_rng(seed)
                    init = rng.standard_normal((1, 1, num_patches, right))
                else:
                    init = perturb_block(left, num_patches, right, None)
            b.node(f"A{i}", (f"r{i}", up_label, "patches", f"r{i+1}"),
                   (left, up, num_patches, right), kind=PARAM,
                   left=(f"r{i}",), right=(f"r{i+1}",), init=init)
            if convolution_bond > 0:
                cb_l = 1 if i == 1 else convolution_bond
                cb_r = 1 if i == N else convolution_bond
                b.node(f"C{i}", (f"CB{i}", "patch_pixels", f"CB{i+1}"),
                       (cb_l, patch_pixels, cb_r), kind=PARAM,
                       left=(f"CB{i}",), right=(f"CB{i+1}",))
            else:
                b.node(f"C{i}", ("patch_pixels",), (patch_pixels,), kind=PARAM)
            b.node(f"X{i}", ("s", "patches", "patch_pixels"),
                   (None, num_patches, patch_pixels), kind=INPUT)
            b.connect(f"X{i}", "patches", f"A{i}")
            b.connect(f"C{i}", "patch_pixels", f"X{i}")
            if i > 1:
                b.connect(f"A{i-1}", f"r{i}", f"A{i}")
                if convolution_bond > 0:
                    b.connect(f"C{i-1}", f"CB{i}", f"C{i}")
            train_order.append(f"A{i}")
        # train order: cores then conv blocks
        train_order += [f"C{i}" for i in range(1, N + 1)]
        for i in range(1, N + 1):
            b.squeeze(f"A{i}", exclude=out_labels)
            b.squeeze(f"C{i}")
        topo = b.finalize([f"X{i}" for i in range(1, N + 1)],
                          [f"A{i}" for i in range(1, N + 1)],
                          train_nodes=train_order,
                          output_labels=tuple(out_labels))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


class SumLayer:
    """Type-I sum: an ensemble of networks whose outputs add; each member
    sees the global x through its input function (default: a slice down to
    its input nodes' trailing shapes)."""

    def __init__(self, layers: Sequence[TNLayer],
                 input_fns: Optional[Sequence[Callable]] = None):
        self.layers = list(layers)
        if input_fns is None:
            input_fns = [_slice_adapter(l.network) for l in self.layers]
        self.input_fns = list(input_fns)

    def __call__(self, x, params_list=None):
        params_list = params_list or [l.params for l in self.layers]
        out = None
        for layer, fn, p in zip(self.layers, self.input_fns, params_list):
            y = layer(fn(x), params=p)
            out = y if out is None else out + y
        return out

    def forward_batch(self, x, batch_size: int):
        S = x.shape[0] if hasattr(x, "shape") else next(iter(x.values())).shape[0]
        if batch_size <= 0 or batch_size >= S:
            return self(x)
        outs = [self(x[b:b + batch_size]) for b in range(0, S, batch_size)]
        return torch.cat(outs, dim=0)

    @property
    def params_list(self):
        return [l.params for l in self.layers]

    def set_params_list(self, params_list):
        for l, p in zip(self.layers, params_list):
            l.params = dict(p)

    def num_parameters(self):
        return sum(l.num_parameters() for l in self.layers)

    def node_states(self):
        return [l.node_states() for l in self.layers]

    def load_node_states(self, states):
        for l, s in zip(self.layers, states):
            l.load_node_states(s)


def _slice_adapter(net: Network):
    """Slices the global x down to each input node's static trailing shape
    (x[..., :shape] member routing)."""
    t = net.topology

    def fn(x):
        inputs = {}
        bound = net.bind_inputs(x)
        for ni in t.input_nodes:
            spec = t.nodes[ni]
            arr = bound[spec.name]
            idx = (slice(None),) + tuple(slice(0, s) for s in spec.shape[1:])
            inputs[spec.name] = arr[idx]
        return inputs

    return fn
