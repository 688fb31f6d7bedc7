"""Model zoo: tensor-network layer builders (port of
tensornetworksfork_tpu/models/layers.py).

Each builder returns a `TNLayer` holding a `Network` (structure) and a params
dict (state). The topology is built by the same calls as in the JAX package,
so node names, axis ids and shapes agree one to one. Every builder takes
`device` (the card unless the caller asks for the CPU) and `use_kernels`
(see `Network`).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import Network
from ..core.topology import CONST, INPUT, PARAM, TopologyBuilder


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


class TensorTrainLinearLayer(TNLayer):
    """Tensor train over learned linear feature maps: core A_i reads
    L_i(lin, p) X_i(s, p), a map of the f features down to linear_dim.
    train_linear=False freezes the maps (they stay out of the train
    order)."""

    def __init__(self, num_carriages: int, bond_dim: int, input_features: int,
                 linear_dim: int, output_shape=(), constrict_bond: bool = True,
                 train_linear: bool = True, perturb: bool = False,
                 dtype=torch.float32, seed: int = 0, device="cuda",
                 use_kernels: Optional[bool] = None):
        N, r, f, ld = num_carriages, bond_dim, input_features, linear_dim
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        self.num_carriages, self.bond_dim = N, r
        self.input_features, self.linear_dim = f, ld
        b = TopologyBuilder()
        rng = np.random.default_rng(seed)
        if perturb:
            inits = perturb_profile(N, 1 if N == 1 else r, ld, constrict_bond, rng)
            profile = [(a.shape[0], a.shape[-1]) for a in inits]
        else:
            profile = tt_rank_profile(N, 1 if N == 1 else r, ld, constrict_bond)
            inits = [None] * N

        out_labels = ["s"]
        train_order = []
        for i in range(1, N + 1):
            left, right = profile[i - 1]
            if i - 1 < len(output_shape):
                up, up_label = output_shape[i - 1], f"c{i}"
                out_labels.append(up_label)
            else:
                up, up_label = 1, "c"
            b.node(f"A{i}", (f"r{i}", up_label, f"lin{i}", f"r{i+1}"),
                   (left, up, ld, right), kind=PARAM,
                   left=(f"r{i}",), right=(f"r{i+1}",), init=inits[i - 1])
            b.node(f"L{i}", (f"lin{i}", f"p{i}"), (ld, f), kind=PARAM)
            b.node(f"X{i}", ("s", f"p{i}"), (None, f), kind=INPUT)
            b.connect(f"A{i}", f"lin{i}", f"L{i}")
            b.connect(f"L{i}", f"p{i}", f"X{i}")
            if i > 1:
                b.connect(f"A{i-1}", f"r{i}", f"A{i}")
            train_order += [f"A{i}", f"L{i}"] if train_linear else [f"A{i}"]
        for i in range(1, N + 1):
            b.squeeze(f"A{i}", exclude=out_labels)
        topo = b.finalize([f"X{i}" for i in range(1, N + 1)],
                          [f"A{i}" for i in range(1, N + 1)],
                          train_nodes=train_order,
                          output_labels=tuple(out_labels))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


def cum_sum_operator(n: int, num_carriages: int, f: int) -> np.ndarray:
    """Core n of the cumulative-sum MPO: op[i,k,l,m] = H[i,k] δ(k=l)
    δ(m = k, or 0 on the last core), H upper-triangular ones; built directly
    in O(f²) entries."""
    left_dim = 1 if n == 0 else f
    right_dim = 1 if n == num_carriages - 1 else f
    H = np.triu(np.ones((left_dim, f)))
    op = np.zeros((left_dim, f, f, right_dim))
    last = n == num_carriages - 1
    for k in range(f):
        op[:, k, k, 0 if last else k] = H[:, k]
    return op


class CumSumLayer(TNLayer):
    """Tensor train acting on cumulative feature sums: a second chain of
    CONST operator nodes O_i (`cum_sum_operator`) sits between the inputs
    and the cores."""

    def __init__(self, num_carriages: int, bond_dim: int, input_features: int,
                 output_shape=(), constrict_bond: bool = True,
                 perturb: bool = False, dtype=torch.float32, seed: int = 0,
                 device="cuda", use_kernels: Optional[bool] = None):
        N, r, f = num_carriages, bond_dim, input_features
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        self.num_carriages, self.input_features = N, f
        b = TopologyBuilder()
        rng = np.random.default_rng(seed)
        if perturb:
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
            if i > 1:
                b.connect(f"A{i-1}", f"r{i}", f"A{i}")
        if N > 1:
            for i in range(1, N + 1):
                op = cum_sum_operator(i - 1, N, f)
                b.node(f"O{i}", (f"b{i}", f"p{i}", f"d{i}", f"b{i+1}"),
                       op.shape, kind=CONST,
                       left=(f"b{i}",), right=(f"b{i+1}",), init=op)
                b.node(f"X{i}", ("s", f"d{i}"), (None, f), kind=INPUT)
                b.connect(f"A{i}", f"p{i}", f"O{i}")
                b.connect(f"O{i}", f"d{i}", f"X{i}")
                if i > 1:
                    b.connect(f"O{i-1}", f"b{i}", f"O{i}")
            for i in range(1, N + 1):
                b.squeeze(f"O{i}")
        else:
            b.node("X1", ("s", "p1"), (None, f), kind=INPUT)
            b.connect("A1", "p1", "X1")
        for i in range(1, N + 1):
            b.squeeze(f"A{i}", exclude=out_labels)
        topo = b.finalize([f"X{i}" for i in range(1, N + 1)],
                          [f"A{i}" for i in range(1, N + 1)],
                          output_labels=tuple(out_labels))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


class CPDLayer(TNLayer):
    """CP decomposition: factors A_i(b, p) tied over one rank hyperedge b;
    the first factor carries the output leg."""

    def __init__(self, num_factors: int, rank: int, input_features: int,
                 output_shape=(), perturb: bool = False, dtype=torch.float32,
                 seed: int = 0, device="cuda", use_kernels: Optional[bool] = None):
        Nf, R, f = num_factors, rank, input_features
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        self.num_factors, self.rank, self.input_features = Nf, R, f
        out_dim = output_shape[0] if output_shape else 1
        b = TopologyBuilder()
        for i in range(1, Nf + 1):
            if i == 1:
                if Nf == 1:
                    b.node("A1", ("p", "o"), (f, out_dim), kind=PARAM)
                else:
                    b.node("A1", ("b", "p", "o"), (R, f, out_dim), kind=PARAM)
            else:
                init = None
                if perturb:
                    rng = np.random.default_rng(seed + i)
                    core = np.zeros((R, f))
                    core[:, -1] = 1.0
                    if i == Nf:
                        core[:, -1] += 0.02 * rng.standard_normal(R)
                    init = core
                b.node(f"A{i}", ("b", "p"), (R, f), kind=PARAM, init=init)
            b.node(f"X{i}", ("s", f"p{i}"), (None, f), kind=INPUT)
            b.connect(f"A{i}", "p", f"X{i}", f"p{i}")
        if Nf > 1:
            b.tie([(f"A{i}", "b") for i in range(1, Nf + 1)])
        topo = b.finalize([f"X{i}" for i in range(1, Nf + 1)],
                          [f"A{i}" for i in range(1, Nf + 1)],
                          output_labels=("s", "o"))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


class CPDTrainLayer(TNLayer):
    """CPD written as a tensor train of diagonal cores: the middle cores
    start diagonal in their bonds and `cpd_mask` keeps every update so."""

    def __init__(self, num_carriages: int, bond_dim: int, input_features: int,
                 output_shape=(), dtype=torch.float32, seed: int = 0,
                 device="cuda", use_kernels: Optional[bool] = None):
        N, r, f = num_carriages, bond_dim, input_features
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        b = TopologyBuilder()
        rng = np.random.default_rng(seed)
        out_labels = ["s"]
        for i in range(1, N + 1):
            if i - 1 < len(output_shape):
                up, up_label = output_shape[i - 1], f"c{i}"
                out_labels.append(up_label)
            else:
                up, up_label = 1, "c"
            left = 1 if i == 1 else r
            right = 1 if i == N else r
            init = None
            if left > 1 and right > 1:
                core = np.zeros((left, up, f, right))
                for u in range(up):
                    for k in range(f):
                        core[:, u, k, :] = np.diag(rng.standard_normal(right))
                init = core
            b.node(f"A{i}", (f"r{i}", up_label, f"p{i}", f"r{i+1}"),
                   (left, up, f, right), kind=PARAM,
                   left=(f"r{i}",), right=(f"r{i+1}",), init=init, cpd_mask=True)
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


class OperatorTTLayer(TNLayer):
    """Operator sandwich: input -> MPO operator row O_i -> TT spine A_i.
    `operator` is one (bl, u, d, br) core (first and last cores cut to
    their boundary bonds unless `left` / `right` are given), or a list of
    cores. ring=True closes both chains into rings: each keeps one open
    bond through the whole environment chain. train_operator makes the
    operator cores trainable."""

    def __init__(self, operator, input_features: int, bond_dim: int,
                 num_carriages: int, output_shape=1, ring: bool = False,
                 left=None, right=None, constrict_bond: bool = True,
                 train_operator: bool = False, dtype=torch.float32,
                 seed: int = 0, device="cuda", use_kernels: Optional[bool] = None):
        N, f, r = num_carriages, input_features, bond_dim
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        b = TopologyBuilder()
        ops = []
        for i in range(N):
            if isinstance(operator, (list, tuple)):
                O = np.asarray(operator[i])
            elif ring:
                O = np.asarray(operator)
            elif i == 0 and left is not None:
                O = np.asarray(left)
            elif i == N - 1 and right is not None:
                O = np.asarray(right)
            elif i == 0:
                O = np.asarray(operator)[:1]
            elif i == N - 1:
                O = np.asarray(operator)[..., -1:]
            else:
                O = np.asarray(operator)
            ops.append(O)

        profile = tt_rank_profile(N, 1 if N == 1 else r, f, constrict_bond)
        out_labels = ["s"]
        for i in range(1, N + 1):
            O = ops[i - 1]
            bl = "br" if ring and i == 1 else f"b{i}"
            br = "br" if ring and i == N else f"b{i+1}"
            b.node(f"O{i}", (bl, f"u{i}", f"d{i}", br), O.shape,
                   kind=PARAM if train_operator else CONST,
                   left=(bl,), right=(br,), init=O)
            b.node(f"X{i}", ("s", f"d{i}"), (None, f), kind=INPUT)
            b.connect(f"O{i}", f"d{i}", f"X{i}")
            if i > 1:
                b.connect(f"O{i-1}", f"b{i}", f"O{i}")
            lab_l = "rr" if ring and i == 1 else f"r{i}"
            lab_r = "rr" if ring and i == N else f"r{i+1}"
            if i - 1 < len(output_shape):
                up, up_label = output_shape[i - 1], f"c{i}"
                out_labels.append(up_label)
            else:
                up, up_label = 1, "c"
            lft, rgt = profile[i - 1]
            if ring:
                lft = rgt = r
            b.node(f"A{i}", (lab_l, up_label, f"u{i}", lab_r),
                   (lft, up, O.shape[1], rgt),
                   kind=PARAM, left=(lab_l,), right=(lab_r,))
            b.connect(f"A{i}", f"u{i}", f"O{i}")
            if i > 1:
                b.connect(f"A{i-1}", lab_l, f"A{i}")
        if ring and N > 1:
            b.connect(f"A{N}", "rr", "A1")
            b.connect(f"O{N}", "br", "O1")
        for i in range(1, N + 1):
            b.squeeze(f"A{i}", exclude=out_labels)
            b.squeeze(f"O{i}")
        topo = b.finalize([f"X{i}" for i in range(1, N + 1)],
                          [f"A{i}" for i in range(1, N + 1)],
                          output_labels=tuple(out_labels))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


class ComplexTensorTrainLayer(TensorTrainLayer):
    """Complex tensor train: complex64 by default; complex128 runs natively
    on the card as on the CPU. Complex networks take the plain routes of
    the Gram stage (the kernels are real)."""

    def __init__(self, num_carriages, bond_dim, input_features, output_shape=(),
                 constrict_bond=True, dtype=torch.complex64, seed=0,
                 device="cuda", use_kernels: Optional[bool] = None):
        if not dtype.is_complex:
            raise ValueError(f"dtype must be complex, got {dtype}")
        super().__init__(num_carriages, bond_dim, input_features,
                         output_shape=output_shape, constrict_bond=constrict_bond,
                         perturb=False, dtype=dtype, seed=seed, device=device,
                         use_kernels=use_kernels)


class TensorTrainSplitInputLayer(TNLayer):
    """Each of num_wagons input tensors (s, *input_shape) feeds
    len(input_shape) consecutive cores, one axis each; bonds inside a wagon
    are bond_dim, between wagons axle_bond. The inputs are a list, one
    tensor a wagon."""

    def __init__(self, num_wagons: int, bond_dim: int, input_shape=(),
                 output_shape=(), axle_bond: int = 1, dtype=torch.float32,
                 seed: int = 0, device="cuda", use_kernels: Optional[bool] = None):
        d = len(input_shape)
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        b = TopologyBuilder()
        out_labels = ["s"]
        names = []
        for i in range(num_wagons):
            b.node(f"X{i}", ("s",) + tuple(f"I{i*d+j}" for j in range(d)),
                   (None,) + tuple(input_shape), kind=INPUT)
            for j in range(d):
                idx = i * d + j
                if idx < len(output_shape):
                    up, up_label = output_shape[idx], f"c{idx}"
                    out_labels.append(up_label)
                else:
                    up, up_label = 1, "c"
                first = (i == 0 and j == 0)
                last = (i == num_wagons - 1 and j == d - 1)
                lft = 1 if first else (axle_bond if j == 0 else bond_dim)
                rgt = 1 if last else (axle_bond if j == d - 1 else bond_dim)
                name = f"A{idx}"
                b.node(name, (f"r{idx}", up_label, f"I{idx}", f"r{idx+1}"),
                       (lft, up, input_shape[j], rgt), kind=PARAM,
                       left=(f"r{idx}",), right=(f"r{idx+1}",))
                b.connect(name, f"I{idx}", f"X{i}")
                if names:
                    b.connect(names[-1], f"r{idx}", name)
                names.append(name)
        for name in names:
            b.squeeze(name, exclude=out_labels)
        topo = b.finalize([f"X{i}" for i in range(num_wagons)], names,
                          output_labels=tuple(out_labels))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


class TensorConvolutionGridTrainLayer(TNLayer):
    """A grid of num_layers x num_carriages cores over conv-patched inputs:
    horizontal bonds bond_dim on the top layer and lin_bond below, vertical
    bonds lin_dim; only the top layer carries outputs, the bottom one reads
    the patches. A column holds several trainable nodes; the train order is
    column-major, bottom to top, conv block first."""

    def __init__(self, num_carriages: int, num_layers: int, bond_dim: int,
                 lin_dim: int, lin_bond: int, num_patches: int,
                 patch_pixels: int, output_shape=(), convolution_bond: int = -1,
                 dtype=torch.float32, seed: int = 0, device="cuda",
                 use_kernels: Optional[bool] = None):
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        NC, NL = num_carriages, num_layers
        b = TopologyBuilder()
        out_labels = ["s"]
        for i in range(1, NC + 1):
            b.node(f"X{i}", ("s", "patches", "patch_pixels"),
                   (None, num_patches, patch_pixels), kind=INPUT)
            if convolution_bond > 0:
                cb_l = 1 if i == 1 else convolution_bond
                cb_r = 1 if i == NC else convolution_bond
                b.node(f"C{i}", (f"CB{i}", "patch_pixels", f"CB{i+1}"),
                       (cb_l, patch_pixels, cb_r), kind=PARAM,
                       left=(f"CB{i}",), right=(f"CB{i+1}",))
            else:
                b.node(f"C{i}", ("patch_pixels",), (patch_pixels,), kind=PARAM)
            b.connect(f"C{i}", "patch_pixels", f"X{i}")
            if convolution_bond > 0 and i > 1:
                b.connect(f"C{i-1}", f"CB{i}", f"C{i}")

        all_nodes = []
        for l in range(NL):
            top = (l == NL - 1)
            hb = bond_dim if top else lin_bond
            for i in range(1, NC + 1):
                if top and i - 1 < len(output_shape):
                    cdim, clab = output_shape[i - 1], f"c{i}"
                    out_labels.append(clab)
                else:
                    cdim, clab = 1, "c"
                lft = 1 if i == 1 else max(hb, 1)
                rgt = 1 if i == NC else max(hb, 1)
                labels = [f"v{l}_{i}", f"r{l}_{i}", clab, f"r{l}_{i+1}",
                          f"v{l+1}_{i}"]
                vb_down = 1 if l == 0 else lin_dim
                vb_up = lin_dim if l < NL - 1 else 1
                if l == 0:
                    labels.insert(3, "patches")
                    shape = (vb_down, lft, cdim, num_patches, rgt, vb_up)
                else:
                    shape = (vb_down, lft, cdim, rgt, vb_up)
                name = f"A{l}_{i}"
                b.node(name, tuple(labels), shape, kind=PARAM,
                       left=(f"r{l}_{i}",), right=(f"r{l}_{i+1}",))
                all_nodes.append(name)
                if l == 0:
                    b.connect(name, "patches", f"X{i}")
                else:
                    b.connect(f"A{l-1}_{i}", f"v{l}_{i}", name)
                if i > 1 and (hb > 0 or top):
                    b.connect(f"A{l}_{i-1}", f"r{l}_{i}", name)
        for name in all_nodes:
            b.squeeze(name, exclude=out_labels)
        for i in range(1, NC + 1):
            b.squeeze(f"C{i}")
        main = [f"A{NL-1}_{i}" for i in range(1, NC + 1)]
        train = []
        for i in range(1, NC + 1):
            train.append(f"C{i}")
            for l in range(NL):
                train.append(f"A{l}_{i}")
        topo = b.finalize([f"X{i}" for i in range(1, NC + 1)], main,
                          train_nodes=train, output_labels=tuple(out_labels))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


class TensorConvOperatorLayer(TNLayer):
    """Conv block x fixed operator feature map x TT over patches: per patch
    out = sum_q X[s,p,q] C[a,q,b] O[q,u], the input's pixel axis, the conv
    block's and the operator's input leg being one three-way hyperedge.
    Requires patch_pixels == operator.shape[0]."""

    def __init__(self, operator, input_features: int, bond_dim: int,
                 num_carriages: int, num_patches: int, patch_pixels: int,
                 output_shape=(), convolution_bond: int = -1,
                 dtype=torch.float32, seed: int = 0, device="cuda",
                 use_kernels: Optional[bool] = None):
        N = num_carriages
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        op0 = np.asarray(operator[0] if isinstance(operator, (list, tuple))
                         else operator)
        if patch_pixels != op0.shape[0]:
            raise ValueError("patch_pixels must equal the operator input dim")
        b = TopologyBuilder()
        out_labels = ["s"]
        for i in range(N):
            if convolution_bond > 0:
                cl = 1 if i == 0 else convolution_bond
                cr = 1 if i == N - 1 else convolution_bond
                b.node(f"C{i}", (f"CB{i+1}", f"q{i}", f"CB{i+2}"),
                       (cl, patch_pixels, cr), kind=PARAM,
                       left=(f"CB{i+1}",), right=(f"CB{i+2}",))
                if i > 0:
                    b.connect(f"C{i-1}", f"CB{i+1}", f"C{i}")
            else:
                b.node(f"C{i}", (f"q{i}",), (patch_pixels,), kind=PARAM)
            b.node(f"X{i}", ("s", "patches", f"q{i}"),
                   (None, num_patches, patch_pixels), kind=INPUT)
            O = np.asarray(operator[i] if isinstance(operator, (list, tuple))
                           else operator)
            b.node(f"O{i}", (f"q{i}", f"u{i}"), O.shape, kind=CONST, init=O)
            out_dim = output_shape[i] if i < len(output_shape) else 1
            b.node(f"A{i}", (f"r{i+1}", f"c{i+1}", "patches", f"u{i}", f"r{i+2}"),
                   (1 if i == 0 else bond_dim, out_dim, num_patches,
                    O.shape[1], 1 if i == N - 1 else bond_dim), kind=PARAM,
                   left=(f"r{i+1}",), right=(f"r{i+2}",))
            out_labels.append(f"c{i+1}")
            # hyperedge: input pixels x conv pixels x operator input leg
            b.tie([(f"X{i}", f"q{i}"), (f"C{i}", f"q{i}"), (f"O{i}", f"q{i}")])
            b.connect(f"O{i}", f"u{i}", f"A{i}")
            b.connect(f"X{i}", "patches", f"A{i}")
            if i > 0:
                b.connect(f"A{i-1}", f"r{i+1}", f"A{i}")
        for i in range(N):
            b.squeeze(f"A{i}", exclude=out_labels)
            b.squeeze(f"C{i}")
        # size-1 output labels are kept
        topo = b.finalize([f"X{i}" for i in range(N)],
                          [f"A{i}" for i in range(N)],
                          output_labels=tuple(out_labels))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


class CompressedTensorTrainLayer(TNLayer):
    """Tensor train over TT-compressed design-matrix blocks (ops/
    compression.py): the data blocks (k_i, p_i, d, k_{i+1}) are CONST nodes
    X_i, each core A_i reads X_i's physical axis, and the last block's right
    bond IS the sample axis. The network has no input node: its data are
    baked in (the sweep takes its input-less branch; pass `{}` as x)."""

    def __init__(self, data_blocks, bond_dim: int, output_shape=(),
                 constrict_bond: bool = True, perturb: bool = False,
                 dtype=torch.float32, seed: int = 0, device="cuda",
                 use_kernels: Optional[bool] = None):
        N = len(data_blocks)
        output_shape = output_shape if isinstance(output_shape, tuple) else (output_shape,)
        blocks = [blk.detach().cpu().numpy() if torch.is_tensor(blk) else np.asarray(blk)
                  for blk in data_blocks]
        phys = [int(blk.shape[1]) for blk in blocks]
        self.num_carriages = N
        b = TopologyBuilder()
        rng = np.random.default_rng(seed)
        if perturb:
            inits = []
            prev = 1
            for i in range(N):
                cap = min(bond_dim, prev * phys[i]) if constrict_bond else bond_dim
                rr = 1 if i == N - 1 else cap
                inits.append(perturb_block(prev, phys[i], rr, rng,
                                           0.02 if i in (0, N - 1) else 0.0))
                prev = rr
            profile = [(a.shape[0], a.shape[-1]) for a in inits]
        else:
            profile = tt_rank_profile(N, 1 if N == 1 else bond_dim, phys,
                                      constrict_bond)
            inits = [None] * N

        out_labels = ["s"]
        for i in range(1, N + 1):
            blk = blocks[i - 1]
            last = i == N
            labels = (f"k{i}", f"p{i}", "d", f"k{i+1}" if not last else "s")
            b.node(f"X{i}", labels, blk.shape, kind=CONST, init=blk,
                   left=(f"k{i}",), right=(f"k{i+1}",) if not last else ())
            if i > 1:
                b.connect(f"X{i-1}", f"k{i}", f"X{i}")
            lft, rgt = profile[i - 1]
            if i - 1 < len(output_shape):
                up, up_label = output_shape[i - 1], f"c{i}"
                out_labels.append(up_label)
            else:
                up, up_label = 1, "c"
            b.node(f"A{i}", (f"r{i}", up_label, f"p{i}", f"r{i+1}"),
                   (lft, up, phys[i - 1], rgt), kind=PARAM,
                   left=(f"r{i}",), right=(f"r{i+1}",), init=inits[i - 1])
            b.connect(f"A{i}", f"p{i}", f"X{i}")
            if i > 1:
                b.connect(f"A{i-1}", f"r{i}", f"A{i}")
        for i in range(1, N + 1):
            b.squeeze(f"A{i}", exclude=out_labels)
            b.squeeze(f"X{i}", exclude=("s",))
        topo = b.finalize([], [f"A{i}" for i in range(1, N + 1)],
                          output_labels=tuple(out_labels))
        super().__init__(Network(topo, device=device, use_kernels=use_kernels),
                         topo.init_params(seed, dtype, device))


def concatenate_trains(tensor_layers) -> TensorTrainLayer:
    """Direct sum of several TensorTrainLayers of the same length and
    features (block-diagonal bonds, ops/compression.py `train_concat`),
    scaled by 1/len so the result computes their mean. Built on the first
    layer's device."""
    from ..ops.compression import train_concat

    def blocks_of(layer):
        N = layer.num_carriages
        blocks = []
        for i in range(1, N + 1):
            arr = layer.params[f"A{i}"].detach().cpu().numpy()
            # normalise to (rl, c, p, rr)
            if i == 1:
                arr = arr[None] if arr.ndim < 4 else arr
            if arr.ndim == 2:  # (r, p) last core squeezed
                arr = arr[:, None, :, None]
            elif arr.ndim == 3:
                if i == 1:        # (c, p, r)
                    arr = arr[None]
                elif i == N:      # (r, p) + c? -> (r, c?, p)
                    arr = arr[:, None, :, None] if arr.shape[-1] != 1 else arr[..., None]
                else:             # (r, p, r')
                    arr = arr[:, None]
            blocks.append(torch.as_tensor(arr.reshape(arr.shape[0], -1, 1,
                                                      arr.shape[-1])))
        return blocks

    train = blocks_of(tensor_layers[0])
    for layer in tensor_layers[1:]:
        train = train_concat(train, blocks_of(layer))
    train[0] = train[0] / len(tensor_layers)

    first = tensor_layers[0]
    f = first.input_features
    out_shape = first.output_shape
    out_dim = out_shape[0] if out_shape else 1
    net = first.network
    new = TensorTrainLayer(len(train), max(b.shape[0] for b in train), f,
                           output_shape=out_shape, constrict_bond=False,
                           seed=0, device=net.device, use_kernels=net.use_kernels)
    params = {}
    for i, blk in enumerate(train, 1):  # (rl, c*p, 1, rr)
        arr = blk.reshape(blk.shape[0], out_dim if i == 1 else 1, f, blk.shape[-1])
        tgt = new.params[f"A{i}"]
        params[f"A{i}"] = arr.reshape(tgt.shape).to(dtype=tgt.dtype, device=tgt.device)
    new.params = params
    return new
