"""Static tensor-network topology IR (port of tensornetworksfork_tpu/core/topology.py).

The graph is an immutable `Topology`:

- every node axis gets a *global axis id* via union-find over explicit
  `connect`/`tie` declarations (two axes with the same id are one edge;
  3+ carriers form a hyperedge, used by CPD's shared rank axis),
- the sample axis of every input node is tied into one global id,
- columns (the vertical slices the sweep walks over) are discovered once by
  BFS over non-horizontal edges.

This part is pure Python and matches the JAX package line for line, so the
two packages assign the same axis ids, columns and shapes to a model.
Parameters live in a plain dict `{node_name: torch.Tensor}`; `init_params`
draws them from a `torch.Generator` (the draws differ from `jax.random`'s —
parity tests copy the JAX params across with `utils.convert`).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PARAM = "param"
INPUT = "input"
CONST = "const"


@dataclasses.dataclass
class NodeSpec:
    """One tensor in the network. `labels` are node-local axis names; the
    builder resolves them to global ids. `left`/`right` mark horizontal (bond)
    axes."""

    name: str
    labels: Tuple[str, ...]
    shape: Tuple[Optional[int], ...]  # None for the (dynamic) sample axis
    kind: str = PARAM
    left: Tuple[str, ...] = ()
    right: Tuple[str, ...] = ()
    # init: explicit array, or callable generator->array, or None (random
    # normal, unit Frobenius norm)
    init: object = None
    # CPD-style diagonal step mask
    cpd_mask: bool = False

    def axis_index(self, label: str) -> int:
        return self.labels.index(label)

    def is_horizontal(self, label: str) -> bool:
        return label in self.left or label in self.right


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


class TopologyBuilder:
    """Collects nodes and edges, then `finalize()`s into a Topology."""

    def __init__(self, sample_dim: str = "s"):
        self.sample_dim = sample_dim
        self.nodes: List[NodeSpec] = []
        self._by_name: Dict[str, int] = {}
        self._uf = _UnionFind()
        self._edges: List[Tuple[Tuple[int, int], Tuple[int, int]]] = []

    def add(self, spec: NodeSpec) -> NodeSpec:
        if spec.name in self._by_name:
            raise ValueError(f"duplicate node name {spec.name!r}")
        if len(spec.labels) != len(spec.shape):
            raise ValueError(f"{spec.name}: labels/shape length mismatch")
        self._by_name[spec.name] = len(self.nodes)
        self.nodes.append(spec)
        return spec

    def node(self, name, labels, shape, **kw) -> NodeSpec:
        return self.add(NodeSpec(name, tuple(labels), tuple(shape), **kw))

    def _slot(self, name: str, label: str) -> Tuple[int, int]:
        idx = self._by_name[name]
        return (idx, self.nodes[idx].axis_index(label))

    def connect(self, a: str, label: str, b: str, label_b: Optional[str] = None):
        """Declare an edge: axis `label` of node `a` is the same axis as
        `label_b` (default: same label) of node `b`."""
        sa = self._slot(a, label)
        sb = self._slot(b, label_b if label_b is not None else label)
        self._uf.union(sa, sb)
        self._edges.append((sa, sb))

    def tie(self, slots: Sequence[Tuple[str, str]]):
        """Unify 3+ axes into one hyperedge, e.g. the CPD shared rank axis."""
        first = self._slot(*slots[0])
        for name, label in slots[1:]:
            s = self._slot(name, label)
            self._uf.union(first, s)
            self._edges.append((first, s))

    def squeeze(self, name: str, exclude: Sequence[str] = ()):
        """Drop size-1 axes that carry no edge. Rewrites the spec in place,
        remapping the edge axis positions."""
        idx = self._by_name[name]
        spec = self.nodes[idx]
        connected = {s[1] for e in self._edges for s in e if s[0] == idx}
        keep = [
            i
            for i, (lab, sz) in enumerate(zip(spec.labels, spec.shape))
            if not (
                sz == 1
                and lab not in exclude
                and lab != self.sample_dim
                and i not in connected
            )
        ]
        if len(keep) == len(spec.labels):
            return
        if any(s[0] == idx for e in self._edges for s in e):
            # remap edge axis indices
            remap = {old: new for new, old in enumerate(keep)}
            new_edges = []
            for sa, sb in self._edges:
                if sa[0] == idx:
                    sa = (idx, remap[sa[1]])
                if sb[0] == idx:
                    sb = (idx, remap[sb[1]])
                new_edges.append((sa, sb))
            self._edges = new_edges
            # union-find keys also carry stale axis indices; rebuild
            uf = _UnionFind()
            for sa, sb in self._edges:
                uf.union(sa, sb)
            self._uf = uf
        spec.labels = tuple(spec.labels[i] for i in keep)
        spec.shape = tuple(spec.shape[i] for i in keep)
        if isinstance(spec.init, (np.ndarray, torch.Tensor)):
            drop = tuple(i for i in range(spec.init.ndim) if i not in keep)
            if drop:
                spec.init = spec.init.reshape(
                    [spec.init.shape[i] for i in keep])
        spec.left = tuple(l for l in spec.left if l in spec.labels)
        spec.right = tuple(l for l in spec.right if l in spec.labels)

    def finalize(
        self,
        input_nodes: Sequence[str],
        main_nodes: Sequence[str],
        train_nodes: Optional[Sequence[str]] = None,
        output_labels: Tuple[str, ...] = ("s",),
    ) -> "Topology":
        # tie every sample axis into one global axis
        sample_slots = [
            (spec.name, self.sample_dim)
            for spec in self.nodes
            if self.sample_dim in spec.labels
        ]
        if len(sample_slots) > 1:
            self.tie(sample_slots)
        # tie output labels shared across nodes (normally a single carrier)
        for ol in output_labels:
            if ol == self.sample_dim:
                continue
            carriers = [(s.name, ol) for s in self.nodes if ol in s.labels]
            if len(carriers) > 1:
                self.tie(carriers)
        return Topology(self, input_nodes, main_nodes, train_nodes, output_labels)


class Topology:
    """Immutable, finalized network structure. See module docstring."""

    def __init__(self, b: TopologyBuilder, input_nodes, main_nodes, train_nodes, output_labels):
        self.sample_dim = b.sample_dim
        self.nodes: Tuple[NodeSpec, ...] = tuple(b.nodes)
        self.by_name = dict(b._by_name)
        self.input_nodes = tuple(self.by_name[n] for n in input_nodes)
        self.main_nodes = tuple(self.by_name[n] for n in main_nodes)
        self.train_nodes = tuple(
            self.by_name[n]
            for n in (train_nodes if train_nodes is not None else main_nodes)
        )
        self.output_labels = tuple(output_labels)

        # --- global axis ids -------------------------------------------------
        uf = b._uf
        self.node_axes: List[Tuple[int, ...]] = []
        root_to_id: Dict[Tuple[int, int], int] = {}
        self.axis_size: Dict[int, Optional[int]] = {}
        for ni, spec in enumerate(self.nodes):
            axes = []
            for ai, (lab, sz) in enumerate(zip(spec.labels, spec.shape)):
                root = uf.find((ni, ai))
                if root not in root_to_id:
                    root_to_id[root] = len(root_to_id)
                aid = root_to_id[root]
                axes.append(aid)
                prev = self.axis_size.get(aid)
                if lab == self.sample_dim:
                    sz = None
                if prev is None:
                    self.axis_size[aid] = sz
                elif sz is not None and prev != sz:
                    raise ValueError(
                        f"axis size mismatch on {spec.name}.{lab}: {sz} vs {prev}"
                    )
            self.node_axes.append(tuple(axes))
        self.node_axes = tuple(self.node_axes)

        # sample axis id
        self.sample_axis = None
        for ni, spec in enumerate(self.nodes):
            if self.sample_dim in spec.labels:
                self.sample_axis = self.node_axes[ni][spec.axis_index(self.sample_dim)]
                break

        # output axes (ordered, excluding the sample label)
        out_axes = []
        for ol in self.output_labels:
            if ol == self.sample_dim:
                continue
            aid = None
            for ni, spec in enumerate(self.nodes):
                if ol in spec.labels:
                    aid = self.node_axes[ni][spec.axis_index(ol)]
                    break
            if aid is None:
                raise ValueError(f"output label {ol!r} not found on any node")
            out_axes.append(aid)
        self.output_axes: Tuple[int, ...] = tuple(out_axes)

        # horizontal (bond) axes: axis marked l/r on any carrier node
        self.horizontal_axes = set()
        for ni, spec in enumerate(self.nodes):
            for ai, lab in enumerate(spec.labels):
                if spec.is_horizontal(lab):
                    self.horizontal_axes.add(self.node_axes[ni][ai])

        # axis -> carrier nodes
        self.axis_nodes: Dict[int, List[int]] = {}
        for ni, axes in enumerate(self.node_axes):
            for a in axes:
                self.axis_nodes.setdefault(a, []).append(ni)

        # --- columns: BFS from main nodes over non-horizontal edges ---------
        col_of: Dict[int, int] = {m: ci for ci, m in enumerate(self.main_nodes)}
        q = deque(self.main_nodes)
        while q:
            ni = q.popleft()
            spec = self.nodes[ni]
            for ai, a in enumerate(self.node_axes[ni]):
                if a == self.sample_axis or spec.is_horizontal(spec.labels[ai]):
                    continue
                for nj in self.axis_nodes[a]:
                    if nj not in col_of:
                        col_of[nj] = col_of[ni]
                        q.append(nj)
        unreached = [s.name for i, s in enumerate(self.nodes) if i not in col_of]
        if unreached:
            raise ValueError(f"nodes unreachable from main nodes: {unreached}")
        self.col_of: Dict[int, int] = col_of
        ncols = len(self.main_nodes)
        self.columns: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(ni for ni in range(len(self.nodes)) if col_of[ni] == ci)
            for ci in range(ncols)
        )

    # --- param/const initialisation ----------------------------------------
    def init_params(self, seed: int = 0, dtype=torch.float32,
                    device="cpu") -> Dict[str, torch.Tensor]:
        """Random params: normal / unit Frobenius norm unless an explicit init
        array/callable was given. Drawn on the CPU from a `torch.Generator`
        seeded with `seed`, then moved to `device`, so a seed gives the same
        params on every device."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        params = {}
        for spec in self.nodes:
            if spec.kind != PARAM:
                continue
            params[spec.name] = _materialize(spec, gen, dtype).to(device)
        return params

    def consts(self, dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
        out = {}
        for spec in self.nodes:
            if spec.kind != CONST:
                continue
            if spec.init is None:
                raise ValueError(f"const node {spec.name} needs an explicit init")
            out[spec.name] = _materialize(spec, None, dtype).to(device)
        return out

    def num_parameters(self, params: Dict[str, torch.Tensor]) -> int:
        return sum(
            int(np.prod(params[s.name].shape))
            for s in self.nodes
            if s.kind == PARAM and s.name in params
        )

    def node_axis_tuple(self, ni: int) -> Tuple[int, ...]:
        return self.node_axes[ni]

    def without_nodes(self, names: Sequence[str]) -> "Topology":
        """Copy of the network minus the given nodes (to inspect
        operator-only subnetworks). Edges to removed nodes are dropped."""
        drop = set(names)
        b = TopologyBuilder(self.sample_dim)
        for spec in self.nodes:
            if spec.name in drop:
                continue
            b.add(NodeSpec(spec.name, spec.labels, spec.shape, spec.kind,
                           spec.left, spec.right, spec.init, spec.cpd_mask))
        # re-declare the surviving edges through the shared global axes
        kept = {s.name for s in b.nodes}
        seen = {}
        for ni, axes in enumerate(self.node_axes):
            name = self.nodes[ni].name
            if name in drop:
                continue
            for ai, a in enumerate(axes):
                if a == self.sample_axis:
                    continue
                lab = self.nodes[ni].labels[ai]
                if a in seen:
                    other_name, other_lab = seen[a]
                    b.connect(other_name, other_lab, name, lab)
                else:
                    seen[a] = (name, lab)

        def names_of(idx):
            return [self.nodes[ni].name for ni in idx
                    if self.nodes[ni].name in kept]

        out_labels = tuple(
            ol for ol in self.output_labels
            if ol == self.sample_dim or any(ol in s.labels for s in b.nodes))
        return b.finalize(names_of(self.input_nodes), names_of(self.main_nodes),
                          names_of(self.train_nodes), out_labels)


def _materialize(spec: NodeSpec, gen: Optional[torch.Generator],
                 dtype) -> torch.Tensor:
    """A node's tensor: the callable's draw or the explicit init in `dtype`
    (a complex init passes through uncast), else a normal draw of unit
    Frobenius norm; for a complex dtype its real and imaginary parts are
    drawn separately, as in the JAX package."""
    if callable(spec.init):
        return torch.as_tensor(spec.init(gen), dtype=dtype)
    if spec.init is not None:
        arr = torch.as_tensor(np.asarray(spec.init))
        return arr if arr.is_complex() else arr.to(dtype)
    if dtype.is_complex:
        re = torch.randn(spec.shape, generator=gen, dtype=torch.float64)
        im = torch.randn(spec.shape, generator=gen, dtype=torch.float64)
        t = torch.complex(re, im).to(dtype)
    else:
        t = torch.randn(spec.shape, generator=gen, dtype=torch.float32).to(dtype)
    return t / torch.linalg.vector_norm(t)
