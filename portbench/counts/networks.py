"""The structure of the benchmark's two networks, written out for the counts.

Each network is a list of nodes in the port's build order, each with its
axes as global edge names; an edge name becomes an axis id at its first
appearance, as the port's topology numbers them. A column holds a
carriage's input and its parameter nodes. The keeps follow the port's
rules (`core/engine.py` `env_keep`, `jacobian_keep`): an environment keeps
its axes that reach outside it or are output axes, sorted by id, with the
sample axis last; a Jacobian keeps (sample, output axes, node axes), or
(node axes, sample) when it carries no output axis.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

SAMPLE = "s"


class Net:
    """nodes: (name, kind, ((edge, size), ...)) in build order, size-1
    axes already squeezed; `columns` lists the node indices of each
    column; `train` the train-node names in sweep order."""

    def __init__(self, nodes, columns, train, outputs):
        self.names = [n for n, _, _ in nodes]
        self.kinds = [k for _, k, _ in nodes]
        ids: Dict[str, int] = {}
        self.size: Dict[int, int] = {}
        self.node_axes: List[Tuple[int, ...]] = []
        for _, _, axes in nodes:
            row = []
            for edge, sz in axes:
                if edge not in ids:
                    ids[edge] = len(ids)
                row.append(ids[edge])
                self.size[ids[edge]] = sz
            self.node_axes.append(tuple(row))
        self.sample = ids[SAMPLE]
        self.outputs = tuple(ids[o] for o in outputs)
        self.columns = [tuple(c) for c in columns]
        self.col_of = {ni: ci for ci, col in enumerate(self.columns) for ni in col}
        self.train = [self.names.index(n) for n in train]

    def sizes(self, rows: int) -> Dict[int, int]:
        return {a: (rows if a == self.sample else sz) for a, sz in self.size.items()}

    def col_axes(self, ci: int) -> set:
        return set().union(*(set(self.node_axes[ni]) for ni in self.columns[ci]))

    def env_keep(self, cols: Sequence[int]) -> Tuple[int, ...]:
        cols = set(cols)
        group = set().union(*(self.col_axes(c) for c in cols)) if cols else set()
        outside = set().union(*(self.col_axes(c) for c in range(len(self.columns))
                                if c not in cols)) if len(cols) < len(self.columns) else set()
        want = group & (outside | set(self.outputs))
        want.discard(self.sample)
        ordered = tuple(sorted(want))
        return ordered + (self.sample,) if self.sample in group else ordered

    def jacobian_keep(self, ni: int, operand_axes) -> Tuple[int, ...]:
        present = set().union(*(set(ax) for ax in operand_axes))
        node = self.node_axes[ni]
        out_part = tuple(a for a in self.outputs if a in present and a not in node)
        node_part = tuple(dict.fromkeys(a for a in node if a in present))
        if not out_part:
            return node_part + (self.sample,)
        return (self.sample,) + out_part + node_part

    def jacobian_operands(self, ni: int) -> List[Tuple[int, ...]]:
        ci = self.col_of[ni]
        ncols = len(self.columns)
        ops = []
        if ci > 0:
            ops.append(self.env_keep(range(0, ci)))
        ops += [self.node_axes[nj] for nj in self.columns[ci] if nj != ni]
        if ci < ncols - 1:
            ops.append(self.env_keep(range(ci + 1, ncols)))
        return ops

    def D(self, ni: int) -> int:
        n = 1
        for a in self.node_axes[ni]:
            n *= self.size[a]
        return n

    def owns_output(self, ni: int) -> bool:
        return any(a in self.outputs for a in self.node_axes[ni])


def conv_tt(N: int, r: int, CB: int, P: int, pp: int, C: int) -> Net:
    """TensorConvolutionTrainLayer: carriage i holds a TT core A_i
    (r_i, c_i, patches, r_i+1), a conv block C_i (cb_i, pixels, cb_i+1) and
    its input X_i (s, patches, pixels); the C logits sit on A_1."""
    nodes, columns = [], []
    for i in range(1, N + 1):
        left, right = (1 if i == 1 else r), (1 if i == N else r)
        up, up_edge = (C, "c1") if i == 1 else (1, f"x{i}")
        cbl, cbr = (1 if i == 1 else CB), (1 if i == N else CB)
        a = tuple(x for x in ((f"r{i}", left), (up_edge, up), (f"p{i}", P), (f"r{i+1}", right))
                  if x[1] != 1 or x[0] == "c1")
        c = tuple(x for x in ((f"b{i}", cbl), (f"q{i}", pp), (f"b{i+1}", cbr)) if x[1] != 1)
        base = len(nodes)
        nodes += [(f"A{i}", "param", a), (f"C{i}", "param", c),
                  (f"X{i}", "input", ((SAMPLE, 0), (f"p{i}", P), (f"q{i}", pp)))]
        columns.append((base, base + 1, base + 2))
    train = [f"A{i}" for i in range(1, N + 1)] + [f"C{i}" for i in range(1, N + 1)]
    return Net(nodes, columns, train, ("c1",))


def tt(N: int, r: int, f: int, constrict: bool = False) -> Net:
    """TensorTrainLayer with one output, as TensorTrainRegressor builds it
    (bonds not constricted unless asked): carriage i holds A_i (r_i, c,
    features, r_i+1) and its input X_i (s, features); the output axis
    (size 1) sits on A_1."""
    prof = tt_profile(N, r, f, constrict)
    nodes, columns = [], []
    for i in range(1, N + 1):
        left, right = prof[i - 1]
        up_edge = "c1" if i == 1 else f"x{i}"
        a = tuple(x for x in ((f"r{i}", left), (up_edge, 1), (f"p{i}", f), (f"r{i+1}", right))
                  if x[1] != 1 or x[0] == "c1")
        base = len(nodes)
        nodes += [(f"A{i}", "param", a), (f"X{i}", "input", ((SAMPLE, 0), (f"p{i}", f)))]
        columns.append((base, base + 1))
    return Net(nodes, columns, [f"A{i}" for i in range(1, N + 1)], ("c1",))


def tt_profile(N: int, r: int, f: int, constrict: bool) -> List[Tuple[int, int]]:
    """(left, right) bonds of a TT: with `constrict`, ranks clipped to
    f**depth from both ends, grown alternately inward."""
    if N == 1:
        return [(1, 1)]

    def clip(R, cap):
        return min(R, cap) if constrict else R
    b0, bn = (1, clip(r, f)), (clip(r, f), 1)
    left, right, middle = [b0], [bn], [b0, bn]
    for i in range(N - 2):
        lr, rr = left[-1][1], right[0][0]
        if i == N - 3:
            middle = [*left, (lr, rr), *right]
        if i % 2 == 0:
            left.append((lr, clip(r, lr * f)))
        else:
            right.insert(0, (clip(r, rr * f), rr))
    return middle
