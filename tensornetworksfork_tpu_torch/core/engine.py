"""Tensor-network engine (port of tensornetworksfork_tpu/core/engine.py, main path).

Functions over a static `Topology` + a params dict:

- `forward`            model output
- `env_chain`          left/right environment stacks
- `jacobian`           per-sample Jacobian of the output w.r.t. one node
- `packed_jacobian`    the same in the layout-packed (S, C, A0, REST) form
- `packed_gram_rhs`    A = JᵀHJ, b = Jᵀg on the packed form (kernel route)
- `gram_and_rhs`       A, b on the generic form (flat, own-out, einsum)
- `jacobian_apply`, `jacobian_transpose_apply`, `hessian_apply`,
  `gram_matvec`        J v, Jᵀ u, H u and JᵀHJ v for the matrix-free tier,
                       each one contraction at `Network.precision`
- `prepare_jacobian`   J v and Jᵀ u of one chunk as a `PreparedJacobian`:
                       its fixed factors laid out once, each product then
                       one GEMM and a per-row product

Every contraction runs at the network's dot precision, `Network.precision`
(highest | high | default: `contract.matmul`), taken from TNF_PRECISION
once, at import, as in the JAX package: the forward, the plain routes' A
products and K builds, the matrix-free tier. The auxiliary contractions
(environment chains, Jacobian builds, predictions, right-hand sides) run at
`Network.aux_precision` (TNF_AUX_PRECISION, read on every call, else the
network's precision): "default" rounds their operands to bf16 and sums in
f32, as the TPU runs a DEFAULT dot; "high" sums the three bf16 products of
the TPU's bf16x3. A's product on the kernel routes follows TNF_GRAM_DTYPE
(f32 | bf16 | int8), which no precision relaxes (the JAX package's Pallas
kernels never see it either), and the solves stay f32 (float64 where
solve_dtype asks for it). The route thresholds follow
TNF_PACKED_SYRK_MIN_D, with the JAX package's defaults, so both packages
take the same route for a node. Where XLA was asked for a bf16 dot with an
f32 result on the Gram ladder, the operands are upcast to f32 instead
(bf16 products are exact in f32).

Under a 2-D (data x model) mesh (`shard_model`, set by Sweeper.run) the
input axes of the named labels hold the model rank's block. Every
contraction slices the params' full copies of such an axis to that block
where an operand holds it so, and sums its result over the model group
where it sums the axis (one such axis a contraction: the forward goes
column by column). A Jacobian that keeps the axis keeps the block; the
Gram stage takes whole-sample row blocks with all columns from
`rows_for_gram` (an all-to-all over the model group), and a right-hand side
or Jᵀu that keeps it is assembled over the model group.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.cuda import gram as kgram
from ..parallel import mesh as pmesh
from ..utils.device import resolve_device
from .contract import check_precision, contract, matmul, max_elems
from .topology import CONST, INPUT, PARAM, Topology

Operand = Tuple[Tuple[int, ...], torch.Tensor]


def _prime(a):
    return ("~", a)


# The dot precision of every network built without one (JAX engine.py's
# DEFAULT_PRECISION): TNF_PRECISION, read once, at import
DEFAULT_PRECISION = check_precision(os.environ.get("TNF_PRECISION", "highest").lower())


def _packed_min_d() -> int:
    return int(os.environ.get("TNF_PACKED_SYRK_MIN_D", "4096"))


# Memory caps of two lowerings, the JAX package's defaults (there they are
# TNF_ENV_STAGED_MAX_BYTES and TNF_OWNOUT_K_MAX_ELEMS): the staged conv-TT
# advance swaps its operand roles, or falls back to the generic contract,
# past STAGED_MAX_BYTES of intermediates; the own-out Gram materialises
# K = H*J only up to OWNOUT_K_MAX_ELEMS elements.
STAGED_MAX_BYTES = 2 * 1024 ** 3
OWNOUT_K_MAX_ELEMS = 1 << 28


class Network:
    """Binds a Topology to constant tensors and exposes the compute functions.

    `inputs` is a dict {input_node_name: tensor}; `bind_inputs` normalises a
    single shared tensor or a per-node list. `device` is the card unless the
    caller asks for the CPU (utils/device.py). `use_kernels` selects the
    kernel routes of the Gram stage; it defaults to True exactly when the
    network lives on CUDA (the JAX package's use_pallas defaults to True only
    on a TPU) and TNF_KERNELS is not "0", which turns every network built
    meanwhile to the plain torch routes, as a reference for the kernels'.
    With use_kernels on CPU tensors the same routes run through the
    kernels' plain versions. `precision` is the dot precision of its
    contractions (module docstring; DEFAULT_PRECISION when None)."""

    def __init__(self, topology: Topology,
                 consts: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", use_kernels: Optional[bool] = None,
                 precision: Optional[str] = None):
        self.precision = check_precision((precision or DEFAULT_PRECISION).lower())
        self.aux_precision  # raises for an unknown TNF_AUX_PRECISION
        # the model sharding of a 2-D mesh run (shard_model): the mesh and,
        # per sharded axis id, this rank's block (start, size)
        self.mesh = None
        self.model_blocks: Dict[int, Tuple[int, int]] = {}
        self.device = resolve_device(device)
        if use_kernels is None:
            use_kernels = (self.device.type == "cuda"
                           and os.environ.get("TNF_KERNELS", "1") != "0")
        self.use_kernels = use_kernels
        self.topology = topology
        self.consts = dict(consts or {})
        for spec in topology.nodes:
            if spec.kind == CONST and spec.name not in self.consts:
                self.consts.update(topology.consts(device=self.device))
                break
        t = topology
        self._col_axes = [
            set().union(*(set(t.node_axes[ni]) for ni in col)) if col else set()
            for col in t.columns
        ]

    @property
    def aux_precision(self) -> str:
        """Precision of the auxiliary contractions: environment chains,
        Jacobian builds, predictions, rhs products. Read from
        TNF_AUX_PRECISION on every call (highest | high | default), the
        network's own precision when it is unset, as in the JAX package; A's
        product keeps its own ladder (TNF_GRAM_DTYPE) and the solves stay
        f32."""
        name = os.environ.get("TNF_AUX_PRECISION")
        return self.precision if name is None else check_precision(name.lower())

    # --------------------------------------------------------- model sharding
    def shard_model(self, mesh, labels: Sequence[str] = ()) -> None:
        """Shards the input axes whose labels are in `labels` over the model
        axis of the 2-D `mesh`: this rank's block of each (its inputs must
        come sharded so, parallel.mesh.shard_chunked_inputs). None (or no
        labels, or a model axis of one rank) ends the sharding. Raises
        ValueError when an axis does not split evenly."""
        self.mesh, self.model_blocks = None, {}
        if mesh is None or not labels or mesh.axis_size("model") == 1:
            return
        t = self.topology
        m, j = mesh.axis_size("model"), mesh.axis_rank("model")
        blocks = {}
        for ni in t.input_nodes:
            for a, lbl in zip(t.node_axes[ni], t.nodes[ni].labels):
                if lbl in labels:
                    n = t.axis_size[a]
                    if n % m:
                        raise ValueError(f"axis {lbl!r} of {t.nodes[ni].name} ({n}) "
                                         f"does not split over {m} model ranks")
                    blocks[a] = (j * (n // m), n // m)
        self.mesh, self.model_blocks = mesh, blocks

    def _local_axes(self, ops) -> set:
        """The model-sharded axes that some operand holds as this rank's
        block (its size there is the block's, not the axis's)."""
        return {a for axes, arr in ops for a, n in zip(axes, arr.shape)
                if a in self.model_blocks and n == self.model_blocks[a][1]}

    def _packed_local(self, pj) -> set:
        """The model-sharded node axes a packed Jacobian holds as blocks."""
        return {a for a, n in zip((pj["a0"],) + pj["rest"], pj["node_local_shape"])
                if a in self.model_blocks and n == self.model_blocks[a][1]}

    def _slice_ops(self, ops, local) -> List[Operand]:
        """The operands with each full copy of an axis in `local` cut to this
        rank's block."""
        out = []
        for axes, arr in ops:
            for k, a in enumerate(axes):
                if a in local and arr.shape[k] == self.topology.axis_size[a]:
                    start, n = self.model_blocks[a]
                    arr = arr.narrow(k, start, n)
            out.append((axes, arr))
        return out

    def _model_sum(self, out: torch.Tensor, summed: set) -> torch.Tensor:
        """out summed over the model group when its contraction summed a
        model-sharded axis held as blocks (each rank summed its block)."""
        if len(summed) > 1:
            raise ValueError(f"one contraction sums the model-sharded axes {summed}: "
                             "each block sum must be summed over the ranks alone")
        if summed:
            pmesh.all_reduce_sum(out, self.mesh, "model")
        return out

    def _tp_contract(self, ops, keep, precision: str) -> torch.Tensor:
        """contract() under the model sharding: the params' full copies of a
        sharded axis that an operand holds as a block are cut to it, and a
        result that sums such an axis is summed over the model group."""
        local = self._local_axes(ops) if self.model_blocks else set()
        if not local:
            return contract(ops, keep, precision)
        out = contract(self._slice_ops(ops, local), keep, precision)
        return self._model_sum(out, local - set(keep))

    def _assemble(self, axes, arr: torch.Tensor) -> torch.Tensor:
        """The whole tensor from this rank's block of its model-sharded axes
        (each rank's block placed in zeros, summed over the model group);
        arr itself when it holds none."""
        local = self._local_axes([(axes, arr)]) if self.model_blocks else set()
        if not local:
            return arr
        full = arr.new_zeros([self.topology.axis_size[a] if a in local else d
                              for a, d in zip(axes, arr.shape)])
        view = full
        for k, a in enumerate(axes):
            if a in local:
                start, n = self.model_blocks[a]
                view = view.narrow(k, start, n)
        view.copy_(arr)
        return pmesh.all_reduce_sum(full, self.mesh, "model")

    def _rows_block(self, arr: torch.Tensor, s_dim: int, local_dim: Optional[int],
                    groups: int) -> torch.Tensor:
        """Of each of `groups` equal runs of arr's rows (dim s_dim), the
        model rank's block, with all columns: when dim local_dim holds this
        rank's block of a sharded axis, each rank sends each other rank its
        block of rows (an all-to-all over the model group) and the column
        blocks received are joined in rank order."""
        if local_dim is None:
            return pmesh.rows_of(arr, self.mesh, groups, dim=s_dim)
        m = self.mesh.axis_size("model")
        a = arr.movedim(s_dim, 0)
        c = local_dim - (local_dim > s_dim)  # the local dim among the columns
        rows, cols = a.shape[0], tuple(a.shape[1:])
        if rows % (groups * m):
            raise ValueError(f"{rows} rows do not split into {groups} runs over "
                             f"{m} model ranks")
        rb = rows // (groups * m)
        send = a.reshape((groups, m, rb) + cols).transpose(0, 1)
        got = pmesh.all_to_all(send.contiguous(), self.mesh, "model")
        # (m, groups, rb, cols...): the rank-k block beside the local dim
        got = got.movedim(0, 3 + c - 1)
        shape = list(got.shape)
        shape[3 + c - 1:3 + c + 1] = [m * shape[3 + c]]
        return got.reshape([groups * rb] + shape[2:]).movedim(0, s_dim)

    def rows_for_gram(self, J, groups: int = 1):
        """This rank's rows of a Jacobian for the Gram stage under the 2-D
        mesh, with all its columns: of each of `groups` equal runs of its
        samples (the chunks of a merged batch), the model rank's block, as a
        1-D mesh of every rank would hold them. J is an operand (axes, arr)
        or a packed Jacobian (packed_jacobian's dict)."""
        t = self.topology
        if isinstance(J, dict):
            arr, n_out = J["arr"], J["n_out"]
            axes = (t.sample_axis,) + J["out_part"] + (J["a0"],) + J["rest"]
            full = arr.reshape(arr.shape[:1 + n_out] + J["node_local_shape"])
            local = self._packed_local(J)
            if len(local) > 1:
                raise ValueError(f"J holds blocks of several sharded axes {local}")
            got = self._rows_block(full, 0, axes.index(next(iter(local)))
                                   if local else None, groups)
            return dict(J, arr=got.reshape(got.shape[:2 + n_out] + (-1,)),
                        node_local_shape=tuple(got.shape[1 + n_out:]))
        axes, arr = J
        local = self._local_axes([J])
        if len(local) > 1:
            raise ValueError(f"J holds blocks of several sharded axes {local}")
        return (axes, self._rows_block(arr, axes.index(t.sample_axis),
                                       axes.index(next(iter(local))) if local else None,
                                       groups))

    # ------------------------------------------------------------------ inputs
    def bind_inputs(self, x) -> Dict[str, torch.Tensor]:
        t = self.topology
        names = [t.nodes[ni].name for ni in t.input_nodes]
        if isinstance(x, dict):
            return x
        if isinstance(x, (list, tuple)):
            return dict(zip(names, x))
        return {n: x for n in names}

    # ---------------------------------------------------------------- operands
    def operand(self, ni: int, params, inputs) -> Operand:
        spec = self.topology.nodes[ni]
        if spec.kind == PARAM:
            arr = params[spec.name]
        elif spec.kind == INPUT:
            arr = inputs[spec.name]
        else:
            arr = self.consts[spec.name]
        return (self.topology.node_axes[ni], arr)

    def column_operands(self, ci: int, params, inputs,
                        exclude: Sequence[int] = ()) -> List[Operand]:
        return [
            self.operand(ni, params, inputs)
            for ni in self.topology.columns[ci]
            if ni not in exclude
        ]

    # ------------------------------------------------------------------- keeps
    def _keep_for_group(self, group_axes: set, outside_axes: set) -> Tuple[int, ...]:
        """Environment keep order: bond/output axes first, sample axis last
        (the JAX package's layout; consumers address axes by id)."""
        t = self.topology
        want = group_axes & (outside_axes | set(t.output_axes))
        want.discard(t.sample_axis)
        ordered = tuple(sorted(want))
        if t.sample_axis in group_axes:
            return ordered + (t.sample_axis,)
        return ordered

    def env_keep(self, cols: Sequence[int]) -> Tuple[int, ...]:
        cols = set(cols)
        group = set().union(*(self._col_axes[c] for c in cols)) if cols else set()
        ncols = len(self.topology.columns)
        outside_cols = [c for c in range(ncols) if c not in cols]
        outside = (set().union(*(self._col_axes[c] for c in outside_cols))
                   if outside_cols else set())
        return self._keep_for_group(group, outside)

    # ------------------------------------------------------------ environments
    def env_step(self, prev: Optional[Operand], ci: int, params, inputs,
                 cols_so_far: Sequence[int]) -> Operand:
        """Contract column `ci` into the running environment (summed over
        the model group where it sums a model-sharded axis)."""
        col_ops = self.column_operands(ci, params, inputs)
        keep = self.env_keep(cols_so_far)
        ops = ([prev] if prev is not None else []) + col_ops
        local = self._local_axes(ops) if self.model_blocks else set()
        if local:
            ops = self._slice_ops(ops, local)
            col_ops = ops[len(ops) - len(col_ops):]
        if prev is not None:
            fast = self._env_step_conv_fast(prev, col_ops, keep)
            if fast is not None:
                return (keep, self._model_sum(fast, local - set(keep)))
        return (keep, self._model_sum(contract(ops, keep, self.aux_precision),
                                      local - set(keep)))

    def _env_step_conv_fast(self, prev, col_ops, keep):
        """Staged lowering of a conv-TT-like column advance, or None.

          1. U[(s·p), (cb·cb')]   = X[(s·p), q] @ conv[q, (cb·cb')]
          2. V[s, (p·cb'), (o·r)] = U ⋅ prev[s, (o·r), cb]   (contract cb)
          3. env[(s·cb'·o), r']   = V[(s·cb'·o), (r·p)] @ core[(r·p), r']

        Acceptance is structural (axis-id driven), exactly as in the JAX
        package: one sample-carrying input X(s, p, q), one 3-axis operand
        sharing p (the core), one sharing q (the conv block), each with one
        axis bridging to prev and one surviving into keep. Anything else
        returns None and takes the generic contract."""
        t = self.topology
        s = t.sample_axis
        prev_axes, P = prev
        if len(col_ops) != 3 or s not in prev_axes:
            return None
        xs = [o for o in col_ops if s in o[0]]
        if len(xs) != 1:
            return None
        x_axes, X = xs[0]
        if len(x_axes) != 3 or len(set(x_axes)) != 3:
            return None
        others = [o for o in col_ops if o is not xs[0]]
        if any(len(ax) != 3 or len(set(ax)) != 3 or s in ax
               for ax, _ in others):
            return None
        if any(a.is_complex() for _, a in [prev] + col_ops):
            return None
        x_free = [a for a in x_axes if a != s]

        def classify(op):
            ax, arr = op
            shared = [a for a in ax if a in x_free]
            bridge = [a for a in ax if a in prev_axes]
            kept = [a for a in ax if a in keep]
            if (len(shared) != 1 or len(bridge) != 1 or len(kept) != 1
                    or shared[0] in prev_axes or shared[0] in keep
                    or bridge[0] == kept[0] or bridge[0] in keep):
                return None
            return shared[0], bridge[0], kept[0], ax, arr

        c0, c1 = classify(others[0]), classify(others[1])
        if c0 is None or c1 is None or c0[0] == c1[0]:
            return None
        if c0[1] == c1[1] or c0[2] == c1[2]:
            return None
        # conv := the operand sharing X's q; core := the one sharing p. Keep
        # the operand-order roles unless their intermediates exceed the byte
        # cap; swap only then, falling back to the generic einsum when
        # neither choice fits (same rule as the JAX package). Sizes are the
        # operands' own: a model-sharded axis is this rank's block
        szs = dict(t.axis_size)
        for ax, arr in [prev] + col_ops:
            szs.update(zip(ax, arr.shape))
        B_guess = X.shape[x_axes.index(s)]
        cap = STAGED_MAX_BYTES

        def staged_elems(conv_c, core_c):
            o = 1
            for a in prev_axes:
                if a not in (s, core_c[1], conv_c[1]):
                    o *= szs[a]
            u = B_guess * szs[core_c[0]] * szs[conv_c[1]] * szs[conv_c[2]]
            v = B_guess * szs[core_c[0]] * szs[conv_c[2]] * o * szs[core_c[1]]
            return max(u, v)

        if 4 * staged_elems(c0, c1) > cap:
            if 4 * staged_elems(c1, c0) > cap:
                return None
            c0, c1 = c1, c0
        (q, cb_b, cb_k, conv_ax, CONV), (p, r_b, r_k, core_ax, CORE) = c0, c1
        outs = tuple(a for a in prev_axes if a not in (s, r_b, cb_b))
        if any(a not in keep for a in outs):
            return None
        if set(keep) != {s, r_k, cb_k, *outs}:
            return None
        sz = szs
        Pn, Qn = sz[p], sz[q]
        CBb, CBk, Rb, Rk = sz[cb_b], sz[cb_k], sz[r_b], sz[r_k]
        O = 1
        for a in outs:
            O *= sz[a]
        B = X.shape[x_axes.index(s)]
        prec = self.aux_precision
        rt = torch.promote_types(torch.promote_types(X.dtype, CONV.dtype),
                                 torch.promote_types(P.dtype, CORE.dtype))

        X3 = X.to(rt).permute(x_axes.index(s), x_axes.index(p), x_axes.index(q))
        convm = CONV.permute(conv_ax.index(q), conv_ax.index(cb_b),
                             conv_ax.index(cb_k)).reshape(Qn, CBb * CBk)
        U = matmul(X3.reshape(B * Pn, Qn), convm.to(rt), prec).reshape(
            B, Pn, CBb, CBk)
        pe = P.permute(*[prev_axes.index(a) for a in (s,) + outs + (r_b, cb_b)])
        pe = pe.reshape(B, O * Rb, CBb)
        V = matmul(U.permute(0, 1, 3, 2).reshape(B, Pn * CBk, CBb),
                   pe.to(rt).transpose(1, 2), prec)  # (B, P*CBk, O*Rb)
        V = V.reshape(B, Pn, CBk, O, Rb)
        Vp = V.permute(0, 2, 3, 4, 1).reshape(B * CBk * O, Rb * Pn)
        corem = CORE.permute(core_ax.index(r_b), core_ax.index(p),
                             core_ax.index(r_k)).reshape(Rb * Pn, Rk)
        out = matmul(Vp, corem.to(rt), prec)
        out = out.reshape((B, CBk) + tuple(sz[a] for a in outs) + (Rk,))
        cur = (s, cb_k) + outs + (r_k,)
        return out.permute(*[cur.index(a) for a in keep])

    def env_chain(self, params, inputs, direction: str = "left",
                  skip_last: bool = False) -> List[Optional[Operand]]:
        """envs[c] = contraction of columns 0..c (left) or c..end (right).
        skip_last drops the terminal step (the full-network env), which no
        sweep consumer reads."""
        ncols = len(self.topology.columns)
        order = list(range(ncols) if direction == "left"
                     else range(ncols - 1, -1, -1))
        if skip_last:
            order = order[:-1]
        envs: List[Optional[Operand]] = [None] * ncols
        prev = None
        seen: List[int] = []
        for ci in order:
            seen.append(ci)
            prev = self.env_step(prev, ci, params, inputs, seen)
            envs[ci] = prev
        return envs

    # ---------------------------------------------------------------- forward
    def output_keep(self) -> Tuple[int, ...]:
        t = self.topology
        keep = []
        oi = 0
        for ol in t.output_labels:
            if ol == t.sample_dim:
                keep.append(t.sample_axis)
            else:
                keep.append(t.output_axes[oi])
                oi += 1
        return tuple(keep)

    def forward(self, params, x) -> torch.Tensor:
        """Model output with axes ordered as output_labels, at the network's
        precision. Under the model sharding column by column, each column's
        sum over its sharded axis summed over the model group."""
        inputs = self.bind_inputs(x)
        if self.model_blocks:
            ncols = len(self.topology.columns)
            prev: List[Operand] = []
            for ci in range(ncols):
                keep = (self.env_keep(range(ci + 1)) if ci < ncols - 1
                        else self.output_keep())
                ops = prev + self.column_operands(ci, params, inputs)
                prev = [(keep, self._tp_contract(ops, keep, self.precision))]
            return prev[0][1]
        ops = [self.operand(ni, params, inputs)
               for ni in range(len(self.topology.nodes))]
        return contract(ops, self.output_keep(), self.precision)

    # --------------------------------------------------------------- jacobian
    def jacobian_operands(self, ni: int, params, inputs,
                          left_env: Optional[Operand],
                          right_env: Optional[Operand]) -> List[Operand]:
        ci = self.topology.col_of[ni]
        ops: List[Operand] = []
        if left_env is not None:
            ops.append(left_env)
        ops += self.column_operands(ci, params, inputs, exclude=(ni,))
        if right_env is not None:
            ops.append(right_env)
        return ops

    def jacobian_keep(self, ni: int, operand_axes: Sequence[Tuple[int, ...]]
                      ) -> Tuple[int, ...]:
        """Jacobian axis order: (s, out axes..., node axes...), or, when J
        carries no output axes, (node axes..., s) — as in the JAX package."""
        t = self.topology
        present = set()
        for axes in operand_axes:
            present.update(axes)
        node_axes = t.node_axes[ni]
        out_part = tuple(a for a in t.output_axes
                         if a in present and a not in node_axes)
        node_part = tuple(dict.fromkeys(a for a in node_axes if a in present))
        if not out_part:
            return node_part + (t.sample_axis,)
        return (t.sample_axis,) + out_part + node_part

    def jacobian(self, ni: int, params, inputs, left_env, right_env) -> Operand:
        """Environment of everything except node `ni`: the per-sample
        Jacobian of the (multi-linear) output w.r.t. that node."""
        ops = self.jacobian_operands(ni, params, inputs, left_env, right_env)
        keep = self.jacobian_keep(ni, [ax for ax, _ in ops])
        return (keep, self._tp_contract(ops, keep, self.aux_precision))

    # ------------------------------------------------------ packed jacobian
    def column_operand_axes(self, ni: int, left_axes, right_axes
                            ) -> List[Tuple[int, ...]]:
        """Axes of jacobian_operands(ni, ...) without building them."""
        t = self.topology
        ci = t.col_of[ni]
        axes = [] if left_axes is None else [tuple(left_axes)]
        axes += [t.node_axes[nj] for nj in t.columns[ci] if nj != ni]
        if right_axes is not None:
            axes.append(tuple(right_axes))
        return axes

    def packed_plan(self, ni: int, operand_axes: Sequence[Tuple[int, ...]]):
        """Static plan of the layout-packed Jacobian, or None when the
        topology around `ni` does not fit the packing precondition (the
        caller then uses `jacobian`). Needs >= 3 node axes in J, each on
        exactly one operand, one operand carrying all present out axes plus
        node_axes[0], and the others free of out axes. Depends on axes and
        sizes only, so the sweep decides the route before its chunk loop."""
        t = self.topology
        keep = self.jacobian_keep(ni, operand_axes)
        s = t.sample_axis
        node_axes = t.node_axes[ni]
        out_part = tuple(a for a in keep if a in t.output_axes)
        node_part = tuple(a for a in keep if a in node_axes and a not in out_part)
        if len(node_part) < 3 or len(set(node_axes)) != len(node_axes):
            return None
        if tuple(a for a in node_axes if a in node_part) != node_part:
            return None  # J must keep node axes in node order
        a0 = node_part[0]
        rest = node_part[1:]
        out_total = 1
        for a in t.output_axes:
            out_total *= t.axis_size[a]
        if len(out_part) != len(t.output_axes) and not (
                len(out_part) == 0 and out_total == 1):
            return None
        carriers = {a: [i for i, ax in enumerate(operand_axes) if a in ax]
                    for a in node_part}
        if any(len(c) != 1 for c in carriers.values()):
            return None
        li = carriers[a0][0]
        L_axes = tuple(operand_axes[li])
        if s not in L_axes:
            return None
        if any(a not in L_axes for a in out_part):
            return None
        others = [ax for i, ax in enumerate(operand_axes) if i != li]
        if any(a in ax for a in out_part for ax in others):
            return None
        if any(a in L_axes for a in rest):
            return None
        other_axes = set()
        for ax in others:
            other_axes.update(ax)
        bridges = tuple(a for a in L_axes
                        if a != s and a not in out_part and a != a0
                        and a in other_axes)
        extra_L = [a for a in L_axes
                   if a != s and a not in out_part and a != a0
                   and a not in bridges]
        if extra_L:
            return None
        if not any(s in ax for ax in others):
            return None
        r_sz = 1
        for a in rest:
            r_sz *= t.axis_size[a]
        return {"li": li, "a0": a0, "rest": rest, "bridges": bridges,
                "out_part": out_part, "n_out": len(out_part),
                "node_shape": tuple(t.axis_size[a] for a in node_axes),
                "a0_sz": t.axis_size[a0], "r_sz": r_sz,
                "pad_out": len(t.output_axes) - len(out_part)}

    def packed_jacobian(self, ni: int, params, inputs, left_env, right_env):
        """Layout-packed Jacobian (S, [out...], A0, prod(rest node axes)),
        stored in the Gram operand dtype (bf16 under the bf16/int8 tiers),
        or None (see packed_plan). Under the model sharding a sharded node
        axis holds this rank's block (`node_local_shape`: the sizes of A0
        and the rest axes as stored)."""
        ops = self.jacobian_operands(ni, params, inputs, left_env, right_env)
        if any(arr.is_complex() for _, arr in ops):
            return None
        plan = self.packed_plan(ni, [ax for ax, _ in ops])
        if plan is None:
            return None
        t = self.topology
        s = t.sample_axis
        li, a0, rest, bridges = plan["li"], plan["a0"], plan["rest"], plan["bridges"]
        out_part = plan["out_part"]
        local = self._local_axes(ops) if self.model_blocks else set()
        ops = self._slice_ops(ops, local)
        L_axes, L_arr = ops[li]
        others = [op for i, op in enumerate(ops) if i != li]
        # stage 1: everything but L, rest axes flattened last
        prec = self.aux_precision
        W_keep = (s,) + bridges + rest
        summed = {a for ax, _ in others for a in ax} - set(W_keep)
        W = self._model_sum(contract(others, W_keep, prec), local & summed)
        S_sz = W.shape[0]
        b_sz = 1
        for a in bridges:
            b_sz *= W.shape[W_keep.index(a)]
        rest_shape = tuple(W.shape[1 + len(bridges):])
        W2 = W.reshape(S_sz, b_sz, -1)
        # stage 2: batched matmul over the sample axis
        perm = ([L_axes.index(s)] + [L_axes.index(a) for a in out_part]
                + [L_axes.index(a0)] + [L_axes.index(a) for a in bridges])
        c_sz = 1
        for a in out_part:
            c_sz *= t.axis_size[a]
        a0_sz = L_arr.shape[L_axes.index(a0)]
        L3 = L_arr.permute(*perm).reshape(S_sz, c_sz * a0_sz, b_sz)
        J2 = self._model_sum(matmul(L3, W2, prec), local & set(bridges))
        gd = kgram.gram_dtype()
        if gd is not None:
            # stored in the Gram operand dtype: every consumer wants bf16
            # operands, so this loses nothing and halves J's footprint
            J2 = J2.to(gd)
        out_sizes = tuple(t.axis_size[a] for a in out_part)
        J2 = J2.reshape((S_sz,) + out_sizes + (a0_sz, W2.shape[2]))
        return dict(plan, arr=J2, node_local_shape=(a0_sz,) + rest_shape)

    def packed_predict(self, pj, core: torch.Tensor) -> torch.Tensor:
        """J · core at the aux precision, f32 out; the core is cast to J's
        dtype first, as in the JAX package. Under the model sharding a J
        holding blocks of a sharded axis meets the core's blocks, and the
        prediction is summed over the model group."""
        J2 = pj["arr"]
        local = self._packed_local(pj)
        core = self._slice_ops([((pj["a0"],) + pj["rest"], core)], local)[0][1]
        D = J2.shape[-2] * J2.shape[-1]
        core2 = core.reshape(D, 1).to(J2.dtype)
        pred = matmul(J2.reshape(-1, D), core2, self.aux_precision)
        pred = self._model_sum(pred.reshape(J2.shape[:-2]), local)
        if pj["pad_out"]:
            pred = pred.reshape(pred.shape + (1,) * pj["pad_out"])
        return pred

    def packed_kernel_route(self, plan) -> bool:
        """Will packed_gram_rhs take the tiled kernel route?"""
        D = plan["a0_sz"] * plan["r_sz"]
        return self.use_kernels and D >= _packed_min_d()

    def packed_gram_acc_init(self, plan, device) -> Optional[torch.Tensor]:
        """Zero (Dp, Dp) f32 chunk carry on `device` for the tiled kernel
        route, or None when that route is not taken. Every tier carries the
        sum inside the Gram kernel (int8: gram_pair_band_q; f32/bf16:
        gram_pair's or, for a diagonal Hessian, weighted_gram_tiled's carry
        epilogue, which replaces the reference's add_packed_upper)."""
        if not self.packed_kernel_route(plan):
            return None
        _, _, _, Dp = kgram.plan_tiles(plan["a0_sz"] * plan["r_sz"])
        return torch.zeros((Dp, Dp), dtype=torch.float32, device=device)

    def packed_gram_finisher(self, plan):
        """fn(carry) -> (D, D) symmetric A for the tiled route's carry: the
        band layout under int8 (full and diagonal Hessians both run the
        band Gram there), the upper triangle otherwise."""
        D = plan["a0_sz"] * plan["r_sz"]
        if kgram.gram_quant():
            return lambda A: kgram.mirror_band(A)[:D, :D]
        return lambda A: kgram.mirror_gram(A[:D, :D])

    def packed_gram_rhs(self, pj, grad: torch.Tensor, hess: torch.Tensor,
                        acc: Optional[torch.Tensor] = None):
        """A = Jᵀ H J, b = Jᵀ g on the packed Jacobian. Returns (A, b).

        On the tiled kernel route (use_kernels and D >= TNF_PACKED_SYRK_MIN_D)
        the chunk's Gram is added to the carry `acc` ((Dp, Dp) f32, from
        packed_gram_acc_init) IN PLACE and (acc, b) is returned raw — the
        caller finishes the carry once with packed_gram_finisher. Without
        `acc` a fresh carry is used and the finished (D, D) A returned.
        Elsewhere A is the full (D, D) f32 product of plain dots."""
        if self.model_blocks and self._packed_local(pj):
            raise ValueError("packed_gram_rhs needs all of J's columns: take "
                             "rows_for_gram's rows first")
        J2 = pj["arr"]
        n_out = pj["n_out"]
        S_sz = J2.shape[0]
        C_sz = 1
        for d in J2.shape[1:1 + n_out]:
            C_sz *= d
        D0, D1 = pj["a0_sz"], pj["r_sz"]
        D = D0 * D1
        J3 = J2.reshape(S_sz, C_sz, D)
        diag = hess.ndim == grad.ndim
        g2 = grad.reshape(S_sz, -1).to(J3.dtype)
        gd = kgram.gram_dtype()
        prec = self.aux_precision
        dot_prec = self.precision if gd is None else "highest"
        if self.packed_kernel_route(pj):
            finish = acc is None
            if finish:
                acc = self.packed_gram_acc_init(pj, J3.device)
            _, block, _, Dp = kgram.plan_tiles(D)
            quant = gd is not None and kgram.gram_quant()
            if diag:
                # no class mix: rows stay (s, c) ordered. The int8 tier
                # quantises K = h*J, which the retile forms in the same pass
                h = hess.reshape(S_sz * C_sz).float().contiguous()
                Jt, Kt = kgram.retile_rows(J3.reshape(S_sz * C_sz, D).contiguous(),
                                           Dp, h if quant else None)
                b = matmul(g2.reshape(1, -1), Jt, prec).reshape(-1)[:D]
            else:
                H3 = hess.reshape(S_sz, C_sz, C_sz).float().contiguous()
                # fused class-major retile + class mix, which also sums the
                # rhs Jtᵀg from the J it reads, in f32: rows come back (c, s)
                # ordered, so g is reordered to match. g is in J's dtype, so
                # a bf16 J makes that the aux tier's product already; under
                # the aux tier an f32 J takes b's product outside K1, which
                # must not round the J it retiles
                gvec = g2.reshape(S_sz, C_sz).T.reshape(-1).contiguous()
                fused = prec == "highest" or J3.dtype == torch.bfloat16
                Jt, Kt, b = kgram.retile_hmix(J3.contiguous(), H3, Dp,
                                              gvec if fused else None)
                if not fused:
                    b = matmul(gvec.reshape(1, -1), Jt, prec).reshape(-1)
                b = b[:D]
            if quant:
                Q1, s1 = kgram.quantize_tiled(Jt, block)
                Q2, s2 = kgram.quantize_tiled(Kt, block)
                del Jt, Kt
                kgram.gram_pair_band_q(Q1, s1, Q2, s2, acc)
            elif diag:
                # the weighting rides the Gram kernel's operand load; here
                # and below, tiles past the node's D (the layout's zero
                # padding) are skipped
                kgram.weighted_gram_tiled(Jt, h, acc, D)
            else:
                kgram.gram_pair(Jt, Kt, acc=acc, D=D)
            if finish:
                return self.packed_gram_finisher(pj)(acc), b
            return acc, b
        b = matmul(g2.reshape(1, -1), J3.reshape(-1, D), prec).reshape(-1)
        if diag:
            h2 = hess.reshape(S_sz, -1)
            K3 = J3 * h2[:, :, None].to(J3.dtype)
        else:
            H2 = hess.reshape(S_sz, C_sz, C_sz).to(J3.dtype)
            # K[s,c',d] = sum_c H[s,c,c'] J[s,c,d] (bf16 under the bf16/int8
            # tiers: the JAX package runs this dot at DEFAULT precision, whose
            # bf16 products "highest" runs exactly in f32)
            K3 = matmul(H2.transpose(1, 2), J3, dot_prec).to(J3.dtype)
        Jop, Kop = J3, K3
        if gd is not None:
            Jop, Kop = J3.to(gd), K3.to(gd)
        A = matmul(Jop.reshape(-1, D).T, Kop.reshape(-1, D), dot_prec)
        return A, b

    def predict_from_jacobian(self, ni: int, J: Operand,
                              core: torch.Tensor) -> torch.Tensor:
        """out = J · core — exact because the network is multi-linear in
        each node."""
        J_axes, J_arr = J
        node_axes = self.topology.node_axes[ni]
        return self._tp_contract([(J_axes, J_arr), (node_axes, core)],
                                 self.output_keep(), self.aux_precision)

    # ------------------------------------------------------------------- A, b
    def rhs(self, ni: int, J: Operand, grad: torch.Tensor) -> torch.Tensor:
        """b = Jᴴ g over the node axes, at the aux precision: the rhs line
        of gram_and_rhs, alone (the gradient method needs no A). Whole on
        every model rank: assembled over the model group from J's blocks of
        a sharded axis."""
        t = self.topology
        J_axes, J_arr = J
        Jc = J_arr.conj() if J_arr.is_complex() else J_arr
        g_axes = (t.sample_axis,) + t.output_axes
        b = self._tp_contract([(J_axes, Jc), (g_axes, grad)], t.node_axes[ni],
                              self.aux_precision)
        return self._assemble(t.node_axes[ni], b)

    def _kernel_gram(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """Symmetric Gram XᵀY of flat (rows, D) operands through the Gram
        kernel (K10), mirrored."""
        return kgram.mirror_gram(kgram.gram_pair(X.contiguous(), Y.contiguous()))

    def gram_and_rhs(self, ni: int, J: Operand, grad: torch.Tensor,
                     hess: torch.Tensor, defer_ownout=None):
        """A = Jᴴ H J (Gram over node dims), b = Jᴴ g (J is conjugated for
        a complex network, which takes the plain routes).

        grad axes: (s, *output_axes); hess axes (s, *out, *out') for a full
        Hessian or (s, *out) for a diagonal one. Output axes not owned by the
        node are summed directly.

        defer_ownout (optional dict): if the structured output-owning-node
        path fires, A comes back RAW as the (P, DJ, DJ) upper class-pair
        blocks (P = C(C+1)/2) with `defer_ownout["plan"]` set — the caller
        accumulates the raw form over chunks and calls expand_ownout() once.

        The JAX package's multi-contracting-dim form for large flattenable
        nodes (TNF_FLAT_GRAM_MAX_D) worked around a TPU compiler limit and is
        not ported: such nodes take the flat route here."""
        t = self.topology
        J_axes, J_arr = J
        node_axes = t.node_axes[ni]
        out_axes = t.output_axes
        s = t.sample_axis

        present = set(J_axes) | set(out_axes) | {s}
        missing = [a for a in node_axes if a not in present]
        if missing:
            raise ValueError(f"node axes {missing} appear in neither jacobian nor outputs")
        if self.model_blocks and self._local_axes([J]):
            raise ValueError("gram_and_rhs needs all of J's columns: take "
                             "rows_for_gram's rows first")

        b = self.rhs(ni, J, grad)

        diag = hess.ndim == grad.ndim

        # ---- flattened-matmul path ----------------------------------------
        flattenable = (
            not any(a in out_axes for a in node_axes)
            and all(a in J_axes for a in node_axes)
            and set(a for a in J_axes if a != s) <= set(node_axes) | set(out_axes)
            and len(set(node_axes)) == len(node_axes)
            and len(set(J_axes)) == len(J_axes)
        )
        out_in_J = [a for a in out_axes if a in J_axes]
        if flattenable and not diag:
            flattenable = len(out_in_J) == len(out_axes)
        if flattenable and diag:
            flattenable = len(out_in_J) in (0, len(out_axes))
        if flattenable:
            perm = ([J_axes.index(s)]
                    + [J_axes.index(a) for a in out_in_J]
                    + [J_axes.index(a) for a in node_axes])
            Jp = J_arr.permute(*perm)
            S = Jp.shape[0]
            C = 1
            for a in out_in_J:
                C *= J_arr.shape[J_axes.index(a)]
            D = Jp.numel() // (S * C)
            node_shape = tuple(J_arr.shape[J_axes.index(a)] for a in node_axes)
            J3 = Jp.reshape(S, C, D)
            if diag:
                W = hess.reshape(S, -1)
                if not out_in_J:
                    W = W.sum(dim=1, keepdim=True)  # C == 1
            else:
                W = hess.reshape(S, C, C)
            if self.use_kernels and not J_arr.is_complex():
                gd = kgram.gram_dtype()
                J2 = J3.reshape(S * C, D)
                if diag:
                    # the weighting rides the kernel's operand load (K9)
                    if gd is not None:
                        J2 = J2.to(gd)
                    A = kgram.mirror_gram(kgram.weighted_gram(
                        J2.contiguous(), W.reshape(S * C).float().contiguous()))
                else:
                    K2 = matmul(W.to(J3.dtype).transpose(1, 2), J3,
                                self.precision).reshape(S * C, D)
                    if gd is not None:
                        J2, K2 = J2.to(gd), K2.to(gd)
                    A = self._kernel_gram(J2, K2)
            else:
                A = _flat_gram(J3, W, diag, self.precision)
            return A.reshape(node_shape + node_shape), b

        # ---- general einsum path ------------------------------------------
        primed = {a: _prime(a) for a in set(node_axes) | set(out_axes)}
        if diag and any(a in out_axes for a in node_axes):
            hess = _embed_diag(hess)
            diag = False

        # ---- structured path for output-owning nodes ----------------------
        # A[c,d,c',d'] = sum_s H[s,c,c'] J[s,d] J[s,d']: materialise
        # K = H*J and finish with one dot over s
        if (not diag and out_axes
                and all(a in node_axes for a in out_axes)
                and not any(a in J_axes for a in out_axes)
                and not J_arr.is_complex()):
            rest = tuple(a for a in node_axes if a not in out_axes)
            if (set(J_axes) == {s, *rest}
                    and len(J_axes) == 1 + len(rest)
                    and len(set(node_axes)) == len(node_axes)):
                S_sz = J_arr.shape[J_axes.index(s)]
                C_sz = 1
                for a in out_axes:
                    C_sz *= t.axis_size[a]
                DJ = 1
                for a in rest:
                    DJ *= t.axis_size[a]
                if S_sz * C_sz * C_sz * DJ <= OWNOUT_K_MAX_ELEMS:
                    gd = kgram.gram_dtype()
                    # bf16 operands' products are exact in f32 ("highest")
                    dot_prec = self.precision if gd is None else "highest"
                    perm = [J_axes.index(s)] + [J_axes.index(a) for a in rest]
                    Jf = J_arr.permute(*perm).reshape(S_sz, DJ)
                    Hf = hess.reshape(S_sz, C_sz, C_sz)
                    Jop = Jf if gd is None else Jf.to(gd)
                    Hop = Hf if gd is None else Hf.to(gd)
                    out_sizes = tuple(t.axis_size[a] for a in out_axes)
                    rest_sizes = tuple(t.axis_size[a] for a in rest)
                    O, R = len(out_axes), len(rest)
                    upos = {a: i for i, a in enumerate(out_axes)}
                    upos.update({a: 2 * O + j for j, a in enumerate(rest)})
                    ppos = {a: O + i for i, a in enumerate(out_axes)}
                    ppos.update({a: 2 * O + R + j for j, a in enumerate(rest)})
                    perm_out = tuple([upos[a] for a in node_axes]
                                     + [ppos[a] for a in node_axes])
                    if (self.use_kernels
                            and os.environ.get("TNF_OWNOUT_KERNEL") == "1"
                            and DJ >= int(os.environ.get(
                                "TNF_OWNOUT_KERNEL_MIN_DJ", "256"))):
                        # opt-in class-pair kernel (K8 + K11), checked
                        # before the deferred form as in the JAX package:
                        # the caller gets the full A and no plan
                        _, _, _, Dp = kgram.plan_tiles(DJ)
                        Jt, _ = kgram.retile_rows(Jop.contiguous(), Dp)
                        A4 = kgram.own_out_gram(Jt, Hf.float().contiguous(),
                                                C_sz, DJ)
                        A4 = kgram.mirror_own_out(A4)[:, :, :DJ, :DJ]
                        A5 = A4.reshape(out_sizes + out_sizes
                                        + rest_sizes + rest_sizes)
                        return A5.permute(*perm_out).to(J_arr.dtype), b
                    if defer_ownout is not None and C_sz > 1:
                        # upper class pairs only: H[s,c,c'] = H[s,c',c], so
                        # A[c',.,c,.] = A[c,.,c',.]ᵀ(d↔d')
                        iu, ju = np.triu_indices(C_sz)
                        iu_t = torch.as_tensor(iu, device=Hop.device)
                        ju_t = torch.as_tensor(ju, device=Hop.device)
                        Kup = Hop[:, iu_t, ju_t, None] * Jop[:, None, :]
                        A_raw = matmul(Kup.reshape(S_sz, len(iu) * DJ).T, Jop,
                                       dot_prec).to(J_arr.dtype)
                        defer_ownout["plan"] = (
                            C_sz, DJ, out_sizes, rest_sizes, perm_out)
                        return A_raw.reshape(len(iu), DJ, DJ), b
                    K4 = Hop[:, :, :, None] * Jop[:, None, None, :]
                    A_raw = matmul(K4.reshape(S_sz, C_sz * C_sz * DJ).T, Jop,
                                   dot_prec).to(J_arr.dtype)
                    A5 = A_raw.reshape(out_sizes + out_sizes
                                       + rest_sizes + rest_sizes)
                    return A5.permute(*perm_out), b
        if diag:
            H_axes = (s,) + out_axes
            J2_axes = tuple(
                a if (a == s or a in out_axes) else primed[a] for a in J_axes
            )
        else:
            H_axes = (s,) + out_axes + tuple(primed[a] for a in out_axes)
            J2_axes = tuple(primed.get(a, a) if a != s else s for a in J_axes)
        keep_A = node_axes + tuple(primed.get(a, a) for a in node_axes)
        Jc = J_arr.conj() if J_arr.is_complex() else J_arr
        A = contract([(J_axes, Jc), (J2_axes, J_arr), (H_axes, hess)], keep_A,
                     self.precision)
        return A, b

    @staticmethod
    def expand_ownout(A_raw: torch.Tensor, plan) -> torch.Tensor:
        """Expand a deferred own-out Gram (see gram_and_rhs defer_ownout):
        (P, DJ, DJ) upper class-pair blocks -> the node²-shaped A."""
        C, DJ, out_sizes, rest_sizes, perm_out = plan
        iu, ju = np.triu_indices(C)
        pidx = np.zeros((C, C), np.int64)
        pidx[iu, ju] = np.arange(len(iu))
        pidx[ju, iu] = pidx[iu, ju]
        Afull = A_raw[torch.as_tensor(pidx.reshape(-1), device=A_raw.device)]
        Afull = Afull.reshape(C, C, DJ, DJ)
        upper = torch.as_tensor(np.triu(np.ones((C, C), bool)),
                                device=A_raw.device)
        Afull = torch.where(upper[:, :, None, None], Afull,
                            Afull.transpose(2, 3))
        A5 = Afull.reshape(out_sizes + out_sizes + rest_sizes + rest_sizes)
        return A5.permute(*perm_out)

    # ------------------------------------------------------- matrix-free tier
    # These contract at the network's matmul precision (`precision`), never
    # at the aux tier's: only the operands they are handed (environments,
    # jacobian_operands) come from the aux sites. Each is one contraction
    # over the Jacobian's operands, planned under contract's memory cap, so
    # J itself is never built. Under the model sharding each result is whole
    # on every model rank.

    def jacobian_apply(self, ni: int, operands: Sequence[Operand],
                       v: torch.Tensor) -> torch.Tensor:
        """(J v)[s, *out] as one contraction over the Jacobian operands."""
        t = self.topology
        keep = (t.sample_axis,) + t.output_axes
        ops = list(operands) + [(t.node_axes[ni], v)]
        return self._tp_contract(ops, keep, self.precision)

    def jacobian_transpose_apply(self, ni: int, operands: Sequence[Operand],
                                 u: torch.Tensor) -> torch.Tensor:
        """(Jᴴ u)[node axes] as one contraction; u axes (s, *out)."""
        t = self.topology
        u_axes = (t.sample_axis,) + t.output_axes
        ops = [(axes, arr.conj() if arr.is_complex() else arr)
               for axes, arr in operands] + [(u_axes, u)]
        out = self._tp_contract(ops, t.node_axes[ni], self.precision)
        return self._assemble(t.node_axes[ni], out)

    def prepare_jacobian(self, ni: int, operands: Sequence[Operand]
                         ) -> Optional["PreparedJacobian"]:
        """The node's Jacobian over `operands` (one chunk's
        jacobian_operands) with its fixed factors laid out once, so that
        each J v and Jᵀ u is one GEMM and a per-row product; or None where
        the split below does not hold, and jacobian_apply and
        jacobian_transpose_apply serve.

        The operands split into the carrier L, the one operand that holds
        output axes (none where the node holds them all), and the rest,
        contracted once into M[(s, b), a_M]: b the bonds L shares with the
        rest, a_M the node axes the rest holds. With a_L the node axes L
        holds and a_N the output axes on the node,
            (J v)[s, out_L, a_N] = Σ_{b, a_L} L[s, out_L, b, a_L] (M V)[(s, b), (a_L, a_N)]
        with V = v as an a_M × (a_L, a_N) matrix, and Jᵀ u the same steps
        in reverse. Taken where every node axis lies on exactly one of L,
        the rest and the output axes, the sample axis on L and the rest,
        and M holds no more elements than S·D (|b| ≤ |a_L|·|a_N|) and than
        contract's cap: past S·D, as at the conv-TT's conv blocks, whose
        bridge r is wider than their own bond CB, each GEMM would read more
        of M than the einsums compute. Declined under the model sharding
        and for complex operands."""
        t = self.topology
        s = t.sample_axis
        node = t.node_axes[ni]
        outs = t.output_axes
        if (self.model_blocks or len(set(node)) != len(node)
                or any(arr.is_complex() for _, arr in operands)):
            return None
        carriers = [op for op in operands if set(op[0]) & set(outs)]
        if len(carriers) > 1:
            return None
        L = carriers[0] if carriers else None
        rest = [op for op in operands if op is not L]
        L_axes = L[0] if L is not None else (s,)
        rest_axes = {a for ax, _ in rest for a in ax}
        out_L = tuple(a for a in outs if a in L_axes)
        a_N = tuple(a for a in node if a in outs)
        a_L = tuple(a for a in node if a in L_axes)
        a_M = tuple(a for a in node if a in rest_axes)
        b = tuple(a for a in L_axes if a != s and a not in out_L + a_L)
        if (s not in rest_axes or s not in L_axes or len(set(L_axes)) != len(L_axes)
                or sorted(out_L + a_N) != sorted(outs)
                or sorted(a_L + a_M + a_N) != sorted(node)
                or any(a not in rest_axes for a in b)):
            return None
        size = dict(t.axis_size)
        for ax, arr in operands:
            size.update(zip(ax, arr.shape))
        S = size[s]
        nb, nM = math.prod(size[a] for a in b), math.prod(size[a] for a in a_M)
        cap = max_elems()
        if (nb > math.prod(size[a] for a in a_L + a_N)
                or (cap > 0 and S * nb * nM > cap)):
            return None
        M = contract(rest, (s,) + b + a_M, self.precision).contiguous().view(S * nb, nM)
        Lm = None
        if L is not None:
            Lm = L[1].permute(*[L_axes.index(a) for a in (s,) + out_L + b + a_L])
            Lm = Lm.contiguous().view(S, math.prod(size[a] for a in out_L), -1)

        def layout(axes, order):
            return ([axes.index(a) for a in order], tuple(size[a] for a in order),
                    [order.index(a) for a in axes])
        return PreparedJacobian(M, Lm, layout(node, a_L + a_N + a_M),
                                layout((s,) + outs, (s,) + out_L + a_N), self.precision)

    def hessian_apply(self, hess: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """H u over the output axes; diagonal (ndim == u.ndim) or full."""
        if hess.ndim == u.ndim:
            return hess * u
        t = self.topology
        s = t.sample_axis
        out = t.output_axes
        H_axes = (s,) + out + tuple(_prime(a) for a in out)
        u_axes = (s,) + tuple(_prime(a) for a in out)
        return contract([(H_axes, hess), (u_axes, u)], (s,) + out,
                        self.precision)

    def gram_matvec(self, ni: int, J: Operand, hess: torch.Tensor,
                    grad_ndim: int, v: torch.Tensor) -> torch.Tensor:
        """(Jᴴ H J) v from a built J without materialising A: coeff = H (J v),
        then Av = Jᴴ coeff."""
        t = self.topology
        J_axes, J_arr = J
        node_axes = t.node_axes[ni]
        out_axes = t.output_axes
        s = t.sample_axis
        coeff_keep = (s,) + out_axes
        Jv = self._tp_contract([(J_axes, J_arr), (node_axes, v)], coeff_keep,
                               self.precision)
        if hess.ndim == grad_ndim:
            coeff = hess * Jv
        else:
            H_axes = (s,) + tuple(_prime(a) for a in out_axes) + out_axes
            coeff = contract([(H_axes, hess),
                              ((s,) + tuple(_prime(a) for a in out_axes), Jv)],
                             coeff_keep, self.precision)
        Jc = J_arr.conj() if J_arr.is_complex() else J_arr
        return self._assemble(node_axes, self._tp_contract(
            [(J_axes, Jc), (coeff_keep, coeff)], node_axes, self.precision))


class PreparedJacobian:
    """One chunk's Jacobian of a node with its fixed factors laid out
    (`Network.prepare_jacobian`): M, (S·b) × a_M, and the carrier Lm,
    S × out_L × (b·a_L), or None. `apply` and `transpose_apply` equal
    jacobian_apply and jacobian_transpose_apply up to the order of their
    sums: each one GEMM over M, whose other operand is a view of v or of
    the per-row product, and one batched product with Lm. `v_layout` and
    `u_layout` (permutation, shape, inverse) take v to (a_L, a_N, a_M) and
    J v's (s, *out) to (s, out_L, a_N), and back."""

    def __init__(self, M, Lm, v_layout, u_layout, precision):
        self.M, self.Lm, self.precision = M, Lm, precision
        self._v_perm, self._v_shape, self._v_back = v_layout
        self._u_perm, self._u_shape, self._u_back = u_layout

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """(J v)[s, *out]: Y = M @ V, then the per-row sum with L over (b, a_L)."""
        V = v.permute(*self._v_perm).reshape(-1, self.M.shape[1])
        Y = matmul(self.M, V.T, self.precision)
        if self.Lm is not None:
            S, _, bL = self.Lm.shape
            Y = matmul(self.Lm, Y.view(S, bL, -1), self.precision)
        return Y.reshape(self._u_shape).permute(*self._u_back)

    def transpose_apply(self, u: torch.Tensor) -> torch.Tensor:
        """(Jᵀ u)[node axes]: Z, the per-row product of u with L, then Zᵀ @ M."""
        U = u.permute(*self._u_perm)
        if self.Lm is not None:
            S, O, _ = self.Lm.shape
            U = matmul(self.Lm.transpose(1, 2), U.reshape(S, O, -1), self.precision)
        W = matmul(U.reshape(self.M.shape[0], -1).T, self.M, self.precision)
        return W.reshape(self._v_shape).permute(*self._v_back)


def _flat_gram(J3: torch.Tensor, W: torch.Tensor, diag: bool,
               precision: str) -> torch.Tensor:
    """A = sum_s J3ᴴ W J3 over (sample, class) rows, as one flat matmul at
    `precision`."""
    S, C, D = J3.shape
    if diag:
        K = J3 * W[..., None].to(J3.dtype)
    else:
        K = matmul(W.to(J3.dtype).transpose(1, 2), J3, precision).to(J3.dtype)
    Jc = J3.conj() if J3.is_complex() else J3
    return matmul(Jc.reshape(S * C, D).T, K.reshape(S * C, D), precision).to(
        torch.promote_types(J3.dtype, K.dtype))


def _embed_diag(hess_diag: torch.Tensor) -> torch.Tensor:
    """(B, *out) diagonal Hessian -> (B, *out, *out) full form."""
    B = hess_diag.shape[0]
    out_shape = tuple(hess_diag.shape[1:])
    C = 1
    for d in out_shape:
        C *= d
    full = torch.diag_embed(hess_diag.reshape(B, C))
    return full.reshape((B,) + out_shape + out_shape)
