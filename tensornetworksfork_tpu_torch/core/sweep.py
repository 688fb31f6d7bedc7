"""Accumulating sweep optimizer (port of tensornetworksfork_tpu/core/sweep.py).

Each node update accumulates the Gauss-Newton system A, b over the data
chunks, solves it and applies the step (the dense branch). The matrix-free
branch (method cg | minres | lanczos) never forms A: it freezes each
chunk's loss linearisation and runs a Krylov solve (`krylov.py`) whose
matvec sums Jᵀ·H·(J·v) over the chunks through the engine's contractions,
warm-started from the node's previous solution. The gradient branch takes
one steepest-descent step per chunk, in sequence. The JAX package
jit-compiles one program per (node, direction) around a `lax.scan` over
chunks; here the chunk loop is a Python loop and every route decision the
JAX package takes at trace time is a plain Python decision taken before
the loop.

- Environments are carried between node updates: far-side environments are
  computed once per column-monotone run, the near side advances one column
  at a time, and every computed environment is kept in a per-side history
  with the param tensors it contracted, so a later far chain whose params
  are unchanged is reused instead of recomputed.
- A failed solve keeps the node's old value (`where(ok, new, old)`); the ok
  flags stay on the device and are read with ONE host sync per half-pass
  (`_flush_ok`), as in the JAX package.

- With `orthonormalize`, each main core updated in a column-monotone run
  is QR-gauged toward the run's direction (`gauges.py`), and the far
  environment of the neighbour that took the triangular factor is
  recomputed (and recorded): a history entry made from the neighbour's old
  tensor no longer matches it by identity, so it is never handed back.

- A member with no input node (its data baked in as CONST nodes, e.g.
  `CompressedTensorTrainLayer`) takes a standalone full-batch update: its
  Jacobian contracts every other node at once, with no chunks and no
  environments; inside a type-I sum the other members' cached outputs are
  its rest term, and its own forward, padded and chunked, feeds theirs.

- Under a 1-D data mesh (`run(mesh=)`, parallel/mesh.py) each rank keeps
  its block of every chunk's rows and accumulates its own sums with the
  kernels; each is summed over the ranks once per node update (A's carry
  or deferred own-out block before it is finished, b and the loss; in the
  matrix-free branch b, the loss and every matvec), and the solve runs
  replicated. An input-less member's update sees every row on every rank
  and is not summed. Branches that decide whether collectives run (the
  timeout, convergence, the singular flag) take rank 0's decision.
- Under a 2-D (data x model) mesh with `model_axis_labels` the input axes
  of those labels are sharded over the model axis as well, and the
  networks sum over the model group where a contraction sums them
  (`Network.shard_model`): the environments, Jacobians and predictions of
  a data shard's rows are whole on each of its model ranks. The dense
  branch then gives each rank its block of those rows with all of J's
  columns (`Network.rows_for_gram`: the rows a 1-D mesh of every rank would
  give it) and sums A, b and the loss over every rank, as the 1-D mesh
  does; the matrix-free and gradient branches, whose sums are whole on the
  model ranks, sum over the data axis alone.

- Spans (`utils/timing.py` `span`: under a running profiler with
  TNF_SPANS=1, else one profiler check each where no profiler runs) mark
  the layers for a `torch.profiler` trace: `tnf.sweep.run` a call;
  `tnf.env.far`, `tnf.env.advance` and `tnf.env.gauge` the environments;
  `tnf.update:<node>` a node update, and inside it `tnf.update.jacobian`
  (Jacobian, prediction, loss terms), `tnf.update.gram` (A and b, their
  finish and mesh sums) and `tnf.solve` (the factor and solve, or the
  Krylov solve, in which `tnf.krylov.matvec` is each matvec and
  `krylov.py`'s `tnf.krylov.check` each host read of the loop's flag);
  `tnf.member_forward` a sum's cached member outputs;
  `tnf.sync.flush_ok` and `tnf.sync.loss` the waits on the device.
  `solve_block` is looked up at each call, so a caller may wrap it.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.cuda import gram as kgram
from ..parallel import mesh as pmesh
from ..utils.timing import span
from . import gauges, krylov
from .contract import contract
from .engine import Network
from .solve import apply_update, cpd_diag_mask, solve_block
from .topology import INPUT, PARAM


@dataclasses.dataclass
class SweepConfig:
    """The sweep's settings, as in the JAX package."""

    num_swipes: int = 1
    batch_size: int = -1  # chunk size; <=0 means full batch
    method: str = "ridge_cholesky"
    eps: object = 1e-12  # float or per-half-sweep list
    eps_decay: Optional[float] = None
    eps_per_node: bool = False
    lr: float = 1.0
    direction: str = "l2r"
    skip_second: bool = False
    orthonormalize: bool = False
    adaptive_step: bool = False
    max_norm: Optional[float] = None
    timeout: Optional[float] = None
    refine: bool = False
    solve_dtype: Optional[str] = None
    max_iter: int = 50
    tol: float = 1e-6
    verbose: int = 0


ITERATIVE_METHODS = ("cg", "minres", "lanczos")
# the span of a timer phase, where it is not "tnf.<phase>"
_PHASE_SPANS = {"far_envs": "tnf.env.far", "advance": "tnf.env.advance"}
# environments retained across node updates for two-sided reuse; beyond this
# many bytes new entries are dropped (recomputed later instead)
ENV_HISTORY_MAX_BYTES = 4 * 1024 ** 3


class Member:
    """One network of an (optional) type-I sum. `input_fn` adapts the global
    x to this member's inputs. `train` selects which nodes sweep: 'train' =
    the topology's train nodes, 'main' = main nodes only."""

    def __init__(self, net: Network, input_fn: Optional[Callable] = None,
                 train: str = "train"):
        self.net = net
        self.input_fn = input_fn or (lambda x: net.bind_inputs(x))
        self.train_nodes = (net.topology.train_nodes if train == "train"
                            else net.topology.main_nodes)


def _merge(a: torch.Tensor, spos: int) -> torch.Tensor:
    """(nc, ...) with the sample axis at piece dim `spos` -> (1, ...) with
    nc*B samples there (the chunk axis moved next to the sample axis)."""
    if spos == 0:
        return a.reshape((1, a.shape[0] * a.shape[1]) + tuple(a.shape[2:]))
    perm = (list(range(1, spos + 1)) + [0, spos + 1]
            + list(range(spos + 2, a.ndim)))
    at = a.permute(*perm)
    shape = (tuple(at.shape[:spos]) + (at.shape[spos] * at.shape[spos + 1],)
             + tuple(at.shape[spos + 2:]))
    return at.reshape(shape)[None]


def _stack(chunks):
    return None if chunks[0] is None else torch.stack(chunks)


class Sweeper:
    # on a CUDA device without a mesh, each matrix-free update records its
    # matvec as a CUDA graph at the first call and replays it after
    # (`_record_matvec`)
    graph_matvecs = True

    def __init__(self, members, loss_fn, cfg: SweepConfig):
        if isinstance(members, Network):
            members = [Member(members)]
        self.members: List[Member] = list(members)
        self.loss_fn = loss_fn
        self.cfg = cfg
        # per-phase wall-clock attribution (TNF_SWEEP_TIMERS=1): each phase
        # is synchronised on the device, so totals are for attribution only
        self.timers: Dict[str, List[float]] = {}
        self._timing = os.environ.get("TNF_SWEEP_TIMERS", "0") == "1"
        # two-sided stack reuse: every computed environment is recorded per
        # (member, side, column) together with the param tensors it
        # contracted (references, compared by identity: updates replace the
        # dict entries with new tensors)
        self._near_hist: Dict = {}
        self._near_hist_bytes = 0
        self._hist_aux = None  # the TNF_AUX_PRECISION the history was made at
        self._data_cache = None
        # deferred per-node ok flags (device tensors) — see _flush_ok
        self._pending_ok: List = []
        # matrix-free warm starts: the last solution of each (member, node),
        # kept for the life of the Sweeper
        self._node_sols: Dict = {}
        # (member, node name, k) of each Krylov solve, k a device tensor
        # (read it after the run: reading it here would sync every update)
        self.krylov_iters: List = []
        # matvecs launched per (member, node name), over the Sweeper's life:
        # the residual, the scale probe and every iteration the loop ran,
        # the masked ones past convergence included (k counts none of those)
        self.krylov_matvecs: Dict[Tuple[int, str], int] = {}
        # of those, the matvecs whose J v and Jᵀ u ran as GEMMs over the
        # factors prepared once an update (`Network.prepare_jacobian`)
        self.krylov_prepared: Dict[Tuple[int, str], int] = {}
        # [graph memory pool, capture stream, last graph] of the matvec
        # graphs, made at the first one
        self._graph_kit = None
        # the data mesh of the current run (None: one process)
        self._mesh = None

    def _defer_ok(self, ok, name: str) -> None:
        self._pending_ok.append((ok, name))

    def _flush_ok(self) -> bool:
        """ONE host fetch for all deferred per-node singular flags. Updates
        guard themselves (where(ok, new, old)), so detection can wait until
        the end of the half-pass; run() still returns False."""
        if not self._pending_ok:
            return True
        pending, self._pending_ok = self._pending_ok, []
        with span("tnf.sync.flush_ok"):
            oks = torch.stack([o for o, _ in pending]).to("cpu", torch.int32)
            if self._mesh is not None:  # rank 0's flags: every rank stops alike
                oks = pmesh.replicate(oks, self._mesh)
        if bool(oks.all()):
            return True
        if self.cfg.verbose > 0:
            bad = pending[int(torch.argmin(oks.int()))][1]
            print(f"Singular system for node {bad}")
        if self.cfg.solve_dtype is None:
            warnings.warn(
                "Singular/non-finite solve in an f32 sweep. The f32 tier's "
                "supported eps floor is ~1e-6 on a unit-rescaled Gram; for "
                "the reference's deep-eps corners (eps<=1e-9, high condition "
                "number) set SweepConfig.solve_dtype='float64' (estimator "
                "kwarg solve_dtype) to run the solve in float64.",
                RuntimeWarning, stacklevel=2)
        return False

    def _timed(self, phase: str, fn, *args):
        """`fn(*args)` inside the phase's span; with TNF_SWEEP_TIMERS=1
        synchronised and added to `timers[phase]`."""
        with span(_PHASE_SPANS.get(phase, f"tnf.{phase}")):
            if not self._timing:
                return fn(*args)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        acc = self.timers.setdefault(phase, [0.0, 0])
        acc[0] += time.perf_counter() - t0
        acc[1] += 1
        return out

    def timer_report(self) -> str:
        rows = sorted(self.timers.items(), key=lambda kv: -kv[1][0])
        total = sum(v[0] for v in self.timers.values())
        lines = [f"{'phase':<28} {'total_s':>8} {'calls':>6} {'ms/call':>8}"]
        for k, (s, n) in rows:
            lines.append(f"{k:<28} {s:>8.3f} {n:>6d} {s/n*1e3:>8.1f}")
        lines.append(f"{'TOTAL':<28} {total:>8.3f}")
        return "\n".join(lines)

    def _sum_ranks(self, *ts) -> None:
        """Sums each tensor over the mesh's ranks, in place (nothing without
        a mesh)."""
        if self._mesh is not None:
            for t in ts:
                pmesh.all_reduce_sum(t, self._mesh)

    def _sum_data(self, *ts) -> None:
        """Sums each tensor over the mesh's data axis, in place: sums whole
        on the model ranks of a 2-D mesh (on a 1-D mesh, every rank)."""
        if self._mesh is not None:
            for t in ts:
                pmesh.all_reduce_sum(t, self._mesh, self._mesh.axis_names[0])

    def _model_mesh(self):
        """The mesh when it has a model axis (the 2-D mesh), else None."""
        m = self._mesh
        return m if m is not None and "model" in m.axis_names else None

    # ------------------------------------------------------------------ data
    def _prepare(self, x, y, sample_weight, mesh=None, model_labels=()):
        """Pads the sample axis and stores everything pre-chunked as
        (nchunks, B, ...); padding rows carry weight 0. With a mesh, B is
        rounded up to a multiple of its size (d x m on a 2-D mesh: the Gram
        stage splits a data shard's rows over the model ranks, and the port
        has no unsharded product to fall back on when they do not split;
        the padding rows weigh 0, so no sum changes) and each rank keeps its
        data block of every chunk's rows (`shard_chunked`), and with
        `model_labels` its model block of those input axes
        (`shard_chunked_inputs`); the full chunked y and w are kept as well
        for input-less members, whose updates see every row."""
        S = int(y.shape[0])
        B = self.cfg.batch_size
        if B is None or B <= 0 or B > S:
            B = S
        if mesh is not None:
            B = ((B + mesh.size - 1) // mesh.size) * mesh.size
        P = ((S + B - 1) // B) * B
        pad = P - S

        def chunk(a):
            a = torch.as_tensor(a)
            if pad:
                a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], 0)
            return a.reshape((P // B, B) + tuple(a.shape[1:]))

        w = (torch.ones((S,), dtype=torch.float32, device=y.device)
             if sample_weight is None
             else torch.as_tensor(sample_weight, dtype=torch.float32,
                                  device=y.device))
        # members handed the same input tensor share one chunked copy (the
        # sources stay referenced here, so identity cannot be recycled)
        chunked: List[Tuple[torch.Tensor, torch.Tensor]] = []

        def chunk_once(v):
            for src, dst in chunked:
                if src is v:
                    return dst
            chunked.append((v, chunk(v)))
            return chunked[-1][1]

        data = {
            "y": chunk(y),
            "w": chunk(w),
            "inputs": [{k: chunk_once(v) for k, v in m.input_fn(x).items()}
                       for m in self.members],
            "S": S, "B": B, "P": P,
        }
        if mesh is not None:
            if any(not m.net.topology.input_nodes for m in self.members):
                data["y_full"], data["w_full"] = data["y"], data["w"]
            data["y"], data["w"] = pmesh.shard_chunked((data["y"], data["w"]), mesh)
            # members sharing a chunked input (and its labels) share its
            # shard too
            shards: Dict = {}

            def shard_once(v, labels):
                if (id(v), labels) not in shards:
                    shards[id(v), labels] = pmesh.shard_chunked_inputs(
                        {"v": v}, mesh, {"v": labels}, model_labels)["v"]
                return shards[id(v), labels]
            for mi, m in enumerate(self.members):
                t = m.net.topology
                labels = {t.nodes[ni].name: tuple(lb for lb in t.nodes[ni].labels
                                                  if lb != t.sample_dim)
                          for ni in t.input_nodes}
                data["inputs"][mi] = {k: shard_once(v, labels.get(k, ()))
                                      for k, v in data["inputs"][mi].items()}
        return data

    def _prepare_cached(self, x, y, sample_weight, mesh=None, model_labels=()):
        """_prepare memoised on input identity and the mesh: repeated run()
        calls on the same tensors skip re-chunking and keep the environment
        history valid across epochs. The history is keyed on
        TNF_AUX_PRECISION as well (environments depend on the contraction
        precision), as in the JAX package."""
        aux = os.environ.get("TNF_AUX_PRECISION", "")
        mesh_key = None if mesh is None else (tuple(mesh.shape.items()), mesh.rank,
                                              str(mesh.device), tuple(model_labels))
        key = (x, y, sample_weight, mesh_key, self.cfg.batch_size)
        data = None
        if self._data_cache is not None:
            (ox, oy, ow, omk, ob), cached = self._data_cache
            if (ox is x and oy is y and ow is sample_weight and omk == mesh_key
                    and ob == self.cfg.batch_size):
                data = cached
        if data is None:
            data = self._prepare(x, y, sample_weight, mesh, model_labels)
            self._data_cache = (key, data)
        elif self._hist_aux == aux:
            return data
        # recorded environments were computed from other data, or at
        # another precision
        self._hist_aux = aux
        self._near_hist.clear()
        self._near_hist_bytes = 0
        return data

    # --------------------------------------------------------- environments
    @staticmethod
    def _chunk_inputs(inputs, c):
        return {k: v[c] for k, v in inputs.items()}

    def _far_envs(self, mid: int, direction: str, params, inputs):
        """Chunked environment chain: per column a (nc, ...) tensor or None
        (the terminal entry is skipped: no consumer reads it)."""
        net = self.members[mid].net
        nc = next(iter(inputs.values())).shape[0]
        per_chunk = [
            [None if e is None else e[1]
             for e in net.env_chain(params, self._chunk_inputs(inputs, c),
                                    direction, skip_last=True)]
            for c in range(nc)]
        return [_stack([pc[ci] for pc in per_chunk])
                for ci in range(len(per_chunk[0]))]

    def _advance(self, mid: int, ci: int, direction: str, params, prev, inputs):
        net = self.members[mid].net
        ncols = len(net.topology.columns)
        if direction == "left":
            cols = tuple(range(0, ci + 1))
            prev_axes = net.env_keep(tuple(range(0, ci)))
        else:
            cols = tuple(range(ci, ncols))
            prev_axes = net.env_keep(tuple(range(ci + 1, ncols)))
        nc = next(iter(inputs.values())).shape[0]
        return torch.stack([
            net.env_step(None if prev is None else (prev_axes, prev[c]), ci,
                         params, self._chunk_inputs(inputs, c), cols)[1]
            for c in range(nc)])

    def _env_axes(self, mid: int, side: str, ci: int):
        net = self.members[mid].net
        ncols = len(net.topology.columns)
        if side == "left":
            return net.env_keep(tuple(range(0, ci + 1)))
        return net.env_keep(tuple(range(ci, ncols)))

    # ---------------------------------------------------------------- update
    def _update(self, mid: int, ni: int, method: str, use_rest: bool,
                return_pred: bool, params, L, R, inputs, y, w, y_rest, eps,
                x0=None):
        """One node update. Returns (new_core, loss_sum, ok, pred, x_sol):
        loss_sum and ok stay on the device; pred is the chunked
        (nchunks, B, *out) member output after the update, if asked for;
        x_sol is the matrix-free branch's solution (zeros where the update
        failed), its warm start at the node's next visit."""
        cfg = self.cfg
        net = self.members[mid].net
        t = net.topology
        ci = t.col_of[ni]
        ncols = len(t.columns)
        name = t.nodes[ni].name
        spec = t.nodes[ni]
        has_left, has_right = ci > 0, ci < ncols - 1
        L_axes = self._env_axes(mid, "left", ci - 1) if has_left else None
        R_axes = self._env_axes(mid, "right", ci + 1) if has_right else None
        loss_fn = self.loss_fn
        gradient_mode = method == "gradient"
        core = params[name]
        mask = None
        if spec.cpd_mask:
            mask = cpd_diag_mask(core.shape, spec.labels, spec.left, spec.right,
                                 core.dtype, core.device)
        col_inputs = tuple(t.nodes[nj].name for nj in t.columns[ci]
                           if t.nodes[nj].kind == INPUT)
        pieces = {"x": {k: inputs[k] for k in col_inputs}, "y": y, "w": w}
        if has_left:
            pieces["L"] = L
        if has_right:
            pieces["R"] = R
        if use_rest:
            pieces["rest"] = y_rest

        # Full-batch merge for small-D nodes: all chunks become ONE chunk
        # when the full-batch J stays under TNF_FULLBATCH_MAX_BYTES (default
        # 512 MB, 0 disables), itemsize 2 under the bf16/int8 tiers — the
        # JAX package's rule, so both take the same route. Never in gradient
        # mode, whose chunks update the node in sequence.
        nc0 = y.shape[0]
        merged = False
        if nc0 > 1 and not gradient_mode:
            out_elems = 1
            for d in y.shape[2:]:
                out_elems *= d
            jbytes = (nc0 * y.shape[1] * out_elems * core.numel()
                      * (2 if kgram.gram_dtype() is not None else 4))
            cap_s = os.environ.get("TNF_FULLBATCH_MAX_BYTES", "")
            cap = int(cap_s) if cap_s else 512 * 1024 * 1024
            if 0 < jbytes <= cap:
                s_ax = t.sample_axis
                pieces["x"] = {n: _merge(v, 0) for n, v in pieces["x"].items()}
                for k in ("y", "w", "rest"):
                    if k in pieces:
                        pieces[k] = _merge(pieces[k], 0)
                if has_left:
                    pieces["L"] = _merge(pieces["L"], L_axes.index(s_ax))
                if has_right:
                    pieces["R"] = _merge(pieces["R"], R_axes.index(s_ax))
                merged = True
        nc = pieces["y"].shape[0]

        def piece_at(c):
            return {k: ({n: v[c] for n, v in val.items()} if k == "x" else val[c])
                    for k, val in pieces.items()}

        def env_ops(piece):
            Lop = (L_axes, piece["L"]) if has_left else None
            Rop = (R_axes, piece["R"]) if has_right else None
            return Lop, Rop

        def jac_ops(piece, prms):
            return net.jacobian_operands(ni, prms, piece["x"], *env_ops(piece))

        def weighted_terms(pred, piece):
            loss, g, H = loss_fn(pred, piece["y"])
            wc = piece["w"]
            loss = loss * wc.to(loss.dtype)
            g = g * wc.to(g.dtype).reshape((-1,) + (1,) * (g.ndim - 1))
            H = H * wc.to(H.dtype).reshape((-1,) + (1,) * (H.ndim - 1))
            return loss, g, H

        # the packed-Jacobian plan, decided once from axes and sizes (the
        # JAX package probes the first chunk at trace time); a complex node
        # has none (packed_jacobian declines complex operands)
        plan = (None if method in ITERATIVE_METHODS or core.is_complex()
                else net.packed_plan(ni, net.column_operand_axes(ni, L_axes, R_axes)))
        x_sol = None
        if method in ITERATIVE_METHODS:
            chunks = [piece_at(c) for c in range(nc)]
            with span("tnf.update.jacobian"):
                ops_all = [jac_ops(piece, params) for piece in chunks]
            new_core, loss_acc, ok, x_sol = self._update_matrix_free(
                net, mid, ni, method, core, mask, eps, x0, use_rest, chunks,
                ops_all, weighted_terms)
        elif gradient_mode:
            # one steepest-descent step per chunk, in sequence; only b is
            # formed (gram_and_rhs's rhs line), never A
            cur = core
            loss_acc = torch.zeros((), dtype=torch.float32, device=core.device)
            for c in range(nc):
                piece = piece_at(c)
                with span("tnf.update.jacobian"):
                    J = net.jacobian(ni, dict(params, **{name: cur}), piece["x"],
                                     *env_ops(piece))
                    pred = net.predict_from_jacobian(ni, J, cur)
                    if use_rest:
                        pred = pred + piece["rest"]
                    loss, g, _ = weighted_terms(pred, piece)
                with span("tnf.update.gram"):
                    b = net.rhs(ni, J, g)
                    self._sum_data(b)  # this chunk's rows on every rank
                cur = apply_update(cur, -b, cfg.lr, cfg.adaptive_step,
                                   cfg.max_norm, mask)
                loss_acc = loss_acc + loss.sum()
                del J, pred, g, b
            self._sum_data(loss_acc)
            ok = torch.isfinite(cur).all()
            # singular guard (deferred-ok contract: see _flush_ok)
            new_core = torch.where(ok, cur, core)
        else:
            new_core, loss_acc, ok = self._update_dense(
                net, ni, plan, method, core, mask, eps, use_rest, nc,
                piece_at, env_ops, params, weighted_terms,
                nc0 if merged else 1)

        pred_out = None
        if return_pred:
            prms = dict(params, **{name: new_core})
            preds = []
            for c in range(nc):
                piece = piece_at(c)
                with span("tnf.update.jacobian"):
                    if method in ITERATIVE_METHODS:
                        preds.append(net.jacobian_apply(ni, jac_ops(piece, prms),
                                                        new_core))
                        continue
                    Lop, Rop = env_ops(piece)
                    pj = (net.packed_jacobian(ni, prms, piece["x"], Lop, Rop)
                          if plan is not None else None)
                    if pj is not None:
                        preds.append(net.packed_predict(pj, new_core))
                    else:
                        J = net.jacobian(ni, prms, piece["x"], Lop, Rop)
                        preds.append(net.predict_from_jacobian(ni, J, new_core))
            pred_out = torch.stack(preds)
            if merged:  # restore the (nchunks, B, *out) layout
                pred_out = pred_out.reshape((nc0, -1) + tuple(pred_out.shape[2:]))
        return new_core, loss_acc, ok, pred_out, x_sol

    def _update_dense(self, net, ni, plan, method, core, mask, eps, use_rest,
                      nc, piece_at, env_ops, params, weighted_terms, groups=1):
        """The dense branch: A and b accumulated over the chunks, one block
        solve. Returns (new_core, loss_sum, ok).

        Route: the packed Jacobian (`plan`), and with it the tiled kernel
        route whose chunk carry lives inside the Gram kernel; otherwise the
        generic Jacobian, whose own-out Gram comes back deferred for an
        output-owning node. Under a 2-D mesh each chunk's J, y, w and rest
        are cut to this rank's rows first (of each of `groups` runs, the
        chunks of a merged batch, its model block), J with all columns."""
        cfg = self.cfg
        tp = self._model_mesh()
        t = net.topology
        D = core.numel()
        A_acc = (net.packed_gram_acc_init(plan, core.device)
                 if plan is not None else None)
        in_kernel_acc = A_acc is not None
        own_all_out = (bool(t.output_axes)
                       and all(a in t.node_axes[ni] for a in t.output_axes))
        C_out = 1
        for a in t.output_axes:
            C_out *= t.axis_size[a]
        ownout = ({"plan": None} if plan is None and own_all_out and C_out > 1
                  else None)

        b_acc = torch.zeros((D,), dtype=core.dtype, device=core.device)
        loss_acc = torch.zeros((), dtype=torch.float32, device=core.device)
        for c in range(nc):
            piece = piece_at(c)
            with span("tnf.update.jacobian"):
                Lop, Rop = env_ops(piece)
                pj = (net.packed_jacobian(ni, params, piece["x"], Lop, Rop)
                      if plan is not None else None)
                J = net.jacobian(ni, params, piece["x"], Lop, Rop) if pj is None else None
                if tp is not None:
                    if pj is not None:
                        pj = net.rows_for_gram(pj, groups)
                    else:
                        J = net.rows_for_gram(J, groups)
                    piece = {k: pmesh.rows_of(v, tp, groups) for k, v in piece.items()
                             if k in ("y", "w", "rest")}
                if pj is not None:
                    pred = net.packed_predict(pj, core)
                else:
                    pred = net.predict_from_jacobian(ni, J, core)
                if use_rest:
                    pred = pred + piece["rest"]
                loss, g, H = weighted_terms(pred, piece)
            with span("tnf.update.gram"):
                if pj is not None and in_kernel_acc:
                    # the kernel adds this chunk's Gram into A_acc in place (the
                    # JAX package aliases the carry into the kernel output)
                    _, b = net.packed_gram_rhs(pj, g, H, acc=A_acc)
                    A = None
                elif pj is not None:
                    A, b = net.packed_gram_rhs(pj, g, H)
                else:
                    A, b = net.gram_and_rhs(ni, J, g, H, defer_ownout=ownout)
                    if ownout is None or ownout["plan"] is None:
                        A = A.reshape(D, D)
                    b = b.reshape(D)
                if A is not None:
                    A_acc = A if A_acc is None else A_acc + A
                b_acc = b_acc + b
                loss_acc = loss_acc + loss.sum()
            del pj, J, pred, g, H, A, b
        with span("tnf.update.gram"):
            # under a mesh: each rank's raw sums (the in-kernel carry, the
            # deferred own-out block or A) summed once, before they are finished
            self._sum_ranks(A_acc, b_acc, loss_acc)
            if in_kernel_acc:
                A = net.packed_gram_finisher(plan)(A_acc)
            elif ownout is not None and ownout["plan"] is not None:
                A = net.expand_ownout(A_acc, ownout["plan"]).reshape(D, D)
            else:
                A = A_acc
        del A_acc
        with span("tnf.solve"):
            step, ok = solve_block(A, b_acc, core, method, eps, cfg.refine,
                                   cfg.solve_dtype)
        del A
        new_core = apply_update(core, step.reshape(core.shape), cfg.lr,
                                cfg.adaptive_step, cfg.max_norm, mask)
        # singular guard (deferred-ok contract: see _flush_ok)
        return torch.where(ok, new_core, core), loss_acc, ok

    def _update_matrix_free(self, net, mid, ni, method, core, mask, eps, x0,
                            use_rest, pieces, ops_all, weighted_terms):
        """The matrix-free branch (JAX sweep.py, the ITERATIVE_METHODS
        branch of the update). Returns (new_core, loss_sum, ok, x_sol).

        Linearise: per chunk pred = J·core, the weighted loss, g and H,
        b = Jᵀg; every chunk's H is kept. Matvec: Σ over chunks of
        Jᵀ·H·(J·v), J v and Jᵀ u one GEMM each over the chunk's factors
        laid out once an update (`Network.prepare_jacobian`) where the
        engine can split them, else its einsums. Then the ridge and one
        scale probe along b, the Krylov solve from x0, and the singular
        guard. No Gram kernel runs: A is never formed. The scale probe runs
        the matvec eagerly; on a CUDA device without a mesh the later ones
        replay it as a CUDA graph (`graph_matvecs`, `_record_matvec`)."""
        cfg = self.cfg
        b_rhs = torch.zeros(core.shape, dtype=core.dtype, device=core.device)
        loss_acc = torch.zeros((), dtype=torch.float32, device=core.device)
        with span("tnf.krylov.prepare"):
            preps = [net.prepare_jacobian(ni, ops) for ops in ops_all]
        prepared = all(p is not None for p in preps)
        # each chunk's (J v, Jᵀ u)
        jac = [(p.apply, p.transpose_apply) if p is not None else
               (functools.partial(net.jacobian_apply, ni, ops),
                functools.partial(net.jacobian_transpose_apply, ni, ops))
               for p, ops in zip(preps, ops_all)]
        H_all = []
        for piece, (jv, jtu) in zip(pieces, jac):
            with span("tnf.update.jacobian"):
                pred = jv(core)
                if use_rest:
                    pred = pred + piece["rest"]
                loss, g, H = weighted_terms(pred, piece)
            with span("tnf.update.gram"):
                b_rhs = b_rhs + jtu(g)
                loss_acc = loss_acc + loss.sum()
            H_all.append(H)
        with span("tnf.update.gram"):
            self._sum_data(b_rhs, loss_acc)
        key = (mid, net.topology.nodes[ni].name)
        self.krylov_matvecs.setdefault(key, 0)
        self.krylov_prepared.setdefault(key, 0)

        def matvec_eager(v_flat):
            v = v_flat.reshape(core.shape)
            Av = torch.zeros(core.shape, dtype=core.dtype, device=core.device)
            for (jv, jtu), H in zip(jac, H_all):
                Av = Av + jtu(net.hessian_apply(H, jv(v)))
            # one all-reduce a matvec: every rank's Krylov iterates and
            # stopping tests see the same numbers
            self._sum_data(Av)
            return Av.reshape(-1)

        replay = None

        def matvec_raw(v_flat):
            nonlocal replay
            self.krylov_matvecs[key] += 1
            self.krylov_prepared[key] += prepared
            with span("tnf.krylov.matvec"):
                if replay is not None:
                    return replay(v_flat)
                out = matvec_eager(v_flat)
                if self.graph_matvecs and core.is_cuda and self._mesh is None:
                    replay = self._record_matvec(matvec_eager, v_flat)
                return out

        # The ridge (the reference's iterative tier has none) and a scale
        # normalisation, so that f32 iterates cannot overflow on an
        # ill-conditioned system: the dense branch's diagonal-mean rescale
        # needs A, so ||A|| is estimated along b with one probe.
        with span("tnf.solve"):
            two_eps = 2.0 * torch.tensor(eps, dtype=core.dtype, device=core.device)
            b_aug = b_rhs.reshape(-1) + two_eps * core.reshape(-1)
            unit = b_aug / torch.clamp(torch.linalg.vector_norm(b_aug), min=1e-30)
            scale = torch.linalg.vector_norm(matvec_raw(unit) + two_eps * unit)
            scale = torch.where(scale <= 0, torch.ones_like(scale), scale)

            def matvec(v_flat):
                return (matvec_raw(v_flat) + two_eps * v_flat) / scale

            b_flat = -b_aug / scale
            if x0 is None:
                x0 = torch.zeros((core.numel(),), dtype=core.dtype, device=core.device)
            if method == "lanczos":
                x_sol = krylov.lanczos_galerkin(matvec, b_flat, x0, cfg.max_iter,
                                                cfg.tol)
                iters = torch.tensor(cfg.max_iter)
            else:
                x_sol, iters = krylov.SOLVERS[method](matvec, b_flat, x0=x0,
                                                      maxiter=cfg.max_iter,
                                                      tol=cfg.tol)
        self.krylov_iters.append((*key, iters))
        new_core = apply_update(core, x_sol.reshape(core.shape), cfg.lr,
                                cfg.adaptive_step, cfg.max_norm, mask)
        ok = torch.isfinite(new_core).all()
        # singular guard (deferred-ok contract: see _flush_ok)
        new_core = torch.where(ok, new_core, core)
        x_sol = torch.where(ok, x_sol, torch.zeros_like(x_sol))
        return new_core, loss_acc, ok, x_sol

    def _record_matvec(self, matvec, like: torch.Tensor):
        """`matvec` recorded as a CUDA graph: returns v -> matvec(v), whose
        result is a buffer that the next call overwrites. Its ~300 kernels
        a matvec then cost the host one launch, so the card runs the Krylov
        loop without waiting for the host. The graphs of all updates share
        one memory pool and one capture stream; the last graph is kept, so
        that the pool lives on to the next capture (a pool no graph holds
        is released), and is never replayed again. The low-level capture
        skips `torch.cuda.graph`'s synchronise, gc and cache release, which
        would drain the card at every update."""
        dev = like.device
        if self._graph_kit is None:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                # the capture stream's first use (cuBLAS handle and
                # workspace) outside any capture
                matvec(like)
            torch.cuda.current_stream(dev).wait_stream(side)
            self._graph_kit = [torch.cuda.graph_pool_handle(), side, None]
        pool, side, _ = self._graph_kit
        v_in = like.clone()
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                out = matvec(v_in)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graph_kit[2] = graph

        def replay(v_flat):
            v_in.copy_(v_flat)
            graph.replay()
            return out
        return replay

    def _update_standalone(self, mid: int, ni: int, method: str,
                           use_rest: bool, params, y, w, y_rest, eps):
        """Full-batch update of a node of a member with no input node (its
        data are CONST nodes whose last bond is the sample axis): J
        contracts every other node directly, with no chunks and no
        environments. The chunked y, w and rest may carry padding rows past
        the member's baked-in sample count; they are dropped (they weigh 0
        anyway). Returns (new_core, loss_sum, ok)."""
        cfg = self.cfg
        net = self.members[mid].net
        t = net.topology
        spec = t.nodes[ni]
        core = params[spec.name]
        mask = None
        if spec.cpd_mask:
            mask = cpd_diag_mask(core.shape, spec.labels, spec.left, spec.right,
                                 core.dtype, core.device)
        with span("tnf.update.jacobian"):
            ops = [net.operand(nj, params, {}) for nj in range(len(t.nodes)) if nj != ni]
            keep = net.jacobian_keep(ni, [ax for ax, _ in ops])
            J = (keep, contract(ops, keep, net.precision))
            pred = net.predict_from_jacobian(ni, J, core)
            n = pred.shape[0]
            y_f = y.reshape((-1,) + tuple(y.shape[2:]))[:n]
            w_f = w.reshape(-1)[:n]
            if use_rest:
                pred = pred + y_rest.reshape((-1,) + tuple(y_rest.shape[2:]))[:n]
            loss, g, H = self.loss_fn(pred, y_f)
            loss = loss * w_f.to(loss.dtype)
            g = g * w_f.to(g.dtype).reshape((-1,) + (1,) * (g.ndim - 1))
            H = H * w_f.to(H.dtype).reshape((-1,) + (1,) * (H.ndim - 1))
        with span("tnf.update.gram"):
            A, b = net.gram_and_rhs(ni, J, g, H)
        D = core.numel()
        with span("tnf.solve"):
            step, ok = solve_block(A.reshape(D, D), b.reshape(D), core, method, eps,
                                   cfg.refine, cfg.solve_dtype)
        new_core = apply_update(core, step.reshape(core.shape), cfg.lr,
                                cfg.adaptive_step, cfg.max_norm, mask)
        # singular guard (deferred-ok contract: see _flush_ok)
        return torch.where(ok, new_core, core), loss.sum(), ok

    def _member_forward_chunked(self, mi: int, params_list, data):
        """Chunked (nc, B, *out) forward of member `mi` (under a mesh, this
        rank's rows of each chunk); a member with no input node is padded to
        the chunked sample count P first."""
        net = self.members[mi].net
        if not net.topology.input_nodes:
            def standalone():
                out = net.forward(params_list[mi], {})
                pad = data["P"] - out.shape[0]
                if pad:
                    out = torch.cat([out, out.new_zeros((pad,) + tuple(out.shape[1:]))])
                out = out.reshape((data["P"] // data["B"], data["B"])
                                  + tuple(out.shape[1:]))
                # the other members see this rank's rows of each chunk
                return out if self._mesh is None else pmesh.shard_chunked(out, self._mesh)
            return self._timed("member_forward", standalone)
        inputs = data["inputs"][mi]
        nc = next(iter(inputs.values())).shape[0]
        return self._timed("member_forward", lambda: torch.stack([
            net.forward(params_list[mi], self._chunk_inputs(inputs, c))
            for c in range(nc)]))

    # ------------------------------------------------------------------- run
    def run(self, params_list, x, y, *, sample_weight=None,
            convergence_criterion=None, block_callback=None, loss_callback=None,
            node_order: Optional[Sequence] = None, mesh=None,
            model_axis_labels: Sequence[str] = ()):
        """Runs num_swipes * (first pass, second pass). Returns
        (params_list, success) — success False on timeout or singular solve.

        mesh: a mesh of parallel.mesh.make_mesh. A 1-D data mesh shards the
        samples over its ranks. A 2-D (data, model) mesh shards them over
        the data axis and, with `model_axis_labels` (topology labels, e.g.
        ("patches",)), those input axes over the model axis: tensor
        parallelism with explicit collectives (module docstring); the
        params stay replicated. Every rank calls run with the same full x
        and y and the same params (rank 0's are broadcast), and ends with
        the same params. Raises ValueError for model axis labels without a
        model axis, and for a labelled axis that does not split over it."""
        model_axis_labels = tuple(model_axis_labels)
        if model_axis_labels and (mesh is None or "model" not in mesh.axis_names):
            raise ValueError(f"model axis labels {model_axis_labels} need a mesh with a "
                             f"'model' axis, not {None if mesh is None else mesh.axis_names}")
        self._mesh = mesh
        try:
            for m in self.members:
                # input-less members keep no model sharding (no input to shard)
                m.net.shard_model(mesh if m.net.topology.input_nodes else None,
                                  model_axis_labels)
            with span("tnf.sweep.run"):
                return self._run(params_list, x, y, sample_weight, convergence_criterion,
                                 block_callback, loss_callback, node_order,
                                 model_axis_labels)
        finally:
            self._mesh = None
            for m in self.members:
                m.net.shard_model(None)

    def _run(self, params_list, x, y, sample_weight, convergence_criterion,
             block_callback, loss_callback, node_order, model_labels):
        cfg = self.cfg
        mesh = self._mesh
        if isinstance(params_list, dict):
            params_list = [params_list]
        params_list = list(params_list)
        if mesh is not None:
            params_list = [pmesh.replicate(p, mesh) for p in params_list]
        # live view for callbacks (convergence_criterion closures read
        # current params through sweeper.params_list)
        self.params_list = params_list
        data = self._prepare_cached(x, y, sample_weight, mesh, model_labels)
        start = time.time()

        seq = [(mi, ni) for mi, m in enumerate(self.members)
               for ni in m.train_nodes]
        if node_order is not None:
            seq = list(node_order)

        use_rest = len(self.members) > 1
        y_members = None
        if use_rest:
            y_members = [self._member_forward_chunked(mi, params_list, data)
                         for mi in range(len(self.members))]

        NS = 0
        last_other: Optional[Tuple[int, int]] = None
        for _swipe in range(cfg.num_swipes):
            for pass_idx in (0, 1):
                if pass_idx == 1 and cfg.skip_second:
                    continue
                if pass_idx == 0:
                    reversed_pass = cfg.direction != "l2r"
                else:
                    reversed_pass = cfg.direction == "l2r"
                order = list(reversed(seq)) if reversed_pass else list(seq)
                ok, stop, last_other = self._half_pass(
                    params_list, data, order, NS, last_other, use_rest,
                    y_members, start, convergence_criterion, block_callback,
                    loss_callback, reversed_pass=reversed_pass)
                NS += 1
                if not ok:
                    return params_list, False
                if stop:
                    return params_list, True
        return params_list, True

    # ------------------------------------------------------------- half pass
    def _eps_for(self, NS: int, node_i: int, n_nodes: int, reverse: bool):
        """eps for the node at position `node_i` of the current pass order.
        With eps_per_node the eps list indexes the canonical train order in
        both directions."""
        cfg = self.cfg
        if cfg.eps_per_node:
            if isinstance(cfg.eps, (list, tuple)):
                idx = node_i if not reverse else n_nodes - 1 - node_i
                return float(cfg.eps[idx])
            return float(cfg.eps)
        e = cfg.eps[NS] if isinstance(cfg.eps, (list, tuple)) else cfg.eps
        if cfg.eps_decay is not None:
            e = e * cfg.eps_decay ** NS
        return float(e)

    def _half_pass(self, params_list, data, order, NS, last_other, use_rest,
                   y_members, start, convergence_criterion, block_callback,
                   loss_callback, reversed_pass: bool = False):
        cfg = self.cfg
        self._pending_ok.clear()
        S = data["S"]
        n_nodes = len(order)

        # Segment the node sequence into maximal column-monotone runs per
        # member. Within a run the near-side env advances incrementally and
        # the far side is computed once; a fresh run starts
        # direction-neutral (trend 0).
        run_of = [0] * n_nodes
        run_trend: Dict[int, int] = {}
        cur_run = -1
        prev = None  # (member, col, trend)
        for i, (mi, ni) in enumerate(order):
            ci = self.members[mi].net.topology.col_of[ni]
            if prev is None or prev[0] != mi:
                cur_run += 1
                trend = 0
            else:
                _, pci, trend = prev
                if ci > pci:
                    if trend < 0:
                        cur_run += 1
                        trend = 0
                    else:
                        trend = 1
                elif ci < pci:
                    if trend > 0:
                        cur_run += 1
                        trend = 0
                    else:
                        trend = -1
            run_of[i] = cur_run
            run_trend[cur_run] = trend
            prev = (mi, ci, trend)

        far_envs: Dict[int, List] = {}
        near_env: Dict[int, Optional[torch.Tensor]] = {}
        near_col: Dict[int, int] = {}
        cur_dir: Dict[int, str] = {}
        active_run: Dict[int, int] = {}

        def env_params(mi, c, side):
            """The param tensors an env of `side` at column c contracted."""
            t = self.members[mi].net.topology
            ncols = len(t.columns)
            cols = range(0, c + 1) if side == "left" else range(c, ncols)
            return tuple(params_list[mi][t.nodes[n].name]
                         for cc in cols for n in t.columns[cc]
                         if t.nodes[n].kind == PARAM)

        def same(a, b):
            return len(a) == len(b) and all(x is y for x, y in zip(a, b))

        def record_env(mi, c, side, env):
            hist = self._near_hist.setdefault((mi, side), {})
            old = hist.pop(c, None)  # stale either way: params changed
            if old is not None:
                self._near_hist_bytes -= old[0].numel() * old[0].element_size()
            nbytes = env.numel() * env.element_size()
            if self._near_hist_bytes + nbytes > ENV_HISTORY_MAX_BYTES:
                return  # over budget: recompute later instead of retaining
            self._near_hist_bytes += nbytes
            hist[c] = (env, env_params(mi, c, side))

        def reuse_chain(mi, far_dir, ncols):
            """Far chain from recorded history, or None if any needed entry
            is missing or stale."""
            hist = self._near_hist.get((mi, far_dir))
            if not hist:
                return None
            needed = (range(1, ncols) if far_dir == "right"
                      else range(0, ncols - 1))
            chain = [None] * ncols
            for c in needed:
                ent = hist.get(c)
                if ent is None or not same(ent[1], env_params(mi, c, far_dir)):
                    return None
                chain[c] = ent[0]
            return chain

        def ensure_run(i, mi):
            rid = run_of[i]
            if active_run.get(mi) == rid:
                return
            net = self.members[mi].net
            ncols = len(net.topology.columns)
            d = "l2r" if run_trend[rid] >= 0 else "r2l"
            cur_dir[mi] = d
            far_dir = "right" if d == "l2r" else "left"
            chain = reuse_chain(mi, far_dir, ncols)
            if chain is None:
                chain = self._timed("far_envs", self._far_envs, mi, far_dir,
                                    params_list[mi], data["inputs"][mi])
                for c, env in enumerate(chain):
                    if env is not None:
                        record_env(mi, c, far_dir, env)
            far_envs[mi] = chain
            near_env[mi] = None
            near_col[mi] = -1 if d == "l2r" else ncols
            active_run[mi] = rid

        def advance_near(mi, upto_col):
            """Bring the near-side env up to (and including) upto_col."""
            d = cur_dir[mi]
            step = 1 if d == "l2r" else -1
            side = "left" if d == "l2r" else "right"
            while (near_col[mi] + step <= upto_col if d == "l2r"
                   else near_col[mi] + step >= upto_col):
                c = near_col[mi] + step
                near_env[mi] = self._timed(
                    "advance", self._advance, mi, c, side, params_list[mi],
                    near_env[mi], data["inputs"][mi])
                near_col[mi] = c
                record_env(mi, c, side, near_env[mi])

        def gauge(mi, k, ci, d):
            """QR-gauge main core k toward the run's direction; the
            neighbour that took the factor gets its far env recomputed."""
            net = self.members[mi].net
            ncols = len(net.topology.columns)
            if d == "l2r" and k < len(net.topology.main_nodes) - 1:
                with span("tnf.env.gauge"):
                    params_list[mi] = gauges.orthonormalize_left(net, params_list[mi], k)
                c, side = ci + 1, "right"
                prev = far_envs[mi][c + 1] if c < ncols - 1 else None
            elif d == "r2l" and k > 0:
                with span("tnf.env.gauge"):
                    params_list[mi] = gauges.orthonormalize_right(net, params_list[mi], k)
                c, side = ci - 1, "left"
                prev = far_envs[mi][c - 1] if c > 0 else None
            else:
                return
            far_envs[mi][c] = self._timed(
                "advance", self._advance, mi, c, side, params_list[mi], prev,
                data["inputs"][mi])
            record_env(mi, c, side, far_envs[mi][c])

        rest_cache: Dict[int, torch.Tensor] = {}

        def rest_for(mi):
            if not use_rest:
                return None
            if mi not in rest_cache:
                tot = None
                for mj in range(len(self.members)):
                    if mj == mi:
                        continue
                    tot = y_members[mj] if tot is None else tot + y_members[mj]
                rest_cache[mi] = tot
            return rest_cache[mi]

        member_last_i = {}
        for i, (mi, ni) in enumerate(order):
            member_last_i[mi] = i

        # Junction rule: skip nodes in the same column as the LAST node of the
        # opposite-direction pass (frozen for this pass).
        frozen_other = last_other
        for i, (mi, ni) in enumerate(order):
            net = self.members[mi].net
            t = net.topology
            ci = t.col_of[ni]
            if frozen_other is not None and frozen_other == (mi, ci):
                continue
            # under a mesh rank 0's clock decides, so every rank stops at
            # the same update
            if cfg.timeout is not None and pmesh.agree(
                    (time.time() - start) > cfg.timeout, self._mesh):
                if cfg.verbose > 0:
                    print(f"Timeout reached ({cfg.timeout} s). Stopping sweep.")
                self._pending_ok.clear()
                return False, False, last_other

            eps = self._eps_for(NS, i, n_nodes, reverse=reversed_pass)
            method = cfg.method
            if eps == 0 and method == "ridge_exact":
                method = "exact"
            name = t.nodes[ni].name

            standalone = not t.input_nodes
            if standalone:
                # every row on every rank (replicated: never summed); under
                # a mesh the rest is assembled from the ranks' shards
                y_s, w_s, rest = data["y"], data["w"], rest_for(mi)
                if self._mesh is not None:
                    y_s, w_s = data["y_full"], data["w_full"]
                    if rest is not None:
                        rest = pmesh.gather_chunked(rest, self._mesh)
                new_core, loss_sum, ok = self._timed(
                    f"update:{name}", self._update_standalone, mi, ni, method,
                    use_rest, params_list[mi], y_s, w_s, rest, eps)
                pred = None
            else:
                ensure_run(i, mi)
                d = cur_dir[mi]
                # near env must cover everything strictly before ci
                if d == "l2r" and ci - 1 >= 0:
                    advance_near(mi, ci - 1)
                elif d == "r2l" and ci + 1 <= len(t.columns) - 1:
                    advance_near(mi, ci + 1)

                ncols = len(t.columns)
                if d == "l2r":
                    L = near_env[mi]
                    R = far_envs[mi][ci + 1] if ci < ncols - 1 else None
                else:
                    L = far_envs[mi][ci - 1] if ci > 0 else None
                    R = near_env[mi]

                return_pred = use_rest and i == member_last_i[mi]
                # matrix-free warm start: the node's previous solution; zeros
                # (in _update_matrix_free) on its first visit
                x0 = self._node_sols.get((mi, ni))
                new_core, loss_sum, ok, pred, x_sol = self._timed(
                    f"update:{name}", self._update, mi, ni, method, use_rest,
                    return_pred, params_list[mi], L, R, data["inputs"][mi],
                    data["y"], data["w"], rest_for(mi), eps, x0)
                if x_sol is not None:
                    self._node_sols[(mi, ni)] = x_sol
            self._defer_ok(ok, name)
            params_list[mi] = dict(params_list[mi], **{name: new_core})
            last_other = (mi, ci)
            if not standalone and cfg.orthonormalize and ni in t.main_nodes:
                gauge(mi, t.main_nodes.index(ni), ci, d)
            if standalone and use_rest and i == member_last_i[mi]:
                pred = self._member_forward_chunked(mi, params_list, data)

            if use_rest and pred is not None:
                y_members[mi] = pred
                rest_cache.clear()

            avg_loss = None
            if loss_callback or cfg.verbose > 1:
                with span("tnf.sync.loss"):
                    avg_loss = float(loss_sum) / S
            if cfg.verbose > 1:
                print(f"NS: {NS}, loss ({name}): {avg_loss} (eps: {eps})")
            if loss_callback is not None:
                loss_callback(NS, name, avg_loss)
            if convergence_criterion is not None and pmesh.agree(
                    convergence_criterion(), self._mesh):
                if cfg.verbose > 0:
                    print("Converged")
                if block_callback is not None:
                    block_callback(NS, name)
                return self._flush_ok(), True, last_other
            if block_callback is not None:
                block_callback(NS, name)

        return self._flush_ok(), False, last_other


def accumulating_sweep(net: Network, params, x, y, loss_fn,
                       cfg: Optional[SweepConfig] = None, **run_kw):
    """One network's sweep: `Sweeper(net, loss_fn, cfg).run([params], x, y,
    **run_kw)`. Returns (params, success)."""
    sw = Sweeper(net, loss_fn, cfg or SweepConfig())
    out, ok = sw.run([params], x, y, **run_kw)
    return out[0], ok
