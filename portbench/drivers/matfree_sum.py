"""Entry `matfree_sum`: one epoch of `Sweeper.run` on a type-I sum of
conv-TTs, matrix-free (the reference's CIFAR_minres configuration), run
again and again from the same state.

Set-up makes the cell's rows (`cifar.py`) and weights on the card from the
seed, builds the model with `train_image.build_model` (`tt_type1`: members
of 1..N carriages) and loads the benchmark's weights into it, calibrates
the XE logit scale as `train_image` does (w = 1 / std of the forward of the
first 64 rows; the reference computes its own from the same weights),
builds `train_image`'s sweeper over the members (the
configuration's method, max_iter, tol, eps, decay and chunk) in the cell's
numerics tier, and runs the first epoch: the window's own call on all its
rows, which also warms every shape and pays the chunking. It then keeps the
state that sets what a later epoch computes: the parameters the first epoch
returned and what the sweeper carries from one `run` call to the next and
reads again (`CARRIED`: the Krylov warm starts `_node_sols`, and the
environment history `_near_hist` with its byte count, whose entries a later
epoch reuses where the parameters they contracted are still the same
tensors). Nothing else carries over: eps restarts at the configuration's
on every call (`_eps_for` counts the half-passes of the call), the data
cache holds the same rows, and the Krylov counters (`krylov_iters`,
`krylov_matvecs`) only count.

A window epoch is training's second epoch, run from that state: each unit
hands the sweeper the kept parameters by reference (`run` copies the list
and replaces its dicts, never writing into a tensor or a dict it was
given), and fresh copies of the carried dicts, whose tensors they share
(`run` writes into those dicts): a copy of a few dozen references before
the call. So every unit, every seed's run, and the runs of two versions of
the program, do the same epoch: how fast the program is does not decide
how far into training the window reaches.

Each epoch keeps, from the program's own state at its block callbacks
(read by reference, no synchronisation), for each followed node (`follow`
in the cell: a core and a conv block): the parameters just before its first
update, its warm start then, the parameters after the update and the
iteration count k the program recorded for it; and the epoch's updates'
(member, node, k) and the matvecs the program launched
(`Sweeper.krylov_matvecs`, where the program counts them). The check
follows each of those updates with the plain reference from the same
state, at set-up (the first epoch) and in the window's last epoch (an
epoch-2 update), and compares the program's forward of the parameters that
epoch ended with.
"""
from __future__ import annotations

import contextlib
import sys
import time

import torch

from .. import checks, cifar, data
from ..counts.matfree import members
from ..reference import matfree_sum as mf
from ..reference.tn import Numerics
from ..trace import SOLVE


# what `Sweeper.run` carries from one call to the next and reads again
CARRIED = ("_node_sols", "_near_hist", "_near_hist_bytes")


def _containers_copied(v):
    """`v` with its dicts copied, its tensors shared."""
    if isinstance(v, dict):
        return {k: _containers_copied(x) for k, x in v.items()}
    return v


class Driver:
    unit_name = "swipe"

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config
        self.wl = cell.workload
        self.units = []

    def setup(self):
        from tensornetworksfork_tpu_torch.core.sweep import Member, SweepConfig, Sweeper
        from tensornetworksfork_tpu_torch.experiments import train_image
        from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
        from tensornetworksfork_tpu_torch.utils.precision import numerics_tier
        dev, c, d, t = self.cell.device, self.cfg["model"], self.cfg["data"], self.cfg["training"]
        self.tier = contextlib.ExitStack()
        self.tier.enter_context(numerics_tier(self.wl["tier"]))
        gen = data.generator(self.cell.seed, dev)
        self.X, self.y = cifar.images(gen, self.wl["rows"], d["side"], d["kernel"],
                                      d["channels"], d["classes"], d["noise"], dev)
        self.model = train_image.build_model(
            {"model_type": c["model_type"], "N": c["N"], "r": c["r"], "CB": c["CB"], "seed": 0,
             "device": dev}, self.X.shape[1], self.X.shape[2], d["classes"])
        self.shapes = [data.conv_tt_shapes(n, c["r"], c["CB"], P, q, c["logits"])
                       for n, P, q in members(self.cfg)]
        self.init = []
        for layer, shapes in zip(self.model.layers, self.shapes):
            w0 = data.weights(gen, shapes, dev)
            layer.params = {k: w0[k].reshape(v.shape) for k, v in layer.params.items()}
            self.init.append(dict(layer.params))
        # the logit scale of train_image (the reference's AAMNST.py:192-195)
        y0 = self.model(self.X[:64]).cpu().numpy()
        self.w = float(1.0 / max(y0.std(), 1e-8))
        self.sweeper = Sweeper(
            [Member(l.network, fn) for l, fn in zip(self.model.layers, self.model.input_fns)],
            XEBregman(w=self.w),
            SweepConfig(num_swipes=self.wl["swipes"], batch_size=t["chunk"], method=t["method"],
                        max_iter=t["max_iter"], tol=t["tol"], eps=t["eps"],
                        eps_decay=t["eps_decay"]))
        self.targets = []
        for f in self.wl["follow"]:
            net = self.model.layers[f["member"] - 1].network
            ni = [n.name for n in net.topology.nodes].index(f["node"])
            self.targets.append((f["member"] - 1, f["node"], ni, f["tag"]))
        losses = []

        def on_loss(ns, name, mean_loss):
            losses.append(mean_loss)
        self.params, first, ok, _ = self._epoch(self.model.params_list, on_loss)
        if not ok:
            raise RuntimeError("the first epoch reported a failed solve")
        self.first = first
        self.first_loss = {t: losses[r["index"]] for t, r in first.items()}
        self.start = {"params": self.params,
                      **{a: _containers_copied(getattr(self.sweeper, a)) for a in CARRIED}}

    def _epoch(self, params, on_loss=None):
        """One call of the window. Returns the parameters it ends with, the
        record of each followed node's first update, whether every solve
        held, and its updates and matvecs."""
        sw = self.sweeper
        n0 = len(sw.krylov_iters)
        counts = getattr(sw, "krylov_matvecs", None)
        m0 = None if counts is None else sum(counts.values())

        def warm():
            return {t: sw._node_sols.get((t[0], t[2])) for t in self.targets}
        state = {"params": [dict(p) for p in params], "x0": warm(), "index": 0}
        recs = {}

        def on_update(ns, node):
            mi, nm, k = sw.krylov_iters[-1]
            for t in self.targets:
                if t not in recs and (mi, nm) == t[:2]:
                    recs[t] = dict(before=state["params"], x0=state["x0"][t], k=k, ns=ns,
                                   after=[dict(p) for p in sw.params_list],
                                   index=state["index"])
            state.update(params=[dict(p) for p in sw.params_list], x0=warm(),
                         index=state["index"] + 1)
        plist, ok = sw.run(params, self.X, self.y, loss_callback=on_loss,
                           block_callback=on_update)
        stats = {"updates": sw.krylov_iters[n0:],
                 "matvecs": None if counts is None else sum(counts.values()) - m0}
        return plist, recs, ok, stats

    def unit(self):
        """Training's second epoch, from the state set-up kept."""
        t0 = time.perf_counter()
        for a in CARRIED:
            setattr(self.sweeper, a, _containers_copied(self.start[a]))
        self.params, self.last, ok, stats = self._epoch(self.start["params"])
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)
        stats["seconds"] = time.perf_counter() - t0
        self.units.append(stats)
        return self.wl["rows"] * self.wl["swipes"], bool(ok)

    @contextlib.contextmanager
    def spans(self):
        """The Krylov solve of every node update inside a span of the
        benchmark's own, for the traced window (the residual and the
        iterations; the scale probe and the linearisation stay outside)."""
        from torch.profiler import record_function

        from tensornetworksfork_tpu_torch.core import krylov
        method = self.cfg["training"]["method"]
        orig = krylov.SOLVERS[method]

        def solver(*a, **k):
            with record_function(SOLVE):
                return orig(*a, **k)
        krylov.SOLVERS[method] = solver
        try:
            yield
        finally:
            krylov.SOLVERS[method] = orig

    def detail(self):
        """The window's epochs as the program recorded them: each update's
        (member, node, k), and the matvecs launched (None where the program
        keeps no count)."""
        return {"updates": [[(m, n, int(k)) for m, n, k in u["updates"]] for u in self.units],
                "matvecs": [u["matvecs"] for u in self.units]}

    def release(self):
        """Keeps the program's forward of its final parameters on every row
        (in the cell's tier, in train_image's evaluation batches), then
        frees the program's state."""
        self.model.set_params_list(self.params)
        with torch.no_grad():
            self.out = self.model.forward_batch(self.X, self.wl["eval_batch"]).float()
        self.final = [dict(p) for p in self.params]
        del self.model, self.sweeper, self.params, self.start
        self.tier.close()
        print(f"[portbench] window epochs: seconds {[round(u['seconds'], 4) for u in self.units]},"
              f" matvecs {[u['matvecs'] for u in self.units]}", file=sys.stderr, flush=True)

    # ------------------------------------------------------------------ check
    def _sum(self, plist) -> mf.Sum:
        return mf.Sum([mf.Member({k: p[k].reshape(s) for k, s in shapes.items()}, n, P, q)
                       for p, shapes, (n, P, q) in zip(plist, self.shapes, members(self.cfg))])

    def _half_chunks(self) -> torch.Tensor:
        """Per-row weights of the fault: the rows of the first half of the
        chunks at 2, the rest left out of the matvec."""
        rows, chunk = self.wl["rows"], self.cfg["training"]["chunk"]
        k = torch.zeros((rows,), dtype=torch.float64, device=self.cell.device)
        nch = -(-rows // chunk)
        k[:min(rows, (nch // 2) * chunk)] = 2.0
        return k

    def _ref_w(self, aux: Numerics) -> float:
        """The reference's own logit scale in `aux`: 1 / std of its forward
        of the seed's weights on the first 64 rows (train_image's rule)."""
        y0 = self._sum(self.init).forward(self.X[:64], aux)
        return float(1.0 / max(float(y0.std(unbiased=False)), 1e-8))

    def _stage(self, stage, target, rec, prog_loss, variants):
        """The readings of one followed update (`<stage><tag>...`): the
        program's change of the node against the reference's x
        (`solve_gap`, ||x_p - x_r|| over ||x_r||) and, where the program's
        loss is known, its loss of the state before the update
        (`loss_gap`). Variants: the reference in the control's aux numerics
        (its logit scale its own), with half the chunks in the matvec, or
        with the matvec's operands rounded to TF32 or bf16."""
        t, (mid, name, _, tag) = self.cfg["training"], target
        eps = t["eps"] * t["eps_decay"] ** rec["ns"]
        k = int(rec["k"])
        shape = self.shapes[mid][name]
        pre = stage + tag

        def follow(aux=None, weights=None, mv=None):
            aux = aux or Numerics()
            return mf.update(self._sum(rec["before"]), self.X, self.y, self._ref_w(aux), mid,
                             name, eps, k, rec["x0"], aux, weights, mv)
        ref_loss, ref_x = follow()
        dx = (rec["after"][mid][name].double().reshape(shape)
              - rec["before"][mid][name].double().reshape(shape)).reshape(-1)

        def gaps(loss, x):
            gap = torch.linalg.vector_norm(x - ref_x) / torch.linalg.vector_norm(ref_x)
            # a step that is not a number (a diverged solve) reads inf
            out = {pre + "solve_gap": float(gap) if torch.isfinite(x).all() else float("inf")}
            if prog_loss is not None:
                out[pre + "loss_gap"] = abs(loss - ref_loss) / abs(ref_loss)
            return out

        out = {}
        for v in variants:
            if v == "program":
                out[v] = gaps(prog_loss, dx)
            elif v == "control":
                out[v] = gaps(*follow(Numerics(self.wl["control"])))
            elif v == "half":
                out[v] = gaps(*follow(weights=self._half_chunks()))
            elif v in ("tf32mv", "bf16mv"):
                out[v] = gaps(*follow(mv=v[:4]))
            else:
                raise ValueError(f"unknown variant {v!r}")
        return out

    def check(self, variants=("program",)):
        """Each followed node's first update at set-up (the program's loss
        compared for the first node only) and in the window's last epoch,
        and the forward of the final parameters."""
        parts = []
        for i, tgt in enumerate(self.targets):
            loss = self.first_loss[tgt] if i == 0 else None
            parts.append(self._stage("", tgt, self.first[tgt], loss, variants))
            parts.append(self._stage("last_", tgt, self.last[tgt], None, variants))
        ref = self._sum(self.final)
        parts.append(checks.forward_readings("forward_gap", self.out,
                                             lambda nm: ref.forward(self.X, nm),
                                             self.wl["control"], variants))
        return checks.merge(*parts)
