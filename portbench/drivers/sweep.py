"""Entry `sweep`: epochs of `Sweeper.run` on a conv-TT over the MNIST stand-in.

Set-up makes the weights and the cell's rows on the card from the seed,
builds the network and its sweeper in the cell's numerics tier, and runs
the first epoch from the benchmark's weights: the window's own call on all
its rows, which also warms every shape and pays the chunking. Its first
`first_steps` node updates are the check's start: each one's loss (the
sweep's own, of the state it starts from) and the cores they leave. The
window then calls `sweeper.run` back to back from where the first epoch
left off, as a user's later epochs do. Each epoch keeps the parameters it
began from and the cores its first `first_steps` updates leave, so the
check can follow the window's last epoch from where it began; and the
program's forward of the parameters the window ended with is kept before
its state is freed.
"""
from __future__ import annotations

import contextlib
import os

import torch

from .. import checks, data
from ..reference import tn
from ..trace import SOLVE


class Driver:
    unit_name = "swipe"

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config
        self.wl = cell.workload

    def _layer(self):
        from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
        c = self.cfg["model"]
        return TensorConvolutionTrainLayer(
            num_carriages=c["N"], bond_dim=c["r"], num_patches=c["patches"],
            patch_pixels=c["patch_pixels"], output_shape=(c["logits"],),
            convolution_bond=c["CB"], seed=0, device=self.cell.device)

    def _sweeper(self, layer):
        from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
        from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
        t = self.cfg["training"]
        return Sweeper(layer.network, XEBregman(w=1.0), SweepConfig(
            num_swipes=self.wl["swipes"], batch_size=t["chunk"], method=t["method"],
            eps=t["eps"], eps_decay=t["eps_decay"]))

    def setup(self):
        from tensornetworksfork_tpu_torch.utils.precision import numerics_tier
        dev, c, d = self.cell.device, self.cfg["model"], self.cfg["data"]
        self.tier = contextlib.ExitStack()
        self.tier.enter_context(numerics_tier(self.wl["tier"]))
        gen = data.generator(self.cell.seed, dev)
        self.w0 = data.weights(gen, data.conv_tt_shapes(
            c["N"], c["r"], c["CB"], c["patches"], c["patch_pixels"], c["logits"]), dev)
        self.X, self.y = data.images(gen, self.wl["rows"], d["side"], d["kernel"],
                                     d["classes"], d["noise"], dev)
        self.layer = self._layer()
        self.sweeper = self._sweeper(self.layer)
        params = {k: self.w0[k].reshape(v.shape) for k, v in self.layer.params.items()}
        losses = []

        def on_loss(ns, name, mean_loss):
            losses.append(mean_loss)
        self.params, states, ok = self._epoch(params, on_loss)
        if not ok:
            raise RuntimeError("the first epoch reported a singular solve")
        self.losses, self.first = losses[:self.wl["first_steps"]], states[-1]

    def _epoch(self, params, on_loss=None):
        """One call of the window: returns the parameters it ends with, the
        cores after each of its first `first_steps` updates, and whether
        every solve held."""
        k, states = self.wl["first_steps"], []

        def on_update(ns, name):
            if len(states) < k:
                states.append(dict(self.sweeper.params_list[0]))
        plist, ok = self.sweeper.run([params], self.X, self.y, loss_callback=on_loss,
                                     block_callback=on_update)
        return plist[0], states, ok

    def unit(self):
        start = self.params
        self.params, states, ok = self._epoch(start)
        self.last = (start, states[-1])
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)
        return self.wl["rows"] * self.wl["swipes"], bool(ok)

    @contextlib.contextmanager
    def spans(self):
        """The solve of every node update inside a span of the benchmark's
        own, for the traced window."""
        from torch.profiler import record_function

        from tensornetworksfork_tpu_torch.core import sweep
        orig = sweep.solve_block

        def solve_block(*a, **k):
            with record_function(SOLVE):
                return orig(*a, **k)
        sweep.solve_block = solve_block
        try:
            yield
        finally:
            sweep.solve_block = orig

    def detail(self):
        """One swipe with the sweep's phase timers (each phase synchronised)."""
        os.environ["TNF_SWEEP_TIMERS"] = "1"
        try:
            sw = self._sweeper(self.layer)
        finally:
            os.environ.pop("TNF_SWEEP_TIMERS", None)
        sw.run([self.params], self.X, self.y)
        return {"timers": {k: list(v) for k, v in sw.timers.items()},
                "timer_units": self.wl["swipes"]}

    def release(self):
        """Keeps the program's forward of its final parameters on every row
        (in the cell's tier, in chunks), then frees the program's state."""
        self.layer.load_node_states(self.params)
        with torch.no_grad():
            self.out = self.layer.forward_batch(self.X, self.cfg["training"]["chunk"]).float()
        self.final = dict(self.params)
        del self.layer, self.sweeper, self.params
        self.tier.close()

    def _canonical(self, cores):
        return {k: cores[k].reshape(self.w0[k].shape) for k in self.w0}

    def _follow(self, p0):
        """`follow(numerics, keep)`: the reference through the first node
        updates of one epoch from `p0`, on all the rows."""
        t, c = self.cfg["training"], self.cfg["model"]

        def follow(nm, keep):
            net = tn.Net(p0, c["N"], True)
            losses = tn.run(net, self.X, self.y, "xe", self.wl["swipes"], t["eps"],
                            t["eps_decay"], nm, keep, updates=self.wl["first_steps"])
            return losses, tn.cores_in(net, list(p0))
        return follow

    def check(self, variants=("program",)):
        ctl, dev = self.wl["control"], self.cell.device
        half = checks.half_rows(self.wl["rows"], self.cfg["training"]["chunk"], dev)
        start = checks.stage_readings("", self.w0, self._follow(self.w0), self.losses,
                                      self.first, ctl, half, variants)
        p0 = self._canonical(self.last[0])
        last = checks.stage_readings("last_", p0, self._follow(p0), None, self.last[1],
                                     ctl, half, variants)
        net = tn.Net(self._canonical(self.final), self.cfg["model"]["N"], True)
        fwd = checks.forward_readings("forward_gap", self.out,
                                      lambda nm: net.forward(self.X, nm), ctl, variants)
        return checks.merge(start, last, fwd)
