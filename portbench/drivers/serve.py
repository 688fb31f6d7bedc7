"""Entry `serve`: one client's batches, back to back, to the conv-TT's served artifact.

Set-up makes the weights and a pool of `pool` batches of `batch` images
(patch tensors) on the card from the seed, exports the network with those
weights (`utils/serving.py` `export_forward`, a batch-polymorphic
`torch.export` program) and loads it with `load_forward`, as a user serves
a trained model, then calls it once on every batch of the pool. In the
window one client calls it on the pool's batches in turn, each call's
predictions read back to the host before the next call: a unit is one
call. The answers of the calls a seeded draw keeps (one in `keep_every`)
are compared with the reference after the window.
"""
from __future__ import annotations

import sys
import time

import torch

from .. import checks, data
from ..reference import tn


class Driver:
    unit_name = "batch"

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config
        self.wl = cell.workload

    def setup(self):
        from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
        from tensornetworksfork_tpu_torch.utils.serving import export_forward, load_forward
        dev, c, d = self.cell.device, self.cfg["model"], self.cfg["data"]
        t0 = time.perf_counter()
        gen = data.generator(self.cell.seed, dev)
        self.w0 = data.weights(gen, data.conv_tt_shapes(
            c["N"], c["r"], c["CB"], c["patches"], c["patch_pixels"], c["logits"]), dev)
        B, K = self.wl["batch"], self.wl["pool"]
        X, _ = data.images(gen, B * K, d["side"], d["kernel"], d["classes"], d["noise"], dev)
        self.pool = [X[i * B:(i + 1) * B].contiguous() for i in range(K)]
        del X
        layer = TensorConvolutionTrainLayer(
            num_carriages=c["N"], bond_dim=c["r"], num_patches=c["patches"],
            patch_pixels=c["patch_pixels"], output_shape=(c["logits"],),
            convolution_bond=c["CB"], seed=0, device=dev)
        layer.params = {k: self.w0[k].reshape(v.shape) for k, v in layer.params.items()}
        t1 = time.perf_counter()
        blob = export_forward(layer, (c["patches"], c["patch_pixels"]), device=dev)
        del layer
        t2 = time.perf_counter()
        self.f = load_forward(blob)
        t3 = time.perf_counter()
        for x in self.pool:
            self.f(x).cpu()
        print(f"[portbench] serve set-up: inputs and weights {t1 - t0:.2f} s, export"
              f" {t2 - t1:.2f} s, load_forward {t3 - t2:.2f} s, first calls"
              f" {time.perf_counter() - t3:.2f} s", file=sys.stderr)
        g = torch.Generator().manual_seed(self.cell.seed)
        # which calls' answers are kept: one in keep_every, drawn from the seed
        self.keep = torch.randint(0, self.wl["keep_every"], (1 << 20,), generator=g) == 0
        self.calls = 0
        self.kept = []
        self.enqueue_s, self.latency_s = [], []

    def unit(self):
        i = self.calls % len(self.pool)
        t0 = time.perf_counter()
        out = self.f(self.pool[i])
        t1 = time.perf_counter()
        host = out.cpu()
        t2 = time.perf_counter()
        self.enqueue_s.append(t1 - t0)
        self.latency_s.append(t2 - t0)
        if self.calls == 0 or self.keep[self.calls % self.keep.numel()]:
            self.kept.append((i, host))
        self.calls += 1
        return host.shape[0], True

    def detail(self):
        """Calls outside the profiler: each one's enqueue and latency."""
        self.enqueue_s, self.latency_s = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.wl["detail_seconds"]:
            self.unit()
        return {"enqueue_s": list(self.enqueue_s), "latency_s": list(self.latency_s)}

    def release(self):
        del self.f

    def check(self, variants=("program",)):
        c = self.cfg["model"]
        net = tn.Net(self.w0, c["N"], True)
        used = sorted({i for i, _ in self.kept})
        ref = {i: net.forward(self.pool[i]) for i in used}
        out = {}
        if "program" in variants:
            out["program"] = {"serve_gap": max(
                checks.max_rel(h, ref[i]) for i, h in self.kept)}
        if "control" in variants:
            nm = tn.Numerics(self.wl["control"])
            out["control"] = {"serve_gap": max(
                checks.max_rel(net.forward(self.pool[i], nm), ref[i]) for i in used)}
        return out
