"""grow_cart's XE growth at the MNIST headline's widths on the card, node
update by node update.

    python -m tensornetworksfork_tpu_torch.experiments.probes.grow_probe

Drives run_grow_cart's loop (1 -> 4 carriages, r = 18, CB = 8, 3 swipes a
step at eps 1.0 x 0.5 a half-pass, XEBregman on 9 logits, full batch) on
8,192 samples of train_image's synthetic stand-in, as is and with
chip_smoke's pixel noise (`grow_stand_in`): with the kernels and with the
plain torch routes on the card (TNF_KERNELS=0), each in the f32 and fastest
Gram tiers, and with the kernels and float64 solves. It prints the factor c
by which each growth scales the logits (the grown forward against the last
one's), and, after every node update, records the mean XE loss and the
train accuracy; for each step it prints the loss and accuracy at its start
and end, the largest rise of the loss in one update (with its node and
eps; a rise is a Gauss-Newton step that overshot), ok, and how far its
end predictions lie from the f32 plain-route run's.
"""
from __future__ import annotations

import sys
import time

import torch

sys.path.insert(0, ".")


def grow(x, y, solve_dtype=None, r=18):
    """run_grow_cart's loop with a per-update record: a list, one entry per
    step, of (carriages, ok, [(half-pass, node, eps, loss, accuracy)],
    (loss, accuracy) at the step's start, predictions at its end)."""
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models import growing
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman

    loss_fn = XEBregman(1.0)
    labels = y.argmax(1)

    def score(layer, params):
        pred = layer.network.forward(params, x)
        full = torch.cat([pred, torch.zeros_like(pred[:, :1])], 1)
        return (float(loss_fn(pred, y, only_loss=True).mean()),
                float((full.argmax(1) == labels).float().mean()))

    layer = TensorConvolutionTrainLayer(1, r, x.shape[1], x.shape[2], output_shape=(9,),
                                        convolution_bond=8, device=x.device)
    steps = []
    for step in range(4):
        sw = Sweeper(layer.network, loss_fn,
                     SweepConfig(num_swipes=3, method="ridge_cholesky", eps=1.0,
                                 eps_decay=0.5, solve_dtype=solve_dtype))
        trace, start = [], score(layer, layer.params)
        (params,), ok = sw.run([layer.params], x, y, block_callback=lambda ns, name: trace.append(
            (ns, name, 0.5 ** ns) + score(layer, sw.params_list[0])))
        layer.params = params
        steps.append((layer.num_carriages, ok, trace, start,
                      layer.network.forward(params, x).cpu()))
        if step < 3:
            old = steps[-1][4].to(x.device)
            layer = growing.grow_cart(layer)
            new = layer.network.forward(layer.params, x)
            c = (new * old).sum() / (old * old).sum()
            print(f"    growth to {layer.num_carriages}c scales the logits by {float(c):.4g} "
                  f"(residual {float((new - c * old).abs().max() / new.abs().max()):.2g})",
                  flush=True)
    return steps


def main() -> None:
    import chip_smoke as cs
    from tensornetworksfork_tpu_torch.data.images import synthetic_image_classification

    if not torch.cuda.is_available():
        raise SystemExit("grow_probe runs on the card")
    dev = torch.device("cuda", 0)
    data = {"stand-in": synthetic_image_classification(S=8192, seed=0),
            f"noise {cs.GROW_NOISE:g}": cs.grow_stand_in(8192)}
    runs = {"f32 plain routes": ("f32", {"TNF_KERNELS": "0"}, None),
            "f32 kernels": ("f32", {}, None),
            "fastest kernels": ("fastest", {}, None),
            "fastest plain routes": ("fastest", {"TNF_KERNELS": "0"}, None),
            "f32 kernels, float64 solves": ("f32", {}, "float64")}
    for name, (x, y) in data.items():
        x, y = x.to(dev), y.to(dev)
        ref = None
        for run, (tier, extra, solve_dtype) in runs.items():
            with cs.env(**cs.SLICE_TIERS[tier], **extra):
                t = time.perf_counter()
                steps = grow(x, y, solve_dtype)
            print(f"{name}, {run}: {time.perf_counter() - t:.1f} s", flush=True)
            ref = ref or [s[4] for s in steps]
            for (carriages, ok, trace, (l0, a0), pred), p0 in zip(steps, ref):
                gap = float((pred - p0).abs().max() / p0.abs().max())
                losses = [l0] + [e[3] for e in trace]
                rise = max(range(len(trace)), key=lambda i: losses[i + 1] - losses[i])
                ns, node, eps, l1, _ = trace[rise]
                print(f"    {carriages}c ok {ok}: loss {l0:.4g} -> {trace[-1][3]:.4g}, "
                      f"accuracy {a0:.4f} -> {trace[-1][4]:.4f}; largest rise "
                      f"{losses[rise]:.4g} -> {l1:.4g} at {node} (half-pass {ns}, eps {eps:g}); "
                      f"max|pred - f32 plain| / max|f32 plain| {gap:.3g}",
                      flush=True)


if __name__ == "__main__":
    main()
