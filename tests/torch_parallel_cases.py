"""The port's mesh scenarios, run in gloo ranks by test_torch_parallel.py
(the 1-D data mesh) and test_torch_mesh2d.py (the 2-D data x model mesh).

A module of its own (no JAX, no test collection) because every rank that
`parallel.mesh.launch` spawns imports it: each scenario is a spec of numpy
arrays (params made by the JAX package, data from a numpy seed), built here
into the port's layers and swept with or without a mesh.
"""
import contextlib
import os

import torch

from tensornetworksfork_tpu_torch.core import sweep as sweep_mod
from tensornetworksfork_tpu_torch.core.engine import Network
from tensornetworksfork_tpu_torch.core.sweep import Member, SweepConfig, Sweeper
from tensornetworksfork_tpu_torch.models import layers as tl
from tensornetworksfork_tpu_torch.ops import bregman as tb
from tensornetworksfork_tpu_torch.parallel import mesh as pmesh
from tensornetworksfork_tpu_torch.parallel.dryrun import counted_kernels
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy, params_to_numpy


@contextlib.contextmanager
def environ(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _layer(kind, kw):
    cls = {"tt": tl.TensorTrainLayer, "conv": tl.TensorConvolutionTrainLayer,
           "compressed": tl.CompressedTensorTrainLayer}[kind]
    return cls(**kw, device="cpu")


def build(spec):
    """(members, params_list, x, y) of a spec: its layers (kind, kwargs),
    each a member of a type-I sum when there are several (an input-less
    layer sees no x), with the spec's numpy params."""
    layers = [_layer(kind, kw) for kind, kw in spec["layers"]]
    members = []
    for layer in layers:
        net = Network(layer.topology, consts=layer.network.consts, device="cpu",
                      use_kernels=spec.get("use_kernels", False))
        if not net.topology.input_nodes:
            members.append(Member(net, lambda x: {}))
        elif len(layers) > 1:
            members.append(Member(net, tl._slice_adapter(net)))
        else:
            members.append(Member(net))
    params = [params_from_numpy(p, device="cpu") for p in spec["params"]]
    return members, params, torch.tensor(spec["x"]), torch.tensor(spec["y"])


def predict(members, params, x):
    out = None
    for m, p in zip(members, params):
        y = m.net.forward(p, m.input_fn(x))
        out = y if out is None else out + y
    return out.numpy()


def sweep(spec, mesh=None, **run_kw):
    """One Sweeper.run of the spec (under `mesh` if given). Returns the
    params (numpy), the predictions on x, ok, the Gram wrappers' calls, the
    Krylov iteration counts and the own-out expansions taken."""
    members, params, x, y = build(spec)
    expansions = {"n": 0}
    expand = Network.expand_ownout

    def spy(A_raw, plan):
        expansions["n"] += 1
        return expand(A_raw, plan)
    Network.expand_ownout = staticmethod(spy)
    try:
        with environ(**spec.get("env", {})), counted_kernels() as counts:
            sw = Sweeper(members, getattr(tb, spec["loss"])(**spec.get("loss_kw", {})),
                         SweepConfig(**spec["cfg"]))
            out, ok = sw.run(params, x, y, mesh=mesh, **run_kw)
    finally:
        Network.expand_ownout = staticmethod(expand)
    return {"params": [params_to_numpy(p) for p in out],
            "pred": predict(members, out, x), "ok": ok, "counts": dict(counts),
            "iters": [int(k) for _, _, k in sw.krylov_iters],
            "expansions": expansions["n"]}


class _Clock:
    """Stands for the time module in core/sweep.py: jumps `jump` seconds
    ahead once `after` node updates have run."""

    def __init__(self, after, jump):
        self.after, self.jump, self.updates = after, jump, 0

    def time(self):
        import time
        return time.time() + (self.jump if self.updates >= self.after else 0.0)

    def perf_counter(self):
        import time
        return time.perf_counter()


def timeout_sweep(spec, mesh, late_rank):
    """The spec swept with a 1,000 s timeout while only `late_rank`'s clock
    jumps past it after the third update. Returns ok and the node updates
    this rank ran."""
    clock = _Clock(after=3, jump=1e6 if mesh.rank == late_rank else 0.0)
    saved = sweep_mod.time
    sweep_mod.time = clock

    def count(ns, name):
        clock.updates += 1
    try:
        spec = dict(spec, cfg=dict(spec["cfg"], timeout=1000.0))
        res = sweep(spec, mesh, block_callback=count)
    finally:
        sweep_mod.time = saved
    return {"ok": res["ok"], "updates": clock.updates}


def rank_main(specs, timeout_spec):
    """Every scenario of `specs` on a data mesh over this process's group,
    then the one-rank-clock timeouts, and the error of a 2-D mesh whose
    shape does not hold the world. Returns {name: result}."""
    mesh = pmesh.make_mesh(device="cpu")
    out = {name: sweep(spec, mesh) for name, spec in specs.items()}
    for late in (0, 1):
        out[f"timeout on rank {late}'s clock"] = timeout_sweep(timeout_spec, mesh, late)
    out["stats"] = dict(mesh.stats)
    try:
        pmesh.make_mesh(axis=("data", "model"), shape=(2, 2), device="cpu")
    except ValueError as e:
        out["2-D shape error"] = str(e)
    return out


MODEL_LABELS = ("patches",)


def rank_main_2d(specs, tight=(), unsplit=None):
    """Every scenario of `specs` on a 2 x 2 data x model mesh over this
    process's 4 ranks (the patches sharded over "model"), the collectives'
    counts, the scenarios named in `tight` once more on a 1-D data mesh of
    the 4 ranks, and the error of sweeping `unsplit`, whose patches do not
    split over the model ranks. Returns {name: result}."""
    mesh = pmesh.make_mesh(axis=("data", "model"), shape=(2, 2), device="cpu")
    out = {name: sweep(spec, mesh, model_axis_labels=MODEL_LABELS)
           for name, spec in specs.items()}
    out["stats"] = {k: dict(v) for k, v in mesh.stats.items()}
    flat = pmesh.make_mesh(device="cpu")
    for name in tight:
        out[f"{name}, 1-D"] = sweep(specs[name], flat)
    if unsplit is not None:
        try:
            sweep(unsplit, mesh, model_axis_labels=MODEL_LABELS)
        except ValueError as e:
            out["unsplit error"] = str(e)
    return out
