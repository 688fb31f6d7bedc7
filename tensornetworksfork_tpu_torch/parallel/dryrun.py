"""Dry run of the data mesh (port of `__graft_entry__.dryrun_multichip`).

Spawns n gloo ranks (`mesh.launch`) that sweep, on a 1-D data mesh at tiny
shapes: (1) the type-I sum of conv-TT members, the flagship's training
configuration; (2) one conv-TT on the packed route (TNF_PACKED_SYRK_MIN_D=1),
which must call the Gram kernels on every rank (on the CPU, their wrappers
take the plain versions). Prints one "OK" line for each. The 2-D data x model
line waits for ROADMAP item 17, step 2.

Run:  python -m tensornetworksfork_tpu_torch.parallel.dryrun 4 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from . import mesh as pmesh

# the wrappers of ops/cuda/gram.py the sweep's Gram routes call
KERNEL_WRAPPERS = ("retile_hmix", "quantize_tiled", "gram_pair_band_q", "gram_pair",
                   "retile_rows", "weighted_gram_tiled", "weighted_gram", "own_out_gram")


@contextlib.contextmanager
def counted_kernels():
    """Counts calls of the Gram wrappers (kernel launches on the card, their
    plain versions on the CPU) while the context is open; yields the counts."""
    from ..ops.cuda import gram as kg
    counts = dict.fromkeys(KERNEL_WRAPPERS, 0)
    saved = {k: getattr(kg, k) for k in KERNEL_WRAPPERS}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call
    for k in KERNEL_WRAPPERS:
        setattr(kg, k, counting(k))
    try:
        yield counts
    finally:
        for k, fn in saved.items():
            setattr(kg, k, fn)


def _rank(n: int, device: str):
    from ..core.engine import Network
    from ..core.sweep import Member, SweepConfig, Sweeper
    from ..models.layers import SumLayer, TensorConvolutionTrainLayer
    from ..ops.bregman import XEBregman

    mesh = pmesh.make_mesh(n, device=device)
    dev = mesh.device
    rng = np.random.default_rng(0)
    S, P, pp, C = 4 * n, 5, 6, 3
    lines = []

    # type-I sum of conv-TT members (the flagship's training configuration,
    # tiny shapes): the samples sharded, the params replicated
    layers = [TensorConvolutionTrainLayer(
        num_carriages=i, bond_dim=3, num_patches=P if i == 1 else P - 1,
        patch_pixels=pp if i == 1 else pp - 1, output_shape=(C,),
        convolution_bond=2, seed=i, device=dev) for i in (1, 2)]
    sl = SumLayer(layers)
    x = torch.tensor(rng.standard_normal((S, P, pp)), dtype=torch.float32, device=dev)
    y = torch.tensor(np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)], device=dev)
    members = [Member(l.network, fn) for l, fn in zip(sl.layers, sl.input_fns)]
    cfg = dict(num_swipes=1, batch_size=2 * n, method="ridge_cholesky", eps=1.0)
    params_list, ok = Sweeper(members, XEBregman(w=1.0), SweepConfig(**cfg)).run(
        [l.params for l in sl.layers], x, y, mesh=mesh)
    assert ok, "data-mesh dry-run sweep reported failure"
    lines.append(f"dryrun_multichip({n}): dp sweep OK on mesh {mesh.shape}")

    # the Gram kernels under the data mesh: each rank runs them on its rows
    # and the sweep sums the carries; TNF_PACKED_SYRK_MIN_D=1 puts the tiny
    # middle core on the packed kernel route
    saved = os.environ.get("TNF_PACKED_SYRK_MIN_D")
    os.environ["TNF_PACKED_SYRK_MIN_D"] = "1"
    try:
        layer = TensorConvolutionTrainLayer(
            num_carriages=2, bond_dim=3, num_patches=P, patch_pixels=pp,
            output_shape=(C,), convolution_bond=2, seed=9, device=dev)
        net = Network(layer.topology, device=dev, use_kernels=True)
        with counted_kernels() as counts:
            _, ok_pk = Sweeper(net, XEBregman(w=1.0), SweepConfig(**cfg)).run(
                [layer.params], x, y, mesh=mesh)
        assert ok_pk, "kernels-under-mesh dry-run sweep reported failure"
        assert sum(counts.values()) > 0, \
            "kernels-under-mesh dry run did not route through the kernels"
    finally:
        if saved is None:
            del os.environ["TNF_PACKED_SYRK_MIN_D"]
        else:
            os.environ["TNF_PACKED_SYRK_MIN_D"] = saved
    lines.append(f"dryrun_multichip({n}): dp sweep with the Gram kernels "
                 f"(per-rank kernels + all-reduce) OK on mesh {mesh.shape}")
    return lines, {k: v for k, v in counts.items() if v}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """Runs the dry run on n_devices ranks and prints rank 0's lines;
    returns them."""
    lines, _ = pmesh.launch(_rank, n_devices, n_devices, device, threads=1)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=4, help="ranks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
