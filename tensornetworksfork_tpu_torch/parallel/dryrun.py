"""Dry run of the meshes (port of `__graft_entry__.dryrun_multichip`).

Spawns n gloo ranks (`mesh.launch`) that sweep, on a 1-D data mesh at tiny
shapes: (1) the type-I sum of conv-TT members, the flagship's training
configuration; (2) one conv-TT on the packed route (TNF_PACKED_SYRK_MIN_D=1),
which must call the Gram kernels on every rank (on the CPU, their wrappers
take the plain versions). For an even n, on the 2-D (2, n / 2) data x model
mesh with the patches sharded over "model": (3) a conv-TT training step;
(4) the same on the packed kernel route (N=3), the wrappers called on every
rank; (5) a MINRES swipe of an r=16 conv-TT, after checking that the Gram
stage's rows are conserved: every rank holds S / n of them. Prints one "OK"
line for each.

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
    counts = {k: v for k, v in counts.items() if v}
    if n % 2 == 0:
        lines += _rank_2d(n, device, rng)
    return lines, counts


def _conv_data(rng, S, P, pp, C, dev):
    x = torch.tensor(rng.standard_normal((S, P, pp)), dtype=torch.float32, device=dev)
    y = torch.tensor(np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)], device=dev)
    return x, y


def _rank_2d(n: int, device: str, rng) -> list:
    """The 2-D lines (3)-(5) of the module docstring, on a (2, n / 2) mesh."""
    from ..core.engine import Network
    from ..core.sweep import SweepConfig, Sweeper
    from ..models.layers import TensorConvolutionTrainLayer
    from ..ops.bregman import XEBregman

    mesh = pmesh.make_mesh(axis=("data", "model"), shape=(2, n // 2), device=device)
    dev, mdl, pp, C = mesh.device, n // 2, 6, 3
    labels = ("patches",)
    lines = []

    # (3) samples over "data", the patches over "model"; params replicated
    layer = TensorConvolutionTrainLayer(
        num_carriages=2, bond_dim=3, num_patches=2 * mdl, patch_pixels=pp,
        output_shape=(C,), convolution_bond=2, seed=3, device=dev)
    S2 = 2 * n
    x, y = _conv_data(rng, S2, 2 * mdl, pp, C, dev)
    _, ok = Sweeper(layer.network, XEBregman(w=1.0), SweepConfig(
        num_swipes=1, batch_size=S2 // 2, method="ridge_cholesky", eps=1.0)).run(
        [layer.params], x, y, mesh=mesh, model_axis_labels=labels)
    assert ok, "2-D (data, model) sharded training step reported failure"
    lines.append(f"dryrun_multichip({n}): 2D data x model tensor-parallel "
                 f"training step OK on mesh {mesh.shape}")

    # (4) the packed kernel route under the 2-D mesh: J's rows go to the
    # ranks with all columns (all-to-all over "model"), the kernels run on
    # each rank's rows, A and b are summed over every rank
    saved = os.environ.get("TNF_PACKED_SYRK_MIN_D")
    os.environ["TNF_PACKED_SYRK_MIN_D"] = "1"
    try:
        layer = TensorConvolutionTrainLayer(
            num_carriages=3, bond_dim=3, num_patches=2 * mdl, patch_pixels=pp,
            output_shape=(C,), convolution_bond=2, seed=11, device=dev)
        net = Network(layer.topology, device=dev, use_kernels=True)
        x, y = _conv_data(rng, 4 * n, 2 * mdl, pp, C, dev)
        with counted_kernels() as counts:
            _, ok = Sweeper(net, XEBregman(w=1.0), SweepConfig(
                num_swipes=1, batch_size=2 * n, method="ridge_cholesky", eps=1.0)).run(
                [layer.params], x, y, mesh=mesh, model_axis_labels=labels)
        assert ok, "kernels-under-TP dry-run sweep reported failure"
        assert sum(counts.values()) > 0, \
            "kernels-under-TP dry run did not route through the kernels"
    finally:
        if saved is None:
            del os.environ["TNF_PACKED_SYRK_MIN_D"]
        else:
            os.environ["TNF_PACKED_SYRK_MIN_D"] = saved
    lines.append(f"dryrun_multichip({n}): 2D TP with the Gram kernels (rows to "
                 f"every rank + all-reduce) OK on mesh {mesh.shape}")

    # (5) the matrix-free tier: every matvec summed over the model group
    # where it sums the patches and over "data" after
    r = 16
    layer = TensorConvolutionTrainLayer(
        num_carriages=3, bond_dim=r, num_patches=2 * mdl, patch_pixels=pp,
        output_shape=(C,), convolution_bond=2, seed=13, device=dev)
    S4 = 4 * n
    x, y = _conv_data(rng, S4, 2 * mdl, pp, C, dev)
    rows = pmesh.rows_of(pmesh.shard_chunked(x[None], mesh)[0], mesh)
    held = pmesh.all_reduce_sum(torch.tensor([rows.shape[0]]), mesh)
    assert rows.shape[0] == S4 // n and int(held) == S4, \
        f"row-count violation: {rows.shape[0]} rows here, {int(held)} in all (S={S4})"
    _, ok = Sweeper(layer.network, XEBregman(w=1.0), SweepConfig(
        num_swipes=1, batch_size=-1, method="minres", eps=1e-1, max_iter=8,
        tol=1e-6)).run([layer.params], x, y, mesh=mesh, model_axis_labels=labels)
    assert ok, "2-D mesh matrix-free dry-run sweep reported failure"
    lines.append(f"dryrun_multichip({n}): mesh matrix-free OK: MINRES sweep step "
                 f"(middle-core D={r * 2 * mdl * r}, matvecs summed over the model "
                 f"and data groups) on mesh {mesh.shape}; rows {S4}/{n} per rank "
                 "conserved")
    return lines


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
