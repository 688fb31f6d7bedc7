"""Data parallelism over torch.distributed (port of
tensornetworksfork_tpu/parallel/mesh.py).

The Gauss-Newton system A = sum_s JᵀHJ, b = sum_s Jᵀg is a plain sum over
samples, so sharding the samples is exact: each rank keeps its contiguous
block of every chunk's rows (`shard_chunked`), accumulates its own A and b
with the kernels, and the sweep sums them over the ranks once per node
update (`all_reduce_sum`, called at the sweep's reduction sites in
core/sweep.py). The solve then runs replicated from bit-identical A and b,
so every rank holds the same params. The JAX package shards arrays over a
device mesh and lets XLA insert the psum; here the collectives are explicit.

One process a rank (`launch`), backend gloo: NCCL refuses two ranks on one
card, and the card's machine has one. The 2-D (data x model) mesh is ROADMAP
item 17, step 2: asking for it raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

STEP2 = "ROADMAP item 17, step 2 (the 2-D data x model mesh) is not ported yet"


def _zero_stats() -> dict:
    return {"calls": 0, "bytes": 0, "seconds": 0.0, "copy_seconds": 0.0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: the process group, its axis name, its size, this
    process's rank and the device its tensors live on. `stats` counts its
    collectives since `reset_stats`: calls, bytes of the tensors reduced or
    broadcast, host seconds in all and of those the staging copies' (each
    call ends synchronised: the copy to the host waits for the device)."""

    group: object
    axis: str
    size: int
    rank: int
    device: torch.device
    stats: dict = dataclasses.field(default_factory=_zero_stats, compare=False)

    def reset_stats(self) -> None:
        self.stats.update(_zero_stats())

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def make_mesh(n_devices: Optional[int] = None, axis="data",
              device="cuda") -> Mesh:
    """A mesh over the initialised default process group, one rank a
    device. `device` "cuda" (the default) gives rank k the card
    k % device_count (two ranks share a card when there is one) and makes
    it current; "cpu" keeps every rank on the CPU. Raises when no group is
    initialised or when n_devices differs from the world size; a 2-D axis
    tuple raises NotImplementedError."""
    if isinstance(axis, (tuple, list)):
        if len(axis) != 1:
            raise NotImplementedError(f"mesh axes {tuple(axis)}: {STEP2}")
        axis = axis[0]
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(parallel.launch, or torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD, axis=axis, size=world, rank=rank, device=dev)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def shard_chunked(tree, mesh: Mesh):
    """This rank's contiguous block of dim 1 (the per-chunk samples) of
    every (nchunks, B, ...) tensor of `tree`, as the JAX package's
    P(None, 'data'); tensors of fewer dims are kept whole. B must be a
    multiple of the mesh size."""
    def take(x):
        if x.ndim < 2:
            return x
        if x.shape[1] % mesh.size:
            raise ValueError(f"dim 1 of {tuple(x.shape)} does not split over "
                             f"{mesh.size} ranks")
        b = x.shape[1] // mesh.size
        return x[:, mesh.rank * b:(mesh.rank + 1) * b].contiguous()
    return _map(take, tree)


def shard_chunked_inputs(inputs: dict, mesh: Mesh, labels_by_name: dict,
                         model_labels=(), data_axis: str = "data",
                         model_axis: str = "model", sample_dim: str = "s") -> dict:
    """The chunked input dict sharded on the samples. Sharding input axes
    over a model axis (`model_labels`) raises NotImplementedError."""
    if model_labels:
        raise NotImplementedError(f"model_labels {tuple(model_labels)}: {STEP2}")
    return shard_chunked(inputs, mesh)


def _collective(t: torch.Tensor, mesh: Mesh, reduce: bool) -> torch.Tensor:
    """All-reduce (sum) or broadcast from rank 0 of `t`, in place; returns
    t. A contiguous CPU tensor goes to gloo as it is. A CUDA tensor (or a
    strided one) is staged through a host copy, reduced there and copied
    back: gloo's own CUDA path stages through pinned host memory as well,
    and staging here gives CPU and CUDA ranks one code path whose copies
    the counters time. Decided once, here; there is no fallback."""
    t0 = time.perf_counter()
    host = t if t.device.type == "cpu" and t.is_contiguous() else t.detach().cpu().contiguous()
    t1 = time.perf_counter()
    if reduce:
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
    else:
        dist.broadcast(host, src=0, group=mesh.group)
    t2 = time.perf_counter()
    if host is not t:
        t.copy_(host)
    t3 = time.perf_counter()
    mesh.stats["calls"] += 1
    mesh.stats["bytes"] += t.numel() * t.element_size()
    mesh.stats["seconds"] += t3 - t0
    mesh.stats["copy_seconds"] += (t1 - t0) + (t3 - t2)
    return t


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t summed over the mesh's ranks, in place (and returned). Every rank
    ends with the same bits."""
    return _collective(t, mesh, reduce=True)


def replicate(tree, mesh: Mesh):
    """Every tensor of `tree` broadcast from rank 0 (copies; the tree's own
    tensors are left as they are)."""
    return _map(lambda x: _collective(x.clone(), mesh, reduce=False), tree)


def agree(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Rank 0's `flag` on every rank (the flag itself without a mesh): a
    branch that decides whether collectives run must decide the same way on
    every rank, or one rank waits in a collective for ever."""
    if mesh is None:
        return bool(flag)
    return bool(_collective(torch.tensor([int(bool(flag))], dtype=torch.int32),
                            mesh, reduce=False)[0])


def gather_chunked(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full (nchunks, B, ...) tensor from each rank's shard (nchunks,
    B / size, ...): each rank's shard placed in a zero tensor at its rows,
    then summed over the ranks (gloo has no all-gather of CUDA tensors)."""
    b = x.shape[1]
    full = x.new_zeros((x.shape[0], b * mesh.size) + tuple(x.shape[2:]))
    full[:, mesh.rank * b:(mesh.rank + 1) * b] = x
    return all_reduce_sum(full, mesh)


# ------------------------------------------------------------------ launch
def _rank_main(fn, rank, n, store_path, timeout, threads, results, args):
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        store = dist.FileStore(store_path, n)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
        results.put((rank, True, out))
    except Exception:  # the parent raises it, with this rank's traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, n: int, *args, timeout: float = 300.0, join_timeout: float = 900.0,
           threads: Optional[int] = None):
    """Runs fn(*args) in `n` fresh processes (the spawn start method), each a
    rank of a gloo group initialised through a FileStore in a temporary
    directory (so concurrent launches never contend for a port). Returns
    the ranks' return values in rank order (they are pickled: return CPU
    tensors or numpy). `timeout` bounds each collective, so a rank stuck in
    one fails with its traceback; `join_timeout` bounds the whole run,
    after which every rank is killed and TimeoutError raised. The first
    failure reported is raised here as RuntimeError with that rank's
    traceback, after the other ranks are killed. `threads` sets each rank's
    torch.set_num_threads."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, os.path.join(tmp, "store"), timeout,
                                   threads, results, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + join_timeout
        try:
            while len(out) < n:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"launch: {n - len(out)} of {n} ranks did "
                                           f"not finish within {join_timeout} s")
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead and results.empty():
                        time.sleep(1.0)  # a result may still be in flight
                        if results.empty():
                            raise RuntimeError(f"launch: rank {dead[0]} exited with "
                                               f"code {procs[dead[0]].exitcode} "
                                               "and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"launch: rank {rank} of {n} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                if p.is_alive() and len(out) < n:
                    p.kill()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n)]
