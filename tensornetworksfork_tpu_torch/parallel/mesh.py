"""Data and tensor parallelism over torch.distributed (port of
tensornetworksfork_tpu/parallel/mesh.py).

The Gauss-Newton system A = sum_s JᵀHJ, b = sum_s Jᵀg is a plain sum over
samples, so sharding the samples is exact: each rank keeps its contiguous
block of every chunk's rows (`shard_chunked`), accumulates its own A and b
with the kernels, and the sweep sums them over the ranks once per node
update (`all_reduce_sum`, called at the sweep's reduction sites in
core/sweep.py). The solve then runs replicated from bit-identical A and b,
so every rank holds the same params. The JAX package shards arrays over a
device mesh and lets XLA insert the collectives; here they are explicit.

A 2-D ("data", "model") mesh of d x m ranks (rank k at (k // m, k % m),
row-major, as the JAX package's Mesh(devices.reshape(d, m))) also shards
the input axes whose topology labels the caller names (`model_labels`,
e.g. "patches") over "model" (`shard_chunked_inputs`). The engine then
slices the params on those axes to the rank's block, sums over the model
group every contraction that sums such an axis, and hands the Gram stage
whole-sample row blocks with all their columns (an all-to-all over the
model group, `all_to_all`): core/engine.py.

One process a rank (`launch`), backend gloo: NCCL refuses two ranks on one
card, and the card's machine has one.
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

COLLECTIVES = ("all_reduce", "broadcast", "all_to_all")
# seconds a collective of a sub-group may take: `launch` sets it in each rank
# to the world group's timeout (None: torch's default)
_GROUP_TIMEOUT: Optional[float] = None


def _zero_stats() -> dict:
    return {kind: {"calls": 0, "bytes": 0, "seconds": 0.0, "copy_seconds": 0.0}
            for kind in COLLECTIVES}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of ranks: the world group, the axis name (a 1-D mesh) or
    names, the world size, this process's rank, the device its tensors
    live on, and for a 2-D mesh the axes' sizes (`dims`) and each axis's
    sub-group holding this rank (`groups`). `stats` counts its collectives
    since `reset_stats`, by kind (COLLECTIVES): calls, bytes of the tensors
    moved, host seconds in all and of those the staging copies' (each call
    ends synchronised: the copy to the host waits for the device)."""

    group: object
    axis: object
    size: int
    rank: int
    device: torch.device
    stats: dict = dataclasses.field(default_factory=_zero_stats, compare=False)
    dims: Tuple[int, ...] = ()
    groups: dict = dataclasses.field(default_factory=dict, compare=False)

    def reset_stats(self) -> None:
        self.stats.update(_zero_stats())

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axis) if isinstance(self.axis, (tuple, list)) else (self.axis,)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims or (self.size,)))

    def axis_size(self, name: Optional[str] = None) -> int:
        """Ranks along axis `name` (None: the world)."""
        return self.size if name is None else self.shape[name]

    def axis_rank(self, name: Optional[str] = None) -> int:
        """This rank's index along axis `name` (None: its world rank);
        rank-major over the axes, the last fastest."""
        if name is None:
            return self.rank
        names, sizes = self.axis_names, list(self.shape.values())
        k = names.index(name)
        stride = 1
        for d in sizes[k + 1:]:
            stride *= d
        return (self.rank // stride) % sizes[k]

    def axis_group(self, name: Optional[str] = None):
        """The sub-group of this rank along axis `name`: the world group for
        None and for the one axis of a 1-D mesh."""
        if name is None:
            return self.group
        if name not in self.axis_names:
            raise KeyError(f"mesh {self.axis_names} has no axis {name!r}")
        return self.group if len(self.axis_names) == 1 else self.groups[name]


def make_mesh(n_devices: Optional[int] = None, axis="data", device="cuda",
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over the initialised default process group, one rank a
    device. `axis` is one name (a 1-D mesh over every rank) or the pair
    ("data", "model") with `shape` (d, m), d x m the world size: the 2-D
    mesh, rank k at (k // m, k % m), each rank in one data group (the d
    ranks of its model index) and one model group (the m ranks of its data
    index). Every rank must call make_mesh alike: each calls `new_group`
    for every sub-group, in one order. `device` "cuda" (the default) gives
    rank k the card k % device_count (ranks share a card when there are
    fewer) and makes it current; "cpu" keeps every rank on the CPU. Raises
    when no group is initialised, when n_devices or the shape's product
    differs from the world size, and for any other axis tuple."""
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    if len(names) not in (1, 2) or (len(names) == 2 and names != ("data", "model")):
        raise ValueError(f"mesh axes {names}: one axis, or ('data', 'model')")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(parallel.launch, or torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has {world} ranks")
    dims: Tuple[int, ...] = ()
    groups = {}
    if len(names) == 2:
        if shape is None or len(shape) != 2 or shape[0] * shape[1] != world:
            raise ValueError(f"a ('data', 'model') mesh of shape {shape} does not hold "
                             f"the {world} ranks of the process group")
        d, m = int(shape[0]), int(shape[1])
        dims = (d, m)
        timeout = (None if _GROUP_TIMEOUT is None
                   else datetime.timedelta(seconds=_GROUP_TIMEOUT))
        # every rank creates every group, in the same order
        for j in range(m):
            g = dist.new_group([i * m + j for i in range(d)], timeout=timeout)
            if rank % m == j:
                groups["data"] = g
        for i in range(d):
            g = dist.new_group([i * m + j for j in range(m)], timeout=timeout)
            if rank // m == i:
                groups["model"] = g
    elif shape is not None and tuple(shape) != (world,):
        raise ValueError(f"a 1-D mesh of shape {shape} does not hold the {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD, axis=names if dims else names[0],
                size=world, rank=rank, device=dev, dims=dims, groups=groups)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def block(x: torch.Tensor, dim: int, n: int, k: int, what: str = "") -> torch.Tensor:
    """Block k of n equal contiguous blocks of x along dim (a copy). Raises
    ValueError when the dim does not split evenly."""
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim}{' (' + what + ')' if what else ''} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    b = x.shape[dim] // n
    return x.narrow(dim, k * b, b).contiguous()


def shard_chunked(tree, mesh: Mesh, axis: Optional[str] = None):
    """This rank's contiguous block of dim 1 (the per-chunk samples) of
    every (nchunks, B, ...) tensor of `tree` along mesh axis `axis` (the
    mesh's first, "data", by default), as the JAX package's
    P(None, 'data'); tensors of fewer dims are kept whole. B must be a
    multiple of the axis size."""
    axis = axis or mesh.axis_names[0]
    n, k = mesh.axis_size(axis), mesh.axis_rank(axis)
    return _map(lambda x: x if x.ndim < 2 else block(x, 1, n, k, "samples"), tree)


def rows_of(x: torch.Tensor, mesh: Mesh, groups: int = 1, dim: int = 0,
            axis: str = "model") -> torch.Tensor:
    """Of each of `groups` equal runs of x's dim `dim`, this rank's
    contiguous block along mesh axis `axis`, the runs' blocks joined in
    order (a copy). Raises ValueError when the runs do not split evenly."""
    n, k = mesh.axis_size(axis), mesh.axis_rank(axis)
    rows, shape = x.shape[dim], tuple(x.shape)
    if rows % (groups * n):
        raise ValueError(f"{rows} rows do not split into {groups} runs over {n} ranks")
    runs = x.reshape(shape[:dim] + (groups, n, rows // (groups * n)) + shape[dim + 1:])
    return runs.select(dim + 1, k).reshape(shape[:dim] + (rows // n,)
                                           + shape[dim + 1:]).contiguous()


def shard_chunked_inputs(inputs: dict, mesh: Mesh, labels_by_name: dict,
                         model_labels=(), data_axis: str = "data",
                         model_axis: str = "model", sample_dim: str = "s") -> dict:
    """The chunked input dict (each value (nchunks, B, *rest), rest in the
    order of the node's labels after the sample label) sharded on the
    samples over `data_axis`, and on every rest dim whose label is in
    `model_labels` over `model_axis`: the model rank's contiguous block.
    Raises ValueError when such a dim does not split evenly, and when
    model labels are given to a mesh without a model axis."""
    if model_labels and model_axis not in mesh.axis_names:
        raise ValueError(f"model labels {tuple(model_labels)} need a mesh with a "
                         f"{model_axis!r} axis, not {mesh.axis_names}")
    out = {}
    for name, x in inputs.items():
        x = shard_chunked(x, mesh, data_axis)
        rest = [lbl for lbl in labels_by_name.get(name, ()) if lbl != sample_dim]
        for d, lbl in enumerate(rest, start=2):
            if lbl in model_labels and x.ndim > d:
                x = block(x, d, mesh.axis_size(model_axis), mesh.axis_rank(model_axis),
                          f"{name}'s {lbl!r}")
        out[name] = x
    return out


def _host(t: torch.Tensor) -> torch.Tensor:
    """t itself when it is a contiguous CPU tensor, else a contiguous host
    copy (the copy to the host waits for the device)."""
    return t if t.device.type == "cpu" and t.is_contiguous() else t.detach().cpu().contiguous()


def _count(mesh: Mesh, kind: str, nbytes: int, t0, t1, t2, t3) -> None:
    s = mesh.stats[kind]
    s["calls"] += 1
    s["bytes"] += nbytes
    s["seconds"] += t3 - t0
    s["copy_seconds"] += (t1 - t0) + (t3 - t2)


def _collective(t: torch.Tensor, mesh: Mesh, kind: str,
                axis: Optional[str] = None) -> torch.Tensor:
    """All-reduce (sum) over axis `axis` (None: every rank), or broadcast
    from rank 0 to every rank, of `t`, in place; returns t. A contiguous
    CPU tensor goes to gloo as it is. A CUDA tensor (or a strided one) is
    staged through a host copy, reduced there and copied back: gloo's own
    CUDA path stages through pinned host memory as well, and staging here
    gives CPU and CUDA ranks one code path whose copies the counters time.
    Decided once, here; there is no fallback."""
    t0 = time.perf_counter()
    host = _host(t)
    t1 = time.perf_counter()
    if kind == "all_reduce":
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.axis_group(axis))
    else:
        dist.broadcast(host, src=0, group=mesh.group)
    t2 = time.perf_counter()
    if host is not t:
        t.copy_(host)
    _count(mesh, kind, t.numel() * t.element_size(), t0, t1, t2, time.perf_counter())
    return t


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """t summed over the ranks of mesh axis `axis` (None: every rank), in
    place (and returned). Every rank of the group ends with the same bits."""
    return _collective(t, mesh, "all_reduce", axis)


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """Dim 0 of t (of size n, the ranks along `axis`) scattered over the
    axis: block k goes to the axis's rank k, and the result's block k is
    what rank k sent this rank (a new tensor on t's device, of t's shape and
    dtype). The bytes travel as uint8, so every dtype moves bit for bit;
    staged through the host as `_collective` stages."""
    n = mesh.axis_size(axis)
    if t.shape[0] != n:
        raise ValueError(f"all_to_all over {n} ranks needs dim 0 of size {n}, "
                         f"not {tuple(t.shape)}")
    t0 = time.perf_counter()
    flat = _host(t).reshape(n, -1).view(torch.uint8)
    got = torch.empty_like(flat)
    t1 = time.perf_counter()
    dist.all_to_all_single(got, flat, group=mesh.axis_group(axis))
    t2 = time.perf_counter()
    out = got.view(t.dtype).reshape(t.shape).to(t.device)
    _count(mesh, "all_to_all", t.numel() * t.element_size(), t0, t1, t2,
           time.perf_counter())
    return out


def replicate(tree, mesh: Mesh):
    """Every tensor of `tree` broadcast from rank 0 (copies; the tree's own
    tensors are left as they are)."""
    return _map(lambda x: _collective(x.clone(), mesh, "broadcast"), tree)


def agree(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Rank 0's `flag` on every rank (the flag itself without a mesh): a
    branch that decides whether collectives run must decide the same way on
    every rank, or one rank waits in a collective for ever."""
    if mesh is None:
        return bool(flag)
    return bool(_collective(torch.tensor([int(bool(flag))], dtype=torch.int32),
                            mesh, "broadcast")[0])


def gather_chunked(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full (nchunks, B, ...) tensor from each rank's shard (nchunks,
    B / n, ...) along the mesh's first (data) axis: each rank's shard placed
    in a zero tensor at its rows, then summed over the axis (gloo has no
    all-gather of CUDA tensors)."""
    axis = mesh.axis_names[0]
    b, k = x.shape[1], mesh.axis_rank(axis)
    full = x.new_zeros((x.shape[0], b * mesh.axis_size(axis)) + tuple(x.shape[2:]))
    full[:, k * b:(k + 1) * b] = x
    return all_reduce_sum(full, mesh, axis)


# ------------------------------------------------------------------ launch
def _rank_main(fn, rank, n, store_path, timeout, threads, results, args):
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        global _GROUP_TIMEOUT
        _GROUP_TIMEOUT = timeout
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
