"""Phase timing and tracing (port of tensornetworksfork_tpu/utils/timing.py).

`span(name)` marks a region of the program for `torch.profiler`: under a
running profiler, with TNF_SPANS=1 in the environment, it is a
`record_function` range, which lands in the same timeline as the CUDA
activity; otherwise it is a shared no-op context, and where no profiler
runs it costs one check that the profiler is enabled. The program's spans
are named `tnf.<layer>...` (`core/sweep.py`, `Timer.phase`); the serving
callable of `utils/serving.py` opens its own, `tnf.serve.call`, with torch
alone. They are off unless asked for: a reader that keys a profile's CPU
events by correlation id would take a range's id, the profiler's op id, for
a runtime call's.

Each `Timer` phase synchronises the CUDA device at its start and end, so its
totals are the card's time and not the host's launch time (the JAX package
blocks on its results for the same reason). `block_on` waits for the
devices of the tensors it is given, as `jax.block_until_ready`. `xla_trace`
keeps the JAX package's name so that a reader finds the counterpart; here
it is a `torch.profiler` context (the host and, where a card is visible,
CUDA activity) that writes a Chrome trace into its directory on exit.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A `torch.profiler.record_function(name)` range where the profiler is
    enabled and TNF_SPANS=1, else a no-op context."""
    if _profiler_enabled() and os.environ.get("TNF_SPANS") == "1":
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def block_on(x):
    """Waits until the work producing the tensors of `x` (a tensor, or
    dicts, lists and tuples of them) is done on their CUDA devices; returns
    `x`."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


class Timer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        """Times the block (synchronised) and marks it as the span
        `tnf.phase:<name>`."""
        with span(f"tnf.phase:{name}"):
            _sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _sync()
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def rate(self, name: str):
        t = self.totals.get(name, 0.0)
        return self.counts[name] / t if t > 0 else float("nan")

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }


@contextmanager
def xla_trace(log_dir: str = "build/tnf_trace"):
    """A `torch.profiler` trace of the block: host activity, and CUDA
    activity where a card is visible. Yields `log_dir`, as the JAX package
    does; on exit the Chrome trace (chrome://tracing or Perfetto) is written
    there as `trace-<pid>-<ms>.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        _sync()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{int(time.time() * 1000)}.json"))
