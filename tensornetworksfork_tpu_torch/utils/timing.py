"""Phase timing (port of tensornetworksfork_tpu/utils/timing.py: `Timer`).

Each phase synchronises the CUDA device at its start and end, so its totals
are the card's time and not the host's launch time (the JAX package blocks
on its results for the same reason). The JAX package's `xla_trace` is not
ported (ROADMAP item 18).
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
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
