"""The traced window, read from `torch.profiler`'s raw events.

The window is the benchmark's own span `portbench.window`. Device
operations (kernels, copies, sets) are clipped to it; each is tied to the
host time of its launch (the runtime call of its own correlation id, or
else the host operation its linked correlation id names). The solve's
device time is that of the operations launched inside the benchmark's
spans `portbench.solve`, which a driver puts around the program's solve
(`spans()`). Idle gaps are the gaps between the merged device intervals,
each named by the outermost host operation that overlaps it the most
("host" where none does).
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, List, Tuple

import torch

from .harness import HERE

WINDOW = "portbench.window"
SOLVE = "portbench.solve"


def port_kernels() -> List[str]:
    with open(HERE / "counts" / "kernels.json") as f:
        return json.load(f)["port_kernels"]


class Trace:
    def __init__(self, prof):
        cpu = torch.autograd.DeviceType.CPU
        evs = prof.profiler.kineto_results.events()
        ops, launch, dev, solve = [], {}, [], []
        w0 = w1 = None
        for e in evs:
            name = e.name()
            if e.device_type() == cpu:
                s, t = e.start_ns(), e.start_ns() + e.duration_ns()
                if name == WINDOW:
                    w0, w1 = s, t
                    continue
                if name == SOLVE:
                    solve.append((s, t))
                    continue
                if name.startswith("aten::"):
                    ops.append((s, t, name))
                    launch[("op", e.correlation_id())] = s
                elif e.correlation_id():
                    launch[("rt", e.correlation_id())] = s
            elif name not in (WINDOW, SOLVE) and not e.is_user_annotation():
                s = e.start_ns()
                dev.append((s, s + e.duration_ns(), name, e.correlation_id(),
                            e.linked_correlation_id()))
        if w0 is None:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        self.w0, self.w1 = w0, w1
        self.window_s = (w1 - w0) / 1e9
        # (start, end, name, host time of its launch or None)
        self.dev = [(max(s, w0), min(t, w1), n,
                     launch.get(("rt", c)) or launch.get(("op", lk)))
                    for s, t, n, c, lk in dev if t > w0 and s < w1]
        self.launched = sum(1 for d in self.dev if d[3] is not None)
        ops.sort(key=lambda o: (o[0], -o[1]))
        self.top: List[Tuple[int, int, str]] = []
        end = -1
        for s, t, n in ops:
            if s >= end:
                self.top.append((s, t, n))
                end = t
        self._top_starts = [o[0] for o in self.top]
        solve.sort()
        self.solve_spans = solve
        self._solve_starts = [s for s, _ in solve]

    # ------------------------------------------------------------ device time
    def busy(self) -> List[Tuple[int, int]]:
        iv = sorted((s, t) for s, t, _, _ in self.dev if t > s)
        merged: List[List[int]] = []
        for s, t in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) / 1e9

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, t, n, _ in self.dev:
            out[n] = out.get(n, 0.0) + (t - s) / 1e9
        return out

    def _in_solve(self, at) -> bool:
        if at is None:
            return False
        i = bisect.bisect_right(self._solve_starts, at) - 1
        return i >= 0 and self.solve_spans[i][0] <= at < self.solve_spans[i][1]

    def split(self) -> Dict[str, float]:
        """Device seconds of the port's own kernels, of the solve's (launched
        inside a solve span) and of everything else; the solve's is None
        where the window holds no solve span."""
        mine = port_kernels()
        out = {"port": 0.0, "solve": 0.0, "other": 0.0}
        for s, t, n, c in self.dev:
            k = ("port" if any(m in n for m in mine)
                 else "solve" if self._in_solve(c) else "other")
            out[k] += (t - s) / 1e9
        if not self.solve_spans:
            out["solve"] = None
        return out

    # ------------------------------------------------------------- breakdown
    def host_op_in(self, s: int, t: int) -> str:
        """The outermost host operation that overlaps [s, t) the most, or
        "host" where none does."""
        best, name = 0, "host"
        i = max(bisect.bisect_left(self._top_starts, s) - 1, 0)
        while i < len(self.top) and self.top[i][0] < t:
            a, b, n = self.top[i]
            ov = min(b, t) - max(a, s)
            if ov > best:
                best, name = ov, n
            i += 1
        return name

    def idle_gaps(self) -> List[Tuple[str, float]]:
        edges = [self.w0] + [x for iv in self.busy() for x in iv] + [self.w1]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [(self.host_op_in(s, t), (t - s) / 1e9) for s, t in gaps[:10]]

    def top_ops(self) -> List[Tuple[str, float]]:
        return sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
