"""Card probe of the CIFAR_minres headline (`chip_smoke.run_cifar_minres`:
train_image, PRESET=cifar_minres, N=4, r=100, CB=5, one whole swipe):
where the matrix-free swipe's device time goes. Each matrix-free node
update, each MINRES solve in it and each matvec of that solve is bracketed
by CUDA events (no host sync) and by a `torch.profiler.record_function`
range. The first run prints the event split: matvec (J v, H u and Jᵀ u over
the chunks), the Krylov vector work (the rest of the solve: dots, norms,
the masked updates, the host reads), the linearisation and the scale probe
(the rest of the update) and everything else of train_seconds
(environment chains, the validation forward after each update, train_image
itself). The second run, under `torch.profiler`, prints the operations that
take the most device time and the ranges' device totals. Run from the repository root on
a CUDA machine:

    python3 tensornetworksfork_tpu_torch/experiments/probes/krylov_probe.py [samples]

`samples` defaults to chip_smoke's CIFAR_SAMPLES (49,152 to train).
"""
import contextlib
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tensornetworksfork_tpu_torch.core import krylov  # noqa: E402
from tensornetworksfork_tpu_torch.core import sweep as tsweep  # noqa: E402

card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, flush=True)
if len(sys.argv) > 1:
    cs.CIFAR_ENV["SYNTHETIC_SAMPLES"] = int(sys.argv[1])
device = torch.device("cuda")


class Spans:
    """CUDA event pairs per label, summed after one synchronise."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def span(self, label):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with record_function(label):
            yield
        end.record()
        self.events.setdefault(label, []).append((start, end))

    def totals_ms(self):
        torch.cuda.synchronize()
        return {k: (sum(s.elapsed_time(e) for s, e in v), len(v))
                for k, v in self.events.items()}


spans = Spans()
solve = krylov.SOLVERS["minres"]
update = tsweep.Sweeper._update_matrix_free


def minres(matvec, b, **kw):
    def timed_matvec(v):
        with spans.span("krylov matvec"):
            return matvec(v)
    with spans.span("krylov solve"):
        return solve(timed_matvec, b, **kw)


def matrix_free_update(self, *args, **kw):
    with spans.span("matrix-free update"):
        return update(self, *args, **kw)


krylov.SOLVERS["minres"] = minres
tsweep.Sweeper._update_matrix_free = matrix_free_update

_, train_s = cs.run_cifar_minres(device, card)
tot = spans.totals_ms()
upd, n_upd = tot["matrix-free update"]
sol, n_sol = tot["krylov solve"]
mv, n_mv = tot["krylov matvec"]
print(f"[krylov-probe] {card}: train_seconds {train_s}: {n_upd} matrix-free updates "
      f"{upd:.1f} ms of stream time; their MINRES solves {sol:.1f} ms = matvec "
      f"{mv:.1f} ms ({n_mv} matvecs, {mv / max(n_mv, 1):.2f} ms each) + Krylov "
      f"vector work {sol - mv:.1f} ms; linearisation and scale probe "
      f"{upd - sol:.1f} ms; outside the updates {train_s * 1e3 - upd:.1f} ms",
      flush=True)

spans.events.clear()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    cs.run_cifar_minres(device, card)
spans.events.clear()
avg = prof.key_averages()
for ln in avg.table(sort_by="cuda_time_total", row_limit=25).splitlines():
    print(f"[krylov-probe] {ln}", flush=True)
