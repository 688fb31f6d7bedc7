"""Card probe of the bf16 aux tier on the conv-TT flagship: one swipe
(S = 8,192, `chip_smoke.run_slice`) in the int8 Gram tier with the aux
contractions in f32 and one in `bench.py`'s tier (PRECISION=fastest: int8
Gram operands and TNF_AUX_PRECISION=default), for weights and data from
seeds 0-3. Prints each pair's losses, |d loss| / loss and wall times; the
largest relative difference sets chip_smoke's AUX_LOSS_RTOL. Then one swipe
of each tier (seed 0) with TNF_SWEEP_TIMERS=1, whose report splits the
swipe's time by node update (each phase synchronised, so its wall time is
not the untimed swipe's), and one under `torch.profiler`: the operations
that take the most device time. Run from the repository root on a CUDA
machine:

    python3 tensornetworksfork_tpu_torch/experiments/probes/aux_tier_probe.py
"""
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tensornetworksfork_tpu_torch.ops.cuda import _build  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
_build.lib()
device = torch.device("cuda")
cs.run_slice(device, "int8")  # a first swipe on a fresh machine runs slow
worst = 0.0
for seed in range(4):
    a = cs.run_slice(device, "int8", seed=seed)
    b = cs.run_slice(device, "fastest", seed=seed)
    rel = abs(b["loss1"] - a["loss1"]) / a["loss1"]
    worst = max(worst, rel)
    print(f"[aux-tier] seed {seed}: int8 loss {a['loss1']:.6f} ({a['wall']:.3f} s), "
          f"fastest loss {b['loss1']:.6f} ({b['wall']:.3f} s), |d loss| / loss {rel:.3g}",
          flush=True)
print(f"[aux-tier] largest |d loss| / loss over seeds 0-3: {worst:.3g}", flush=True)

from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper  # noqa: E402
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman  # noqa: E402

X, y = cs.flagship_data(cs.SLICE_SAMPLES, 0, device)
for tier in ("int8", "fastest"):
    with cs.env(TNF_SWEEP_TIMERS=1, **cs.SLICE_TIERS[tier]):
        layer = cs.flagship_layer(device, 0)
        sweeper = Sweeper(layer.network, XEBregman(w=1.0),
                          SweepConfig(**cs.SLICE_CONFIG))  # reads the knob here
        sweeper.run([layer.params], X, y)
    for ln in sweeper.timer_report().splitlines():
        print(f"[timers {tier}] {ln}", flush=True)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

for tier in ("int8", "fastest"):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cs.run_slice(device, tier)
    rows = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    for ln in rows.splitlines():
        print(f"[profile {tier}] {ln}", flush=True)
