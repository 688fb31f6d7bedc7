"""Where K8's time goes: host time per call of its wrapper and of its parts
(stream lookup, allocation, the ctypes launch) against F.pad, then device
time alone from CUDA graphs and from torch.profiler. Run from the
repository root on a CUDA machine:

    python3 tensornetworksfork_tpu_torch/experiments/probes/k8_host_probe.py
"""
import os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from tensornetworksfork_tpu_torch.ops.cuda import _build, gram as kg
dev = torch.device("cuda")
X = torch.randn(512, 8256, device=dev)
lib = _build.lib()
F = torch.nn.functional
print("torch", torch.__version__, "raw stream api", hasattr(torch._C, "_cuda_getCurrentRawStream"))

def host_us(fn, n=300):
    fn(); torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    h = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return h

Jt = torch.empty((512, 8704), device=dev)
raw = lambda: lib.tnf_retile_rows_f32(X.data_ptr(), None, Jt.data_ptr(), None, 512, 8256, 8704, 132, torch.cuda.current_stream().cuda_stream)
s = torch.cuda.current_stream().cuda_stream
raw2 = lambda: lib.tnf_retile_rows_f32(X.data_ptr(), None, Jt.data_ptr(), None, 512, 8256, 8704, 132, s)
cands = {"wrapper": lambda: kg.retile_rows(X, 8704), "pad": lambda: F.pad(X, (0, 448)),
         "raw ctypes": raw, "raw ctypes cached stream": raw2,
         "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
         "empty": lambda: torch.empty((512, 8704), device=dev),
         "sm_count": lambda: kg.sm_count(X.device), "_build.lib": _build.lib}
for k, f in cands.items():
    print(f"[host] {k}: {host_us(f):.2f} us/call", flush=True)
for k in ("wrapper", "pad", "raw ctypes cached stream"):
    print(f"[time_ms] {k}: {cs.time_ms(cands[k]) * 1e3:.2f} us", flush=True)
# device time from CUDA graphs of 20 calls
for k in ("wrapper", "pad"):
    g = torch.cuda.CUDAGraph()
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        cands[k]()
        with torch.cuda.graph(g, stream=st):
            for _ in range(20):
                cands[k]()
    torch.cuda.current_stream().wait_stream(st)
    print(f"[graph] {k}: {cs.time_ms(g.replay) / 20 * 1e3:.2f} us per call", flush=True)
from torch.profiler import profile, ProfilerActivity
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for _ in range(50):
        cands["wrapper"](); cands["pad"]()
    torch.cuda.synchronize()
for e in p.key_averages():
    if e.device_type.name == "CUDA" or "retile" in e.key or "pad" in e.key:
        print(f"[prof] {e.key[:70]}: count {e.count}, device {getattr(e, 'device_time', getattr(e, 'cuda_time', 0)):.2f} us avg, cpu {e.cpu_time:.2f} us")
