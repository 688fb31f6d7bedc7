"""First card probe of the 3xTF32 K6 kernel and the vectorised K8: builds
the kernels (printing ptxas's lines), runs the K6 and K8 card tests, then
times K8 against F.pad and K6 at the conv-TT flagship's A2 shape (f32:
against plain, float64, the split Gram's f32 FMA kernel and addmm_; bf16:
against bf16 torch.mm). Run from the repository root on a CUDA machine:

    python3 tensornetworksfork_tpu_torch/experiments/probes/k6_k8_first_probe.py
"""
import os, subprocess, sys, time, traceback
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from tensornetworksfork_tpu_torch.ops.cuda import _build, gram as kg

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
t = time.time(); kg._build.lib(); print("build", time.time() - t, flush=True)
for ln in _build.BUILD_INFO["log"].splitlines():
    if "registers" in ln or "spill" in ln or "Compiling" in ln or "arning" in ln:
        print("[ptxas]", ln.strip())
rc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                     "-q", "-x", "tests/test_torch_cuda.py", "-k",
                     "carry or retile_rows_bit"], capture_output=True, text=True)
print(rc.stdout[-6000:], rc.stderr[-3000:], flush=True)
dev = torch.device("cuda")

def step(name, fn):
    try:
        fn()
    except Exception:
        print(f"[{name}] FAILED"); traceback.print_exc()

def k6():
    rows, D, Dp = 18432, 16200, 16384
    gen = torch.Generator(device=dev).manual_seed(6)
    J, K = (torch.nn.functional.pad(torch.randn((rows, D), generator=gen, device=dev) * 0.05,
                                    (0, Dp - D)) for _ in range(2))
    acc = torch.zeros((Dp, Dp), device=dev)
    kg.gram_pair(J, K, acc=acc, D=D)
    torch.cuda.synchronize()
    A_p = J[:, :D].T @ K[:, :D]
    err = float((acc[:D, :D] - A_p).triu().abs().max()); tol = 1e-5 * float(A_p.abs().max())
    print(f"[k6 f32] err {err:.3g} tol {tol:.3g}", flush=True)
    del A_p
    A64, sc = cs.pair_float64(J[:, :D], K[:, :D])
    print(f"[k6 f32] float64 ratio {cs.pair_errors(acc[:D, :D], A64, sc)[1] / 2**-24:.3g}", flush=True)
    del A64, sc
    ms = cs.time_ms(lambda: kg.gram_pair(J, K, acc=acc, D=D))
    fma = cs.time_ms(lambda: kg._launch_wgram_split(J, None, 0, None, acc, D, True, 1, "g", Y=K, has_acc=True))
    lib = cs.time_ms(lambda: acc.addmm_(J.T, K))
    print(f"[k6 f32] tf32x3 {ms:.3f} ms, split FMA {fma:.3f}, addmm_ {lib:.3f}", flush=True)
    Jb, Kb = J.to(torch.bfloat16), K.to(torch.bfloat16)
    del J, K
    accb = torch.zeros_like(acc); kg.gram_pair(Jb, Kb, acc=accb, D=D); torch.cuda.synchronize()
    A_p = Jb[:, :D].float().T @ Kb[:, :D].float()
    err = float((accb[:D, :D] - A_p).triu().abs().max()); tol = 1e-5 * float(A_p.abs().max())
    del A_p
    ms = cs.time_ms(lambda: kg.gram_pair(Jb, Kb, acc=acc, D=D))
    with cs.bf16_f32_reduction():
        lib = cs.time_ms(lambda: torch.mm(Jb.T, Kb))
    print(f"[k6 bf16] err {err:.3g} tol {tol:.3g}; {ms:.3f} ms, torch.mm {lib:.3f}", flush=True)

def k8():
    X = torch.randn(512, 8256, device=dev)
    for _ in range(3):
        a = cs.time_ms(lambda: kg.retile_rows(X, 8704))
        b = cs.time_ms(lambda: torch.nn.functional.pad(X, (0, 448)))
        print(f"[k8] kernel {a:.4f} ms, F.pad {b:.4f} ms", flush=True)

step("k8", k8)
step("k6", k6)
