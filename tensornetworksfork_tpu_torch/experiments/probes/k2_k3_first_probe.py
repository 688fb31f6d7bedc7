"""First card probe of the one-read K-major quantiser (K2) and the s8 wgmma
int8 Gram (K3): builds the kernels (printing ptxas's lines for them), runs
their card tests, then, at the conv-TT flagship's A2/A3 chunk (18,432 x
16,384 bf16, blocks of 2,048 rows), times K2 at strips of 16 and 32 columns
a CTA and K3 against its plain version (bit for bit) and torch._int_mm over
the same blocks. Run from the repository root on a CUDA machine:

    python3 tensornetworksfork_tpu_torch/experiments/probes/k2_k3_first_probe.py
"""
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tensornetworksfork_tpu_torch.ops.cuda import _build, gram as kg  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
t0 = time.time()
_build.lib()
print(f"build {time.time() - t0:.1f} s", flush=True)
show = False
for ln in _build.BUILD_INFO["log"].splitlines():
    if "Compiling entry" in ln:
        show = "quantize" in ln or "gram_q" in ln
    if show or "arning" in ln:
        print("[ptxas]", ln.strip(), flush=True)
# the card tests in a child process with a time limit, so a kernel that
# never finishes ends the probe instead of the call
try:
    rc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p",
                         "no:cacheprovider", "-q", "-x", "tests/test_torch_cuda.py", "-k",
                         "quantize_tiled or gram_pair_band_q or gram_pair_tiled_q"],
                        capture_output=True, text=True, timeout=240)
    print(rc.stdout[-8000:], rc.stderr[-3000:], flush=True)
    if rc.returncode != 0:
        sys.exit(1)
except subprocess.TimeoutExpired as err:
    print("card tests timed out:", (err.stdout or b"")[-4000:], flush=True)
    sys.exit(1)
dev = torch.device("cuda")


def step(name, fn):
    try:
        fn()
    except Exception:
        print(f"[{name}] FAILED", flush=True)
        traceback.print_exc()


def flagship():
    rows, Dp, block = 18432, 16384, 2048
    gen = torch.Generator(device=dev).manual_seed(3)
    X, K = ((torch.randn((rows, Dp), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
            for _ in range(2))
    Q1, s1 = kg.quantize_tiled(X, block)
    Q2, s2 = kg.quantize_tiled(K, block)
    Qp, sp = kg.quantize_tiled_plain(K, block)
    torch.cuda.synchronize()
    print(f"[k2] bit-equal {torch.equal(Q2, Qp) and torch.equal(s2, sp)}, "
          f"strides {Q2.stride()} plain {Qp.stride()}", flush=True)
    del Qp, sp
    lib = _build.lib()
    ldq = Q2.stride(1)
    Qt = torch.empty((Dp, ldq), dtype=torch.int8, device=dev)
    s = torch.empty((rows // block, Dp), device=dev)
    for W in (16, 32, 16, 32):
        fn = lambda: lib.tnf_quantize_bf16(K.data_ptr(), Qt.data_ptr(), s.data_ptr(), rows, Dp,
                                           block, rows // block, ldq, W, kg._stream(X.device))
        assert fn() == 0
        torch.cuda.synchronize()
        same = torch.equal(Qt[:, :rows].T, Q2)
        print(f"[k2] strip {W}: {cs.time_ms(fn):.4f} ms, equal {same} "
              f"(bound {(K.numel() * 3 + s.numel() * 4) / cs.HBM * 1e3:.4f} ms)", flush=True)
    del Qt, s, X, K
    acc = torch.zeros((Dp, Dp), device=dev)
    kg.gram_pair_band_q(Q1, s1, Q2, s2, acc)
    acc_p = torch.zeros_like(acc)
    kg.gram_pair_q_plain(Q1, s1, Q2, s2, acc_p)
    torch.cuda.synchronize()
    print(f"[k3] bit-equal {torch.equal(acc, acc_p)}, max|d| "
          f"{float((acc - acc_p).abs().max()):.3g}", flush=True)
    del acc_p
    ms = cs.time_ms(lambda: kg.gram_pair_band_q(Q1, s1, Q2, s2, acc))
    ops = 2.0 * rows * 32 * 33 / 2 * 512 ** 2
    l2 = 2.0 * 8448 * 128 * rows
    print(f"[k3] {ms:.3f} ms, {ops / ms / 1e9:.1f} TOP/s, L2 {l2 / ms / 1e9:.2f} TB/s", flush=True)
    print(f"[k3] {cs.int_mm_ms(Q1, Q2, block)[1]}", flush=True)


step("flagship", flagship)
