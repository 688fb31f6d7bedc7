"""Card probe of K1 (`retile_hmix`): builds the kernels (printing ptxas's
lines for K1), then, at the conv-TT flagship's A2/A3 chunk (S = 2,048
samples, C = 9 classes, D = 16,200, Dp = 16,384) and at a small ragged one
(S = 40, C = 9, D = 701), in bf16 and in f32: Jt and Kt against the plain
version (Jt bit for bit; the share of Kt bit-equal and its largest error in
ulps of its dtype), K1's time beside its byte bound and the plain version's,
and the right-hand side b = Jtᵀg as the engine formed it before K1 could
(an f32 copy of Jt, then a product). Where `retile_hmix` takes `gvec` it
also times K1 with the fused b, checks that b, and times K1 without it,
then rebuilds K1 in variants of csrc/gram.cu (more values of J a thread
holds, three or four CTAs an SM) under build/k1_variants/ and times each at
the flagship chunk. Run from the repository root on a CUDA machine:

    python3 tensornetworksfork_tpu_torch/experiments/probes/k1_probe.py
"""
import inspect
import os
import pathlib
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman  # noqa: E402
from tensornetworksfork_tpu_torch.ops.cuda import _build, gram as kg  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
t0 = time.time()
_build.lib()
print(f"build {time.time() - t0:.1f} s", flush=True)


def ptxas_lines(what, only=None):
    """ptxas's register and spill lines of every K1 instantiation of the
    last build (`only`: the end of the template arguments to keep, e.g.
    "Li9E" for C = 9)."""
    tag = ""
    for ln in _build.BUILD_INFO["log"].splitlines():
        if "Compiling entry" in ln:
            tag = (ln.split("retile_hmix_kernel")[1].split("EEv")[0]
                   if "retile_hmix_kernel" in ln else "")
        elif tag and ("registers" in ln or "spill" in ln) and (only is None
                                                              or tag.endswith(only)):
            print(f"[ptxas {what}] {tag}: {ln.strip()}", flush=True)
        if "arning" in ln:
            print(f"[ptxas {what}] {ln.strip()}", flush=True)


ptxas_lines("build")
dev = torch.device("cuda")
fused = "gvec" in inspect.signature(kg.retile_hmix).parameters
if fused:
    # the card tests of K1 first, in a child process with a time limit
    try:
        rc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p",
                             "no:cacheprovider", "-q", "-x", "tests/test_torch_cuda.py",
                             "-k", "retile_hmix"], capture_output=True, text=True,
                            timeout=240)
        print(rc.stdout[-6000:], rc.stderr[-3000:], flush=True)
        if rc.returncode != 0:
            sys.exit(1)
    except subprocess.TimeoutExpired as err:
        print("card tests timed out:", (err.stdout or b"")[-4000:], flush=True)
        sys.exit(1)


def ulps(x, ref, dtype):
    """|x - ref| in ulps of `dtype` at |ref|."""
    mant = 7 if dtype == torch.bfloat16 else 23
    ax = ref.abs().clamp_min(torch.finfo(dtype).tiny)
    return (x - ref).abs() / torch.exp2(torch.floor(torch.log2(ax)) - mant)


def probe(S, C, D, dtype):
    Dp = kg.plan_tiles(D)[3]
    rng = np.random.default_rng(S + D)
    J3 = torch.tensor(rng.standard_normal((S, C, D), np.float32) * 0.05, device=dev).to(dtype)
    logits = torch.tensor(rng.standard_normal((S, C), np.float32), device=dev)
    onehot = torch.eye(C + 1, device=dev)[torch.tensor(rng.integers(0, C + 1, S), device=dev)]
    _, g, H = XEBregman(1.0)(logits, onehot)
    H = H.contiguous()
    gvec = g.T.reshape(-1).to(dtype).contiguous()  # class-major, as the engine orders it
    what = f"S={S} C={C} D={D} {str(dtype)[6:]}"
    out = kg.retile_hmix(J3, H, Dp, gvec) if fused else kg.retile_hmix(J3, H, Dp)
    pl = kg.retile_hmix_plain(J3, H, Dp, gvec) if fused else kg.retile_hmix_plain(J3, H, Dp)
    torch.cuda.synchronize()
    Jt, Kt = out[0], out[1]
    u = ulps(Kt.float(), pl[1].float(), dtype)
    line = (f"[k1] {what}: Jt bit-equal {torch.equal(Jt, pl[0])}, Kt max {float(u.max()):.3g} "
            f"ulp, {float((u == 0).float().mean()) * 100:.4f}% bit-equal")
    b_old = (gvec.float() @ Jt.float())
    if fused:
        Jf = Jt.float().abs()
        scale = (gvec.float().abs() @ Jf)
        del Jf
        rel = float(((out[2] - b_old).abs() / scale.clamp_min(1e-30)).max())
        line += f"; b vs Jtᵀg max {rel / 2.0 ** -24:.3g} 2^-24 of sum|g||J|"
    print(line, flush=True)
    del pl
    nb = cs.nbytes(J3, H, Jt, Kt)
    ms = cs.time_ms(lambda: kg.retile_hmix(J3, H, Dp, gvec) if fused
                    else kg.retile_hmix(J3, H, Dp))
    line = (f"[k1] {what}: kernel {ms:.4f} ms, bound {nb / cs.HBM * 1e3:.4f} ms "
            f"({nb / 1e9:.3f} GB), {nb / ms / 1e9:.3f} TB/s")
    if fused:
        line += f"; without b {cs.time_ms(lambda: kg.retile_hmix(J3, H, Dp)):.4f} ms"
    line += (f"; old rhs (gvec.float() @ Jt.float()) {cs.time_ms(lambda: gvec.float() @ Jt.float()):.4f} ms"
             f"; plain {cs.time_ms(lambda: kg.retile_hmix_plain(J3, H, Dp)):.3f} ms")
    print(line, flush=True)


for dt in (torch.bfloat16, torch.float32):
    probe(40, 9, 701, dt)
    probe(2048, 9, 16200, dt)
    torch.cuda.empty_cache()


# variants of the packed kernel: (name, replacements in csrc/gram.cu, the
# plan's CTAs an SM)
VARIANTS = [
    ("144 values a thread (C=9: 2 samples bf16, 4 f32)",
     {"kHmixValues = 64;": "kHmixValues = 144;"}, 2),
    ("3 CTAs an SM", {"__launch_bounds__(kHmixThreads, 2)": "__launch_bounds__(kHmixThreads, 3)"}, 3),
    ("4 CTAs an SM", {"__launch_bounds__(kHmixThreads, 2)": "__launch_bounds__(kHmixThreads, 4)"}, 4),
]


CSRC = _build.CSRC


def variant(name, subs, resident):
    root = pathlib.Path("build/k1_variants") / str(abs(hash(name)))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(CSRC, root / "csrc")
    src = (root / "csrc" / "gram.cu").read_text()
    for old, new in subs.items():
        assert old in src, old
        src = src.replace(old, new)
    (root / "csrc" / "gram.cu").write_text(src)
    _build.CSRC, _build.BUILD_DIR, _build._lib = root / "csrc", root / "lib", None
    kg.HMIX_RESIDENT = resident
    _build.lib()
    ptxas_lines(name, only="Li9E")
    for dt in (torch.bfloat16, torch.float32):
        J3, H, gvec = cs.hmix_inputs(2048, 9, 16200, dt, dev)
        out = kg.retile_hmix(J3, H, 16384, gvec)
        ref = kg.retile_hmix_plain(J3, H, 16384, gvec)
        torch.cuda.synchronize()
        ok = torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        ms = cs.time_ms(lambda: kg.retile_hmix(J3, H, 16384, gvec))
        print(f"[variant {name}] {str(dt)[6:]}: {ms:.4f} ms, Jt/Kt equal {ok}", flush=True)
        del J3, H, gvec, out, ref
        torch.cuda.empty_cache()


if fused:
    for v in VARIANTS:
        variant(*v)
