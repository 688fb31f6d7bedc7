"""Card probe of the bf16 aux tier's product (`core/contract.py` `matmul`
at precision "default": operands rounded to bf16, products summed in f32, an
f32 result). For 2-D (`torch.mm`) and batched (`torch.bmm`) products:

- whether `out_dtype=torch.float32` exists for bf16 CUDA operands and
  returns f32;
- its error against the float64 product of the same bf16-rounded operands,
  with cuBLAS allowed to reduce bf16 products in reduced precision
  (`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`,
  torch's default) and with that forbidden (as `matmul` calls it), beside
  the rounded-operand f32 product's (`a16.float() @ b16.float()`) and a
  bf16-output product's (`a16 @ b16`, which rounds its result). Each error
  is the largest |out - ref| over the entry's natural size sum_k |a||b|, in
  units of sqrt(K) 2^-24 (the card test's bound is 4 of them), and over
  max|ref|;
- the time of each form at the shapes of the conv-TT flagship's aux
  products (CUDA events, median of 5), the packed prediction at several
  row counts.

Run from the repository root on a CUDA machine:

    python3 tensornetworksfork_tpu_torch/experiments/probes/aux_probe.py
"""
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
flag = torch.backends.cuda.matmul
print(f"allow_bf16_reduced_precision_reduction by default: "
      f"{flag.allow_bf16_reduced_precision_reduction}", flush=True)
dev = torch.device("cuda")
torch.manual_seed(0)

# (what, shape of a, shape of b): the staged conv advance's three products
# (2,048 samples, 50 patches x 17 pixels, CB = 8, r = 18, 9 classes carried),
# the packed Jacobian's batched product and the packed prediction at A2
# (18,432 = 2,048 x 9 rows) and at fewer rows
SHAPES = [
    ("advance U = X @ conv", (2048 * 50, 17), (17, 64)),
    ("advance V (batched)", (2048, 50 * 8, 8), (2048, 8, 9 * 18)),
    ("advance env = V @ core", (2048 * 8 * 9, 18 * 50), (18 * 50, 18)),
    ("packed J (batched)", (2048, 9 * 18, 8), (2048, 8, 50 * 18)),
    ("packed predict", (2048 * 9, 16200), (16200, 1)),
    ("packed predict, 2,048 rows", (2048, 16200), (16200, 1)),
    ("packed predict, 999 rows", (999, 16200), (16200, 1)),
    ("card test, 999 x 4,100", (999, 4100), (4100, 1)),
]


def product(a, b, out_dtype=None):
    fn = torch.bmm if a.ndim == 3 else torch.mm
    return fn(a, b) if out_dtype is None else fn(a, b, out_dtype=out_dtype)


def reduced(allow: bool, fn):
    old = flag.allow_bf16_reduced_precision_reduction
    flag.allow_bf16_reduced_precision_reduction = allow
    try:
        return fn()
    finally:
        flag.allow_bf16_reduced_precision_reduction = old


for what, sa, sb in SHAPES:
    a = torch.randn(sa, device=dev)
    b = torch.randn(sb, device=dev)
    a16, b16 = a.bfloat16(), b.bfloat16()
    ref = product(a16.double(), b16.double())
    size = product(a16.double().abs(), b16.double().abs())
    unit = sa[-1] ** 0.5 * 2.0 ** -24
    top = float(ref.abs().max())

    def err(out):
        d = (out.double() - ref).abs()
        return f"{float((d / size).max()) / unit:.3g} ({float(d.max()) / top:.3g})"

    try:
        on = reduced(True, lambda: product(a16, b16, torch.float32))
        off = reduced(False, lambda: product(a16, b16, torch.float32))
        has = f"exists, returns {off.dtype}"
        e_on, e_off = err(on), err(off)
        ms_on = reduced(True, lambda: cs.time_ms(lambda: product(a16, b16, torch.float32)))
        ms_off = reduced(False, lambda: cs.time_ms(lambda: product(a16, b16, torch.float32)))
    except (RuntimeError, NotImplementedError, TypeError) as e:
        has = f"missing ({type(e).__name__}: {str(e)[:120]})"
        e_on = e_off = "nan"
        ms_on = ms_off = float("nan")
    rounded = product(a16.float(), b16.float())
    ms_r = cs.time_ms(lambda: product(a16.float(), b16.float()))
    ms_cast = cs.time_ms(lambda: (a.bfloat16(), b.bfloat16()))
    e_bf = err(reduced(False, lambda: product(a16, b16)))
    ms_f32 = cs.time_ms(lambda: product(a, b))
    print(f"[aux] {what}: a {tuple(sa)} b {tuple(sb)}; out_dtype=f32 {has}; "
          f"max|err|/sum|a||b| in sqrt(K) 2^-24 (max|err|/max|ref|): out_dtype with "
          f"reduced-precision reduction allowed {e_on}, forbidden {e_off}, rounded-f32 "
          f"{err(rounded)}, bf16-output {e_bf}; ms out_dtype allowed {ms_on:.4f}, "
          f"forbidden {ms_off:.4f}, rounded-f32 {ms_r:.4f}, f32 (no rounding) "
          f"{ms_f32:.4f}, the two bf16 casts {ms_cast:.4f}", flush=True)
