"""Card probe of the bf16 aux tier on chip_smoke's tiny reference swipe
(phase 6: conv-TT, N=4, r=4, CB=2, 96 samples of 6 patches x 5 pixels, 3
logits, f32 Gram operands, TNF_AUX_PRECISION=default), against the same
swipe on the CPU:

- the card's swipe as the port runs it (bf16 products with an f32 result,
  `out_dtype`);
- the card's swipe with every aux product in the CPU's form (the rounded
  operands multiplied in f32);
- the card's swipe with the aux tier off, against the CPU's with it off;
- each aux product the card's swipe makes, against the float64 product of
  the same bf16-rounded operands: the largest error over the entry's
  natural size sum_k |a||b|, in units of sqrt(K) 2^-24, by shape;
- how many of the values the aux products round to bf16 differ between
  the card's and the CPU's swipes, at the first product where they differ.

Run from the repository root on a CUDA machine:

    python3 tensornetworksfork_tpu_torch/experiments/probes/aux_reference_probe.py
"""
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tensornetworksfork_tpu_torch.core import contract as cmod, engine  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer  # noqa: E402
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)

rng = np.random.default_rng(1)
S, P, pp, C = 96, 6, 5, 3
X = rng.standard_normal((S, P, pp)).astype(np.float32)
y = np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]
PLAIN = cmod.matmul


def swipe(dev, aux, record=None, form=None):
    """Predictions (on the CPU) after the tiny swipe on `dev`; `record`
    collects (a16, b16, out) of each aux product; `form` replaces the aux
    product."""
    def product(a, b, precision="highest"):
        out = (form or PLAIN)(a, b, precision)
        if precision == "default" and record is not None:
            record.append((a.to(torch.bfloat16), b.to(torch.bfloat16), out))
        return out

    cmod.matmul = engine.matmul = product
    try:
        with cs.env(TNF_PACKED_SYRK_MIN_D=1, TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION=aux):
            layer = TensorConvolutionTrainLayer(4, 4, P, pp, output_shape=(C,),
                                                convolution_bond=2, seed=0, device=dev,
                                                use_kernels=True)
            cfg = SweepConfig(num_swipes=1, batch_size=48, method="ridge_cholesky",
                              eps=5.0, eps_decay=0.25)
            Xd, yd = torch.tensor(X, device=dev), torch.tensor(y, device=dev)
            params, ok = Sweeper(layer.network, XEBregman(1.0), cfg).run(
                [layer.params], Xd, yd)
            return layer.network.forward(params[0], Xd).cpu()
    finally:
        cmod.matmul = engine.matmul = PLAIN


def rounded_f32(a, b, precision="highest"):
    if precision != "default":
        return PLAIN(a, b, precision)
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


dev = torch.device("cuda")
cpu_rec, card_rec = [], []
ref = swipe("cpu", "default", cpu_rec)
top = float(ref.abs().max())
card = swipe(dev, "default", card_rec)
print(f"[aux-ref] card (out_dtype) vs cpu: max|d pred| / max|pred| "
      f"{float((card - ref).abs().max()) / top:.3g}", flush=True)
card_r = swipe(dev, "default", form=rounded_f32)
print(f"[aux-ref] card (rounded operands in f32, the CPU's form) vs cpu: "
      f"{float((card_r - ref).abs().max()) / top:.3g}", flush=True)
off_cpu, off_card = swipe("cpu", "highest"), swipe(dev, "highest")
print(f"[aux-ref] aux off, card vs cpu: "
      f"{float((off_card - off_cpu).abs().max()) / float(off_cpu.abs().max()):.3g}; "
      f"aux on vs off on the cpu: {float((ref - off_cpu).abs().max()) / top:.3g}", flush=True)

worst = {}
for a16, b16, out in card_rec:
    exact = a16.double() @ b16.double()
    size = a16.double().abs() @ b16.double().abs()
    unit = a16.shape[-1] ** 0.5 * 2.0 ** -24
    r = float(((out.double() - exact).abs() / size.clamp_min(1e-300)).max()) / unit
    key = (tuple(a16.shape), tuple(b16.shape))
    worst[key] = max(worst.get(key, 0.0), r)
for key, r in sorted(worst.items(), key=lambda kv: -kv[1]):
    print(f"[aux-ref] card product a {key[0]} b {key[1]}: max err {r:.3g} sqrt(K) 2^-24 "
          f"of sum|a||b|", flush=True)

print(f"[aux-ref] aux products: cpu {len(cpu_rec)}, card {len(card_rec)}", flush=True)
for i, ((a_c, b_c, _), (a_g, b_g, _)) in enumerate(zip(cpu_rec, card_rec)):
    if a_c.shape != a_g.shape or b_c.shape != b_g.shape:
        print(f"[aux-ref] product {i}: shapes differ", flush=True)
        break
    da = int((a_c != a_g.cpu()).sum())
    db = int((b_c != b_g.cpu()).sum())
    if da or db:
        print(f"[aux-ref] first product whose bf16 operands differ: {i} of {len(cpu_rec)}, "
              f"a {tuple(a_c.shape)} {da} of {a_c.numel()} values, b {tuple(b_c.shape)} "
              f"{db} of {b_c.numel()}", flush=True)
        break
else:
    print("[aux-ref] every aux product got the same bf16 operands on the card and the cpu",
          flush=True)
