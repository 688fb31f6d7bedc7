"""Where a free-kernel Gaussian-process classifier's card and CPU fits part.

    python studies/gpc_card_cpu_study.py [--device cuda]

For each classification cell of `experiments/kernel_baselines.py`
KERNEL_OPTIONS (the cells chip_smoke.py phase 14 (v) fits), the wrapper is
fitted on the device and on the CPU, and each binary problem's P(class 1)
at the validation and test rows is split into two parts:

- the θ part: the CPU's mode search rerun at the device's fitted θ (from
  f = 0, as the fit's final mode search starts) against the CPU's own fit;
  this is how far L-BFGS-B's two paths move the answer;
- the arithmetic part: the device's fit against that CPU rerun, both at the
  device's θ; this is how far the two devices' float64 arithmetic parts for
  one θ. Its latent mean and variance are printed apart, with the largest
  k(x, x), the condition number of B = I + W^1/2 K W^1/2 at the mode and
  the largest |f| there.

Needs torch only (no sklearn, no JAX). Run from the repository's root.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    from tensornetworksfork_tpu_torch.models import _gp
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    cpu = torch.device("cpu")
    if dev.type == "cuda":
        print(f"[gpc study] {torch.cuda.get_device_name(0)}", flush=True)
    for option, (expression, params, tables) in kb.KERNEL_OPTIONS.items():
        for name in tables:
            data, task = kb.table(name)
            if task != "classification":
                continue
            X = np.concatenate([data["X_val"], data["X_test"]])
            t0 = time.perf_counter()
            w = kb.kernel_model(option, task, str(dev)).fit(data["X_train"], data["y_train"])
            wc = kb.kernel_model(option, task, "cpu").fit(data["X_train"], data["y_train"])
            p_dev = w.fit_.proba(w._x(X)).cpu()
            p_cpu = wc.fit_.proba(wc._x(X))
            # the CPU's final mode search at the device's θ, each binary problem
            Xs = wc._x(X)
            again = [_gp.laplace_mode(f.X.to(cpu), f.y.to(cpu), f.kernel,
                                      int(w.params["max_iter_predict"]))
                     for f in w.fit_.fits]
            shared = _gp.BinaryFits(again, w.fit_.lml, w.fit_.n_eval, w.fit_.optima,
                                    w.fit_.chosen)
            p_shared = shared.proba(Xs)
            mean_d, var_d = w.fit_.latent(w._x(X))
            mean_s, var_s = shared.latent(Xs)
            scale = max(float(f.kernel.diag(Xs).max()) for f in again)
            conds, fmax = [], 0.0
            for f in again:
                W_sr = f.W_sr[0]
                Bm = torch.eye(W_sr.numel(), dtype=torch.float64) + (
                    W_sr[:, None] * f.kernel(f.X) * W_sr[None, :])
                ev = torch.linalg.eigvalsh(Bm)
                conds.append(float(ev[-1] / ev[0]))
                fmax = max(fmax, float(f.f.abs().max()))
            dtheta = float(np.abs(w.theta_ - wc.theta_).max())
            print(f"[gpc study] {option} {name}: {len(again)} binary problem(s), "
                  f"|d theta| {dtheta:.3g}; max |d P(class 1)|: device fit - CPU fit "
                  f"{float((p_dev - p_cpu).abs().max()):.3g} = arithmetic (device - CPU at "
                  f"the device's theta) {float((p_dev - p_shared).abs().max()):.3g} + theta "
                  f"(CPU at the device's theta - CPU fit) "
                  f"{float((p_shared - p_cpu).abs().max()):.3g}; at the device's theta "
                  f"|d mean| {float((mean_d.cpu() - mean_s).abs().max()):.3g} (max |mean| "
                  f"{float(mean_s.abs().max()):.4g}), |d var| "
                  f"{float((var_d.cpu() - var_s).abs().max()):.3g} (var "
                  f"{float(var_s.min()):.4g}-{float(var_s.max()):.4g}); largest k(x, x) "
                  f"{scale:.4g}, cond(B) {max(conds):.4g}, max |f| {fmax:.4g}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
