#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (`tensornetworksfork_tpu_torch`, never the JAX package) through
its two main paths — the conv-TT classifier's sweep and the tabular
TT-regression estimator — and fails loudly on any fault. Phases, each
printing its own lines:

1. environment — torch/CUDA versions and the card's name and power limit
   (nvidia-smi); fails without a CUDA device (it never runs on the CPU);
2. build — compiles the kernels from `tensornetworksfork_tpu_torch/csrc`;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, with its tolerance, and the kernel's and
   the plain version's times (CUDA events, median of 5): K1, K2, K3, K6 and
   K10 at the conv-TT flagship's shapes; K8, K7, K9 and K11 at the
   regression's (and K11 also at the flagship's first core);
4. slice — one swipe of `Sweeper.run` on the flagship conv-TT
   (N=4, r=18, CB=8, 50 patches x 17 pixels, 9 logits, random weights from a
   seed) over 8192 synthetic samples in the int8 Gram tier (K1, K2, K3,
   K10), then one in the f32 tier (K1, K6, K10); the launch counters show
   every kernel of each run ran, and each swipe must lower the training
   loss, keep every parameter finite and report no singular solve;
5. regression — `TensorTrainRegressor(N=3, r=8)` fitted for two swipes on
   `make_regression` (128 features, 65,536 rows to fit, 16,384 to
   validate) in the f32 tier, which must report no singular solve, keep
   every parameter finite, beat predicting the mean on the validation rows
   and launch K8, K7 and K9; then one more swipe with the opt-in own-out
   kernel (K11), which must agree with the default route, and one in the
   int8 tier (K8, K2, K3);
6. reference — a tiny conv-TT swipe (f32, int8) and a tiny TT-regression
   swipe (f32, bf16, int8) with the kernels on the card agree with the same
   swipes through the plain versions on the CPU (which the CPU tests hold
   against the JAX package).

Each path resets the launch counters just before it runs and reads them just
after. The line before last is a JSON object of the kernels' results; the
last line is {"ok": true, "device": {...}}. Any failure raises and exits
nonzero.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = dict(N=4, r=18, CB=8, P=50, pp=17, C=9)
SLICE_SAMPLES = 8192
BATCH = 2048
# the tabular regression: the repo's RunConfig defaults (N=3, r=8, 512-row
# chunks, eps 5.0 x 0.25) on 128 features (+ the bias column: f = 129)
REGRESSION = dict(N=3, r=8, d=128, fit=65536, val=16384, batch=512)
# the kernels each path must launch (the flagship's by Gram tier)
FLAGSHIP_KERNELS = {"int8": ("retile_hmix", "quantize_tiled", "gram_pair_q", "gram_pair"),
                    "f32": ("retile_hmix", "gram_pair_tiled", "gram_pair")}
REGRESSION_KERNELS = ("retile_rows", "weighted_gram_tiled", "weighted_gram")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def time_ms(fn, reps: int = 5) -> float:
    """Median over `reps` runs of fn's device time, from CUDA events (one
    warm-up run first)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bf16_ulp(x):
    """One bf16 ulp at |x| (x float32 tensor): 2^(exponent - 7)."""
    import torch
    ax = x.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


def gram_tol(rows: int) -> float:
    """Tolerance on max|A - A_plain| relative to max|A| for an f32 Gram
    summed over `rows` rows: each kernel thread adds its rows in sequence,
    the plain version in cuBLAS's blocked order, so the two differ by about
    sqrt(rows) f32 roundings; held to 4 sqrt(rows) 2^-24, at least 1e-5."""
    return max(1e-5, 4 * float(np.sqrt(rows)) * 2.0 ** -24)


def k9_ratios(A, A64):
    """max |A - A64| / sqrt(A64_dd A64_ee) on the diagonal and off it, for a
    weighted Gram A against its float64 value A64. Each thread of the kernel
    sums its rows in sequence: a diagonal entry's partial sums grow to A_dd,
    so it carries about sqrt(rows) f32 roundings of A_dd (held to gram_tol);
    an off-diagonal entry of independent zero-mean columns random-walks, so
    its error is about 0.75 2^-24 sqrt(A_dd A_ee) (held to 16 2^-24). A
    bf16 rounding of the operands moves every entry by ~2^-9 of a term,
    hundreds of 2^-24 off the diagonal."""
    import torch
    d = A64.diagonal()
    r = (A.double() - A64).abs() / torch.sqrt(torch.outer(d, d))
    return float(r.diagonal().max()), float(r.fill_diagonal_(0).max())


def check_kernels(device, S=BATCH, D=None, rows4=None, D4=None):
    """Phase 3: every kernel against its plain version, by default at the
    flagship shapes: A2/A3 (S=2048 per chunk, C=9, D=r*P*r=16,200) for K1,
    K2, K3 and K6, A4 (8192*9 merged rows, D=r*P=900) for K10."""
    import torch
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    rng = np.random.default_rng(0)
    C = FLAGSHIP["C"]
    D = D or FLAGSHIP["r"] * FLAGSHIP["P"] * FLAGSHIP["r"]
    _, block, _, Dp = kg.plan_tiles(D)
    J3 = torch.tensor(rng.standard_normal((S, C, D), np.float32) * 0.05,
                      device=device).to(torch.bfloat16)
    logits = torch.tensor(rng.standard_normal((S, C), np.float32), device=device)
    onehot = torch.eye(C + 1, device=device)[
        torch.tensor(rng.integers(0, C + 1, S), device=device)]
    _, _, H = XEBregman(1.0)(logits, onehot)
    H = H.contiguous()
    results = []

    # K1 retile_hmix: Jt bit-equal, Kt within 1 bf16 ulp
    Jt, Kt = kg.retile_hmix(J3, H, Dp)
    Jt_p, Kt_p = kg.retile_hmix_plain(J3, H, Dp)
    torch.cuda.synchronize()
    if not torch.equal(Jt, Jt_p):
        raise AssertionError("retile_hmix: Jt differs from the plain version")
    dK = (Kt.float() - Kt_p.float()).abs()
    ulps = float((dK / bf16_ulp(Kt_p.float())).max())
    if ulps > 1.0:
        raise AssertionError(f"retile_hmix: Kt off by {ulps} bf16 ulp (> 1)")
    results.append(dict(
        name="retile_hmix", err=float(dK.max()),
        ms=time_ms(lambda: kg.retile_hmix(J3, H, Dp)),
        plain_ms=time_ms(lambda: kg.retile_hmix_plain(J3, H, Dp)),
        note=f"Jt bit-equal, Kt max {ulps:.3g} bf16 ulp "
             f"({float((dK == 0).float().mean()) * 100:.4f}% bit-equal)"))
    del Jt_p, Kt_p, dK

    # K2 quantize_tiled: Q and s bit-equal
    Q1, s1 = kg.quantize_tiled(Jt, block)
    Q2, s2 = kg.quantize_tiled(Kt, block)
    Q1_p, s1_p = kg.quantize_tiled_plain(Jt, block)
    Q2_p, s2_p = kg.quantize_tiled_plain(Kt, block)
    torch.cuda.synchronize()
    for a, b, what in ((Q1, Q1_p, "Q(J)"), (s1, s1_p, "s(J)"),
                       (Q2, Q2_p, "Q(K)"), (s2, s2_p, "s(K)")):
        if not torch.equal(a, b):
            raise AssertionError(f"quantize_tiled: {what} differs from plain")
    results.append(dict(
        name="quantize_tiled", err=0.0,
        ms=time_ms(lambda: kg.quantize_tiled(Kt, block)),
        plain_ms=time_ms(lambda: kg.quantize_tiled_plain(Kt, block)),
        note="Q and s bit-equal"))
    del Q1_p, s1_p, Q2_p, s2_p

    # K3 gram_pair_band_q over two chained chunks, finished by mirror_band
    acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=device)
    acc_p = torch.zeros_like(acc)
    for _ in range(2):
        kg.gram_pair_band_q(Q1, s1, Q2, s2, acc)
        kg.gram_pair_q_plain(Q1, s1, Q2, s2, acc_p)
    A, A_p = kg.mirror_band(acc), kg.mirror_band(acc_p)
    torch.cuda.synchronize()
    err = float((A - A_p).abs().max())
    tol = 1e-5 * float(A_p.abs().max())
    if not err <= tol:
        raise AssertionError(f"gram_pair_band_q: max|dA| {err} > {tol}")
    del A, A_p, acc_p
    results.append(dict(
        name="gram_pair_q", err=err,
        ms=time_ms(lambda: kg.gram_pair_band_q(Q1, s1, Q2, s2, acc)),
        plain_ms=time_ms(lambda: kg.gram_pair_q_plain(Q1, s1, Q2, s2, acc)),
        note=f"tol 1e-5*max|A| = {tol:.3g}"))
    del Q1, s1, Q2, s2, acc

    # K6: the float Gram with carry at the A2 shape (bf16 tier's operands)
    acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=device)
    acc_p = torch.zeros_like(acc)
    kg.gram_pair(Jt, Kt, acc=acc)
    kg.gram_pair_plain(Jt, Kt, acc=acc_p)
    A, A_p = kg.mirror_gram(acc), kg.mirror_gram(acc_p)
    torch.cuda.synchronize()
    err6 = float((A - A_p).abs().max())
    tol6 = 1e-5 * float(A_p.abs().max())
    if not err6 <= tol6:
        raise AssertionError(f"gram_pair (A2, carry): max|dA| {err6} > {tol6}")
    results.append(dict(
        name="gram_pair_tiled", err=err6,
        ms=time_ms(lambda: kg.gram_pair(Jt, Kt, acc=acc)),
        plain_ms=time_ms(lambda: kg.gram_pair_plain(Jt, Kt, acc=acc)),
        note=f"A2 shape with carry ({Jt.shape[0]}x{Dp} bf16), tol {tol6:.3g}"))
    del A, A_p, acc, acc_p, Jt, Kt, J3

    # K10: the flat float Gram at the A4 shape, bf16 operands
    rows = rows4 or SLICE_SAMPLES * C
    D4 = D4 or FLAGSHIP["r"] * FLAGSHIP["P"]
    J4 = torch.tensor(rng.standard_normal((rows, D4), np.float32) * 0.05,
                      device=device).to(torch.bfloat16)
    K4 = torch.tensor(rng.standard_normal((rows, D4), np.float32) * 0.05,
                      device=device).to(torch.bfloat16)
    A = kg.mirror_gram(kg.gram_pair(J4, K4))
    A_p = kg.mirror_gram(kg.gram_pair_plain(J4, K4))
    torch.cuda.synchronize()
    err10 = float((A - A_p).abs().max())
    tol10 = 1e-5 * float(A_p.abs().max())
    if not err10 <= tol10:
        raise AssertionError(f"gram_pair (A4): max|dA| {err10} > {tol10}")
    results.append(dict(
        name="gram_pair", err=err10,
        ms=time_ms(lambda: kg.gram_pair(J4, K4)),
        plain_ms=time_ms(lambda: kg.gram_pair_plain(J4, K4)),
        note=f"A4 shape ({rows}x{D4} bf16), tol {tol10:.3g}"))
    log_kernels(results)
    return results


def log_kernels(results) -> None:
    for r in results:
        log(f"[kernels] {r['name']}: max|err| {r['err']:.3g}, kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms — {r['note']}")


def check_weighted_kernels(device, small=False):
    """Phase 3, the regression path's kernels against their plain versions,
    by default at its shapes: K8 and K7 at the A2 chunk (512 rows,
    D=8*129*8=8,256, Dp=8,704), K9 at the merged A3 (65,536 x 1,032), K11 at
    the regression's A1 (65,536 rows, C=1, DJ=1,032, f32) and at the conv-TT
    flagship's A1 (8,192 rows, C=9, DJ=18*50=900, bf16 J). `small` runs the
    same checks at small, ragged shapes."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    rng = np.random.default_rng(2)
    if small:
        rows2, D2, rows3, D3 = 64, 300, 333, 137
        own = [(100, 1, 137, torch.float32), (48, 3, 150, torch.bfloat16)]
    else:
        c = REGRESSION
        rows2, D2 = c["batch"], c["r"] * (c["d"] + 1) * c["r"]
        rows3, D3 = c["fit"], c["r"] * (c["d"] + 1)
        own = [(c["fit"], 1, D3, torch.float32),
               (SLICE_SAMPLES, FLAGSHIP["C"], FLAGSHIP["r"] * FLAGSHIP["P"],
                torch.bfloat16)]
    Dp2 = kg.plan_tiles(D2)[3]

    def randn(*shape, dtype=torch.float32):
        return torch.tensor(rng.standard_normal(shape, np.float32),
                            device=device).to(dtype)

    def within(name, A, A_p, rows):
        err = float((A - A_p).abs().max())
        tol = gram_tol(rows) * float(A_p.abs().max())
        if not err <= tol:
            raise AssertionError(f"{name}: max|dA| {err} > {tol}")
        return err, tol

    results = []
    # K8: bit-equal in both dtypes, with and without the fused Kt
    h2 = torch.tensor(rng.uniform(0.5, 2.0, rows2).astype(np.float32), device=device)
    for dt in (torch.float32, torch.bfloat16):
        X = randn(rows2, D2, dtype=dt)
        for h in (None, h2):
            Jt, Kt = kg.retile_rows(X, Dp2, h)
            Jt_p, Kt_p = kg.retile_rows_plain(X, Dp2, h)
            torch.cuda.synchronize()
            if not torch.equal(Jt, Jt_p) or (h is not None and not torch.equal(Kt, Kt_p)):
                raise AssertionError(f"retile_rows ({dt}, h={h is not None}) "
                                     "differs from the plain version")
    X = randn(rows2, D2)
    results.append(dict(
        name="retile_rows", err=0.0,
        ms=time_ms(lambda: kg.retile_rows(X, Dp2)),
        plain_ms=time_ms(lambda: kg.retile_rows_plain(X, Dp2)),
        note=f"({rows2}x{D2} -> {Dp2}) f32; Jt and Kt bit-equal in f32 and bf16"))

    # K7: two chained carries, f32 and bf16
    errs, times = [], None
    for dt in (torch.float32, torch.bfloat16):
        acc = torch.zeros((Dp2, Dp2), dtype=torch.float32, device=device)
        acc_p = torch.zeros_like(acc)
        for _ in range(2):
            Xt, _ = kg.retile_rows(randn(rows2, D2, dtype=dt), Dp2)
            h = torch.tensor(rng.uniform(0.5, 2.0, rows2).astype(np.float32),
                             device=device)
            kg.weighted_gram_tiled(Xt, h, acc)
            kg.weighted_gram_tiled_plain(Xt, h, acc_p)
        err, tol = within(f"weighted_gram_tiled ({dt})", kg.mirror_gram(acc),
                          kg.mirror_gram(acc_p), 2 * rows2)
        errs.append(err)
        if dt == torch.float32:
            times = (time_ms(lambda: kg.weighted_gram_tiled(Xt, h, acc)),
                     time_ms(lambda: kg.weighted_gram_tiled_plain(Xt, h, acc)))
        del acc, acc_p
    results.append(dict(
        name="weighted_gram_tiled", err=max(errs), ms=times[0], plain_ms=times[1],
        note=f"{rows2}x{Dp2} f32 (bf16 max|dA| {errs[1]:.3g}), two chained "
             f"carries, tol {gram_tol(2 * rows2):.3g}*max|A|"))

    # K9: the flat weighted Gram of the merged A3, f32, held entry by entry
    # to a float64 plain version; a bf16-rounded result must fail the check
    X3 = randn(rows3, D3)
    h3 = torch.tensor(rng.uniform(0.5, 2.0, rows3).astype(np.float32), device=device)
    X64 = X3.double()
    A64 = (X64 * h3.double()[:, None]).T @ X64
    del X64
    A = kg.mirror_gram(kg.weighted_gram(X3, h3))
    ratios = k9_ratios(A, A64)
    ctrl = k9_ratios(kg.weighted_gram_plain(X3.to(torch.bfloat16), h3), A64)
    plain = k9_ratios(kg.weighted_gram_plain(X3, h3), A64)
    bounds = (gram_tol(rows3), 16 * 2.0 ** -24)
    log(f"[kernels] weighted_gram vs float64, max|dA|/sqrt(A_dd A_ee) on and "
        f"off the diagonal (bounds {bounds[0]:.3g}, {bounds[1]:.3g}): kernel "
        f"{ratios[0]:.3g}, {ratios[1]:.3g}; plain f32 {plain[0]:.3g}, "
        f"{plain[1]:.3g}; bf16-rounded control {ctrl[0]:.3g}, {ctrl[1]:.3g}")
    if not (ratios[0] <= bounds[0] and ratios[1] <= bounds[1]):
        raise AssertionError(f"weighted_gram: {ratios} over the bounds {bounds}")
    if ctrl[0] <= bounds[0] and ctrl[1] <= bounds[1]:
        raise AssertionError("weighted_gram: the check passes bf16-rounded "
                             f"operands ({ctrl}), so it cannot see precision")
    results.append(dict(
        name="weighted_gram", err=float((A.double() - A64).abs().max()),
        ms=time_ms(lambda: kg.weighted_gram(X3, h3)),
        plain_ms=time_ms(lambda: kg.weighted_gram_plain(X3, h3)),
        note=f"{rows3}x{D3} f32, random h in [0.5, 2], max|dA| vs float64"))
    del X3, A, A64

    # K11: the own-out class-pair Gram at both first cores
    errs, notes, times = [], [], None
    for S_, C_, DJ, dt in own:
        Dp = kg.plan_tiles(DJ)[3]
        Jt, _ = kg.retile_rows(randn(S_, DJ, dtype=dt), Dp)
        hh = randn(S_, C_, C_)
        H = ((hh + hh.transpose(1, 2)) / 2).contiguous()
        A = kg.mirror_own_out(kg.own_out_gram(Jt, H, C_, DJ))
        A_p = kg.mirror_own_out(kg.own_out_gram_plain(Jt, H, C_, DJ))
        err, tol = within(f"own_out_gram (C={C_})", A, A_p, S_)
        errs.append(err)
        ms = time_ms(lambda: kg.own_out_gram(Jt, H, C_, DJ))
        plain = time_ms(lambda: kg.own_out_gram_plain(Jt, H, C_, DJ))
        notes.append(f"S={S_} C={C_} DJ={DJ} {str(dt)[6:]}: kernel {ms:.3f} ms, "
                     f"plain {plain:.3f} ms, max|dA| {err:.3g} (tol {tol:.3g})")
        times = times or (ms, plain)
        del A, A_p, Jt
    results.append(dict(name="own_out_gram", err=max(errs), ms=times[0],
                        plain_ms=times[1], note="; ".join(notes)))
    log_kernels(results)
    return results


def flagship_data(S: int, seed: int, device):
    """Synthetic flagship data, built as bench.py builds it."""
    import torch
    c = FLAGSHIP
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((S, c["P"], c["pp"])).astype(np.float32)
    y = np.eye(c["C"] + 1, dtype=np.float32)[rng.integers(0, c["C"] + 1, S)]
    return torch.tensor(X, device=device), torch.tensor(y, device=device)


def run_slice(device, tier):
    """Phase 4: one flagship swipe through Sweeper.run in the Gram `tier`."""
    import torch
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    c = FLAGSHIP
    X, y = flagship_data(SLICE_SAMPLES, 0, device)
    layer = TensorConvolutionTrainLayer(
        num_carriages=c["N"], bond_dim=c["r"], num_patches=c["P"],
        patch_pixels=c["pp"], output_shape=(c["C"],),
        convolution_bond=c["CB"], seed=0, device=device)
    if not layer.network.use_kernels:
        raise AssertionError("the network on CUDA must use the kernels")
    loss_fn = XEBregman(w=1.0)

    def mean_loss():
        pred = layer.forward_batch(X, BATCH)
        return float(loss_fn(pred, y, only_loss=True).mean())

    loss0 = mean_loss()
    cfg = SweepConfig(num_swipes=1, batch_size=BATCH, method="ridge_cholesky",
                      eps=5.0, eps_decay=0.25)
    sweeper = Sweeper(layer.network, loss_fn, cfg)
    with env(TNF_GRAM_DTYPE=tier):
        torch.cuda.synchronize()
        kg.reset_launches()
        t0 = time.perf_counter()
        params, ok = sweeper.run([layer.params], X, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kg.LAUNCHES)
    params = params[0]
    finite = all(bool(torch.isfinite(v).all()) for v in params.values())
    layer.params = params
    loss1 = mean_loss()
    log(f"[slice] {tier} swipe wall {wall:.3f} s over {SLICE_SAMPLES} samples "
        f"(batch {BATCH}), ok={ok}, loss {loss0:.6f} -> {loss1:.6f}, "
        f"launches {launches}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not ok:
        raise AssertionError("sweep reported a singular solve")
    if not finite:
        raise AssertionError("non-finite parameters after the swipe")
    if not loss1 < loss0:
        raise AssertionError(f"training loss did not drop: {loss0} -> {loss1}")
    missing = [k for k in FLAGSHIP_KERNELS[tier] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches


def run_regression(device):
    """Phase 5: the tabular TT regression through `TensorTrainRegressor` on
    the card — a two-swipe fit in the f32 tier, then one swipe with the
    opt-in own-out kernel against one through the default route, then one
    swipe in the int8 tier. Returns the launch counts of each run."""
    import torch
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    c = REGRESSION
    t0 = time.perf_counter()
    X, y = make_regression(S=c["fit"] + c["val"], d=c["d"], degree=3, seed=0)
    Xtr, ytr = torch.tensor(X[:c["fit"]], device=device), torch.tensor(y[:c["fit"]], device=device)
    Xva, yva = X[c["fit"]:], y[c["fit"]:]
    log(f"[regression] make_regression(S={c['fit'] + c['val']}, d={c['d']}, "
        f"degree=3, seed=0): {time.perf_counter() - t0:.2f} s")
    est = TensorTrainRegressor(N=c["N"], r=c["r"], batch_size=c["batch"],
                               eps_start=5.0, eps_decay=0.25,
                               method="ridge_cholesky", num_swipes=2,
                               device=device)

    def fit_once(what, **knobs):
        """One fit continuing from the current params, with the launch
        counters reset just before it and read just after."""
        with env(**knobs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kg.reset_launches()
            t = time.perf_counter()
            est.fit(Xtr, ytr, X_val=Xva, y_val=yva)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = dict(kg.LAUNCHES)
            pred = est.predict(Xva)
        finite = all(bool(torch.isfinite(v).all())
                     for v in est._model.params.values())
        rmse = float(np.sqrt(np.mean((pred - yva) ** 2)))
        used = {k: v for k, v in launches.items() if v}
        log(f"[regression] {what}: wall {wall:.3f} s, ok={est.fit_ok_}, "
            f"val rmse {rmse:.6f}, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {used}")
        if not est.fit_ok_:
            raise AssertionError(f"{what}: the sweep reported a singular solve")
        if not finite:
            raise AssertionError(f"{what}: non-finite parameters")
        return launches, pred, rmse

    launches, _, rmse = fit_once("fit, 2 swipes, f32", TNF_GRAM_DTYPE="f32",
                                 TNF_SWEEP_TIMERS=1)
    for ln in est.sweeper_.timer_report().splitlines():
        log(f"[regression] {ln}")
    if not rmse < 1.0:  # y is standardized: predicting the mean scores 1.0
        raise AssertionError(f"val rmse {rmse} does not beat the mean (1.0)")
    need = {"retile_rows": 1, "weighted_gram_tiled": 128, "weighted_gram": 1}
    short = {k: launches[k] for k, n in need.items() if launches[k] < n}
    if short:
        raise AssertionError(f"regression fit launched too few kernels: {short} < {need}")

    est.num_swipes = 1
    base = dict(est._model.params)
    _, pred_d, _ = fit_once("swipe, default own-out route", TNF_GRAM_DTYPE="f32")
    est._model.params = dict(base)
    own, pred_k, _ = fit_once("swipe, TNF_OWNOUT_KERNEL=1", TNF_GRAM_DTYPE="f32",
                              TNF_OWNOUT_KERNEL=1)
    if own["own_out_gram"] < 1:
        raise AssertionError("TNF_OWNOUT_KERNEL=1 did not launch own_out_gram")
    # f32 sums in another order (K11 vs cuBLAS) through five chained solves
    err = float(np.abs(pred_k - pred_d).max())
    scale = float(np.abs(pred_d).max())
    log(f"[regression] own-out kernel vs default route: max|d pred| {err:.3g} "
        f"(max|pred| {scale:.3g}, rtol 1e-3)")
    if not err <= 1e-3 * scale:
        raise AssertionError(f"own-out kernel route disagrees: {err}")
    q, _, _ = fit_once("swipe, int8", TNF_GRAM_DTYPE="int8")
    missing = [k for k in ("retile_rows", "quantize_tiled", "gram_pair_q") if q[k] < 1]
    if missing:
        raise AssertionError(f"int8 regression swipe never launched {missing}")
    return launches, own


def check_reference(device):
    """Phase 6: a tiny conv-TT swipe (f32, int8 tiers) and a tiny
    TT-regression swipe (f32, bf16, int8) with the kernels on the card agree
    with the plain versions on the CPU."""
    import torch
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.layers import (
        TensorConvolutionTrainLayer, TensorTrainLayer)
    from tensornetworksfork_tpu_torch.ops.bregman import SquareBregFunction, XEBregman

    rng = np.random.default_rng(1)
    S, P, pp, C = 96, 6, 5, 3
    X = rng.standard_normal((S, P, pp)).astype(np.float32)
    y = np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]
    F = 9  # the regression's features, bias column included
    Xr = rng.uniform(-1, 1, (S, F)).astype(np.float32)
    Xr[:, -1] = 1.0
    yr = rng.standard_normal((S, 1)).astype(np.float32)

    def conv_tt(dev):
        return TensorConvolutionTrainLayer(4, 4, P, pp, output_shape=(C,),
                                           convolution_bond=2, seed=0,
                                           device=dev, use_kernels=True)

    def tt(dev):
        return TensorTrainLayer(3, 4, F, output_shape=(1,), seed=0, device=dev,
                                use_kernels=True)

    # tolerances: f32 — sums in another order, 1e-4 relative; bf16 and int8
    # — a bf16 rounding that differs by one ulp (and, in int8, the code it
    # flips) carried through the chained solves, 2e-2
    for model, make, loss, Xn, yn, tiers in (
            ("conv-TT", conv_tt, XEBregman(1.0), X, y,
             (("f32", 1e-4), ("int8", 2e-2))),
            ("TT regression", tt, SquareBregFunction(), Xr, yr,
             (("f32", 1e-4), ("bf16", 2e-2), ("int8", 2e-2)))):
        for tier, rtol in tiers:
            outs = {}
            for dev in ("cpu", device):
                with env(TNF_GRAM_DTYPE=tier, TNF_PACKED_SYRK_MIN_D=1):
                    layer = make(dev)
                    cfg = SweepConfig(num_swipes=1, batch_size=48,
                                      method="ridge_cholesky", eps=5.0,
                                      eps_decay=0.25)
                    Xd, yd = torch.tensor(Xn, device=dev), torch.tensor(yn, device=dev)
                    params, ok = Sweeper(layer.network, loss, cfg).run(
                        [layer.params], Xd, yd)
                    if not ok:
                        raise AssertionError(
                            f"reference swipe ({model}, {tier}, {dev}) failed")
                    outs[dev] = layer.network.forward(params[0], Xd).cpu()
            err = float((outs[device] - outs["cpu"]).abs().max())
            scale = float(outs["cpu"].abs().max())
            log(f"[reference] {model} {tier}: kernels on {device} vs plain on "
                f"cpu, max|d pred| {err:.3g} (max|pred| {scale:.3g}, rtol {rtol})")
            if not err <= rtol * scale:
                raise AssertionError(f"reference check ({model}, {tier}) failed: {err}")


def main() -> int:
    import torch

    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("[env] nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(smi)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from tensornetworksfork_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    path = _build.lib()._name
    ptxas = [ln for ln in _build.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[build] {path}: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_INFO['seconds']})")
    for ln in ptxas:
        log(f"[build] {ln.strip()}")

    kernels = check_kernels(device) + check_weighted_kernels(device)
    flagship = run_slice(device, "int8")
    flagship32 = run_slice(device, "f32")
    fit, own = run_regression(device)
    check_reference(device)

    # each kernel's launches come from the run of the path that drives it:
    # the flagship's int8 swipe, its f32 swipe (K6), the regression fit and
    # its own-out swipe (K11)
    launches = {**{k: flagship[k] for k in FLAGSHIP_KERNELS["int8"]},
                "gram_pair_tiled": flagship32["gram_pair_tiled"],
                **{k: fit[k] for k in REGRESSION_KERNELS},
                "own_out_gram": own["own_out_gram"]}
    pallas = "tensornetworksfork_tpu/ops/pallas/gram.py"
    sources = {"retile_hmix": 726, "quantize_tiled": 971, "gram_pair_q": 1254,
               "gram_pair_tiled": 873, "gram_pair": 550, "retile_rows": 657,
               "weighted_gram_tiled": 1439, "weighted_gram": 335,
               "own_out_gram": 1373}
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda",
         "source": "tensornetworksfork_tpu_torch/csrc/gram.cu",
         "replaces": f"{pallas}:{sources[k['name']]}",
         "launches": launches[k["name"]],
         "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
