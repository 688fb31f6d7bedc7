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
   the shapes its path gives it, with its tolerance, and the kernel's, the
   plain version's and (where one PyTorch call computes the same function)
   that library call's times (CUDA events around back-to-back calls, median
   of 5; K8's, shorter than a launch from the host, as CUDA graphs of 20
   calls), beside the kernel's bound: the larger of its operations over the
   card's peak for their type and its bytes over the memory rate (PEAK, HBM
   below). K1 (bf16 and f32, with the rhs it sums), K2, K3, K6 (bf16 and
   f32) and K10 (bf16 and f32) at the conv-TT flagship's shapes, K1 also at
   small shapes for C in 1, 3, 9, 16 on both its paths, K6 and K10 in f32
   on full-mantissa operands held to float64, with bf16- and TF32-rounded
   controls that must fail; K1's Jt, K2 and K3 bit for bit (K2 also in its
   K-major layout), K3 with torch._int_mm over the same blocks as a
   yardstick, and K4 (K3's carry-less entry, on no path) timed once beside
   its bound; K8, K7, K9, K11, K2
   and K3 at the regression's (K7 and K9 also in bf16, K11 also at the
   flagship's first core), with the row split the split Gram (K10, K9, K11)
   plans for each. The kernels of `csrc/gram.cu`: K1 `retile_hmix_kernel`
   (16-byte packs; b's runs added by `hmix_b_reduce_kernel`),
   K2 `quantize_kernel` (one read of X, codes written K-major), K8
   `retile_rows_kernel`; of `csrc/qgram.cu`: K3/K4 `gram_q_kernel` (s8
   wgmma fed by TMA); of `csrc/wgram.cu`: K6 in f32 `gram_tf32x3_kernel`
   (3xTF32 on the tensor cores, with its carry), and the split Gram
   (`wgram_f32_kernel` for f32 operands, `wgram_bf16_kernel` on the tensor
   cores for bf16 ones, `wgram_reduce_kernel` adding the splits): K10
   unweighted, K6 in bf16 and K7 with a carry, K9, K11. The build's ptxas
   lines (registers, spills, warnings) are printed;
4. slice — one swipe of `Sweeper.run` on the flagship conv-TT
   (N=4, r=18, CB=8, 50 patches x 17 pixels, 9 logits, random weights from a
   seed) over 8192 synthetic samples in the int8 Gram tier (K1, K2, K3;
   K10 on bf16 operands), then one in the f32 tier (K1, K6; K10 on f32
   operands) and one in the bf16 tier (K1, K6 and K10 on bf16 operands);
   the launch counters show every kernel of each run ran, and
   each swipe must lower the training loss, keep every parameter finite and
   report no singular solve;
5. regression — `TensorTrainRegressor(N=3, r=8)` fitted for two swipes on
   `make_regression` (128 features, 65,536 rows to fit, 16,384 to
   validate) in the f32 tier, which must report no singular solve, keep
   every parameter finite, beat predicting the mean on the validation rows
   and launch K8, K7 (at least 128 times) and K9; then one more swipe with
   the opt-in own-out kernel (K11), which must agree with the default
   route, and one in the int8 tier (K8, K2, K3);
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
                    "f32": ("retile_hmix", "gram_pair_tiled", "gram_pair"),
                    "bf16": ("retile_hmix", "gram_pair_tiled", "gram_pair")}
REGRESSION_KERNELS = ("retile_rows", "weighted_gram_tiled", "weighted_gram")
# published peaks of one H100 SXM (dense): f32 on the FMA units, bf16, TF32
# and int8 on the tensor cores, and the HBM rate; the bound of a kernel's work
PEAK = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12, "int8": 1979e12}
HBM = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(ops: float, nbytes: float, kind: str):
    """(ms, "operations" | "bytes", kind): the least time the card could
    take for `ops` operations of type `kind` that move `nbytes` bytes (each
    input read once, each output written once)."""
    t_ops, t_bytes = ops / PEAK[kind], nbytes / HBM
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            kind)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def gram_ops(rows: int, D: int, upper: bool = True) -> float:
    """Multiply-adds (2 operations each) of a Gram over `rows` rows and D
    columns: its upper triangle (diagonal included) or the whole block."""
    return 2.0 * rows * (D * (D + 1) / 2 if upper else D * D)


@contextlib.contextmanager
def bf16_f32_reduction():
    """cuBLAS sums bf16 products in f32 inside this block (the yardstick for
    a kernel that does)."""
    import torch
    m = torch.backends.cuda.matmul
    old = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = old


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
    """fn's device time: the median over `reps` runs of CUDA events around n
    back-to-back calls, divided by n. A warm-up call picks n so that a run
    lasts about 2 ms (at most 100 calls; 1 for calls of 2 ms or more), so a
    short kernel is timed over many launches, not one."""
    import torch

    def run(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    n = int(min(100, max(1, np.ceil(2.0 / max(run(1), 1e-3)))))
    return float(np.median([run(n) for _ in range(reps)]))


def graph_ms(fn, calls: int = 20) -> float:
    """fn's device time without the host's launch overhead: `calls` calls
    captured in one CUDA graph, its replay timed by time_ms, divided by
    `calls` (for a call too short to keep the card busy from the host)."""
    import torch
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    ms = time_ms(graph.replay) / calls
    del graph
    return ms


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
    sums the rows of its row split in sequence: a diagonal entry's partial
    sums grow to A_dd, so it carries about sqrt(rows) f32 roundings of A_dd
    (held to gram_tol);
    an off-diagonal entry of independent zero-mean columns random-walks, so
    its error is about 0.75 2^-24 sqrt(A_dd A_ee) (held to 16 2^-24). A
    bf16 rounding of the operands moves every entry by ~2^-9 of a term,
    hundreds of 2^-24 off the diagonal."""
    import torch
    d = A64.diagonal()
    r = (A.double() - A64).abs() / torch.sqrt(torch.outer(d, d))
    return float(r.diagonal().max()), float(r.fill_diagonal_(0).max())


# K10's float64 check: the largest error of an entry over its natural size
PAIR_BOUND = 16 * 2.0 ** -24


def tf32_round(x):
    """x (float32) rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero): the operands a kernel that ran f32 on the TF32 tensor
    cores would multiply."""
    import torch
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pair_float64(X, Y):
    """(A64, scale) of a Gram XᵀY: its float64 value, in which every product
    of bf16 or f32 operands is exact, and each entry's natural size
    sqrt(|X_d|² |Y_e|²), which bounds the entry (Cauchy-Schwarz)."""
    import torch
    X64, Y64 = X.double(), Y.double()
    return X64.T @ Y64, torch.sqrt(torch.outer(X64.square().sum(0),
                                               Y64.square().sum(0)))


def pair_errors(B, A64, scale):
    """(max |B - A64|, max |B - A64| / scale) over the upper triangle of a
    Gram B. A kernel rounds each add of an entry's sum once in f32; for
    independent zero-mean columns the sum random-walks, so its error is a
    fraction of 2^-24 of the scale (held to PAIR_BOUND, K9's off-diagonal
    bound). Operands rounded to bf16 or TF32 move each product by ~2^-9 or
    ~2^-12 of itself (typical size), so a sum of `rows` random terms by
    ~2^-9 / sqrt(rows) or ~2^-12 / sqrt(rows) of the scale: at the A4's
    73,728 rows a typical entry is off by ~120 or ~15 2^-24, the largest of
    its 405,450 upper entries by several times that."""
    d = (B.double() - A64).abs().triu()
    return float(d.max()), float((d / scale).max())


def hold_to_float64(name, B, B_plain, X, Y, controls: bool):
    """Hold a kernel's Gram B of X, Y (upper triangle) to float64 entry by
    entry (pair_errors, PAIR_BOUND); the plain f32 result B_plain beside it.
    With `controls` (f32 operands) the same operands rounded to bf16 and to
    TF32 must fail the check, so it sees a kernel that rounds its f32
    operands. Returns (kernel's max |dA|, its ratio, plain's |dA|, its ratio,
    a note)."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    u = 2.0 ** -24
    A64, scale64 = pair_float64(X, Y)
    (e64, r64), (e64_p, r64_p) = (pair_errors(b, A64, scale64) for b in (B, B_plain))
    log(f"[kernels] {name} vs float64 (max|dA|, and its largest over the entry's "
        f"scale in 2^-24, bound {PAIR_BOUND / u:.3g}): kernel {e64:.3g} "
        f"({r64 / u:.3g}), plain f32 {e64_p:.3g} ({r64_p / u:.3g})")
    if not r64 <= PAIR_BOUND:
        raise AssertionError(f"{name}: float64 error {r64 / u} 2^-24 of the scale "
                             f"> {PAIR_BOUND / u}")
    note = ""
    if controls:
        ctl = {what: pair_errors(kg.gram_pair_plain(rnd(X), rnd(Y)), A64, scale64)[1]
               for what, rnd in (("bf16", lambda t: t.to(torch.bfloat16)),
                                 ("TF32", tf32_round))}
        note = ", ".join(f"{w}-rounded {r / u:.3g}" for w, r in ctl.items())
        log(f"[kernels] {name} float64 controls (must exceed {PAIR_BOUND / u:.3g}): {note}")
        passed = [w for w, r in ctl.items() if r <= PAIR_BOUND]
        if passed:
            raise AssertionError(f"{name}: the float64 check passes operands rounded to "
                                 f"{passed}, so it cannot see precision")
        note = f"; controls {note}"
    return e64, r64, e64_p, r64_p, note


def check_quantized(what, got, plain) -> None:
    """K2's outputs (Q1, s1, Q2, s2) against its plain version's: equal
    values, equal strides (the K-major view), equal code matrices behind
    the views (the zero pad included)."""
    import torch
    for a, b, name in zip(got, plain, ("Q(J)", "s(J)", "Q(K)", "s(K)")):
        if a.stride() != b.stride():
            raise AssertionError(f"{what}: {name} strides {a.stride()} != plain {b.stride()}")
        if a.dtype == torch.int8:
            ld = a.stride(1)
            a = torch.as_strided(a, (a.shape[1], ld), (ld, 1))
            b = torch.as_strided(b, (b.shape[1], ld), (ld, 1))
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs from plain")


def int_mm_ms(Q1, Q2, BS: int):
    """(ms, note) of torch._int_mm over the quantisation blocks of a K3
    chunk: Q1_bᵀ Q2_b in int32 for each block b (the K-major codes give
    cuBLASLt its TN layout), into one (Dp, Dp) int32 output. A reference
    rate for the int8 tensor cores on these shapes, not K3's function (no
    rescale, no carry, every tile): ms None, and the error, if torch
    refuses the strides."""
    import torch
    Bp, Dp = Q1.shape
    out = torch.empty((Dp, Dp), dtype=torch.int32, device=Q1.device)

    def run():
        for b in range(Bp // BS):
            rs = slice(b * BS, (b + 1) * BS)
            torch._int_mm(Q1[rs].T, Q2[rs], out=out)

    try:
        run()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as err:
        return None, f"torch._int_mm refused the K-major blocks: {str(err).splitlines()[0]}"
    ms = time_ms(run)
    return ms, (f"torch._int_mm over the {Bp // BS} blocks of {BS} rows {ms:.3f} ms "
                f"(int32 output written per block, every tile, no rescale)")


def int8_gram_entry(where, Q1, s1, Q2, s2, acc):
    """K3 (gram_pair_band_q) on the K-major codes Q1, Q2 into `acc` over two
    chained chunks, held bit for bit (torch.equal) to its plain version,
    then timed beside its bound, the plain version and torch._int_mm over
    the same blocks; returns its kernels entry."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    acc_p = acc.clone()
    for _ in range(2):
        kg.gram_pair_band_q(Q1, s1, Q2, s2, acc)
        kg.gram_pair_q_plain(Q1, s1, Q2, s2, acc_p)
    torch.cuda.synchronize()
    if not torch.equal(acc, acc_p):
        raise AssertionError(f"gram_pair_band_q ({where}): differs from its plain "
                             f"version by {float((acc - acc_p).abs().max())}")
    del acc_p
    Bp, Dp = Q1.shape
    BS = Bp // s1.shape[0]
    nslab = Dp // kg.TILE
    ms = time_ms(lambda: kg.gram_pair_band_q(Q1, s1, Q2, s2, acc))
    mm, mm_note = int_mm_ms(Q1, Q2, BS)
    ops = 2.0 * Bp * nslab * (nslab + 1) / 2 * kg.TILE ** 2
    # every tile reads two 128-column strips of all Bp rows of codes
    tiles = len(kg._pair_table_np(Dp // kg.QTILE, kg.TILE // kg.QTILE, True))
    l2 = 2.0 * tiles * kg.QTILE * Bp
    log(f"[kernels] gram_pair_q ({where}, {Bp}x{Dp}, blocks of {BS}): {ms:.3f} ms, "
        f"{ops / ms / 1e9:.1f} TOP/s, operand reads from L2 {l2 / 1e9:.2f} GB = "
        f"{l2 / ms / 1e9:.2f} TB/s; {mm_note}")
    return dict(
        name="gram_pair_q", dtype="int8", err=0.0, ms=ms,
        plain_ms=time_ms(lambda: kg.gram_pair_q_plain(Q1, s1, Q2, s2, acc)),
        library_ms=None,
        # the upper 512-slab pairs, diagonal slabs whole; their tiles of the
        # carry read and written once
        bound=bound(ops, nbytes(Q1, s1, Q2, s2) + 2 * tiles * kg.QTILE ** 2 * 4, "int8"),
        int_mm_ms=mm,
        note=f"{where} ({Bp}x{Dp}, blocks of {BS}), bit-equal (torch.equal) over two "
             f"chained chunks; s8 wgmma; L2 reads {l2 / 1e9:.2f} GB at "
             f"{l2 / ms / 1e9:.2f} TB/s; {mm_note}")


# K1's small shapes (class count, D, offset of J from a 16-byte boundary in
# values): D = 701 takes the one-value path, D = 1000 the packs (16 bytes; 8
# for bf16 at C = 16) with padding packs past D, offset 1 the one-value path
# again; 9,000 samples give runs of more than one staged chunk and ragged
# groups of the samples a thread holds (several at C = 1 and 3)
HMIX_SHAPES = [(c, d, 0) for c in (1, 3, 9, 16) for d in (701, 1000)] + [(9, 1000, 1)]
HMIX_SAMPLES = 9000


def hmix_inputs(S, C, D, dtype, device, shift=0, seed=0):
    """J (S, C, D) in `dtype`, its start `shift` values past an allocation,
    H (S, C, C) and the class-major gvec (C*S,) in `dtype` of an XEBregman
    loss on random logits, as the flagship's A2/A3 update gives them K1."""
    import torch
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(S * C * D + shift, generator=gen, device=device) * 0.05
    J3 = flat.to(dtype)[shift:].view(S, C, D)
    logits = torch.randn((S, C), generator=gen, device=device)
    labels = torch.randint(0, C + 1, (S,), generator=gen, device=device)
    _, g, H = XEBregman(1.0)(logits, torch.eye(C + 1, device=device)[labels])
    return J3, H.contiguous(), g.T.reshape(-1).to(dtype).contiguous()


# K1's rhs: the largest |b - b_plain| of a column over sum_r |g_r||Jt_rd|, in
# units of 2^-24 per sqrt(rows): both sum the same exact (bf16) or equally
# rounded (f32) products in f32, in another order
HMIX_B_BOUND = 4.0


def check_retile_hmix(device, S, C, D, dtype, shift=0, timed=False):
    """K1 (retile_hmix with gvec) against its plain version on the card: Jt
    bit for bit; Kt bit for bit in f32 (both round the same f32 products
    and sums) and within 1 bf16 ulp in bf16; b per column within
    HMIX_B_BOUND sqrt(S*C) 2^-24 of sum |g||J|; one launch counted. With
    `timed`, its kernels entry: K1's time with b (the path's call) beside its
    byte bound and the plain version's, K1 without b and the rhs as the
    engine formed it before (an f32 copy of Jt and a product) in the note.
    Returns (entry or None, Jt, Kt)."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    Dp = kg.plan_tiles(D)[3]
    J3, H, gvec = hmix_inputs(S, C, D, dtype, device, shift)
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    what = f"retile_hmix (S={S}, C={C}, D={D}, {kind}, offset {shift})"
    kg.reset_launches()
    Jt, Kt, b = kg.retile_hmix(J3, H, Dp, gvec)
    if kg.LAUNCHES["retile_hmix"] != 1:
        raise AssertionError(f"{what}: launch count {kg.LAUNCHES['retile_hmix']}, not 1")
    Jt_p, Kt_p, b_p = kg.retile_hmix_plain(J3, H, Dp, gvec)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    if not torch.equal(Jt.view(bits), Jt_p.view(bits)):
        raise AssertionError(f"{what}: Jt differs from the plain version")
    dK = (Kt.float() - Kt_p.float()).abs()
    same = float((Kt.view(bits) == Kt_p.view(bits)).float().mean())
    ulps = float((dK / bf16_ulp(Kt_p.float())).max())
    if dtype == torch.float32 and same < 1.0:
        raise AssertionError(f"{what}: Kt not bit-equal ({same * 100:.4f}%)")
    if ulps > 1.0:
        raise AssertionError(f"{what}: Kt off by {ulps} bf16 ulp (> 1)")
    u = 2.0 ** -24
    scale = gvec.float().abs() @ Jt_p.float().abs()
    rb = float(((b - b_p).abs() / scale.clamp_min(1e-30)).max()) / (u * np.sqrt(S * C))
    if not rb <= HMIX_B_BOUND:
        raise AssertionError(f"{what}: b off by {rb:.3g} sqrt(S*C) 2^-24 of sum|g||J| "
                             f"(> {HMIX_B_BOUND})")
    del Jt_p, Kt_p, b_p, scale
    if not timed:
        return None, Jt, Kt
    ms = time_ms(lambda: kg.retile_hmix(J3, H, Dp, gvec))
    bare = time_ms(lambda: kg.retile_hmix(J3, H, Dp))
    rhs_old = time_ms(lambda: gvec.float() @ Jt.float())
    runs, rps = kg.hmix_plan(S, C, Dp, J3.element_size(), kg.sm_count(J3.device))
    entry = dict(
        name="retile_hmix", dtype=kind, err=float(dK.max()), ms=ms,
        plain_ms=time_ms(lambda: kg.retile_hmix_plain(J3, H, Dp, gvec)), library_ms=None,
        # the class mix and the rhs: a multiply and an add per term, in f32
        bound=bound(2.0 * S * C * (C + 1) * D, nbytes(J3, H, gvec, Jt, Kt, b), "f32"),
        note=f"A2/A3 chunk (S={S}, C={C}, D={D}, Dp={Dp}), Jt bit-equal, Kt max "
             f"{ulps:.3g} bf16 ulp ({same * 100:.4f}% bit-equal), b max {rb:.3g} "
             f"sqrt(S*C) 2^-24 of sum|g||J| (bound {HMIX_B_BOUND}); {runs} runs of {rps} "
             f"samples; without b {bare:.4f} ms; the rhs as the engine formed it before, "
             f"gvec.float() @ Jt.float(), {rhs_old:.4f} ms")
    del dK
    return entry, Jt, Kt


def check_kernels(device, S=BATCH, D=None, rows4=None, D4=None):
    """Phase 3: every kernel against its plain version, by default at the
    flagship shapes: A2/A3 (S=2048 per chunk, C=9, D=r*P*r=16,200) for K1,
    K2, K3 and K6, A4 (8192*9 merged rows, D=r*P=900) for K10."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    rng = np.random.default_rng(0)
    C = FLAGSHIP["C"]
    D = D or FLAGSHIP["r"] * FLAGSHIP["P"] * FLAGSHIP["r"]
    _, block, _, Dp = kg.plan_tiles(D)
    results = []

    # K1 retile_hmix with the fused rhs, in bf16 (the int8 and bf16 tiers;
    # its Jt and Kt feed K2, K3 and K6 below) and in f32 (the f32 tier), then
    # at small shapes that reach every class count's path
    entry, Jt, Kt = check_retile_hmix(device, S, C, D, torch.bfloat16, timed=True)
    results.append(entry)
    results.append(check_retile_hmix(device, S, C, D, torch.float32, timed=True)[0])
    for c, d, shift in HMIX_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            check_retile_hmix(device, HMIX_SAMPLES, c, d, dt, shift=shift)
    log(f"[kernels] retile_hmix: held to its plain version at S={HMIX_SAMPLES}, "
        f"(C, D, offset) in {HMIX_SHAPES}, bf16 and f32")

    # K2 quantize_tiled: Q and s bit-equal, Q in the same K-major layout
    Q1, s1 = kg.quantize_tiled(Jt, block)
    Q2, s2 = kg.quantize_tiled(Kt, block)
    Q1_p, s1_p = kg.quantize_tiled_plain(Jt, block)
    Q2_p, s2_p = kg.quantize_tiled_plain(Kt, block)
    torch.cuda.synchronize()
    check_quantized("quantize_tiled", (Q1, s1, Q2, s2), (Q1_p, s1_p, Q2_p, s2_p))
    results.append(dict(
        name="quantize_tiled", dtype="bf16", err=0.0,
        ms=time_ms(lambda: kg.quantize_tiled(Kt, block)),
        plain_ms=time_ms(lambda: kg.quantize_tiled_plain(Kt, block)),
        library_ms=None,
        # |x|, max, x * (1/s), round: 4 operations an element
        bound=bound(4.0 * Kt.numel(), nbytes(Kt, Q2, s2), "f32"),
        note=f"Q and s bit-equal, Q K-major (strides {Q2.stride()}) as the plain "
             f"version's; strip of {kg.quant_strip(kg.quant_block(Kt.shape[0], block))} "
             "columns a CTA"))
    del Q1_p, s1_p, Q2_p, s2_p

    # K3 gram_pair_band_q over two chained chunks: bit-equal to its plain
    # version, then mirror_band
    acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=device)
    k3 = int8_gram_entry("flagship A2 chunk", Q1, s1, Q2, s2, acc)
    A = kg.mirror_band(acc)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(A).all()):
        raise AssertionError("gram_pair_band_q: non-finite Gram")
    results.append(k3)
    del acc, A
    # K4 gram_pair_tiled_q, K3's carry-less entry (on no path of the port):
    # bit-equal to its plain version, and its time at this chunk beside its
    # bound (the wrapper's zeroed output included), logged for the table of
    # kernels but not in the kernels line, which lists the paths' kernels
    B4 = kg.gram_pair_tiled_q(Q1, s1, Q2, s2)
    B4_p = kg.gram_pair_q_plain(Q1, s1, Q2, s2, torch.zeros_like(B4), band=False,
                                has_acc=False)
    torch.cuda.synchronize()
    if not torch.equal(B4, B4_p):
        raise AssertionError("gram_pair_tiled_q: differs from its plain version")
    del B4, B4_p
    ms4 = time_ms(lambda: kg.gram_pair_tiled_q(Q1, s1, Q2, s2))
    nslab = Dp // kg.TILE
    tiles4 = len(kg._pair_table_np(Dp // kg.QTILE, kg.TILE // kg.QTILE, False))
    b4 = bound(2.0 * Q1.shape[0] * nslab * (nslab + 1) / 2 * kg.TILE ** 2,
               nbytes(Q1, s1, Q2, s2) + tiles4 * kg.QTILE ** 2 * 4, "int8")
    log(f"[kernels] gram_pair_tiled_q (K4, on no path; {Q1.shape[0]}x{Dp}): {ms4:.3f} ms, "
        f"bound {b4[0]:.3f} ms ({b4[1]}), bit-equal (torch.equal) to its plain version")
    del Q1, s1, Q2, s2

    # K6: the float Gram with carry at the A2 shape, over the node's D of the
    # (rows, Dp) tiled operands. bf16: K1's operands (the bf16 swipe's);
    # f32: full-mantissa f32 ones (the f32 swipe's), held to float64 as K10
    # in f32 is, with bf16- and TF32-rounded controls that must fail
    def carry_gram(X, Y):
        """K6 and its plain version from a zero carry: (err, tol, acc)."""
        acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=device)
        acc_p = torch.zeros_like(acc)
        kg.gram_pair(X, Y, acc=acc, D=D)
        kg.gram_pair_plain(X, Y, acc=acc_p)
        A, A_p = kg.mirror_gram(acc), kg.mirror_gram(acc_p)
        torch.cuda.synchronize()
        err = float((A - A_p).abs().max())
        tol = 1e-5 * float(A_p.abs().max())
        if not err <= tol:
            raise AssertionError(f"gram_pair (A2, carry, {X.dtype}): max|dA| {err} > {tol}")
        return err, tol, acc

    rows2 = Jt.shape[0]
    err6b, tol6b, acc = carry_gram(Jt, Kt)
    with bf16_f32_reduction():
        lib6b = time_ms(lambda: torch.mm(Jt.T, Kt))
    Jf, Kf = Jt.float(), Kt.float()
    up6b = time_ms(lambda: acc.addmm_(Jf.T, Kf))
    del Jf, Kf
    results.append(dict(
        name="gram_pair_tiled", dtype="bf16", err=err6b,
        ms=time_ms(lambda: kg.gram_pair(Jt, Kt, acc=acc, D=D)),
        plain_ms=time_ms(lambda: kg.gram_pair_plain(Jt, Kt, acc=acc)),
        library_ms=lib6b,
        bound=bound(gram_ops(rows2, D), nbytes(Jt, Kt) + 2 * nbytes(acc), "bf16"),
        note=f"A2 shape with carry ({rows2}x{Dp}, D {D}, bf16 from K1), tol {tol6b:.3g}; "
             f"split Gram wgmma, 1 split; library: torch.mm on the bf16 operands "
             f"(bf16 out, f32 sums); acc.addmm_ on them upcast to f32 {up6b:.3f} ms"))
    del acc, Jt, Kt
    gen = torch.Generator(device=device).manual_seed(6)
    J6, K6 = (torch.nn.functional.pad(
        torch.randn((rows2, D), generator=gen, device=device) * 0.05, (0, Dp - D))
        for _ in range(2))
    err6, tol6, acc = carry_gram(J6, K6)
    e64, r64, e64_p, r64_p, ctl = hold_to_float64(
        "gram_pair_tiled (f32)", acc[:D, :D], kg.gram_pair_plain(J6[:, :D], K6[:, :D]),
        J6[:, :D], K6[:, :D], controls=True)
    # the split Gram's f32 FMA kernel on the same operands: the route K6 in
    # f32 would take if the 3xTF32 kernel were not faster
    fma = time_ms(lambda: kg._launch_wgram_split(J6, None, 0, None, acc, D, True, 1,
                                                 "gram_pair", Y=K6, has_acc=True))
    u = 2.0 ** -24
    results.append(dict(
        name="gram_pair_tiled", dtype="f32", err=err6,
        ms=time_ms(lambda: kg.gram_pair(J6, K6, acc=acc, D=D)),
        plain_ms=time_ms(lambda: kg.gram_pair_plain(J6, K6, acc=acc)),
        library_ms=time_ms(lambda: acc.addmm_(J6.T, K6)),
        # three TF32 products a multiply-add
        bound=bound(3 * gram_ops(rows2, D), nbytes(J6, K6) + 2 * nbytes(acc), "tf32"),
        note=f"A2 shape with carry ({rows2}x{Dp}, D {D}, full-mantissa f32), tol "
             f"{tol6:.3g}; 3xTF32 wgmma; float64 error {e64:.3g} (plain f32 {e64_p:.3g}), "
             f"{r64 / u:.3g} 2^-24 of the scale (plain {r64_p / u:.3g}){ctl}; the split "
             f"Gram's f32 FMA kernel on them {fma:.3f} ms; library: acc.addmm_"))
    del acc, J6, K6

    # K10: the flat float Gram at the A4 shape (the split Gram of
    # csrc/wgram.cu), on bf16 operands (the int8 and bf16 swipes) and on
    # full-mantissa f32 ones (the f32 swipe), each held to its plain version
    # and to float64 of its operands (pair_errors); in f32, the operands
    # rounded to bf16 or to TF32 must fail the float64 check, so the check
    # sees a kernel that rounds f32 operands
    rows = rows4 or SLICE_SAMPLES * C
    D4 = D4 or FLAGSHIP["r"] * FLAGSHIP["P"]
    sms = kg.sm_count(device)
    _, splits, rps = kg.wgram_plan(rows, D4, 1, True, sms)
    log(f"[kernels] gram_pair plan at {rows}x{D4}: {splits} row splits of {rps} "
        f"rows on {sms} SMs")
    for kind, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        X, Y = (torch.tensor(rng.standard_normal((rows, D4), np.float32) * 0.05,
                             device=device).to(dt) for _ in range(2))
        A = kg.mirror_gram(kg.gram_pair(X, Y))
        A_p = kg.mirror_gram(kg.gram_pair_plain(X, Y))
        torch.cuda.synchronize()
        err10 = float((A - A_p).abs().max())
        scale = float(A_p.abs().max())
        log(f"[kernels] gram_pair ({kind}) max|dA| vs plain {err10:.3g} "
            f"(1e-5*max|A| = {1e-5 * scale:.3g})")
        e64, r64, e64_p, r64_p, controls = hold_to_float64(
            f"gram_pair (A4, {kind})", A, A_p, X, Y, controls=kind == "f32")
        tol10, rule = 1e-5 * scale, "1e-5*max|A|"
        if not err10 <= tol10:
            # the kernel's order of sums, not a looser check: held to
            # gram_tol (as K7, K9, K11) and to the exact sum, whose error it
            # may not exceed twice the plain version's
            tol10, rule = gram_tol(rows) * scale, "gram_tol(rows)*max|A| and float64"
            if not (err10 <= tol10 and e64 <= 2 * e64_p):
                raise AssertionError(
                    f"gram_pair (A4, {kind}): max|dA| {err10} (tol {tol10}), "
                    f"float64 error {e64} vs plain {e64_p}")
            log(f"[kernels] gram_pair ({kind}) above 1e-5*max|A|: held to {rule}")
        del A, A_p
        ms = time_ms(lambda: kg.gram_pair(X, Y))
        note = (f"A4 shape ({rows}x{D4} {kind}), {splits} row splits, tol {tol10:.3g} "
                f"({rule}), float64 error {e64:.3g} (plain f32 {e64_p:.3g}), "
                f"{r64 / u:.3g} 2^-24 of the scale{controls}; ")
        if kind == "bf16":
            with bf16_f32_reduction():
                lib = time_ms(lambda: torch.mm(X.T, Y))
            Xf, Yf = X.float(), Y.float()
            mm32 = time_ms(lambda: torch.mm(Xf.T, Yf))
            del Xf, Yf
            note += (f"library: torch.mm on the bf16 operands (bf16 out, f32 "
                     f"sums); torch.mm on them widened to f32 {mm32:.3f} ms")
        else:
            lib = time_ms(lambda: torch.mm(X.T, Y))
            note += "library: torch.mm on the f32 operands"
        results.append(dict(
            name="gram_pair", dtype=kind, err=err10, ms=ms,
            plain_ms=time_ms(lambda: kg.gram_pair_plain(X, Y)), library_ms=lib,
            bound=bound(gram_ops(rows, D4), nbytes(X, Y) + 4 * D4 * D4, kind),
            note=note))
        del X, Y
    log_kernels(results)
    return results


def log_kernels(results) -> None:
    for r in results:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
        log(f"[kernels] {r['name']}: max|err| {r['err']:.3g}, kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library {lib}, "
            f"bound {r['bound'][0]:.3f} ms ({r['bound'][1]}) — {r['note']}")


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
    # K8 takes less time on the card than its launch takes on the host, so
    # it, its plain version and the pad are timed on the card alone
    # (graph_ms); back-to-back launches from the host are in the note
    X = randn(rows2, D2)
    k8 = lambda: kg.retile_rows(X, Dp2)
    pad = lambda: torch.nn.functional.pad(X, (0, Dp2 - D2))
    results.append(dict(
        name="retile_rows", dtype="f32", err=0.0, ms=graph_ms(k8),
        plain_ms=graph_ms(lambda: kg.retile_rows_plain(X, Dp2)), library_ms=graph_ms(pad),
        bound=bound(0.0, nbytes(X) + rows2 * Dp2 * 4, "f32"),
        note=f"({rows2}x{D2} -> {Dp2}) f32; Jt and Kt bit-equal in f32 and bf16; "
             f"library: the pad; times on the card alone (CUDA graph of 20 calls); "
             f"launched back to back from the host: kernel {time_ms(k8) * 1e3:.2f} us, "
             f"pad {time_ms(pad) * 1e3:.2f} us a call"))

    # K7: two chained carries over the node's D < Dp, f32 and bf16; the
    # carry's padding stays zero
    errs, times = [], None
    for dt in (torch.float32, torch.bfloat16):
        acc = torch.zeros((Dp2, Dp2), dtype=torch.float32, device=device)
        acc_p = torch.zeros_like(acc)
        for _ in range(2):
            Xt, _ = kg.retile_rows(randn(rows2, D2, dtype=dt), Dp2)
            h = torch.tensor(rng.uniform(0.5, 2.0, rows2).astype(np.float32),
                             device=device)
            kg.weighted_gram_tiled(Xt, h, acc, D2)
            kg.weighted_gram_tiled_plain(Xt, h, acc_p)
        if acc[D2:].any() or acc[:, D2:].any():
            raise AssertionError(f"weighted_gram_tiled ({dt}) wrote past D={D2}")
        err, tol = within(f"weighted_gram_tiled ({dt})", kg.mirror_gram(acc[:D2, :D2]),
                          kg.mirror_gram(acc_p[:D2, :D2]), 2 * rows2)
        errs.append(err)
        ms = time_ms(lambda: kg.weighted_gram_tiled(Xt, h, acc, D2))
        if dt == torch.float32:
            Xw = kg._weighted_operand(Xt, h)  # the library call's operand
            full = time_ms(lambda: acc.addmm_(Xw.T, Xt))
            # over the node's D, as the kernel computes it
            accD, XwD, XtD = acc[:D2, :D2], Xw[:, :D2], Xt[:, :D2]
            times = (ms, time_ms(lambda: kg.weighted_gram_tiled_plain(Xt, h, acc)),
                     time_ms(lambda: accD.addmm_(XwD.T, XtD)), full,
                     bound(gram_ops(rows2, D2) + rows2 * D2,
                           rows2 * D2 * 4 + nbytes(h) + 2 * 4 * D2 * D2, "f32"))
            del Xw, accD, XwD, XtD
        else:
            ms_b = ms
        del acc, acc_p
    results.append(dict(
        name="weighted_gram_tiled", dtype="f32", err=max(errs), ms=times[0],
        plain_ms=times[1], library_ms=times[2], bound=times[4],
        note=f"{rows2}x{D2} (Dp {Dp2}) f32, two chained carries, tol "
             f"{gram_tol(2 * rows2):.3g}*max|A|; bf16: kernel {ms_b:.3f} ms, "
             f"max|dA| {errs[1]:.3g}; library: acc[:D, :D].addmm_ over D on the "
             f"weighted operand made beforehand (over Dp: {times[3]:.3f} ms)"))

    # K9: the flat weighted Gram of the merged A3, f32, held entry by entry
    # to a float64 plain version; a bf16-rounded result must fail the check
    X3 = randn(rows3, D3)
    h3 = torch.tensor(rng.uniform(0.5, 2.0, rows3).astype(np.float32), device=device)
    sms = kg.sm_count(device)
    _, splits9, rps9 = kg.wgram_plan(rows3, D3, 1, True, sms)
    log(f"[kernels] weighted_gram plan at {rows3}x{D3}: {splits9} row splits of "
        f"{rps9} rows on {sms} SMs")
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
    # the bf16 tier's K9 (tensor cores) against its plain version, beside
    # its bound and one library call: a bf16 product on the pre-weighted
    # operand with f32 sums
    Xb = X3.to(torch.bfloat16)
    err_b, tol_b = within("weighted_gram (bf16)", kg.mirror_gram(kg.weighted_gram(Xb, h3)),
                          kg.mirror_gram(kg.weighted_gram_plain(Xb, h3)), rows3)
    ms_b = time_ms(lambda: kg.weighted_gram(Xb, h3))
    plain_b = time_ms(lambda: kg.weighted_gram_plain(Xb, h3))
    Xwb = kg._weighted_operand(Xb, h3).to(torch.bfloat16)
    with bf16_f32_reduction():
        lib_b = time_ms(lambda: torch.mm(Xwb.T, Xb))
    bnd_b = bound(gram_ops(rows3, D3) + rows3 * D3, nbytes(Xb, h3) + 4 * D3 * D3, "bf16")
    log(f"[kernels] weighted_gram (bf16, {splits9} row splits): kernel {ms_b:.3f} ms, "
        f"plain {plain_b:.3f} ms, library {lib_b:.3f} ms (torch.mm on the bf16 "
        f"pre-weighted operand, f32 sums), bound {bnd_b[0]:.3f} ms ({bnd_b[1]}), "
        f"max|dA| {err_b:.3g} (tol {tol_b:.3g})")
    del Xb, Xwb
    Xw = kg._weighted_operand(X3, h3)  # the library call's operand
    results.append(dict(
        name="weighted_gram", dtype="f32", err=float((A.double() - A64).abs().max()),
        ms=time_ms(lambda: kg.weighted_gram(X3, h3)),
        plain_ms=time_ms(lambda: kg.weighted_gram_plain(X3, h3)),
        library_ms=time_ms(lambda: torch.mm(Xw.T, X3)),
        bound=bound(gram_ops(rows3, D3) + rows3 * D3, nbytes(X3, h3) + 4 * D3 * D3,
                    "f32"),
        note=f"{rows3}x{D3} f32, random h in [0.5, 2], {splits9} row splits, "
             "max|dA| vs float64; library: torch.mm on the weighted operand "
             f"made beforehand; bf16 ({splits9} splits): kernel {ms_b:.3f} ms, "
             f"plain {plain_b:.3f} ms, library {lib_b:.3f} ms, bound {bnd_b[0]:.3f} ms, "
             f"max|dA| {err_b:.3g} vs plain (tol {tol_b:.3g})"))
    del X3, A, A64, Xw

    # K11: the own-out class-pair Gram at both first cores
    errs, notes, first = [], [], None
    for S_, C_, DJ, dt in own:
        Dp = kg.plan_tiles(DJ)[3]
        Jt, _ = kg.retile_rows(randn(S_, DJ, dtype=dt), Dp)
        hh = randn(S_, C_, C_)
        H = ((hh + hh.transpose(1, 2)) / 2).contiguous()
        npq = C_ * (C_ + 1) // 2
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        # the plan of the launch over the p = q blocks (f32: their upper
        # tiles) or, in bf16, over all class pairs
        _, splits, rps = kg.wgram_plan(S_, DJ, C_ if kind == "f32" else npq,
                                       kind == "f32", kg.sm_count(device))
        if not small and C_ == 1 and splits < 2:
            raise AssertionError(f"own_out_gram: the regression A1 plans {splits} split")
        A = kg.mirror_own_out(kg.own_out_gram(Jt, H, C_, DJ))
        A_p = kg.mirror_own_out(kg.own_out_gram_plain(Jt, H, C_, DJ))
        err, tol = within(f"own_out_gram (C={C_})", A, A_p, S_)
        errs.append(err)
        del A, A_p
        ms = time_ms(lambda: kg.own_out_gram(Jt, H, C_, DJ))
        plain = time_ms(lambda: kg.own_out_gram_plain(Jt, H, C_, DJ))
        # the library call: one batched product over the pre-weighted pairs
        J = Jt[:, :DJ]
        W = torch.stack([(J.float() * H[:, p, q, None]).to(dt)
                         for p, q in zip(*np.triu_indices(C_))])
        with bf16_f32_reduction():
            lib = time_ms(lambda: torch.matmul(W.transpose(-1, -2), J))
        del W, J
        # the work the result needs: p = q blocks of f32 J over their upper
        # triangle (the kernel mirrors them), every other block whole
        sym = C_ if kind == "f32" else 0
        bnd = bound(sym * gram_ops(S_, DJ) + (npq - sym) * gram_ops(S_, DJ, upper=False)
                    + npq * S_ * DJ, nbytes(Jt, H) + 4 * C_ * C_ * Dp * Dp, kind)
        notes.append(f"S={S_} C={C_} DJ={DJ} {kind}: {splits} row splits of {rps}, "
                     f"kernel {ms:.3f} ms, plain {plain:.3f} ms, library {lib:.3f} ms, "
                     f"bound {bnd[0]:.3f} ms ({bnd[1]}), max|dA| {err:.3g} "
                     f"(tol {tol:.3g})")
        first = first or (ms, plain, lib, bnd)
        del Jt
    results.append(dict(name="own_out_gram", dtype="f32", err=max(errs), ms=first[0],
                        plain_ms=first[1], library_ms=first[2], bound=first[3],
                        note="; ".join(notes) + "; library: one batched "
                             "torch.matmul over the pre-weighted class pairs"))

    # K2 and K3 at the int8 regression's chunk: the diagonal route's Jt and
    # Kt = h * J (K8, bf16), each quantised in one block of its rows
    Jt, Kt = kg.retile_rows(randn(rows2, D2, dtype=torch.bfloat16), Dp2, h2)
    q = kg.quantize_tiled(Jt) + kg.quantize_tiled(Kt)
    check_quantized("quantize_tiled (regression chunk)", q,
                    kg.quantize_tiled_plain(Jt) + kg.quantize_tiled_plain(Kt))
    entry = int8_gram_entry("int8 regression chunk", *q,
                            torch.zeros((Dp2, Dp2), device=device))
    results.append(dict(entry, dtype="int8, regression chunk"))
    del Jt, Kt, q
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
    return launches, own, q


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
    # per kernel: its name, registers, spills, and ptxas's warnings (C7517:
    # a wgmma serialised by an injected warpgroup.wait)
    ptxas = [ln for ln in _build.BUILD_INFO["log"].splitlines()
             if any(w in ln for w in ("Compiling entry", "registers", "spill", "arning"))]
    log(f"[build] {path}: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_INFO['seconds']})")
    for ln in ptxas:
        log(f"[build] {ln.strip()}")

    kernels = check_kernels(device) + check_weighted_kernels(device)
    flagship = run_slice(device, "int8")
    flagship32 = run_slice(device, "f32")
    flagship16 = run_slice(device, "bf16")
    fit, own, fit8 = run_regression(device)
    check_reference(device)

    # each kernel's launches come from the run of the path that drives it:
    # the flagship's int8 swipe (K10 on bf16 operands), its f32 swipe (K6
    # and K10 on f32 operands), its bf16 swipe (K6 on bf16 operands), the
    # regression fit, its own-out swipe (K11) and its int8 swipe (K3 at
    # the regression's chunk)
    launches = {("retile_hmix", "bf16"): flagship["retile_hmix"],
                ("retile_hmix", "f32"): flagship32["retile_hmix"],
                ("quantize_tiled", "bf16"): flagship["quantize_tiled"],
                ("gram_pair_q", "int8"): flagship["gram_pair_q"],
                ("gram_pair_q", "int8, regression chunk"): fit8["gram_pair_q"],
                ("gram_pair", "bf16"): flagship["gram_pair"],
                ("gram_pair_tiled", "f32"): flagship32["gram_pair_tiled"],
                ("gram_pair_tiled", "bf16"): flagship16["gram_pair_tiled"],
                ("gram_pair", "f32"): flagship32["gram_pair"],
                **{(k, "f32"): fit[k] for k in REGRESSION_KERNELS},
                ("own_out_gram", "f32"): own["own_out_gram"]}
    pallas = "tensornetworksfork_tpu/ops/pallas/gram.py"
    csrc = "tensornetworksfork_tpu_torch/csrc"
    sources = {"retile_hmix": 726, "quantize_tiled": 971, "gram_pair_q": 1254,
               "gram_pair_tiled": 873, "gram_pair": 550, "retile_rows": 657,
               "weighted_gram_tiled": 1439, "weighted_gram": 335,
               "own_out_gram": 1373}
    float_gram = ("gram_pair", "gram_pair_tiled", "weighted_gram_tiled", "weighted_gram",
                  "own_out_gram")

    def source_file(name):
        return ("wgram.cu" if name in float_gram else
                "qgram.cu" if name == "gram_pair_q" else "gram.cu")
    print(json.dumps({"kernels": [
        {"name": k["name"], "dtype": k["dtype"], "route": "cuda",
         "source": f"{csrc}/{source_file(k['name'])}",
         "replaces": f"{pallas}:{sources[k['name']]}",
         "launches": launches[k["name"], k["dtype"]],
         "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
         "bound_type": k["bound"][2] + (", 3 products a multiply-add" if k["bound"][2] == "tf32" else ""),
         "library_ms": k["library_ms"],
         **({"int_mm_ms": k["int_mm_ms"]} if "int_mm_ms" in k else {})}
        for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
