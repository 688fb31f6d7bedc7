#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 1-10    # these two runs together
    python3 chip_smoke.py --phases 11-14   # cover every phase

`--phases` takes ranges and numbers ("3,14"); phases 1-5 run every time
(the build, the kernel checks and the main path, whose launches the kernels
line reports), and a phase runs the phases whose outputs it takes (11: 4, 5
and 7; 12 and 13: 4). Phase 14 launches no Gram kernel, so where it runs it
runs first, beside the build.

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
   calls; a plain version that runs 10x its kernel or more, one timed
   call after a warm-up), beside the kernel's bound: the larger of its
   operations over the card's peak for their type and its bytes over the
   memory rate (PEAK, HBM below). K1 (bf16 and f32, with the rhs it sums), K2, K3, K6 (bf16 and
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
   operands), one in the bf16 tier (K1, K6 and K10 on bf16 operands) and
   one in `bench.py`'s tier, PRECISION=fastest (int8 Gram operands and the
   bf16 aux tier: K1, K2, K3, K10), whose loss must agree with the f32-aux
   int8 swipe's within AUX_LOSS_RTOL (where their time goes:
   `experiments/probes/aux_tier_probe.py`); the launch counters show every
   kernel of each run ran, and
   each swipe must lower the training loss, keep every parameter finite and
   report no singular solve;
5. regression — `TensorTrainRegressor(N=3, r=8)` fitted for two swipes on
   `make_regression` (128 features, 65,536 rows to fit, 16,384 to
   validate) in the f32 tier, which must report no singular solve, keep
   every parameter finite, beat predicting the mean on the validation rows
   and launch K8, K7 (at least 128 times) and K9; then one more swipe with
   the opt-in own-out kernel (K11), which must agree with the default
   route, and one in the int8 tier (K8, K2, K3);
6. reference — a tiny conv-TT swipe (f32, int8, f32 with the bf16 aux
   tier, fastest) and a tiny TT-regression swipe (f32, bf16, int8) with the
   kernels and the aux products on the card agree with the same swipes
   through the plain versions on the CPU (which the CPU tests hold against
   the JAX package); each aux product of the card's swipe with the aux
   tier is held to float64 of its bf16-rounded operands, a bound that a
   bf16-output product and an unrounded f32 product of the same operands
   must both fail;
7. image trainer — `experiments/train_image.py` at the headline MNIST
   configuration (type-I sum of conv-TTs of 1-4 carriages, r=18, CB=8,
   kernel 4/4, batch 2048, eps 5.0 x 0.25) on its synthetic stand-in
   (8,192 samples, 50 patches x 17 pixels, 10 classes), PRECISION=fastest,
   one whole swipe (a patience beyond its 40 updates): it must launch K1 24
   times, K2, K3 and K10, keep its parameters finite and beat chance on its
   test rows; then the digits gate, `reproduce_result.main("digits")`
   (seeds 42-51) in the reference tier (K1, K6 in f32, K10) and in the
   fastest tier: each tier's mean test accuracy must lie within the printed
   noise floor of 96.55 % and no seed may end with non-finite parameters.
   Each of these runs records the shapes it gives K1, K2, K6 and K10, and
   every kernel is then held to its plain version at each of them (K1 in
   bf16 and f32, K2 and K3 bit for bit, K6 in f32 against float64 too, K10
   in the path's type), the largest of each timed into the kernels line
   under the path's name.

8. solver tiers — (a) the float64 solve tier on the card: the eps ladder of
   tests/test_eps_ladder.py (D = 64, cond 1e8, eps 1e-3 down to 1e-12)
   through solve_block, whose float64 tier must meet a numpy float64
   oracle at every eps, with its control (cond 1e9, eps 1e-12: the f32
   tier must fail, the float64 tier solve); the float64 and f32 solves'
   device times at the regression's A2 (D = 8,256); phase 5's fit in f32
   and in solve_dtype="float64" (the opt-in own-out kernel on), whose val
   RMSEs must agree within 1 % and whose float64 run must launch K7, K8,
   K9 and K11; (b) cg, minres and lanczos_galerkin on dense operators at
   D = 4,096 (SPD; symmetric indefinite for MINRES), each held to a float64
   solve at tests/test_matrixfree.py's bounds and to the same solver on the
   CPU run for the card's iteration count; (c) one swipe of a small conv-TT
   (XEBregman) and of a small TT (SquareBreg) in cg, minres, lanczos and
   gradient from the same weights, card against CPU; (d) the CIFAR_minres
   headline: train_image with PRESET=cifar_minres at the reference's width
   (type-I sum of conv-TTs of 1-4 carriages, r=100, CB=5, kernel 8/8, batch
   4096, MINRES with max_iter 50) on its 3-channel synthetic stand-in, 49,152
   training samples, one whole swipe: its train_seconds, each node's MINRES
   iterations, the peak memory and the test accuracy are printed; it must
   beat chance, keep its parameters finite, report no singular solve, launch
   no Gram kernel (the middle cores' D = 160,000 would make a dense A of
   102 GB) and peak far below that.

9. the zoo — (i) one swipe of a small network of every layer builder and
   loss that the zoo added (TensorTrainLinearLayer, CumSumLayer, CPDLayer,
   CPDTrainLayer, OperatorTTLayer and its ring, TensorTrainSplitInputLayer,
   TensorConvolutionGridTrainLayer, TensorConvOperatorLayer, complex64 and
   complex128 ComplexTensorTrainLayer; SoftmaxSquaredLoss,
   BinaryKLDivBregman, AutogradLoss, AutogradBregman,
   UncertaintyAutogradLoss; a sweep with orthonormalize=True), kernels on
   the card against plain versions on the CPU; (ii) the width path: phase
   5's regression config (65,536 rows to fit, 16,384 to validate, N=3,
   r=8, 2 swipes, f32) through TensorTrainRegressor for cpd, cpd_type1, tt
   with linear_dim=4 and cum_sum at d = 64, then tnml on breast_cancer (30
   carriages): each fit's time, val RMSE or accuracy and launches; each
   must launch one of K7-K11, and every shape it gives K7, K8, K9 and K10
   is held to the plain version, the largest timed; (iii) the zoo table
   (experiments/zoo_eval.py, 5 datasets x 8 families x seeds 42-44) with 0
   failed fits, polynomial's cells within compare_tables' 2 points of
   results/zoo_eval.csv, and each other family's mean within 2 x its
   within-cell seed sd x sqrt(1/15 + 1/15) of the committed table's: the
   committed table's sd, and for tt_linear the JAX package's over 60 seeds
   (studies/zoo_seed_sd.json, zoo_floors).

10. growth and the remaining estimators — (i) `run_grow_cart` at the MNIST
   headline's widths (r=18, CB=8, kernel 4/4) on train_image's synthetic
   stand-in with heavy pixel noise (8,192 samples, 10 classes, XEBregman on
   9 logits; on the noiseless stand-in the XE growth diverges to NaN in
   both packages), 1 -> 4 carriages, 3 swipes a step at eps 1.0 x 0.5,
   full batch, in the fastest tier (K1, K2, K3, K10) and in f32 (K1, K6,
   K10): each step's carriages, parameters, train RMSE and accuracy, ok
   and seconds, every step ok or above chance; then the growth replayed,
   each step's first swipe held to the plain routes' on the card and each
   growth's forward to c x the last one's; (ii) `run_dmrg_growth` on
   make_regression's 16 features plus the bias column, 16,384 rows, bond 8,
   rank 8, 2 growth steps (the grown block D = 18,496), held to the plain
   routes on the card, and at 8 features, 4,096 rows to the CPU; (iii)
   `TensorTrainBatchRegressor` at phase 5's data and width over 1,024-row
   minibatches, 2 swipes, in batch_unique, batch_same and batch_block, held
   to the plain routes on the card (batch_same over 16,384 rows), and at
   d = 32 to the CPU; (iv) one swipe of every `default_train` variant at
   S = 8,192, the type-I sum of a compressed-data TT and a TT at batch -1
   and 32, 12 `TTNaturalGradient` steps at phase 5's width, `SymmetricCPD`
   for 60 iterations, each on the card against the port on the CPU from
   the same seed at its CPU test's tolerance, and `MLPWrapper` on
   breast_cancer and `CNNWrapper` (1 epoch on the stand-in's images) held
   to the CPU's final train loss within 2 %. Every kernel is held to its
   plain version at every shape these paths gave it
   (`check_growth_shapes`), the largest of each timed into the kernels
   line under the path's name.

11. serving, the native stream, checkpoints, FLOPs and digits_flat — (i)
   phase 7's trained type-I sum exported with a symbolic batch
   (`utils/serving.py`: `torch.export`), saved under build/ and loaded with
   `load_forward`, served at batches 1, 2,048 and the stand-in's whole test
   split, each within 1e-5 x max|pred| of the model's eager forward on the
   card with the argmax equal (throughputs in images/s, artifact and eager);
   phase 5's estimator (`export_estimator`) and a TNML fit on
   breast_cancer held to predict the same way; (ii)
   `TensorTrainBatchRegressor(stream="native")` in each swipe method at
   phase 10 (iii)'s data and width, every 8th batch the native stream
   gathers equal to X[idx], held to the same fit on the plain routes
   (TNF_KERNELS=0, the same stream; batch_same over 16,384 rows) and at
   d = 32 to the CPU, its fit time beside the default stream's, every
   shape it gave K7, K8 and K9 held to the plain versions; (iii) the
   headline's node states through `utils/checkpoint.py` into a freshly
   built model on the card, forward bit-equal; (iv) `epoch_flops` of phase
   4's flagship swipe and each tier's MFU (int8 against the int8 peak, the
   others against bf16's; a record); (v) a small swipe under `xla_trace`
   leaves a non-empty Chrome trace under build/; (vi) `reproduce_result
   digits_flat`, seeds 42-51: the mean within 2 x 1.17 x sqrt(2/10) of
   RESULTS.md's 94.36 %, every seed's parameters finite.

12. the data mesh and the drivers — (i) `parallel.launch` starts 2 gloo
   ranks that share the card (NCCL refuses two ranks on one device; the
   parent built the kernel library, so no rank runs nvcc), and each sweeps
   the flagship (phase 4's layer, data and config: 1,024 of each 2,048-row
   chunk a rank) on the 1-D data mesh (`parallel/mesh.py`,
   `Sweeper.run(mesh=)`) in int8 and in f32; each run's params held to
   phase 4's single-process swipe from the same weights (test_parallel.py's
   rtol = atol: 5e-2 in int8, whose per-rank quantisation blocks differ,
   5e-3 in f32), the ranks' params bit-equal, every kernel of the path
   launched on each rank; each rank's swipe time and the all-reduces'
   calls, bytes and seconds are printed; (ii) phase 5's regression rows and
   TT (65,536 x 128 features, N=3, r=8, 512-row chunks) for two f32 swipes
   on the mesh (K8 + K7 at D = 8,256, K9), held to the same sweep in one
   process at 5e-3; (iii) phase 8c's small conv-TT in one minres swipe on
   the mesh, held to one process at 5e-3, its iteration counts equal on
   both ranks; every kernel is then held to its plain version at every
   shape either rank gave it. (iv) the drivers: `experiments/sweep.py`'s
   run_sweep (GP-EI, 3 trials, a 2 s fold timeout) on its CLI's synthetic
   regression, `grid_search` at test_experiments.py's small grid (test r2
   above 0.5), `image_sweep.run_config` at the MNIST grid's first point on
   the stand-in in process and as a subprocess, and `utils/viz.py`'s text
   listing of the flagship; their fits' kernel shapes are held as (i)'s.
   reporting, plots and prepare_data need pandas or matplotlib, which the
   card's machine lacks; the CPU tests hold them.
13. the 2-D mesh and the precisions — (i) `parallel.launch` starts 4 gloo
   ranks that share the card as a 2 x 2 data x model mesh
   (`make_mesh(axis=("data", "model"), shape=(2, 2))`), and each sweeps the
   flagship (phase 4's layer, data and config) with its 50 patches split
   over the model pair (`model_axis_labels=("patches",)`: 25 a rank), in
   int8 and in f32, then once more in int8 on a 1-D data mesh of the 4
   ranks; the f32 params held to phase 4's at 5e-3, the int8 ones at 5e-2
   and to the 4-rank 1-D swipe's at MESH2D_INT8_1D_TOL (a 2-D rank's Gram
   rows are the rows rank 2i + j holds there), the ranks' params
   bit-equal, every kernel of the path launched on every rank and held to
   its plain version at every shape a rank gave it; each rank's swipe
   time, peak memory and its all-reduces', all-to-alls' and broadcasts'
   calls, bytes and seconds (the staging copies' apart) are printed; (ii)
   phase 12's minres conv-TT on the 2 x 2 mesh, held to one process at
   5e-3, its iteration counts equal on all ranks; (iii) `matmul(...,
   "high")` (bf16x3: three bf16 products with f32 outputs) on the card
   against its CPU plain version and against float64, with the single-pass
   product as a control that must fail; the flagship swipe in the int8
   Gram tier with TNF_AUX_PRECISION=high (K1, K2, K3, K10); and, card
   against CPU on phase 6's conv-TT, that tier and swipes of networks built
   at precision "default" and "high".
14. the kernel baselines — libsvm's SMO and sklearn's Gaussian processes
   written out in torch (`models/_libsvm.py`, `models/_gp.py`; no Gram
   kernel runs on this path): (i) `train_tabular.run(model_type="svm")` on
   its six tables at full size (synthetic SVR over 4,914 dual variables,
   iris, wine, breast_cancer, diabetes SVR, digits' 45 one-vs-one pairs in
   one batch), on the card and with device="cpu": decision values within
   KB_SVM_DEC_ATOL, labels equal; (ii) `GaussianProcessWrapper` regression
   on diabetes and synthetic (L-BFGS-B on the log-marginal likelihood) and
   classification on iris, wine, breast_cancer and digits (binary Laplace,
   one-vs-rest), card against CPU (theta, lml, predictions or
   probabilities); (iii) every val/test metric of the card's runs held to
   sklearn's (`results/kernel_baselines.json`, written by
   `studies/kernel_baselines_ref.py`); (iv) the sklearn options the
   wrappers port (SVC class_weight="balanced" and break_ties on wine,
   digits and iris; GPR with 3 restarts from random_state=0 on diabetes;
   GPC one_vs_one and warm_start on iris, wine and digits), card against
   CPU at the same bounds and every val/test metric against sklearn's in
   `results/kernel_baselines_options.json`
   (`studies/kernel_baselines_options_ref.py`); (v) sklearn's kernel
   objects (`models/_gp_kernels.py`): every kernel class, sum, product and
   power at diabetes's and breast_cancer's training rows, K, ∂K/∂θ and
   diag card against CPU within KB_KERNEL_RTOL; every
   `kernel_baselines.KERNEL_OPTIONS` fit (Matern + white and rational
   quadratic regression on diabetes, C * RBF classification with free
   hyperparameters on iris and wine one-vs-rest and iris one-vs-one,
   Matern 1.5 on breast_cancer) card against CPU at the KB_* bounds, each
   binary problem's θ too, and held to sklearn's metrics in
   `results/gp_kernels.json` (`studies/gp_kernels_ref.py`); SVC
   probability=True on iris, wine and digits, its labels, decision values
   and SMO iterations equal to the default fit's; (vi) the last kernel
   options: the Bessel function kv (`models/_special.py`) on the card
   against scipy.special.kv and the committed reference at its grid, each
   pairwise kernel function (`models/_pairwise.py`) and PairwiseKernel's and
   general-ν Matern's K, ∂K/∂θ (a finite difference) and diag card against
   CPU at diabetes's training rows, and every
   `kernel_baselines.MORE_KERNEL_OPTIONS` fit (Matern at ν 1 and 0.75,
   PairwiseKernel rbf and laplacian, SVC / SVR with a precomputed or a
   callable kernel, a user's string kernel through `HostKernel`) card
   against CPU (the SVM's SMO iterations and support vectors equal) and
   against sklearn's in `results/gp_kernels_more.json`
   (`studies/gp_kernels_more_ref.py`). Each fit's seconds on the card and
   the CPU, the SMO iterations and support vectors per pair, the L-BFGS
   evaluations and the Newton iterations are printed.

The kernels' operands at the paths' shapes are drawn on the card from
seeded generators. Each kernel is held once at a shape, whichever phase
gives it first, except where a later path times it there.

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
                    "fastest": ("retile_hmix", "quantize_tiled", "gram_pair_q", "gram_pair"),
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


def time_ms(fn, reps: int = 5, once_over: float = float("inf")) -> float:
    """fn's device time: the median over `reps` runs of CUDA events around n
    back-to-back calls, divided by n. A warm-up call picks n so that a run
    lasts about 2 ms (at most 100 calls; 1 for calls of 2 ms or more), so a
    short kernel is timed over many launches, not one. Where the warm-up
    call takes `once_over` ms or more, one more call timed alone is the
    time (plain_time_ms)."""
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

    first = run(1)
    if first >= once_over:
        return float(run(1))
    n = int(min(100, max(1, np.ceil(2.0 / max(first, 1e-3)))))
    return float(np.median([run(n) for _ in range(reps)]))


# a plain version that runs this many times its kernel's time or more is
# timed by one call: its time is a record beside the kernel's, no yardstick
PLAIN_ONCE_RATIO = 10


def plain_time_ms(fn, kernel_ms: float) -> float:
    """A plain version's time beside its kernel's `kernel_ms`: one timed call
    after the warm-up where it runs PLAIN_ONCE_RATIO x the kernel's time or
    more, else time_ms's median of 5."""
    return time_ms(fn, once_over=PLAIN_ONCE_RATIO * kernel_ms)


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


def weighted_to_float64(name, A, X, h):
    """Hold a weighted Gram A = Xᵀ diag(h) X (mirrored, f32) of the f32
    operand X (rows, D) to float64 with k9_ratios: within gram_tol(rows) on
    the diagonal and 16 2^-24 off it. The plain version of X rounded to bf16
    and to TF32 must fail the check, so it sees a kernel that rounds its f32
    operands (a TF32 rounding moves an off-diagonal entry by ~24 2^-24 of
    its natural size at 65,536 rows, the largest of hundreds by 3 sigma and
    more). Returns a note for the kernels line."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    X64 = X.double()
    A64 = (X64 * h.double()[:, None]).T @ X64
    del X64
    bounds = (gram_tol(X.shape[0]), 16 * 2.0 ** -24)
    got = k9_ratios(A, A64)
    ctl = {w: k9_ratios(kg.mirror_gram(kg.weighted_gram_plain(rnd(X), h)), A64)
           for w, rnd in (("bf16", lambda t: t.to(torch.bfloat16)), ("TF32", tf32_round))}
    u = 2.0 ** -24
    note = (f"float64: {got[0] / u:.3g}, {got[1] / u:.3g} 2^-24 of sqrt(A_dd A_ee) on "
            f"and off the diagonal (bounds {bounds[0] / u:.3g}, {bounds[1] / u:.3g}); "
            + ", ".join(f"{w}-rounded {r[0] / u:.3g}, {r[1] / u:.3g}"
                        for w, r in ctl.items()))
    log(f"[kernels] {name} vs {note}")
    if not (got[0] <= bounds[0] and got[1] <= bounds[1]):
        raise AssertionError(f"{name}: float64 ratios {got} over the bounds {bounds}")
    passed = [w for w, r in ctl.items() if r[0] <= bounds[0] and r[1] <= bounds[1]]
    if passed:
        raise AssertionError(f"{name}: the float64 check passes operands rounded to "
                             f"{passed}, so it cannot see precision")
    return note


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


def int8_gram_entry(where, Q1, s1, Q2, s2, acc, timed=True):
    """K3 (gram_pair_band_q) on the K-major codes Q1, Q2 into `acc` over two
    chained chunks, held bit for bit (torch.equal) to its plain version;
    with `timed`, then timed beside its bound, the plain version and
    torch._int_mm over the same blocks, and its kernels entry returned
    (else None)."""
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
    if not timed:
        return None
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
        plain_ms=plain_time_ms(lambda: kg.gram_pair_q_plain(Q1, s1, Q2, s2, acc), ms),
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
    # counted in int64: an f32 mean of some 1e8 ones need not come to 1.0
    differ = int((Kt.view(bits) != Kt_p.view(bits)).sum())
    ulps = float((dK / bf16_ulp(Kt_p.float())).max())
    if dtype == torch.float32 and differ:
        raise AssertionError(f"{what}: Kt not bit-equal ({differ} of {Kt.numel()} values "
                             "differ)")
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
        plain_ms=plain_time_ms(lambda: kg.retile_hmix_plain(J3, H, Dp, gvec), ms),
        library_ms=None,
        # the class mix and the rhs: a multiply and an add per term, in f32
        bound=bound(2.0 * S * C * (C + 1) * D, nbytes(J3, H, gvec, Jt, Kt, b), "f32"),
        note=f"A2/A3 chunk (S={S}, C={C}, D={D}, Dp={Dp}), Jt bit-equal, Kt max "
             f"{ulps:.3g} bf16 ulp ({differ} values differ), b max {rb:.3g} "
             f"sqrt(S*C) 2^-24 of sum|g||J| (bound {HMIX_B_BOUND}); {runs} runs of {rps} "
             f"samples; without b {bare:.4f} ms; the rhs as the engine formed it before, "
             f"gvec.float() @ Jt.float(), {rhs_old:.4f} ms")
    del dK
    return entry, Jt, Kt


def quantize_entry(where, Jt, Kt, block, timed):
    """K2 on K1's Jt and Kt against its plain version (values, the K-major
    layout, the zero pad). Returns the codes (Q1, s1, Q2, s2) and, with
    `timed`, K2's kernels entry (its time on Kt beside its bound), else
    None."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    q = kg.quantize_tiled(Jt, block) + kg.quantize_tiled(Kt, block)
    plain = kg.quantize_tiled_plain(Jt, block) + kg.quantize_tiled_plain(Kt, block)
    torch.cuda.synchronize()
    check_quantized(f"quantize_tiled ({where})", q, plain)
    del plain
    if not timed:
        return q, None
    Q2, s2 = q[2:]
    ms = time_ms(lambda: kg.quantize_tiled(Kt, block))
    return q, dict(
        name="quantize_tiled", dtype="bf16", err=0.0, ms=ms,
        plain_ms=plain_time_ms(lambda: kg.quantize_tiled_plain(Kt, block), ms),
        library_ms=None,
        # |x|, max, x * (1/s), round: 4 operations an element
        bound=bound(4.0 * Kt.numel(), nbytes(Kt, Q2, s2), "f32"),
        note=f"{where} ({Kt.shape[0]}x{Kt.shape[1]}), Q and s bit-equal, Q K-major "
             f"(strides {Q2.stride()}) as the plain version's; strip of "
             f"{kg.quant_strip(kg.quant_block(Kt.shape[0], block))} columns a CTA")


def carry_gram(X, Y, D):
    """K6 (gram_pair with a carry, over the node's D of the (rows, Dp)
    tiled operands X, Y) and its plain version from a zero carry, held to
    1e-5 of max|A|: (err, tol, the kernel's carry)."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    Dp = X.shape[1]
    acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=X.device)
    acc_p = torch.zeros_like(acc)
    kg.gram_pair(X, Y, acc=acc, D=D)
    kg.gram_pair_plain(X, Y, acc=acc_p)
    A, A_p = kg.mirror_gram(acc), kg.mirror_gram(acc_p)
    torch.cuda.synchronize()
    err = float((A - A_p).abs().max())
    tol = 1e-5 * float(A_p.abs().max())
    if not err <= tol:
        raise AssertionError(f"gram_pair ({X.shape[0]}x{Dp}, D {D}, carry, {X.dtype}): "
                             f"max|dA| {err} > {tol}")
    return err, tol, acc


def k6_split_bf16(Jt, Kt, acc, D):
    """K6 in bf16 on the split Gram in one split (the route of operands TMA
    cannot address, and the clustered Gram's former kernel)."""
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    kg._launch_wgram_split(Jt, None, 0, None, acc, D, True, 1, "gram_pair", Y=Kt,
                           has_acc=True)


def k6_cluster_l2_bytes(rows: int, D: int, cluster_rows: int) -> float:
    """Operand bytes K6 in bf16 reads from L2 a call: every CTA of the
    clustered Gram loads, a 64-row stage at a time, half its row's X strip
    (the other half reaches it from its row neighbour) and of its column's
    Y strip half (cluster_rows 2) or all (1); cluster_rows 0: the split
    Gram, two whole 128-column strips a tile."""
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    nt = -(-D // kg.WTILE)
    rows64 = -(-rows // 64) * 64
    if cluster_rows == 0:
        return 2.0 * (nt * (nt + 1) // 2) * rows64 * 2 * kg.WTILE
    ctas = len(kg._cluster_table_np(nt, cluster_rows))
    return 2.0 * ctas * rows64 * (kg.WTILE // 2 + kg.WTILE // cluster_rows)


def k6_bf16_entry(where, Jt, Kt, D, timed):
    """K6 in bf16 on K1's outputs Jt, Kt against its plain version, and bit
    for bit (torch.equal, two chunks chained from a nonzero carry) against
    the split Gram it replaced; with `timed`, its kernels entry (else None)
    beside its bound, its plain version, torch.mm, the split Gram and the
    clustered Gram in clusters of 1 x 2 tiles."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    err, tol, acc = carry_gram(Jt, Kt, D)
    rows, Dp = Jt.shape
    route = kg.k6_kernel(Jt.dtype, Dp, Jt.data_ptr(), Kt.data_ptr())
    if route != "cluster":
        raise AssertionError(f"gram_pair ({where}, bf16) took the {route} route")
    acc_c = torch.randn_like(acc)
    acc_s = acc_c.clone()
    for _ in range(2):
        kg.gram_pair(Jt, Kt, acc=acc_c, D=D)
        k6_split_bf16(Jt, Kt, acc_s, D)
    torch.cuda.synchronize()
    if not torch.equal(acc_c, acc_s):
        raise AssertionError(f"gram_pair ({where}, bf16) differs from the split "
                             f"Gram by {float((acc_c - acc_s).abs().max())}")
    del acc_c, acc_s
    if not timed:
        return None
    with bf16_f32_reduction():
        lib = time_ms(lambda: torch.mm(Jt.T, Kt))
    Jf, Kf = Jt.float(), Kt.float()
    up = time_ms(lambda: acc.addmm_(Jf.T, Kf))
    del Jf, Kf
    ms = time_ms(lambda: kg.gram_pair(Jt, Kt, acc=acc, D=D))
    split = time_ms(lambda: k6_split_bf16(Jt, Kt, acc, D))
    alt = 1 if kg.CLUSTER_ROWS == 2 else 2
    other = time_ms(lambda: kg._launch_gram_cluster(Jt, Kt, acc, D, alt))
    lib_ = kg._build.lib()
    occ = {c: lib_.tnf_gram_bf16_cluster_occupancy(c) for c in (1, 2)}
    shape = {1: "1 x 2", 2: "2 x 2"}
    l2 = {c: k6_cluster_l2_bytes(rows, D, c) for c in (0, 1, 2)}
    times = {kg.CLUSTER_ROWS: ms, alt: other}
    log(f"[kernels] gram_pair bf16 ({where}): clustered {shape[kg.CLUSTER_ROWS]} {ms:.3f} "
        f"ms, {shape[alt]} {other:.3f} ms, split Gram {split:.3f} ms; clusters the card "
        f"holds at once {occ[2]} of 2 x 2, {occ[1]} of 1 x 2")
    return dict(
        name="gram_pair_tiled", dtype="bf16", err=err, ms=ms,
        plain_ms=plain_time_ms(lambda: kg.gram_pair_plain(Jt, Kt, acc=acc), ms),
        library_ms=lib,
        bound=bound(gram_ops(rows, D), nbytes(Jt, Kt) + 2 * nbytes(acc), "bf16"),
        note=f"{where} with carry ({rows}x{Dp}, D {D}, bf16 from K1), tol {tol:.3g}; "
             f"clustered Gram ({shape[kg.CLUSTER_ROWS]} tiles a cluster, TMA multicast), "
             f"bit-equal (torch.equal) to the split Gram over two chained chunks; "
             f"L2 reads a call {l2[kg.CLUSTER_ROWS] / 1e9:.1f} GB = "
             f"{l2[kg.CLUSTER_ROWS] / ms / 1e9:.2f} TB/s; "
             + "; ".join(f"{shape[c]}: {times[c]:.3f} ms, L2 {l2[c] / 1e9:.1f} GB, "
                         f"{occ[c]} clusters at once" for c in (2, 1))
             + f"; split Gram (1 split) {split:.3f} ms, L2 {l2[0] / 1e9:.1f} GB = "
             f"{l2[0] / split / 1e9:.2f} TB/s; library: torch.mm on the bf16 operands "
             f"(bf16 out, f32 sums); acc.addmm_ on them upcast to f32 {up:.3f} ms")


def k6_f32_entry(device, where, rows, D, timed):
    """K6 in f32 at (rows, Dp) over the node's D, on full-mantissa operands
    (the f32 tier's): against its plain version and, entry by entry, float64,
    with bf16- and TF32-rounded controls that must fail; with `timed`, its
    kernels entry (else None)."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    Dp = kg.plan_tiles(D)[3]
    gen = torch.Generator(device=device).manual_seed(6)
    J6, K6 = (torch.nn.functional.pad(
        torch.randn((rows, D), generator=gen, device=device) * 0.05, (0, Dp - D))
        for _ in range(2))
    err, tol, acc = carry_gram(J6, K6, D)
    e64, r64, e64_p, r64_p, ctl = hold_to_float64(
        f"gram_pair_tiled (f32, {where})", acc[:D, :D],
        kg.gram_pair_plain(J6[:, :D], K6[:, :D]), J6[:, :D], K6[:, :D], controls=True)
    if not timed:
        return None
    # the split Gram's f32 FMA kernel on the same operands: the route K6 in
    # f32 would take if the 3xTF32 kernel were not faster
    fma = time_ms(lambda: kg._launch_wgram_split(J6, None, 0, None, acc, D, True, 1,
                                                 "gram_pair", Y=K6, has_acc=True))
    u = 2.0 ** -24
    ms = time_ms(lambda: kg.gram_pair(J6, K6, acc=acc, D=D))
    return dict(
        name="gram_pair_tiled", dtype="f32", err=err, ms=ms,
        plain_ms=plain_time_ms(lambda: kg.gram_pair_plain(J6, K6, acc=acc), ms),
        library_ms=time_ms(lambda: acc.addmm_(J6.T, K6)),
        # three TF32 products a multiply-add
        bound=bound(3 * gram_ops(rows, D), nbytes(J6, K6) + 2 * nbytes(acc), "tf32"),
        note=f"{where} with carry ({rows}x{Dp}, D {D}, full-mantissa f32), tol "
             f"{tol:.3g}; 3xTF32 wgmma; float64 error {e64:.3g} (plain f32 {e64_p:.3g}), "
             f"{r64 / u:.3g} 2^-24 of the scale (plain {r64_p / u:.3g}){ctl}; the split "
             f"Gram's f32 FMA kernel on them {fma:.3f} ms; library: acc.addmm_")


def k10_entry(device, where, rows, D4, kind, timed, seed=0):
    """K10 (the flat split Gram) at (rows, D4) in `kind` against its plain
    version and float64 (pair_errors); in f32 the operands rounded to bf16
    or TF32 must fail the float64 check, so it sees a kernel that rounds f32
    operands. With `timed`, its kernels entry (else None)."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    sms = kg.sm_count(device)
    _, splits, rps = kg.wgram_plan(rows, D4, 1, True, sms)
    log(f"[kernels] gram_pair plan at {rows}x{D4} ({where}): {splits} row splits of "
        f"{rps} rows on {sms} SMs")
    X, Y = ((torch.randn((rows, D4), generator=gen, device=device) * 0.05).to(dt)
            for _ in range(2))
    A = kg.mirror_gram(kg.gram_pair(X, Y))
    A_p = kg.mirror_gram(kg.gram_pair_plain(X, Y))
    torch.cuda.synchronize()
    err = float((A - A_p).abs().max())
    scale = float(A_p.abs().max())
    log(f"[kernels] gram_pair ({kind}, {where}) max|dA| vs plain {err:.3g} "
        f"(1e-5*max|A| = {1e-5 * scale:.3g})")
    e64, r64, e64_p, r64_p, controls = hold_to_float64(
        f"gram_pair ({where}, {kind})", A, A_p, X, Y, controls=kind == "f32")
    tol, rule = 1e-5 * scale, "1e-5*max|A|"
    if not err <= tol:
        # the kernel's order of sums, not a looser check: held to gram_tol
        # (as K7, K9, K11) and to the exact sum, whose error it may not
        # exceed twice the plain version's
        tol, rule = gram_tol(rows) * scale, "gram_tol(rows)*max|A| and float64"
        if not (err <= tol and e64 <= 2 * e64_p):
            raise AssertionError(
                f"gram_pair ({where}, {kind}): max|dA| {err} (tol {tol}), "
                f"float64 error {e64} vs plain {e64_p}")
        log(f"[kernels] gram_pair ({kind}, {where}) above 1e-5*max|A|: held to {rule}")
    del A, A_p
    if not timed:
        return None
    u = 2.0 ** -24
    ms = time_ms(lambda: kg.gram_pair(X, Y))
    note = (f"{where} ({rows}x{D4} {kind}), {splits} row splits, tol {tol:.3g} "
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
    return dict(name="gram_pair", dtype=kind, err=err, ms=ms,
                plain_ms=plain_time_ms(lambda: kg.gram_pair_plain(X, Y), ms), library_ms=lib,
                bound=bound(gram_ops(rows, D4), nbytes(X, Y) + 4 * D4 * D4, kind),
                note=note)


def check_kernels(device, S=BATCH, D=None, rows4=None, D4=None):
    """Phase 3: every kernel against its plain version, timed, by default
    at the flagship's shapes: A2/A3 (S=2048 per chunk, C=9, D=r*P*r=16,200)
    for K1, K2, K3, K4 and K6, A4 (8192*9 merged rows, D=r*P=900) for K10;
    K1 also at HMIX_SHAPES."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

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

    # K2 quantize_tiled, then K3 gram_pair_band_q over two chained chunks:
    # both bit-equal to their plain versions
    (Q1, s1, Q2, s2), k2 = quantize_entry("flagship A2 chunk", Jt, Kt, block, timed=True)
    results.append(k2)
    acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=device)
    results.append(int8_gram_entry("flagship A2 chunk", Q1, s1, Q2, s2, acc))
    A = kg.mirror_band(acc)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(A).all()):
        raise AssertionError("gram_pair_band_q: non-finite Gram")
    del acc, A
    # K4 gram_pair_tiled_q, K3's carry-less entry (on no path of the port):
    # bit-equal to its plain version, and its time at this chunk beside its
    # bound (the wrapper's zeroed output included), its plain version's and
    # torch._int_mm's over the same blocks (as K3's), logged for the table of
    # kernels but not in the kernels line, which lists the paths' kernels
    B4 = kg.gram_pair_tiled_q(Q1, s1, Q2, s2)
    B4_p = kg.gram_pair_q_plain(Q1, s1, Q2, s2, torch.zeros_like(B4), band=False,
                                has_acc=False)
    torch.cuda.synchronize()
    if not torch.equal(B4, B4_p):
        raise AssertionError("gram_pair_tiled_q: differs from its plain version")
    ms4 = time_ms(lambda: kg.gram_pair_tiled_q(Q1, s1, Q2, s2))
    plain4 = time_ms(lambda: kg.gram_pair_q_plain(Q1, s1, Q2, s2, B4_p.zero_(), band=False,
                                                  has_acc=False))
    del B4, B4_p
    _, mm4_note = int_mm_ms(Q1, Q2, Q1.shape[0] // s1.shape[0])
    nslab = Dp // kg.TILE
    tiles4 = len(kg._pair_table_np(Dp // kg.QTILE, kg.TILE // kg.QTILE, False))
    b4 = bound(2.0 * Q1.shape[0] * nslab * (nslab + 1) / 2 * kg.TILE ** 2,
               nbytes(Q1, s1, Q2, s2) + tiles4 * kg.QTILE ** 2 * 4, "int8")
    log(f"[kernels] gram_pair_tiled_q (K4, on no path; {Q1.shape[0]}x{Dp}): {ms4:.3f} ms, "
        f"bound {b4[0]:.3f} ms ({b4[1]}), plain version {plain4:.3f} ms, library: "
        f"{mm4_note}; bit-equal (torch.equal) to its plain version")
    del Q1, s1, Q2, s2

    # K6, the float Gram with carry at the A2 shape: bf16 on K1's operands
    # (the bf16 swipe's), f32 on full-mantissa ones (the f32 swipe's)
    results.append(k6_bf16_entry("A2 shape", Jt, Kt, D, timed=True))
    del Jt, Kt
    results.append(k6_f32_entry(device, "A2 shape", C * S, D, timed=True))

    # K10, the flat float Gram at the A4 shape (the split Gram of
    # csrc/wgram.cu), on bf16 operands (the int8 and bf16 swipes) and on
    # full-mantissa f32 ones (the f32 swipe)
    rows4 = rows4 or SLICE_SAMPLES * C
    D4 = D4 or FLAGSHIP["r"] * FLAGSHIP["P"]
    for kind in ("bf16", "f32"):
        results.append(k10_entry(device, "A4 shape", rows4, D4, kind, timed=True))
    log_kernels(results)
    return results


@contextlib.contextmanager
def recorded_shapes():
    """Records the shapes and types a path gives K1 (J3's S, C, D), K2 (the
    operand it quantises), K6 and K10 (X's rows and width, and D), K8 (X
    and Dp), K7 (Xt and D) and K9 (X), by wrapping their entry points in
    ops/cuda/gram.py, which the engine calls through the module; the
    wrappers only record and call through. K3 takes K2's codes. Yields the
    set of (kernel, shape, dtype[, D or Dp]) seen."""
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    seen = set()
    hmix, quant, pair = kg.retile_hmix, kg.quantize_tiled, kg.gram_pair
    rows_, wtiled, wflat = kg.retile_rows, kg.weighted_gram_tiled, kg.weighted_gram

    def retile_rows(X, Dp, h=None):
        seen.add(("retile_rows", tuple(X.shape), X.dtype, Dp))
        return rows_(X, Dp, h)

    def weighted_gram_tiled(Xt, h, acc, D=None):
        seen.add(("weighted_gram_tiled", tuple(Xt.shape), Xt.dtype,
                  Xt.shape[1] if D is None else D))
        return wtiled(Xt, h, acc, D)

    def weighted_gram(X, h, splits=None):
        seen.add(("weighted_gram", tuple(X.shape), X.dtype))
        return wflat(X, h, splits)

    def retile_hmix(J3, H, Dp, gvec=None):
        seen.add(("retile_hmix", tuple(J3.shape), J3.dtype))
        return hmix(J3, H, Dp, gvec)

    def quantize_tiled(X, block=kg.BLOCK):
        seen.add(("quantize_tiled", tuple(X.shape), X.dtype))
        return quant(X, block)

    def gram_pair(X, Y, acc=None, splits=None, D=None):
        name = "gram_pair" if acc is None else "gram_pair_tiled"
        seen.add((name, tuple(X.shape), X.dtype, X.shape[1] if D is None else D))
        return pair(X, Y, acc=acc, splits=splits, D=D)

    kg.retile_hmix, kg.quantize_tiled, kg.gram_pair = retile_hmix, quantize_tiled, gram_pair
    kg.retile_rows, kg.weighted_gram_tiled, kg.weighted_gram = (
        retile_rows, weighted_gram_tiled, weighted_gram)
    try:
        yield seen
    finally:
        kg.retile_hmix, kg.quantize_tiled, kg.gram_pair = hmix, quant, pair
        kg.retile_rows, kg.weighted_gram_tiled, kg.weighted_gram = rows_, wtiled, wflat


def check_path_shapes(device, path, seen, done):
    """Phase 7's kernels against their plain versions at every shape the
    path gave them (`seen`, from recorded_shapes); K6 in f32 and K10, held to
    float64 too, skip the shapes in `done` (checked for an earlier path;
    updated) unless they are timed here: K1 in bf16 and in f32 at each
    (S, C, D) (its one-value path where D is not a multiple of 8); K2 and K3
    bit for bit on K1's bf16 outputs where the path quantised that chunk;
    K6 in f32 on full-mantissa operands at each chunk (held to float64 too),
    and in bf16 on K1's outputs where the path ran it so; K10 in the path's
    type at each (rows, D). The largest shape of each kernel the path
    launched is timed: returns those kernels entries, their dtype naming the
    path."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    log(f"[path] {path}: shapes {sorted(str(s) for s in seen)}")
    hmix = sorted((s for s in seen if s[0] == "retile_hmix"),
                  key=lambda s: (s[1][0] * s[1][2], str(s[2])))
    quantised = {s[1] for s in seen if s[0] == "quantize_tiled"}
    tiled = {(s[1], s[2]) for s in seen if s[0] == "gram_pair_tiled"}
    flat = sorted((s for s in seen if s[0] == "gram_pair"),
                  key=lambda s: (s[1][0] * s[1][1] ** 2, str(s[2])))
    kinds = {torch.bfloat16: "bf16", torch.float32: "f32"}
    results = []

    def label(entry, kind):
        return dict(entry, dtype=f"{kind}, {path}")

    for i, (_, (S, C, D), dtype) in enumerate(hmix):
        last = i == len(hmix) - 1
        _, block, _, Dp = kg.plan_tiles(D)
        rows = C * S
        for dt in (torch.bfloat16, torch.float32):
            timed = last and dt == dtype
            entry, Jt, Kt = check_retile_hmix(device, S, C, D, dt, timed=timed)
            if timed:
                results.append(label(entry, kinds[dt]))
            if dt == torch.bfloat16 and (rows, Dp) in quantised:
                (Q1, s1, Q2, s2), k2 = quantize_entry(f"{path} chunk", Jt, Kt, block,
                                                      timed=last)
                acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=device)
                k3 = int8_gram_entry(f"{path} chunk", Q1, s1, Q2, s2, acc, timed=last)
                if last:
                    results += [label(k2, "bf16"), label(k3, "int8")]
                del Q1, s1, Q2, s2, acc
            if dt == torch.bfloat16 and ((rows, Dp), dt) in tiled:
                k6 = k6_bf16_entry(f"{path} chunk", Jt, Kt, D, timed=last)
                if last:
                    results.append(label(k6, "bf16"))
            del Jt, Kt
        # K6 in f32 is held to float64, the costly check: once a shape
        key = ("gram_pair_tiled", rows, D)
        timed = last and ((rows, Dp), torch.float32) in tiled
        if key not in done or timed:
            done.add(key)
            k6 = k6_f32_entry(device, f"{path} chunk", rows, D, timed=timed)
            if timed:
                results.append(label(k6, "f32"))
    for i, (_, (rows, D4), dtype, _) in enumerate(flat):
        key = ("gram_pair", rows, D4, dtype)
        timed = i == len(flat) - 1
        if key in done and not timed:
            continue
        done.add(key)
        k10 = k10_entry(device, f"{path}", rows, D4, kinds[dtype], timed=timed)
        if timed:
            results.append(label(k10, kinds[dtype]))
    log(f"[path] {path}: every kernel held to its plain version at the path's shapes")
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

    gen = torch.Generator(device=device).manual_seed(2)
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
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def h_of(rows):
        return torch.rand(rows, generator=gen, device=device) * 1.5 + 0.5

    def within(name, A, A_p, rows):
        err = float((A - A_p).abs().max())
        tol = gram_tol(rows) * float(A_p.abs().max())
        if not err <= tol:
            raise AssertionError(f"{name}: max|dA| {err} > {tol}")
        return err, tol

    results = []
    # K8: bit-equal in both dtypes, with and without the fused Kt
    h2 = h_of(rows2)
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
            h = h_of(rows2)
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
            times = (ms, plain_time_ms(lambda: kg.weighted_gram_tiled_plain(Xt, h, acc), ms),
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
    h3 = h_of(rows3)
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
    plain_b = plain_time_ms(lambda: kg.weighted_gram_plain(Xb, h3), ms_b)
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
        ms=(ms3 := time_ms(lambda: kg.weighted_gram(X3, h3))),
        plain_ms=plain_time_ms(lambda: kg.weighted_gram_plain(X3, h3), ms3),
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
        plain = plain_time_ms(lambda: kg.own_out_gram_plain(Jt, H, C_, DJ), ms)
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


# the Gram tier of each flagship swipe and what it sets: TNF_GRAM_DTYPE with
# the aux contractions in f32, or `bench.py`'s tier, PRECISION=fastest (int8
# Gram operands and the bf16 aux tier, TNF_AUX_PRECISION=default)
SLICE_TIERS = {"int8": dict(TNF_GRAM_DTYPE="int8", TNF_AUX_PRECISION="highest"),
               "f32": dict(TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION="highest"),
               "bf16": dict(TNF_GRAM_DTYPE="bf16", TNF_AUX_PRECISION="highest"),
               "fastest": dict(TNF_GRAM_DTYPE="int8", TNF_AUX_PRECISION="default")}
# |loss(fastest) - loss(int8)| / loss(int8) after the flagship swipe: the
# bf16 aux tier moved it by 5.4e-6..1.97e-4 over weights and data of seeds
# 0-3 on an H100 (experiments/probes/aux_tier_probe.py, PERF.md section 5);
# held to about twice the largest
AUX_LOSS_RTOL = 4e-4


def flagship_layer(device, seed: int):
    """The flagship conv-TT layer with random weights from `seed`."""
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    c = FLAGSHIP
    layer = TensorConvolutionTrainLayer(
        num_carriages=c["N"], bond_dim=c["r"], num_patches=c["P"],
        patch_pixels=c["pp"], output_shape=(c["C"],),
        convolution_bond=c["CB"], seed=seed, device=device)
    if not layer.network.use_kernels:
        raise AssertionError("the network on CUDA must use the kernels")
    return layer


# the flagship's sweep: one swipe over 2,048-sample chunks, eps 5.0 x 0.25
SLICE_CONFIG = dict(num_swipes=1, batch_size=BATCH, method="ridge_cholesky",
                    eps=5.0, eps_decay=0.25)


def run_slice(device, tier, seed: int = 0):
    """Phase 4: one flagship swipe through Sweeper.run in `tier`
    (SLICE_TIERS), weights and data from `seed`. Returns the launches, the
    wall time and the losses before and after."""
    import torch
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    X, y = flagship_data(SLICE_SAMPLES, seed, device)
    loss_fn = XEBregman(w=1.0)

    def mean_loss(layer):
        pred = layer.forward_batch(X, BATCH)
        return float(loss_fn(pred, y, only_loss=True).mean())

    layer = flagship_layer(device, seed)
    loss0 = mean_loss(layer)
    sweeper = Sweeper(layer.network, loss_fn, SweepConfig(**SLICE_CONFIG))
    with env(**SLICE_TIERS[tier]):
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
    loss1 = mean_loss(layer)
    log(f"[slice] {tier} swipe (seed {seed}) wall {wall:.3f} s over {SLICE_SAMPLES} "
        f"samples (batch {BATCH}), ok={ok}, loss {loss0:.6f} -> {loss1:.6f}, "
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
    return dict(launches=launches, wall=wall, loss0=loss0, loss1=loss1,
                params={k: v.cpu().numpy() for k, v in params.items()})


def run_regression(device):
    """Phase 5: the tabular TT regression through `TensorTrainRegressor` on
    the card — a two-swipe fit in the f32 tier, then one swipe with the
    opt-in own-out kernel against one through the default route, then one
    swipe in the int8 tier. Returns the launch counts of each run and the
    estimator (phase 11 exports it)."""
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
    return launches, own, q, est


@contextlib.contextmanager
def recorded_aux_products():
    """Records each product the engine makes at the aux tier's precision
    ("default"): its operands as given and its result. Yields the list of
    (a, b, out)."""
    from tensornetworksfork_tpu_torch.core import contract as cmod, engine
    plain, records = cmod.matmul, []

    def recording(a, b, precision="highest"):
        out = plain(a, b, precision)
        if precision == "default" and not (a.is_complex() or b.is_complex()):
            records.append((a, b, out))
        return out

    cmod.matmul = engine.matmul = recording
    try:
        yield records
    finally:
        cmod.matmul = engine.matmul = plain


# an aux product's largest error over its entry's natural size sum_k |a||b|,
# in units of sqrt(K) 2^-24: f32 sums of the exact products of bf16
# operands, in any order (the card's products read 0.05-1.2 at phase 6's
# shapes and 0.12 at the flagship's packed prediction,
# experiments/probes/aux_reference_probe.py and aux_probe.py)
AUX_PRODUCT_BOUND = 4.0


def check_aux_products(what, records) -> None:
    """Each recorded aux product against the float64 product of its
    operands rounded to bf16, held to AUX_PRODUCT_BOUND; two controls on the
    same operands must fail it: a bf16-output product (a bf16 torch.mm/bmm
    without out_dtype) and the f32 product of the operands as given (the
    rounding skipped)."""
    import torch
    worst = {"card": 0.0, "bf16-output control": 0.0, "unrounded control": 0.0}
    for a, b, out in records:
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        exact = a16.double() @ b16.double()
        size = (a16.double().abs() @ b16.double().abs()).clamp_min(1e-300)
        unit = a.shape[-1] ** 0.5 * 2.0 ** -24
        fn = torch.bmm if a.ndim == 3 else torch.mm
        for k, v in (("card", out), ("bf16-output control", fn(a16, b16)),
                     ("unrounded control", a.float() @ b.float())):
            worst[k] = max(worst[k], float(((v.double() - exact).abs() / size).max()) / unit)
    log(f"[reference] {what}: {len(records)} aux products against float64 of their "
        f"bf16-rounded operands, largest error over sum|a||b| in sqrt(K) 2^-24 (bound "
        f"{AUX_PRODUCT_BOUND}; the controls must exceed it): "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    if not records:
        raise AssertionError(f"{what}: the swipe made no aux product")
    if not worst["card"] <= AUX_PRODUCT_BOUND:
        raise AssertionError(f"{what}: an aux product is off by {worst['card']:.3g} "
                             f"sqrt(K) 2^-24 (> {AUX_PRODUCT_BOUND})")
    passed = [k for k, v in worst.items() if k != "card" and v <= AUX_PRODUCT_BOUND]
    if passed:
        raise AssertionError(f"{what}: {passed} pass the aux products' check, so it "
                             "cannot see the aux tier's rounding")


# phase 6's tiers: the Gram operands' type and the aux contractions'
# precision ("default": bf16 operands, f32 sums, the aux tier)
REFERENCE_TIERS = {"f32": dict(TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION="highest"),
                   "bf16": dict(TNF_GRAM_DTYPE="bf16", TNF_AUX_PRECISION="highest"),
                   "int8": dict(TNF_GRAM_DTYPE="int8", TNF_AUX_PRECISION="highest"),
                   "f32, bf16 aux": dict(TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION="default"),
                   "fastest": dict(TNF_GRAM_DTYPE="int8", TNF_AUX_PRECISION="default")}


def check_reference(device):
    """Phase 6: a tiny conv-TT swipe (f32, int8, f32 with the bf16 aux tier,
    fastest) and a tiny TT-regression swipe (f32, bf16, int8) with the
    kernels and the aux tier's products on the card agree with the plain
    versions on the CPU. Each aux product of the card's swipe in f32 with
    the aux tier is held to float64 of its bf16-rounded operands
    (check_aux_products)."""
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

    # tolerances: f32 — sums in another order, 1e-4 relative; bf16, int8
    # and the aux tier — a bf16 rounding that differs by one ulp (and, in
    # int8, the code it flips) carried through the chained solves, 2e-2 (the
    # aux tier in f32 reads 2e-3: its first 155 of 176 products get the same
    # bf16 operands on the card and the CPU, then 2 of a node's 96 values
    # round the other way, aux_reference_probe.py)
    for model, make, loss, Xn, yn, tiers in (
            ("conv-TT", conv_tt, XEBregman(1.0), X, y,
             (("f32", 1e-4), ("int8", 2e-2), ("f32, bf16 aux", 2e-2), ("fastest", 2e-2))),
            ("TT regression", tt, SquareBregFunction(), Xr, yr,
             (("f32", 1e-4), ("bf16", 2e-2), ("int8", 2e-2)))):
        for tier, rtol in tiers:
            outs = {}
            for dev in ("cpu", device):
                with env(TNF_PACKED_SYRK_MIN_D=1, **REFERENCE_TIERS[tier]), \
                        recorded_aux_products() as records:
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
                if dev != "cpu" and tier == "f32, bf16 aux":
                    check_aux_products(f"{model} {tier} on {device}", records)
                del records
            err = float((outs[device] - outs["cpu"]).abs().max())
            scale = float(outs["cpu"].abs().max())
            log(f"[reference] {model} {tier}: kernels on {device} vs plain on "
                f"cpu, max|d pred| {err:.3g} (max|pred| {scale:.3g}, rtol {rtol})")
            if not err <= rtol * scale:
                raise AssertionError(f"reference check ({model}, {tier}) failed: {err}")


# phase 7: the image trainer. The headline MNIST configuration at full width
# on train_image's synthetic stand-in (8,192 samples: 28x28 -> 50 patches x
# 17 pixels, 10 classes), one swipe in bench.py's tier; then the digits gate,
# 10 seeds in the reference and the fastest tiers, each tier's mean held to
# the test set's noise floor around the TPU's 10-seed mean (RESULTS.md).
# The stand-in is separable: its validation error reaches 0 within the
# first members, after which the headline's patience (10 updates without
# improvement) would end the run a few updates later; a patience beyond the
# swipe's 40 node updates lets the one swipe run through
IMAGE_ENV = dict(NUM_SWIPES=1, SYNTHETIC_SAMPLES=8192, PRECISION="fastest",
                 EARLY_STOPPING=1000, DATA_PATH="build/no_mnist_staged", VERBOSE=0,
                 RESULTS_FILE="build/chip_smoke_image.csv")
IMAGE_KERNELS = ("retile_hmix", "quantize_tiled", "gram_pair_q", "gram_pair")
# K1's launches in the whole swipe: the middle cores with D = 18*49*18 (one
# of member 3, two of member 4), each updated once a pass, two passes, over
# the 4 chunks of the 7,372 training samples (8,192 less the 10 % held out
# to validate) at 2,048 a chunk
IMAGE_K1_SWIPE = 3 * 2 * 4
DIGITS_TARGET = 96.55
DIGITS_KERNELS = {"reference": ("retile_hmix", "gram_pair_tiled", "gram_pair"),
                  "fastest": ("retile_hmix", "quantize_tiled", "gram_pair_q",
                              "gram_pair")}


@contextlib.contextmanager
def built_models(train_image):
    """Records each model train_image builds (to check its parameters)."""
    models, build = [], train_image.build_model

    def recording(*args):
        models.append(build(*args))
        return models[-1]

    train_image.build_model = recording
    try:
        yield models
    finally:
        train_image.build_model = build


def all_finite(model) -> bool:
    import torch
    return all(bool(torch.isfinite(v).all())
               for layer in model.layers for v in layer.params.values())


def run_image_trainer(device):
    """Phase 7a: train_image at the headline MNIST configuration (type-I,
    members of 1-4 carriages, r=18, CB=8, kernel 4/4, batch 2048, eps 5.0 x
    0.25) on the synthetic stand-in, PRECISION=fastest, one whole swipe
    (IMAGE_ENV). Returns its launches, the kernel shapes it recorded, the
    trained model and the run's configuration (phase 11 serves them)."""
    import torch
    from tensornetworksfork_tpu_torch.experiments import reproduce_result, train_image
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    with env(**{**reproduce_result.HEADLINE["mnist"], **IMAGE_ENV,
                "DEVICE": str(device)}), built_models(train_image) as models, \
            recorded_shapes() as seen:
        config = train_image.get_config_from_env()
        torch.cuda.synchronize()
        kg.reset_launches()
        t0 = time.perf_counter()
        res = train_image.train_model(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kg.LAUNCHES)
    used = {k: v for k, v in launches.items() if v}
    log(f"[image] train_image {res['dataset']} N={res['N']} r={res['r']} "
        f"CB={res['CB']} kernel {res['kernel_size']}/{res['kernel_stride']}, "
        f"{config['synthetic_samples']} samples, batch {config['batch_size']}, "
        f"precision {res['precision']}, {res['num_parameters']} params: "
        f"train_seconds {res['train_seconds']}, test accuracy "
        f"{res['test_accuracy']} %, singular={res['singular']}, wall "
        f"{wall:.2f} s (data and model included), launches {used}")
    if res["singular"]:
        raise AssertionError("train_image reported a singular solve")
    if not all_finite(models[0]):
        raise AssertionError("train_image left non-finite parameters")
    if not res["test_accuracy"] > 100.0 / 10:
        raise AssertionError(f"test accuracy {res['test_accuracy']} % is not above chance")
    missing = [k for k in IMAGE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"train_image never launched {missing}")
    if launches["retile_hmix"] != IMAGE_K1_SWIPE:
        raise AssertionError(f"train_image launched K1 {launches['retile_hmix']} times, "
                             f"not the whole swipe's {IMAGE_K1_SWIPE}")
    return launches, seen, models[0], config


def run_digits_gate(device, tier):
    """Phase 7b: reproduce_result digits, seeds 42-51, in `tier`: each seed's
    accuracy and time, the mean +/- std and the noise floor; the mean must
    lie within the floor of DIGITS_TARGET and no seed may end with
    non-finite parameters. Returns its launches and the kernel shapes it
    recorded."""
    import torch
    from tensornetworksfork_tpu_torch.experiments import reproduce_result, train_image
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    with env(PRECISION=tier, DEVICE=str(device)), built_models(train_image) as models, \
            recorded_shapes() as seen:
        torch.cuda.synchronize()
        kg.reset_launches()
        t0 = time.perf_counter()
        results = reproduce_result.main("digits")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kg.LAUNCHES)
    mean, std, floor, line = reproduce_result.summarize("digits", results)
    secs = [r["train_seconds"] for r in results]
    log(f"[digits] {tier}: accuracies {[r['test_accuracy'] for r in results]}, "
        f"train_seconds {secs} (mean {np.mean(secs):.2f}), wall {wall:.1f} s for "
        f"{len(results)} seeds, launches {({k: v for k, v in launches.items() if v})}")
    log(f"[digits] {tier}: {line}; |mean - {DIGITS_TARGET}| = "
        f"{abs(mean - DIGITS_TARGET):.2f}")
    singular = [r["seed"] for r in results if r["singular"]]
    if singular:
        log(f"[digits] {tier}: seeds {singular} reported a singular solve (the node "
            "kept its value)")
    bad = [r["seed"] for r, m in zip(results, models) if not all_finite(m)]
    if bad:
        raise AssertionError(f"digits {tier}: seeds {bad} ended with non-finite parameters")
    if not abs(mean - DIGITS_TARGET) <= floor:
        raise AssertionError(f"digits {tier}: mean {mean:.2f} % is outside the noise "
                             f"floor {floor:.2f} of {DIGITS_TARGET} %")
    missing = [k for k in DIGITS_KERNELS[tier] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"digits {tier} never launched {missing}")
    return launches, seen


# phase 8: the solver tiers (the module note, item 8). The regression's A2
# has D = 8 * 129 * 8 = 8,256
EPS_LADDER = (1e-3, 1e-6, 1e-9, 1e-12)
F64_LADDER_BOUND = 1e-6  # tests/test_eps_ladder.py, the f64 tier at every eps
F64_CORNER_BOUND = 1e-5  # and at its fixed corner
REGRESSION_A2 = REGRESSION["r"] * (REGRESSION["d"] + 1) * REGRESSION["r"]
# the float64 fit's val RMSE against the f32 fit's (relative)
F64_RMSE_RTOL = 1e-2
F64_FIT_KERNELS = ("retile_rows", "weighted_gram_tiled", "weighted_gram",
                   "own_out_gram")
KRYLOV_D = 4096
# each solver's iterations and tolerance, and its bound against the float64
# dense solve: tests/test_matrixfree.py's rtol = atol
KRYLOV = {"cg": dict(maxiter=100, tol=1e-6, bound=1e-3),
          "minres": dict(maxiter=300, tol=1e-6, bound=2e-2),
          "lanczos": dict(maxiter=50, tol=1e-6, bound=1e-2)}
# the card's solution against the same solver on the CPU run for the card's
# k iterations, relative to max|x| (f32 recurrences over products summed in
# another order)
KRYLOV_CPU_RTOL = 1e-4
# phase 8c: params after one swipe, card against CPU, relative to each
# node's max|param|: Krylov recurrences in f32 over contractions summed in
# another order read 5.9e-6..2.2e-5 on an H100 (PERF.md section 6), the
# gradient steps 7.6e-8
ITERATIVE_RTOL = {"cg": 2e-4, "minres": 2e-4, "lanczos": 2e-4, "gradient": 1e-6}
# the headline: the reference's CIFAR_minres.py configuration (RESULTS.md:263,
# N=4, r=100, CB=5) on train_image's 3-channel synthetic stand-in (32x32 ->
# 17 patches x 193 pixels, 10 classes); 54,614 samples leave 49,152 to train
# after the 10 % held out to validate: 12 chunks of 4,096. The stand-in is
# separable, so the patience goes past the swipe's updates, as in phase 7
CIFAR_SAMPLES = 54614
CIFAR_ENV = dict(N=4, R=100, CB=5, NUM_SWIPES=1, SYNTHETIC_SAMPLES=CIFAR_SAMPLES,
                 EARLY_STOPPING=1000, DATA_PATH="build/no_cifar_staged", VERBOSE=0,
                 RESULTS_FILE="build/chip_smoke_cifar.csv")


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def ladder_system(D: int, cond_exp: float, seed: int, bseed: int):
    """tests/test_eps_ladder.py's system: an SPD with eigenvalues
    logspace(0, -cond_exp) and b = -A x, in f32."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    A = (Q * np.logspace(0.0, -cond_exp, D)) @ Q.T
    A = (A + A.T) / 2.0
    b = -(A @ np.random.default_rng(bseed).standard_normal(D))
    return A.astype(np.float32), b.astype(np.float32)


def ladder_oracle(A32, b32, eps):
    """numpy float64 of solve_block's semantics on the f32 system."""
    A = np.asarray(A32, np.float64)
    b = np.asarray(b32, np.float64)
    s = np.abs(np.diag(A)).mean()
    return np.linalg.solve(A / s + 2.0 * eps * np.eye(A.shape[0]), -b / s)


def check_f64_ladder(device):
    """Phase 8a: the eps ladder through solve_block on the card, f32 and
    float64 tiers against the oracle; the float64 tier must meet it at every
    eps, and at the fixed corner the f32 tier must fail where the float64
    tier solves."""
    import torch
    from tensornetworksfork_tpu_torch.core.solve import solve_block

    def solve(A, b, eps, dtype):
        At, bt = torch.tensor(A, device=device), torch.tensor(b, device=device)
        st, ok = solve_block(At, bt, torch.zeros_like(bt), "ridge_cholesky", eps,
                             solve_dtype=dtype)
        xo = ladder_oracle(A, b, eps)
        err = float(np.linalg.norm(st.double().cpu().numpy() - xo) / np.linalg.norm(xo))
        return err, bool(ok)

    A, b = ladder_system(64, 8.0, 0, 100)
    for eps in EPS_LADDER:
        e32, ok32 = solve(A, b, eps, None)
        e64, ok64 = solve(A, b, eps, "float64")
        log(f"[f64] ladder D=64 cond 1e8 eps {eps:g}: f32 err {e32:.3g} ok={ok32}; "
            f"float64 err {e64:.3g} ok={ok64} (bound {F64_LADDER_BOUND})")
        if not (ok64 and e64 < F64_LADDER_BOUND):
            raise AssertionError(f"float64 tier misses the oracle at eps {eps}: {e64}")
    A, b = ladder_system(96, 9.0, 2, 3)
    e32, ok32 = solve(A, b, 1e-12, None)
    e64, ok64 = solve(A, b, 1e-12, "float64")
    log(f"[f64] corner D=96 cond 1e9 eps 1e-12: f32 ok={ok32}; float64 err "
        f"{e64:.3g} ok={ok64} (bound {F64_CORNER_BOUND})")
    if ok32:
        raise AssertionError("control: the f32 tier solved the corner it cannot")
    if not (ok64 and e64 < F64_CORNER_BOUND):
        raise AssertionError(f"float64 tier fails the corner: ok={ok64}, err {e64}")


def f64_solve_times(device, card: str, D: int = REGRESSION_A2):
    """Phase 8a: solve_block's device time at the regression's A2 size in the
    f32 and float64 tiers (ridge_cholesky, an SPD Gram of random rows;
    CUDA events, time_ms)."""
    import torch
    from tensornetworksfork_tpu_torch.core.solve import solve_block
    gen = torch.Generator(device=device).manual_seed(0)
    X = torch.randn(D + 512, D, device=device, generator=gen)
    A = X.T @ X / X.shape[0]
    b = torch.randn(D, device=device, generator=gen)
    nv = torch.zeros_like(b)
    del X
    out = {}
    for dt in ("float32", "float64"):
        st, ok = solve_block(A, b, nv, "ridge_cholesky", 1e-3, solve_dtype=dt)
        if not bool(ok):
            raise AssertionError(f"the {dt} solve at D={D} failed")
        out[dt] = time_ms(lambda: solve_block(A, b, nv, "ridge_cholesky", 1e-3,
                                              solve_dtype=dt))
    log(f"[f64] {card}: solve_block ridge_cholesky at D={D}: f32 "
        f"{out['float32']:.3f} ms, float64 {out['float64']:.3f} ms (CUDA events, "
        "median of 5)")
    return out


def run_regression_f64(device, card: str):
    """Phase 8a: phase 5's two-swipe fit (same data and configuration) in
    the f32 tier and in solve_dtype="float64", each from the estimator's
    own seeded init, with the opt-in own-out kernel so the fit reaches K11
    too. The float64 fit's val RMSE must lie within F64_RMSE_RTOL of the
    f32 fit's, and it must launch K7, K8, K9 and K11. Returns its launches."""
    import torch
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    c = REGRESSION
    X, y = make_regression(S=c["fit"] + c["val"], d=c["d"], degree=3, seed=0)
    Xtr = torch.tensor(X[:c["fit"]], device=device)
    ytr = torch.tensor(y[:c["fit"]], device=device)
    Xva, yva = X[c["fit"]:], y[c["fit"]:]
    res = {}
    for dt in ("float32", "float64"):
        est = TensorTrainRegressor(N=c["N"], r=c["r"], batch_size=c["batch"],
                                   eps_start=5.0, eps_decay=0.25,
                                   method="ridge_cholesky", num_swipes=2,
                                   solve_dtype=dt, device=device)
        with env(TNF_GRAM_DTYPE="f32", TNF_OWNOUT_KERNEL=1):
            sync(device)
            kg.reset_launches()
            t = time.perf_counter()
            est.fit(Xtr, ytr, X_val=Xva, y_val=yva)
            sync(device)
            wall = time.perf_counter() - t
            launches = dict(kg.LAUNCHES)
            pred = est.predict(Xva)
        rmse = float(np.sqrt(np.mean((pred - yva) ** 2)))
        finite = all(bool(torch.isfinite(v).all()) for v in est._model.params.values())
        used = {k: v for k, v in launches.items() if v}
        log(f"[f64] regression fit, 2 swipes, solve_dtype={dt}, TNF_OWNOUT_KERNEL=1: "
            f"wall {wall:.3f} s, ok={est.fit_ok_}, val rmse {rmse:.6f}, launches {used}")
        if not (est.fit_ok_ and finite):
            raise AssertionError(f"the {dt} fit reported a singular solve or left "
                                 "non-finite parameters")
        res[dt] = (wall, rmse, launches)
    rel = abs(res["float64"][1] - res["float32"][1]) / res["float32"][1]
    log(f"[f64] {card}: float64 fit against f32: wall {res['float64'][0]:.3f} / "
        f"{res['float32'][0]:.3f} s, val rmse {res['float64'][1]:.6f} / "
        f"{res['float32'][1]:.6f}, |d rmse| / rmse {rel:.3g} (bound {F64_RMSE_RTOL})")
    if not rel <= F64_RMSE_RTOL:
        raise AssertionError(f"the float64 fit's val rmse moved by {rel:.3g}")
    launches = res["float64"][2]
    missing = [k for k in F64_FIT_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the float64 fit never launched {missing}")
    return launches


def krylov_operator(kind: str, D: int, device):
    """A dense symmetric f32 operator with eigenvalues linspace(1, 4) ("spd")
    or the same with every other one negated ("indefinite"), in a random
    orthogonal basis made on `device` in float64."""
    import torch
    gen = torch.Generator(device=device).manual_seed(7)
    Q, _ = torch.linalg.qr(torch.randn(D, D, dtype=torch.float64, device=device,
                                       generator=gen))
    ev = torch.linspace(1.0, 4.0, D, dtype=torch.float64, device=device)
    if kind == "indefinite":
        ev = ev * torch.where(torch.arange(D, device=device) % 2 == 1, -1.0, 1.0)
    A = (Q * ev) @ Q.T
    return ((A + A.T) / 2).float()


def check_krylov(device, D: int = KRYLOV_D, names=tuple(KRYLOV), card: str = ""):
    """Phase 8b: cg and lanczos_galerkin on an SPD operator, minres on a
    symmetric indefinite one, at D = 4,096 on the card: each held to a
    float64 dense solve at KRYLOV's bound, and to the same solver on the CPU
    run for the card's iteration count."""
    import torch
    from tensornetworksfork_tpu_torch.core import krylov

    gen = torch.Generator(device=device).manual_seed(8)
    b = torch.randn(D, device=device, generator=gen)
    for name in names:
        kind = "indefinite" if name == "minres" else "spd"
        cfg = KRYLOV[name]
        A = krylov_operator(kind, D, device)
        x64 = torch.linalg.solve(A.double(), b.double())
        sync(device)
        t = time.perf_counter()
        if name == "lanczos":
            x = krylov.lanczos_galerkin(lambda v: A @ v, b, torch.zeros_like(b),
                                        maxiter=cfg["maxiter"])
            k = cfg["maxiter"]
        else:
            x, k = krylov.SOLVERS[name](lambda v: A @ v, b, maxiter=cfg["maxiter"],
                                        tol=cfg["tol"])
            k = int(k)
        sync(device)
        wall = time.perf_counter() - t
        dev_err = float(((x.double() - x64).abs() - cfg["bound"] * x64.abs()).max())
        Ac, bc = A.cpu(), b.cpu()
        if name == "lanczos":
            xc = krylov.lanczos_galerkin(lambda v: Ac @ v, bc, torch.zeros_like(bc),
                                         maxiter=k)
        else:
            xc, kc = krylov.SOLVERS[name](lambda v: Ac @ v, bc, maxiter=k, tol=0.0)
            if int(kc) != k:
                raise AssertionError(f"{name} on the CPU ran {int(kc)} iterations, not {k}")
        cpu_err = float((x.cpu() - xc).abs().max() / xc.abs().max())
        log(f"[krylov] {name} D={D} ({kind}, eigenvalues in +-[1, 4]): k {k}, "
            f"{wall * 1e3:.1f} ms ({card}); max(|x - x64| - {cfg['bound']}|x64|) {dev_err:.3g} "
            f"(must be <= {cfg['bound']}); card vs CPU at k: {cpu_err:.3g} of max|x| "
            f"(bound {KRYLOV_CPU_RTOL})")
        if not dev_err <= cfg["bound"]:
            raise AssertionError(f"{name} misses the float64 solve")
        if not cpu_err <= KRYLOV_CPU_RTOL:
            raise AssertionError(f"{name} on the card disagrees with the CPU: {cpu_err}")


def check_iterative_sweeps(device):
    """Phase 8c: one swipe of a small conv-TT (XEBregman, full H) and of a
    small TT (SquareBreg, diagonal H) in cg, minres, lanczos and gradient,
    from the same weights on the card and on the CPU; the card's params held
    to the CPU's (ITERATIVE_RTOL) and no Gram kernel launched."""
    import torch
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.layers import (
        TensorConvolutionTrainLayer, TensorTrainLayer)
    from tensornetworksfork_tpu_torch.ops.bregman import SquareBregFunction, XEBregman
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy, params_to_numpy

    rng = np.random.default_rng(3)
    S, P, pp, C, F = 96, 6, 5, 3, 9
    X = rng.standard_normal((S, P, pp)).astype(np.float32)
    y = np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]
    Xr = rng.uniform(-1, 1, (S, F)).astype(np.float32)
    Xr[:, -1] = 1.0
    yr = rng.standard_normal((S, 1)).astype(np.float32)
    models = (("conv-TT", lambda dev: TensorConvolutionTrainLayer(
                  4, 4, P, pp, output_shape=(C,), convolution_bond=2, seed=0,
                  device=dev), XEBregman(1.0), X, y),
              ("TT regression", lambda dev: TensorTrainLayer(
                  3, 4, F, output_shape=(1,), seed=0, device=dev),
               SquareBregFunction(), Xr, yr))
    for model, make, loss, Xn, yn in models:
        p0 = params_to_numpy(make("cpu").params)
        for method, rtol in ITERATIVE_RTOL.items():
            grad = method == "gradient"
            cfg = SweepConfig(num_swipes=1, batch_size=48, method=method, eps=1.0,
                              max_iter=60, tol=1e-5, lr=0.05 if grad else 1.0,
                              adaptive_step=grad)
            out, iters = {}, {}
            for dev in ("cpu", device):
                layer = make(dev)
                sweeper = Sweeper(layer.network, loss, cfg)
                with env(TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION="highest"):
                    kg.reset_launches()
                    params, ok = sweeper.run([params_from_numpy(p0, device=dev)],
                                             torch.tensor(Xn, device=dev),
                                             torch.tensor(yn, device=dev))
                if not ok:
                    raise AssertionError(f"{model} {method} swipe on {dev} failed")
                out[dev] = params_to_numpy(params[0])
                iters[dev] = [int(k) for _, _, k in sweeper.krylov_iters]
            if any(kg.LAUNCHES.values()):
                raise AssertionError(f"{model} {method} launched a Gram kernel")
            err = max(float(np.abs(out[device][k] - out["cpu"][k]).max()
                            / np.abs(out["cpu"][k]).max()) for k in out["cpu"])
            log(f"[iterative] {model} {method}: card vs CPU max|d param| / max|param| "
                f"{err:.3g} (bound {rtol}); iterations card {iters[device]}, "
                f"cpu {iters['cpu']}")
            if not err <= rtol:
                raise AssertionError(f"{model} {method}: card disagrees with the CPU")


@contextlib.contextmanager
def built_sweepers(train_image):
    """Records each Sweeper train_image builds (to read its Krylov counts)."""
    sweepers, make = [], train_image.Sweeper

    def recording(*args, **kw):
        sweepers.append(make(*args, **kw))
        return sweepers[-1]

    train_image.Sweeper = recording
    try:
        yield sweepers
    finally:
        train_image.Sweeper = make


def run_cifar_minres(device, card: str):
    """Phase 8d: train_image with PRESET=cifar_minres at the reference's
    width (type-I sum of conv-TTs of 1-4 carriages, r=100, CB=5, kernel 8/8,
    batch 4096, MINRES with max_iter 50, bf16 Gram and aux tiers) on the
    3-channel synthetic stand-in, one whole swipe (CIFAR_ENV). Members 3-4's
    middle cores have D = 100 * 16 * 100 = 160,000: a dense A would be a
    102 GB f32 matrix, so the path must launch no Gram kernel. Prints
    train_seconds, each node's Krylov iterations, the peak memory and the
    test accuracy. Returns its launches and train_seconds."""
    import torch
    from tensornetworksfork_tpu_torch.experiments import train_image
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    preset = train_image.PRESETS["cifar_minres"]
    with env(PRESET="cifar_minres", **preset, **CIFAR_ENV, DEVICE=str(device)), \
            built_models(train_image) as models, built_sweepers(train_image) as sweepers:
        config = train_image.get_config_from_env()
        torch.cuda.empty_cache()
        sync(device)
        torch.cuda.reset_peak_memory_stats()
        kg.reset_launches()
        t0 = time.perf_counter()
        res = train_image.train_model(config)
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(kg.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    model = models[0]
    D = max(v.numel() for layer in model.layers for v in layer.params.values())
    dense_a = 4.0 * D * D
    per_member = {}
    for mi, name, k in sweepers[0].krylov_iters:
        per_member.setdefault(mi + 1, []).append(f"{name} {int(k)}")
    log(f"[cifar] {card}: train_image PRESET=cifar_minres {res['dataset']} N={res['N']} "
        f"r={res['r']} CB={res['CB']} kernel {res['kernel_size']}/{res['kernel_stride']}, "
        f"{config['synthetic_samples']} samples ({int(config['synthetic_samples'] * 0.9)} "
        f"to train), batch {config['batch_size']}, method {res['method']}, max_iter "
        f"{config['max_iter']}, {res['num_parameters']} params: train_seconds "
        f"{res['train_seconds']}, test accuracy {res['test_accuracy']} %, "
        f"singular={res['singular']}, wall {wall:.2f} s (data and model included)")
    for m, its in per_member.items():
        log(f"[cifar] member {m} ({m} carriages), MINRES iterations in order of "
            f"update: {', '.join(its)}")
    log(f"[cifar] {card}: largest node D={D}: a dense f32 A would take {dense_a / 1e9:.1f} GB; "
        f"peak memory allocated {peak / 1e9:.2f} GB; Gram kernel launches "
        f"{sum(launches.values())} ({launches})")
    if res["singular"]:
        raise AssertionError("the CIFAR_minres swipe reported a singular solve")
    if not all_finite(model):
        raise AssertionError("the CIFAR_minres swipe left non-finite parameters")
    if not res["test_accuracy"] > 100.0 / 10:
        raise AssertionError(f"test accuracy {res['test_accuracy']} % is not above chance")
    if any(launches.values()):
        raise AssertionError(f"the matrix-free path launched Gram kernels: {launches}")
    if not peak < dense_a / 4:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB is not far below the "
                             f"dense A's {dense_a / 1e9:.1f} GB")
    return launches, res["train_seconds"]


# phase 9: the zoo. (ii) the width path runs phase 5's regression config
# (N=3, r=8, 65,536 rows to fit and 16,384 to validate, 512-row chunks, eps
# 5.0 x 0.25, f32) for two swipes in each family through TensorTrainRegressor:
# cpd, cpd_type1, tt with linear_dim=4, and cum_sum at d = 64 (its middle
# cores' (f, f, f, f) CONST operators are 65^4 x 4 B = 71 MB each; at d = 128
# one would be 1.1 GB, past the JAX package's 1 GB cap for that constant);
# then tnml on breast_cancer, 30 carriages. Each must launch one of K7-K11.
ZOO_WIDTH = {"cpd": (dict(model_type="cpd"), 128),
             "cpd_type1": (dict(model_type="cpd_type1"), 128),
             "tt linear_dim=4": (dict(linear_dim=4), 128),
             "tt cum_sum d=64": (dict(cum_sum=True), 64)}
ZOO_KERNELS = ("weighted_gram_tiled", "retile_rows", "weighted_gram", "gram_pair",
               "own_out_gram")  # K7, K8, K9, K10, K11
# (iii) the zoo table (experiments/zoo_eval.py: 5 datasets x 8 families x
# seeds 42-44) against the JAX package's committed table
ZOO_TABLE = "results/zoo_eval.csv"
ZOO_CELL_PP = 2.0  # compare_tables' cell tolerance, for polynomial's cells


def _zoo_layers():
    """(name, make(device) -> layer, loss, inputs, target) of phase 9's
    card-against-CPU swipes: every layer builder and loss the zoo added."""
    import torch
    from tensornetworksfork_tpu_torch.models import layers as L
    from tensornetworksfork_tpu_torch.ops import bregman as B

    rng = np.random.default_rng(9)
    S, F, P, pp = 96, 9, 6, 5
    X = rng.uniform(-1, 1, (S, F)).astype(np.float32)
    X[:, -1] = 1.0
    Xo = rng.uniform(-1, 1, (S, 5)).astype(np.float32)
    Xp = rng.standard_normal((S, P, pp)).astype(np.float32)
    Xs = [rng.standard_normal((S, 2, 3)).astype(np.float32) for _ in range(2)]
    Xc = (rng.standard_normal((S, 4)) + 1j * rng.standard_normal((S, 4)))
    y1 = rng.standard_normal((S, 1)).astype(np.float32)
    y2 = rng.standard_normal((S, 2)).astype(np.float32)
    y31 = rng.standard_normal((S, 3, 1)).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, S)]
    yc = (rng.standard_normal((S, 1)) + 1j * rng.standard_normal((S, 1)))
    op = L.cum_sum_operator(1, 4, 5)
    conv_op = rng.standard_normal((pp, 3))

    def k(cls, *a, **kw):
        return lambda dev: getattr(L, cls)(*a, **kw, seed=0, device=dev,
                                           use_kernels=True)

    def phi(x):
        return torch.sum(x ** 2) + torch.sum(torch.exp(0.3 * x))

    sq, xe = B.SquareBregFunction(), B.XEBregman(1.0)
    return [
        ("TensorTrainLinearLayer", k("TensorTrainLinearLayer", 3, 4, F, 3,
                                     output_shape=(1,)), sq, X, y1),
        ("CumSumLayer", k("CumSumLayer", 3, 4, F, output_shape=(1,)), sq, X, y1),
        ("CPDLayer (XE)", k("CPDLayer", 3, 4, F, output_shape=(3,)), xe, X, onehot),
        ("CPDTrainLayer", k("CPDTrainLayer", 3, 4, F, output_shape=(1,)), sq, X, y1),
        ("OperatorTTLayer", k("OperatorTTLayer", op, 5, 3, 3, output_shape=(1,)),
         sq, Xo, y1),
        ("OperatorTTLayer ring", k("OperatorTTLayer", op, 5, 2, 3, output_shape=(1,),
                                   ring=True), sq, Xo, y1),
        ("TensorTrainSplitInputLayer", k("TensorTrainSplitInputLayer", 2, 3,
                                         input_shape=(2, 3), output_shape=(1,),
                                         axle_bond=2), sq, Xs, y1),
        ("TensorConvolutionGridTrainLayer (XE)", k(
            "TensorConvolutionGridTrainLayer", 2, 2, 3, 2, 2, P, pp,
            output_shape=(3,), convolution_bond=2), xe, Xp, onehot),
        ("TensorConvOperatorLayer", k("TensorConvOperatorLayer", conv_op, 3, 3, 2,
                                      P, pp, output_shape=(3,), convolution_bond=2),
         sq, Xp, y31),
        ("ComplexTensorTrainLayer complex64", k(
            "ComplexTensorTrainLayer", 3, 3, 4, output_shape=(1,)),
         B.SquareComplexBregFunction(), Xc.astype(np.complex64), yc.astype(np.complex64)),
        ("ComplexTensorTrainLayer complex128", k(
            "ComplexTensorTrainLayer", 3, 3, 4, output_shape=(1,), dtype=torch.complex128),
         B.SquareComplexBregFunction(), Xc, yc),
        ("TT SoftmaxSquaredLoss", k("TensorTrainLayer", 3, 4, F, output_shape=(4,)),
         B.SoftmaxSquaredLoss(1.0), X, onehot),
        ("TT BinaryKLDivBregman", k("TensorTrainLayer", 3, 4, F, output_shape=(1,)),
         B.BinaryKLDivBregman(1.0), X, rng.uniform(0.05, 0.95, (S, 1)).astype(np.float32)),
        ("TT AutogradLoss", k("TensorTrainLayer", 3, 4, F, output_shape=(2,)),
         B.AutogradLoss(), X, y2),
        ("TT AutogradBregman", k("TensorTrainLayer", 3, 4, F, output_shape=(2,)),
         B.AutogradBregman(phi), X, y2),
        ("TT UncertaintyAutogradLoss", k("TensorTrainLayer", 3, 4, F, output_shape=(2,)),
         B.UncertaintyAutogradLoss(), X, y1[:, 0]),
    ]


# card against CPU after one swipe, relative to max|pred|: f32 and complex64
# sum in another order (phase 6's f32 bound); complex128 to 1e-9
ZOO_REFERENCE_RTOL = {"float32": 1e-4, "complex64": 1e-4, "complex128": 1e-9}
# the split-input layer's second column holds no input node, so its
# environments carry no sample axis and the sweep's full-batch merge of
# several chunks cannot place one (in both packages): it sweeps one chunk
ZOO_ONE_CHUNK = ("TensorTrainSplitInputLayer",)


def check_zoo_reference(device):
    """Phase 9 (i): one swipe of a small network of every new layer builder
    and loss (and one with orthonormalize=True), with the kernels on the
    card and their plain versions on the CPU, from the same weights
    (TNF_PACKED_SYRK_MIN_D=1, so the packed routes take the kernels even at
    these sizes); the predictions after it agree within
    ZOO_REFERENCE_RTOL. Returns the launches of the card's swipes."""
    import torch
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.layers import TensorTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import SquareBregFunction
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    cases = _zoo_layers()
    rng = np.random.default_rng(10)
    Xg = rng.uniform(-1, 1, (96, 9)).astype(np.float32)
    cases.append(("TT orthonormalize=True", lambda dev: TensorTrainLayer(
        4, 4, 9, output_shape=(1,), seed=0, device=dev, use_kernels=True),
        SquareBregFunction(), Xg, rng.standard_normal((96, 1)).astype(np.float32)))
    total = {k: 0 for k in kg.LAUNCHES}
    for name, make, loss, Xn, yn in cases:
        cfg = SweepConfig(num_swipes=1, batch_size=-1 if name in ZOO_ONE_CHUNK else 48,
                          method="ridge_cholesky",
                          eps=5.0, eps_decay=0.25,
                          orthonormalize=name.endswith("orthonormalize=True"))
        outs = {}
        for dev in ("cpu", device):
            def put(a):
                return ([torch.tensor(x, device=dev) for x in a] if isinstance(a, list)
                        else torch.tensor(a, device=dev))
            with env(TNF_PACKED_SYRK_MIN_D=1, TNF_GRAM_DTYPE="f32",
                     TNF_AUX_PRECISION="highest"):
                layer = make(dev)
                kg.reset_launches()
                params, ok = Sweeper(layer.network, loss, cfg).run(
                    [layer.params], put(Xn), put(yn))
                if dev != "cpu":
                    for kname, v in kg.LAUNCHES.items():
                        total[kname] += v
            if not ok:
                raise AssertionError(f"zoo reference swipe ({name}, {dev}) failed")
            outs[dev] = layer(put(Xn), params=params[0]).cpu()
        dtype = str(outs["cpu"].dtype).split(".")[-1]
        rtol = ZOO_REFERENCE_RTOL[dtype]
        err = float((outs[device] - outs["cpu"]).abs().max())
        scale = float(outs["cpu"].abs().max())
        log(f"[zoo] reference {name} ({dtype}): kernels on {device} vs plain on cpu, "
            f"max|d pred| {err:.3g} (max|pred| {scale:.3g}, rtol {rtol})")
        if not err <= rtol * scale:
            raise AssertionError(f"zoo reference check ({name}) failed: {err}")
    log(f"[zoo] reference swipes' launches on {device}: "
        f"{({k: v for k, v in total.items() if v})}")
    return total


def run_zoo_width(device, card: str):
    """Phase 9 (ii): the width path (ZOO_WIDTH), each family a two-swipe fit
    with the launch counters reset just before it and read just after, and
    the shapes it gives the kernels recorded; then tnml on breast_cancer
    (30 carriages, seed 42's split, r=8, the same eps and chunks). Each fit
    must report no singular solve, keep its parameters finite, beat the
    mean (regression: val RMSE below 1.0 on the standardized target) or
    the majority class (tnml), and launch one of K7-K11. Returns
    {path: (launches, shapes seen)}."""
    import torch
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.data.tabular import load_sklearn_dataset
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    from tensornetworksfork_tpu_torch.models.tnml import TNMLRegressor
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    c = REGRESSION
    runs, data = {}, {}

    def fit_once(path, est, args, score, what):
        with env(TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION="highest"), \
                recorded_shapes() as seen:
            torch.cuda.synchronize()
            kg.reset_launches()
            t = time.perf_counter()
            est.fit(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = dict(kg.LAUNCHES)
        value, bar = score()
        model = est._model
        finite = all(bool(torch.isfinite(v).all())
                     for p in getattr(model, "params_list", None) or [model.params]
                     for v in p.values())
        used = {k: v for k, v in launches.items() if v}
        log(f"[zoo] width {path} ({card}): fit {wall:.3f} s, ok={est.fit_ok_}, "
            f"{what} {value:.6f} (bar {bar}), launches {used}")
        if not est.fit_ok_:
            raise AssertionError(f"zoo width {path}: the sweep reported a singular solve")
        if not finite:
            raise AssertionError(f"zoo width {path}: non-finite parameters")
        if not (value < bar if what == "val rmse" else value > bar):
            raise AssertionError(f"zoo width {path}: {what} {value} misses {bar}")
        if not any(launches[k] for k in ZOO_KERNELS):
            raise AssertionError(f"zoo width {path} launched none of K7-K11")
        runs[path] = (launches, seen)

    for fam, (kw, d) in ZOO_WIDTH.items():
        if d not in data:
            X, y = make_regression(S=c["fit"] + c["val"], d=d, degree=3, seed=0)
            data[d] = (torch.tensor(X[:c["fit"]], device=device),
                       torch.tensor(y[:c["fit"]], device=device),
                       X[c["fit"]:], y[c["fit"]:])
        Xtr, ytr, Xva, yva = data[d]
        est = TensorTrainRegressor(N=c["N"], r=c["r"], batch_size=c["batch"],
                                   eps_start=5.0, eps_decay=0.25, num_swipes=2,
                                   device=device, **kw)

        def rmse(est=est, Xva=Xva, yva=yva):
            pred = est.predict(Xva)
            return float(np.sqrt(np.mean((pred - yva) ** 2))), 1.0
        fit_once(f"{fam} (d={d})", est, (Xtr, ytr, Xva, yva), rmse, "val rmse")

    bc = load_sklearn_dataset("breast_cancer", seed=42)
    bc.pop("task")
    est = TNMLRegressor(r=c["r"], num_swipes=2, eps_start=5.0, eps_decay=0.25,
                        batch_size=c["batch"], task="classification",
                        input_scale="minmax", device=device)
    yv = bc["y_val"].reshape(-1).astype(int)

    def accuracy():
        pred = est.predict(bc["X_val"]).argmax(axis=1)
        return float(np.mean(pred == yv)), float(max(np.mean(yv), 1 - np.mean(yv)))
    fit_once("tnml breast_cancer (30 carriages)", est,
             (bc["X_train"], bc["y_train"], bc["X_val"], bc["y_val"]), accuracy,
             "val accuracy")
    return runs


def check_zoo_shapes(device, path, seen, done):
    """Phase 9's kernels against their plain versions at every shape its
    width path gave them: K8 bit for bit (with and without Kt), K7 as one
    chunk's carry and K9 within gram_tol of the plain version and against
    float64 with bf16- and TF32-rounded controls (weighted_to_float64), K10
    through k10_entry (float64 too). Shapes in `done` were checked for an earlier
    path (updated). The largest shape of each kernel the path launched is
    timed: returns those kernels entries, their dtype naming the path."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    log(f"[zoo] {path}: shapes {sorted(str(s) for s in seen)}")
    gen = torch.Generator(device=device).manual_seed(11)
    results = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def h_of(rows):
        return torch.rand(rows, generator=gen, device=device) * 1.5 + 0.5

    def label(entry):
        return dict(entry, dtype=f"f32, {path}")

    def by_size(name):
        return sorted((s for s in seen if s[0] == name),
                      key=lambda s: (s[1][0] * s[1][1], str(s[2])))

    for i, (_, (rows, D), dt, Dp) in enumerate(by_size("retile_rows")):
        last = i == len(by_size("retile_rows")) - 1
        if ("retile_rows", rows, D, dt) not in done or last:
            done.add(("retile_rows", rows, D, dt))
            X, h = randn(rows, D, dtype=dt), h_of(rows)
            for hh in (None, h):
                Jt, Kt = kg.retile_rows(X, Dp, hh)
                Jp, Kp = kg.retile_rows_plain(X, Dp, hh)
                if not torch.equal(Jt, Jp) or (hh is not None and not torch.equal(Kt, Kp)):
                    raise AssertionError(f"retile_rows at {rows}x{D} differs from plain")
            if last:
                k8 = lambda: kg.retile_rows(X, Dp)  # noqa: E731
                results.append(label(dict(
                    name="retile_rows", err=0.0, ms=graph_ms(k8),
                    plain_ms=graph_ms(lambda: kg.retile_rows_plain(X, Dp)),
                    library_ms=graph_ms(lambda: torch.nn.functional.pad(X, (0, Dp - D))),
                    bound=bound(0.0, nbytes(X) + rows * Dp * X.element_size(), "f32"),
                    note=f"{path}: ({rows}x{D} -> {Dp}) bit-equal with and without Kt; "
                         "library: the pad; CUDA graphs of 20 calls")))
    for i, (_, (rows, Dp), dt, D) in enumerate(by_size("weighted_gram_tiled")):
        last = i == len(by_size("weighted_gram_tiled")) - 1
        if ("weighted_gram_tiled", rows, D, dt) not in done or last:
            done.add(("weighted_gram_tiled", rows, D, dt))
            Xt, _ = kg.retile_rows(randn(rows, D, dtype=dt), Dp)
            h = h_of(rows)
            acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=device)
            acc_p = torch.zeros_like(acc)
            kg.weighted_gram_tiled(Xt, h, acc, D)
            kg.weighted_gram_tiled_plain(Xt, h, acc_p)
            A, A_p = kg.mirror_gram(acc[:D, :D]), kg.mirror_gram(acc_p[:D, :D])
            err, tol = float((A - A_p).abs().max()), gram_tol(rows) * float(A_p.abs().max())
            if not err <= tol or acc[D:].any() or acc[:, D:].any():
                raise AssertionError(f"weighted_gram_tiled at {rows}x{D}: {err} > {tol}")
            f64 = weighted_to_float64(f"weighted_gram_tiled ({path}, {rows}x{D})", A,
                                      Xt[:, :D], h)
            if last:
                Xw = kg._weighted_operand(Xt, h)
                accD, XwD, XtD = acc[:D, :D], Xw[:, :D], Xt[:, :D]
                results.append(label(dict(
                    name="weighted_gram_tiled", err=err,
                    ms=(ms := time_ms(lambda: kg.weighted_gram_tiled(Xt, h, acc, D))),
                    plain_ms=plain_time_ms(
                        lambda: kg.weighted_gram_tiled_plain(Xt, h, acc), ms),
                    library_ms=time_ms(lambda: accD.addmm_(XwD.T, XtD)),
                    bound=bound(gram_ops(rows, D) + rows * D,
                                rows * D * 4 + nbytes(h) + 2 * 4 * D * D, "f32"),
                    note=f"{path}: one chunk {rows}x{D} (Dp {Dp}) into a carry, tol "
                         f"{gram_tol(rows):.3g}*max|A|; {f64}; library: "
                         "acc[:D, :D].addmm_ on the weighted operand made beforehand")))
                del Xw, accD, XwD, XtD
            del Xt, acc, acc_p, A, A_p
    for i, (_, (rows, D), dt) in enumerate(by_size("weighted_gram")):
        last = i == len(by_size("weighted_gram")) - 1
        if ("weighted_gram", rows, D, dt) not in done or last:
            done.add(("weighted_gram", rows, D, dt))
            X, h = randn(rows, D, dtype=dt), h_of(rows)
            A = kg.mirror_gram(kg.weighted_gram(X, h))
            A_p = kg.mirror_gram(kg.weighted_gram_plain(X, h))
            err, tol = float((A - A_p).abs().max()), gram_tol(rows) * float(A_p.abs().max())
            if not err <= tol:
                raise AssertionError(f"weighted_gram at {rows}x{D}: {err} > {tol}")
            f64 = weighted_to_float64(f"weighted_gram ({path}, {rows}x{D})", A, X, h)
            if last:
                Xw = kg._weighted_operand(X, h)
                results.append(label(dict(
                    name="weighted_gram", err=err,
                    ms=(ms := time_ms(lambda: kg.weighted_gram(X, h))),
                    plain_ms=plain_time_ms(lambda: kg.weighted_gram_plain(X, h), ms),
                    library_ms=time_ms(lambda: torch.mm(Xw.T, X)),
                    bound=bound(gram_ops(rows, D) + rows * D, nbytes(X, h) + 4 * D * D,
                                "f32"),
                    note=f"{path}: {rows}x{D} f32, tol {gram_tol(rows):.3g}*max|A|; "
                         f"{f64}; library: torch.mm on the weighted operand made "
                         "beforehand")))
                del Xw
            del X, A, A_p
    flat = by_size("gram_pair")
    for i, (_, (rows, D4), dt, _) in enumerate(flat):
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        timed = i == len(flat) - 1
        key = ("gram_pair", rows, D4, dt)
        if key in done and not timed:
            continue
        done.add(key)
        entry = k10_entry(device, path, rows, D4, kind, timed=timed, seed=12)
        if timed:
            results.append(dict(entry, dtype=f"{kind}, {path}"))
    log(f"[zoo] {path}: every kernel held to its plain version at the path's shapes")
    log_kernels(results)
    return results


# The family gate: each family's mean within ZOO_FLOOR_Z x s x
# sqrt(1/n_base + 1/n_port) of the committed table's, s the within-cell seed
# sd pooled over the family's cells of the committed table. For the family
# of ZOO_SEED_SD, s is pooled instead from that file's per-cell sds: the JAX
# package's fits over 60 seeds (studies/zoo_seed_study.py sd), a noise
# estimate independent of the port and fixed before the port's table runs.
# tt_linear is that family: its committed seeds of diabetes lie close
# together (sd 0.033, against 0.121 over 60 seeds), which leaves the
# committed table's floor for it too narrow for another draw of initial
# params.
ZOO_FLOOR_Z = 2.0
ZOO_SEED_SD = "studies/zoo_seed_sd.json"


def zoo_floors(base_cells, n_port, seed_sd):
    """{family: (floor, the committed table's floor, the floor's rule)} in
    percentage points, for the difference of the two tables' family means,
    the port's table holding n_port rows of each family. `seed_sd` is the
    parsed ZOO_SEED_SD."""
    cells = {}
    for (ds, fam), v in base_cells.items():
        cells.setdefault(fam, {})[ds] = v
    floors = {}
    for fam, per in cells.items():
        n_base = sum(len(v) for v in per.values())
        root = np.sqrt(1.0 / n_base + 1.0 / n_port)
        ss = sum(float(np.sum((np.asarray(v) - np.mean(v)) ** 2)) for v in per.values())
        df = sum(len(v) - 1 for v in per.values())
        first = 100.0 * ZOO_FLOOR_Z * np.sqrt(ss / df) * root
        floors[fam] = (first, first, "the committed table's sd")
        if seed_sd["family"] == fam:
            sd = seed_sd["cells"]
            if sorted(sd) != sorted(per):
                raise ValueError(f"{ZOO_SEED_SD} covers {sorted(sd)}, the table "
                                 f"{sorted(per)}")
            var = np.mean([sd[ds]["sd"] ** 2 for ds in per])
            floors[fam] = (100.0 * ZOO_FLOOR_Z * np.sqrt(var) * root, first,
                           f"the JAX package's sd over seeds {seed_sd['seeds'][0]}-"
                           f"{seed_sd['seeds'][1]}")
    return floors


def run_zoo_table(device, card: str):
    """Phase 9 (iii): experiments/zoo_eval.py's table (every family on every
    dataset, seeds 42-44, the JAX package's config) on the card, with 0
    failed fits; polynomial (no random init, the same splits) must hold
    each of its cells within compare_tables' 2-point cell tolerance of
    results/zoo_eval.csv, and each other family its mean within its floor
    (zoo_floors) of the committed table's. The same seed gives both
    tables the same split; the initial params differ (a torch.Generator
    here, JAX's PRNG there). Returns the table's launches and wall time."""
    import torch
    from tensornetworksfork_tpu_torch.experiments import zoo_eval
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg

    out = os.path.join("build", "zoo_eval_chip.csv")
    os.makedirs("build", exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    torch.cuda.synchronize()
    kg.reset_launches()
    t0 = time.perf_counter()
    rows, n_fail = zoo_eval.run_table(zoo_eval.DATASETS, zoo_eval.SEEDS, out,
                                      device=str(device),
                                      log=lambda m: log(f"[zoo] {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kg.LAUNCHES)
    n_stop = sum(bool(r["singular"]) for r in rows)
    log(f"[zoo] table ({card}): {len(rows)} fits in {wall:.1f} s, {n_fail} failed, "
        f"{n_stop} sweeps stopped at a singular solve (scored, as the JAX package "
        f"scores them), launches {({k: v for k, v in launches.items() if v})}")
    if n_fail:
        raise AssertionError(f"zoo table: {n_fail} failed fits")
    base, port = zoo_eval._load_metrics(ZOO_TABLE), zoo_eval._load_metrics(out)
    with open(ZOO_SEED_SD) as f:
        seed_sd = json.load(f)
    bad = []
    floors = zoo_floors(base, len(zoo_eval.DATASETS) * len(zoo_eval.SEEDS), seed_sd)
    for fam in sorted(floors):
        a = [x for (_, g), v in base.items() if g == fam for x in v]
        b = [x for (_, g), v in port.items() if g == fam for x in v]
        secs = [r["train_seconds"] for r in rows if r["family"] == fam]
        d = 100.0 * (np.mean(b) - np.mean(a))
        gate, first, rule = floors[fam]
        held = f"floor {gate:.2f} pp, {rule}"
        if gate != first:
            held += (f"; {'within' if abs(d) <= first else 'past'} the committed "
                     f"table's floor {first:.2f}")
        if fam == "polynomial":
            held = "cells within 2 pp"
        log(f"[zoo] family {fam}: mean {100 * np.mean(b):.2f} (committed "
            f"{100 * np.mean(a):.2f}), delta {d:+.2f} pp, {held}; fit mean "
            f"{np.mean(secs):.2f} s, max {np.max(secs):.2f} s")
        if fam != "polynomial" and not abs(d) <= gate:
            bad.append(f"family {fam}: delta {d:+.2f} pp past its floor {gate:.2f}")
    bad += [v for v in zoo_eval.compare_tables(ZOO_TABLE, out, float("inf"), ZOO_CELL_PP)
            if "/polynomial" in v or v.startswith("missing")]
    for key in sorted(base):
        log(f"[zoo] cell {key[0]}/{key[1]}: {100 * np.mean(port[key]):.2f} (committed "
            f"{100 * np.mean(base[key]):.2f})")
    if bad:
        raise AssertionError("zoo table: " + "; ".join(bad))
    return dict(launches=launches, wall=wall)


# phase 10: growth, data compression, feature maps, input-less members and
# the remaining estimators (the module note, item 10). (i) run_grow_cart at
# the MNIST headline's widths (r=18, CB=8, kernel 4/4: 50 patches x 17
# pixels, the bias patch last) on 8,192 samples (phase 7's cut), one-hot 10
# classes, XEBregman on 9 logits, 1 -> 4 carriages (3 growth steps), the
# default 3 swipes a step at eps 1.0 x 0.5 a half-pass, full batch: from 3
# carriages the middle cores have D = 18*50*18 = 16,200 and take the packed
# tiled route (K1 + K2 + K3 in fastest, K1 + K6 in f32), the last core K10.
# The images are train_image's synthetic stand-in's with N(0, GROW_NOISE^2)
# pixel noise added and rescaled to unit variance (grow_stand_in): on the
# stand-in itself the XE fit separates the classes by 2 carriages and the 3-
# and 4-carriage steps flag singular solves and reach NaN, in both packages
# (studies/grow_xe_study.py 1024 18 8 on the CPU) and on the card with the
# kernels, the plain routes or float64 solves alike
# (experiments/probes/grow_probe.py). On the noisy images the 4-carriage
# step still fails as the JAX package's does (ROADMAP queue 3): each growth
# scales the logits by the new conv block's random c (-0.107, 0.405, -0.351
# here), and the last half-pass's update at eps 1/32 overshoots, so f32
# ends below chance with every solve ok and fastest flags a singular solve
# above chance. Gated: every step's parameters finite, every step ok or
# above chance (0.1), the kernels of GROW_KERNELS launched. The reference
# (grow_reference, no launch counted) replays the growth: each step's first
# swipe (eps 1.0, 0.5) from the same params with the kernels and with the
# plain routes on the card within GROW_SWIPE_REL x max|pred| (f32 1e-3:
# 1.8e-7 to 4.1e-6 up to 3 carriages, 1.65e-4 at 4, from the sign-flipped
# fit; fastest 0.1: its kernel route quantises J and K to int8 where the
# plain route does not, 4.1e-6 to 0.036 measured; a wrong tile or sign
# reads O(1)), and each grown forward within GROW_SCALE_RESIDUAL x max of
# c x the last forward (1.1e-6 to 1.3e-5 measured). Whole steps are not
# compared: past the first swipe the growth amplifies rounding to O(1) of
# max|pred| (kernels vs plain routes 0.41 of it after the 2-carriage step,
# float64 solves vs f32 0.72). Every kernel is held to its plain version
# at every shape the growth gave it (check_growth_shapes), the largest timed.
GROW = dict(S=8192, r=18, CB=8, start=1, steps=3, swipes=3, eps=1.0, eps_decay=0.5)
GROW_NOISE = 20.0
GROW_SWIPE_REL = {"f32": 1e-3, "fastest": 0.1}
GROW_SCALE_RESIDUAL = 1e-4
GROW_KERNELS = {"fastest": ("retile_hmix", "quantize_tiled", "gram_pair_q", "gram_pair"),
                "f32": ("retile_hmix", "gram_pair_tiled", "gram_pair")}
# (ii) run_dmrg_growth on make_regression's 16 features plus the bias column
# (f = 17) at both positions, 16,384 rows, bond 8, rank 8, 2 growth steps:
# the grown block has D = 8*17*17*8 = 18,496. eps 0.1 (its CPU test's) for
# run_dmrg_growth's 1e-4: the grown block reads two copies of one column, so its
# Gram is rank-deficient, and at D = 18,496 f32 rounding of the largest
# eigenvalues (up to D x the diagonal mean the solve rescales by) exceeds a
# 2e-4 ridge: the f32 Cholesky fails there (both growth steps flagged on an
# H100). Its predictions are held to the same growth's with the plain routes
# on the card within PHASE10_PRED_REL x max|pred|; the CPU takes minutes for
# the grown block's Gram and Cholesky at this D, so the card is held to the
# CPU at DMRG_CPU (8 features, D = 5,184)
DMRG = dict(S=16384, d=16, bond=8, rank=8, steps=2, eps=0.1)
DMRG_CPU = dict(S=4096, d=8)
# (iii) TensorTrainBatchRegressor at phase 5's data and width (d = 128, N=3,
# r=8; 65,536 rows to fit, 16,384 to validate) over 1,024-row minibatches,
# 2 swipes, eps 5.0 down a geomspace to 5.0 x 0.25^3 (phase 5's decay), its
# validation predictions held to the plain routes' on the card, and at d = 32
# (BATCH_CPU) to the CPU's, within PHASE10_PRED_REL x max|pred|. batch_same
# is held over BATCH_SAME_REF_ROWS rows: it solves every core on each
# minibatch in turn (128 whole sweeps at 65,536 rows, the middle core 8,256
# unknowns against 1,024 rows), and that map amplifies rounding: over 65,536
# rows the kernels and the plain routes part by 3.99 of max|pred| 6.14 (val
# RMSE 0.7294 against 0.4146) where they agree within 3.5e-7 up to 16,384
# rows, and the log prints what one ulp of y does to the plain fit there
BATCH_METHODS = ("batch_unique", "batch_same", "batch_block")
BATCH_CPU = dict(REGRESSION, d=32, fit=8192, val=2048)
BATCH_SAME_REF_ROWS = 16384
# (iv) the rest at their scripts' sizes, card against the port on the CPU
# from the same seed, at the CPU tests' tolerances (tests/test_torch_*.py):
# predictions within PHASE10_PRED_REL x max|pred| (one swipe of each
# default_train variant at S = 8,192, eps 1e-2 as its CPU test: past its
# third swipe the uncertainty head's fit diverges and comes back in both
# packages, rounding amplified to 0.85 of max|pred| by swipe 8
# (studies/conditioning_study.py); the type-I
# sum of a compressed-data TT and a TT at batch -1 and 32; SymmetricCPD
# after 60 iterations), TTNaturalGradient's 12 step losses within 1e-4
# relative; the MLP on breast_cancer and the CNN (1 epoch on the stand-in's
# images) each within NN_LOSS_REL of the CPU's final train loss. The MLP is
# compared after MLP_EPOCHS: at its default 50 epochs (lr 0.1) its final
# loss is 5.7e-6 and a 1e-7 relative change of the initial weights moves it
# by 6 % on the CPU, so rounding alone parts two devices there (at 5
# epochs, 1e-6 moves it by 0.05 %; studies/conditioning_study.py mlp); the
# 50-epoch fit runs on the card and its loss and validation accuracy are
# printed
PHASE10_PRED_REL = 1e-4
# each swipe method's fit time on the default stream (run_batch_paths), read
# by phase 11 beside the native stream's
BATCH_FIT_S = {}
NN_LOSS_REL = 0.02
MLP_EPOCHS = 5


def check_growth_shapes(device, path, seen, done):
    """Every kernel at every shape a phase 10 path gave it: the full-H
    kernels (K1, K2, K3, K6) and K10 through check_path_shapes, the
    diagonal-H ones (K7, K8, K9) through check_zoo_shapes."""
    full = {s for s in seen if s[0] in ("retile_hmix", "quantize_tiled",
                                        "gram_pair_tiled", "gram_pair")}
    results = check_path_shapes(device, path, full, done) if full else []
    diag = seen - full
    if diag:
        results += check_zoo_shapes(device, path, diag, done)
    return results


def grow_stand_in(S: int, noise: float = GROW_NOISE):
    """(patches (S, 50, 17), one-hot (S, 10)) of train_image's MNIST
    stand-in (synthetic_images, seed 0) with N(0, noise^2) pixel noise from
    default_rng(1) added and the images rescaled to unit variance."""
    import torch
    from tensornetworksfork_tpu_torch.data.images import synthetic_images
    from tensornetworksfork_tpu_torch.ops.patches import image_to_conv_input
    imgs, labels = synthetic_images(S=S, seed=0)
    rng = np.random.default_rng(1)
    imgs = ((imgs + noise * rng.standard_normal(imgs.shape).astype(np.float32))
            / np.sqrt(1 + 1.5 ** 2 + noise ** 2)).astype(np.float32)
    return (image_to_conv_input(torch.from_numpy(imgs), 4, 4),
            torch.eye(10)[torch.from_numpy(labels)])


def _timed_run(device, fn):
    """fn() with the launch counters reset just before it and the shapes it
    gives the kernels recorded: (result, launches, seen, wall seconds)."""
    import torch
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    with recorded_shapes() as seen:
        torch.cuda.synchronize()
        kg.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kg.LAUNCHES)
    return out, launches, seen, wall


def grow_reference(device, tier, x, y):
    """Phase 10 (i)'s reference (no launch counted): run_grow_cart's loop
    replayed with the kernels. At each step's start, one swipe from its
    params with the kernels and one with the plain torch routes on the card
    (use_kernels=False), their predictions held within GROW_SWIPE_REL[tier]
    x max|pred|; after each growth, the grown layer's forward held to c x
    the previous one's within GROW_SCALE_RESIDUAL x max|forward| (grow_cart
    keeps the function up to the scale c of the new carriage's conv-block
    draw)."""
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.growing import grow_cart
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    g = GROW

    def sweep(layer, swipes, kernels=True):
        net = layer.network
        if not kernels:
            net = TensorConvolutionTrainLayer(
                layer.num_carriages, g["r"], x.shape[1], x.shape[2], output_shape=(9,),
                convolution_bond=g["CB"], device=device, use_kernels=False).network
        cfg = SweepConfig(num_swipes=swipes, method="ridge_cholesky", eps=g["eps"],
                          eps_decay=g["eps_decay"])
        (params,), _ = Sweeper(net, XEBregman(w=1.0), cfg).run([layer.params], x, y)
        return params

    with env(**SLICE_TIERS[tier]):
        layer = TensorConvolutionTrainLayer(g["start"], g["r"], x.shape[1], x.shape[2],
                                            output_shape=(9,), convolution_bond=g["CB"],
                                            device=device)
        for step in range(g["steps"] + 1):
            fk = layer.network.forward(sweep(layer, 1), x)
            fp = layer.network.forward(sweep(layer, 1, kernels=False), x)
            gap = float((fk - fp).abs().max() / fp.abs().max())
            layer.params = sweep(layer, g["swipes"])
            c = None
            if step < g["steps"]:
                old = layer.network.forward(layer.params, x)
                layer = grow_cart(layer)
                new = layer.network.forward(layer.params, x)
                c = float((new * old).sum() / (old * old).sum())
                resid = float((new - c * old).abs().max() / new.abs().max())
                if not resid <= GROW_SCALE_RESIDUAL:
                    raise AssertionError(f"grow_cart to {layer.num_carriages} carriages: "
                                         f"the forward is no multiple of the last ({resid})")
            log(f"[grow] grow_cart {tier} reference, {step + g['start']} carriages: one "
                f"swipe with the kernels vs the plain routes max|d pred| / max|pred| "
                f"{gap:.3g} (bound {GROW_SWIPE_REL[tier]})"
                + (f"; the growth after it scales the forward by {c:.4g} (residual "
                   f"{resid:.2g})" if c is not None else ""))
            if not gap <= GROW_SWIPE_REL[tier]:
                raise AssertionError(f"grow_cart {tier}, {step + g['start']} carriages: "
                                     f"the kernels' swipe parts from the plain routes' by {gap}")


def run_grow_cart_path(device, tier, card: str):
    """Phase 10 (i): run_grow_cart at the MNIST headline's widths in `tier`
    (SLICE_TIERS) on grow_stand_in, then its reference (grow_reference).
    Every step must keep its parameters finite and either report ok or beat
    chance on its training rows, and the kernels of GROW_KERNELS launch.
    Returns (launches, shapes seen)."""
    import torch
    from tensornetworksfork_tpu_torch.experiments.growing import run_grow_cart
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    g = GROW
    xp, y = grow_stand_in(g["S"])
    x, y = xp.to(device), y.to(device)
    with env(**SLICE_TIERS[tier]):
        (layer, hist), launches, seen, wall = _timed_run(device, lambda: run_grow_cart(
            x, y, start_carriages=g["start"], grow_steps=g["steps"], bond_dim=g["r"],
            convolution_bond=g["CB"], num_swipes=g["swipes"], eps=g["eps"],
            eps_decay=g["eps_decay"], loss_fn=XEBregman(w=1.0), output_dim=9,
            device=device))
    for h in hist:
        log(f"[grow] grow_cart {tier} ({card}): {h['carriages']} carriages, "
            f"{h['params']} params, train rmse {h['train_rmse']:.6f}, train accuracy "
            f"{h['train_accuracy']:.4f}, ok={h['ok']}, {h['seconds']:.3f} s")
    used = {k: v for k, v in launches.items() if v}
    log(f"[grow] grow_cart {tier}: 1 -> {layer.num_carriages} carriages in {wall:.3f} s "
        f"(S={g['S']}, r={g['r']}, CB={g['CB']}), launches {used}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(bool(torch.isfinite(v).all()) for v in layer.params.values()):
        raise AssertionError(f"grow_cart {tier}: non-finite parameters")
    failed = [h["carriages"] for h in hist if not (h["ok"] or h["train_accuracy"] > 0.1)]
    if failed:
        raise AssertionError(f"grow_cart {tier}: the {failed}-carriage steps flagged a "
                             "singular solve and fell to chance")
    missing = [k for k in GROW_KERNELS[tier] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"grow_cart {tier} never launched {missing}")
    grow_reference(device, tier, x, y)
    return launches, seen


def card_and_cpu(device, runs, path, fn):
    """fn(dev) on the card (counted and timed under `path` in `runs`, whose
    launches and shapes add up over several runs of one path) and on the
    CPU, in the f32 tier: (card result, CPU result)."""
    with env(TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION="highest"):
        out, launches, seen, wall = _timed_run(device, lambda: fn(device))
        t0 = time.perf_counter()
        ref = fn("cpu")
        cpu_s = time.perf_counter() - t0
    log(f"[grow] {path}: card {wall:.3f} s, cpu {cpu_s:.3f} s, launches "
        f"{({k: v for k, v in launches.items() if v})}")
    prev = runs.get(path)
    if prev:
        launches = {k: v + prev[0][k] for k, v in launches.items()}
        seen = seen | prev[1]
    runs[path] = (launches, seen)
    return out, ref


def dmrg_data(S, d):
    """make_regression's d features plus the bias column at both positions:
    (X2 (S, 2, d + 1), y)."""
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    X, y = make_regression(S=S, d=d, degree=3, seed=0)
    feats = np.concatenate([X, np.ones((S, 1), np.float32)], axis=1)
    return np.stack([feats, feats], axis=1), y


def run_dmrg_path(device, card: str):
    """Phase 10 (ii): run_dmrg_growth on the card, every step ok; its
    predictions held to the same growth's with the plain routes on the card
    (TNF_KERNELS=0), and, at DMRG_CPU's width, to the port's on the CPU,
    each within PHASE10_PRED_REL x max|pred|. Returns {path: (launches,
    shapes seen)}."""
    import torch
    from tensornetworksfork_tpu_torch.experiments.growing import run_dmrg_growth
    c = DMRG

    def grow(X2, y, dev):
        layer, hist = run_dmrg_growth(X2, y, bond_dim=c["bond"], grow_steps=c["steps"],
                                      rank=c["rank"], eps=c["eps"], device=dev)
        x = X2
        for _ in range(c["steps"]):  # the columns run_dmrg_growth grew to
            mid = x.shape[1] // 2
            x = np.concatenate([x[:, :mid], x[:, mid:mid + 1], x[:, mid:]], axis=1)
            x = np.concatenate([x[:, :mid], x[:, mid:mid + 1], x[:, mid:]], axis=1)
        pred = layer(layer.bind_x(torch.as_tensor(x, device=dev))).cpu().numpy()
        return layer, hist, pred

    X2, y = dmrg_data(c["S"], c["d"])
    with env(TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION="highest"):
        (layer, hist, pred), launches, seen, wall = _timed_run(
            device, lambda: grow(X2, y, device))
        with env(TNF_KERNELS="0"):
            _, ref_hist, ref = grow(X2, y, device)
    for h, r in zip(hist, ref_hist):
        split = (f", split_err {h['split_err']:.6g} (plain routes {r['split_err']:.6g})"
                 if "split_err" in h else "")
        log(f"[grow] dmrg ({card}): {h['positions']} positions, rmse {h['rmse']:.6f} "
            f"(plain routes {r['rmse']:.6f}){split}, ok={h['ok']}")
    log(f"[grow] dmrg: {wall:.3f} s (S={c['S']}, f={c['d'] + 1}, bond {c['bond']}, "
        f"rank {c['rank']}), launches {({k: v for k, v in launches.items() if v})}")
    if not all(h["ok"] and r["ok"] for h, r in zip(hist, ref_hist)):
        raise AssertionError(f"dmrg growth: a singular solve: {hist}")
    _held_to("dmrg growth, kernels vs plain routes on the card", pred, ref,
                  PHASE10_PRED_REL)
    runs = {"dmrg growth": (launches, seen)}
    X2s, ys = dmrg_data(DMRG_CPU["S"], DMRG_CPU["d"])
    (_, hs, out), (_, hc, cpu) = card_and_cpu(
        device, runs, f"dmrg growth f={DMRG_CPU['d'] + 1}", lambda dev: grow(X2s, ys, dev))
    if not all(h["ok"] and r["ok"] for h, r in zip(hs, hc)):
        raise AssertionError(f"dmrg growth at f={DMRG_CPU['d'] + 1}: a singular solve")
    _held_to(f"dmrg growth f={DMRG_CPU['d'] + 1} (S={DMRG_CPU['S']}), card vs cpu", out, cpu,
                  PHASE10_PRED_REL)
    return runs


def run_batch_paths(device, card: str):
    """Phase 10 (iii): TensorTrainBatchRegressor in each swipe method at
    phase 5's width; its validation predictions held to the same fit's with
    the plain routes on the card (TNF_KERNELS=0), batch_same's over
    BATCH_SAME_REF_ROWS rows, and, at BATCH_CPU's width, to the port's on
    the CPU, each within PHASE10_PRED_REL x max|pred|. Returns {path:
    (launches, shapes seen)}."""
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.models.module import TensorTrainBatchRegressor

    def fit(c, method, dev, y_scale=1.0):
        X, y = make_regression(S=c["fit"] + c["val"], d=c["d"], degree=3, seed=0)
        est = TensorTrainBatchRegressor(
            N=c["N"], r=c["r"], batch_size=1024, num_swipes=2, swipe_method=method,
            perturb=False, constrict_bond=False, eps_start=5.0, eps_end=5.0 * 0.25 ** 3,
            seed=42, device=dev)
        est.fit(X[:c["fit"]], y[:c["fit"]] * np.float32(y_scale), X[c["fit"]:], y[c["fit"]:])
        pred = est.predict(X[c["fit"]:])
        return pred, float(np.sqrt(np.mean((pred - y[c["fit"]:]) ** 2)))

    def gap(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    runs = {}
    for method in BATCH_METHODS:
        with env(TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION="highest"):
            (pred, val), launches, seen, wall = _timed_run(
                device, lambda: fit(REGRESSION, method, device))
            c = dict(REGRESSION, fit=BATCH_SAME_REF_ROWS) if method == "batch_same" else REGRESSION
            if c is not REGRESSION:
                pred_c, _ = fit(c, method, device)
            with env(TNF_KERNELS="0"):
                ref, ref_val = fit(REGRESSION, method, device)
                ref_c = ref if c is REGRESSION else fit(c, method, device)[0]
                if c is not REGRESSION:  # the same plain fit, y rounded one ulp up
                    ulp = gap(fit(REGRESSION, method, device, 1 + 2.0 ** -23)[0], ref)
        BATCH_FIT_S[method] = wall
        log(f"[grow] tt_batch {method} ({card}): fit {wall:.3f} s, val rmse {val:.6f} "
            f"(plain routes {ref_val:.6f}), launches "
            f"{({k: v for k, v in launches.items() if v})}")
        if c is not REGRESSION:
            log(f"[grow] tt_batch {method} over {REGRESSION['fit']:,} rows: kernels vs plain "
                f"routes max|d pred| / max|pred| {gap(pred, ref):.3g}; the plain routes "
                f"against themselves with y one ulp up {ulp:.3g}")
            pred = pred_c
        _held_to(f"tt_batch {method} ({c['fit']:,} rows), kernels vs plain routes on the "
                 "card", pred, ref_c, PHASE10_PRED_REL)
        runs[f"tt_batch {method}"] = (launches, seen)
        (out, _), (cpu, _) = card_and_cpu(device, runs, f"tt_batch {method} d={BATCH_CPU['d']}",
                                          lambda dev: fit(BATCH_CPU, method, dev))
        _held_to(f"tt_batch {method} d={BATCH_CPU['d']}, card vs cpu", out, cpu,
                 PHASE10_PRED_REL)
    return runs


def _held_to(what, got, want, rel):
    """got within rel x max|want| of want (the run on the CPU, or with the
    plain routes on the card, as `what` says)."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    log(f"[grow] {what}: max|d| {err:.3g} (max|.| {scale:.3g}, rel {rel})")
    if not (got.shape == want.shape and err <= rel * scale):
        raise AssertionError(f"{what}: the runs differ by {err}")


def check_phase10_rest(device, card: str):
    """Phase 10 (iv): each script on the card and on the CPU from the same
    seed, held together at its CPU test's tolerance. Returns {path:
    (launches, shapes seen)} of the card's runs."""
    import torch
    from tensornetworksfork_tpu_torch.core.sweep import Member, SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.data.images import synthetic_images
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.data.tabular import load_sklearn_dataset
    from tensornetworksfork_tpu_torch.experiments import default_train
    from tensornetworksfork_tpu_torch.models import layers as L
    from tensornetworksfork_tpu_torch.models.baselines import CNNWrapper, MLPWrapper
    from tensornetworksfork_tpu_torch.models.symmetric_cpd import SymmetricCPD
    from tensornetworksfork_tpu_torch.models.tt_nn import TTNaturalGradient
    from tensornetworksfork_tpu_torch.ops import bregman as B
    from tensornetworksfork_tpu_torch.ops.compression import DataCompression, train_compress

    runs = {}

    # default_train: every variant, one swipe
    for v in default_train.VARIANTS:
        res, ref = card_and_cpu(device, runs, "default_train", lambda dev, v=v: default_train.run(
            v, S=8192, num_swipes=1, eps=1e-2, device=dev))
        if not (res["ok"] and ref["ok"]):
            raise AssertionError(f"default_train {v}: a singular solve")
        log(f"[grow] default_train {v} ({card}): train rmse {res['train_rmse']:.6f} "
            f"(cpu {ref['train_rmse']:.6f})")
        _held_to(f"default_train {v}, card vs cpu", res["pred"], ref["pred"], PHASE10_PRED_REL)

    # the type-I sum of a compressed-data TT (no input node) and a TT
    rng = np.random.default_rng(9)
    S, f = 2048, 5
    Xs = np.concatenate([rng.uniform(-1, 1, (S, f - 1)).astype(np.float32),
                         np.ones((S, 1), np.float32)], axis=1)
    ys = ((Xs[:, 0] * Xs[:, 1]) + 0.5 * Xs[:, 2]).reshape(S, 1).astype(np.float32)
    for batch in (-1, 32):
        def sum_fit(dev, batch=batch):
            blocks, _ = train_compress(
                list(DataCompression(Xs, device=dev).non_compressed(degree=2)), rank=16)
            lc = L.CompressedTensorTrainLayer(blocks, bond_dim=4, output_shape=(1,),
                                              seed=0, device=dev)
            lt = L.TensorTrainLayer(1, 1, f, output_shape=(1,), seed=1, device=dev)
            x = torch.tensor(Xs, device=dev)
            pl, ok = Sweeper([Member(lc.network, lambda x: {}), Member(lt.network)],
                             B.SquareBregFunction(),
                             SweepConfig(num_swipes=1, eps=1e-5, batch_size=batch)).run(
                [lc.params, lt.params], x, torch.tensor(ys, device=dev))
            if not ok:
                raise AssertionError(f"compressed sum (batch {batch}): a singular solve")
            return (lc.network.forward(pl[0], {}) + lt.network.forward(pl[1], x)).cpu()
        out, ref = card_and_cpu(device, runs, "compressed type-I sum", sum_fit)
        _held_to(f"compressed type-I sum, batch {batch}, card vs cpu", out, ref, PHASE10_PRED_REL)

    # TTNaturalGradient, 12 steps over 1,024-row batches at phase 5's width,
    # from eps 1.0: its middle block (D = 8,256) is underdetermined by a
    # batch, and from eps 0.1 card and CPU losses came within a tenth of the
    # 1e-4 bound
    c = REGRESSION
    Xr, yr = make_regression(S=12 * 1024, d=c["d"], degree=3, seed=0)

    def ttng(dev):
        tn = TTNaturalGradient(c["d"], (1,), N=c["N"], r=c["r"], eps=1.0, device=dev)
        params, losses = tn.params, []
        for s in range(12):
            b = slice(s * 1024, (s + 1) * 1024)
            params, loss = tn.train_step(params, torch.tensor(Xr[b], device=dev),
                                         torch.tensor(yr[b], device=dev),
                                         B.SquareBregFunction())
            losses.append(float(loss))
        return np.asarray(losses)
    out, ref = card_and_cpu(device, runs, "tt_natural_gradient", ttng)
    log(f"[grow] TTNaturalGradient losses ({card}): {np.array2string(out, precision=6)}")
    rel = float(np.max(np.abs(out - ref) / np.abs(ref)))
    log(f"[grow] TTNaturalGradient: card vs cpu largest relative loss gap {rel:.3g} (1e-4)")
    if not rel <= 1e-4:
        raise AssertionError(f"TTNaturalGradient: card and CPU losses part by {rel}")

    # SymmetricCPD, 60 Gauss-Newton iterations
    rng = np.random.default_rng(0)
    Xc = rng.standard_normal((8192, 16)).astype(np.float32)
    W = rng.standard_normal((2, 16)) / 4
    yc = ((Xc @ W[0]) ** 3 + (Xc @ W[1]) ** 3).astype(np.float32)
    out, ref = card_and_cpu(device, runs, "symmetric_cpd", lambda dev: SymmetricCPD(
        16, 4, 3, seed=1, device=dev).fit(Xc, yc, iters=60).predict(Xc))
    _held_to("SymmetricCPD, card vs cpu", out, ref, PHASE10_PRED_REL)

    # the MLP on breast_cancer and the CNN on the stand-in's images
    bc = load_sklearn_dataset("breast_cancer", seed=42)
    ybc = bc["y_train"].reshape(-1).astype(int)
    out, ref = card_and_cpu(device, runs, "mlp", lambda dev: MLPWrapper(
        bc["X_train"].shape[1], 2, dict(epochs=MLP_EPOCHS), task="classification",
        device=dev).fit(bc["X_train"], ybc))
    full = MLPWrapper(bc["X_train"].shape[1], 2, task="classification",
                      device=device).fit(bc["X_train"], ybc)
    yv = bc["y_val"].reshape(-1)
    log(f"[grow] MLPWrapper breast_cancer ({card}): {MLP_EPOCHS} epochs final train loss "
        f"{out.final_loss_:.6f} (cpu {ref.final_loss_:.6f}), val accuracy "
        f"{np.mean(out.predict(bc['X_val']) == yv):.4f}; the default 50 epochs: loss "
        f"{full.final_loss_:.3g}, val accuracy {np.mean(full.predict(bc['X_val']) == yv):.4f}")
    imgs, labels = synthetic_images(S=8192, seed=0)
    out2, ref2 = card_and_cpu(device, runs, "cnn", lambda dev: CNNWrapper(
        10, dict(epochs=1), device=dev).fit(imgs[:, 0], labels))
    acc2 = float(np.mean(out2.predict(imgs[:, 0]) == labels))
    log(f"[grow] CNNWrapper, 1 epoch on the stand-in ({card}): final train loss "
        f"{out2.final_loss_:.6f} (cpu {ref2.final_loss_:.6f}), train accuracy {acc2:.4f}")
    for what, a, b in (("MLP", out, ref), ("CNN", out2, ref2)):
        if not abs(a.final_loss_ - b.final_loss_) <= NN_LOSS_REL * b.final_loss_:
            raise AssertionError(f"{what}: final loss {a.final_loss_} vs cpu {b.final_loss_}")
    return runs


# phase 11: what users of a trained model touch. (i) serving: phase 7's
# trained type-I sum exported with a symbolic batch (utils/serving.py, a
# torch.export program), saved under build/ and loaded with load_forward,
# served at batches 1, SERVE_BATCH and the stand-in's whole test split, each
# within SERVE_REL x max|pred| of the model's eager forward with the argmax
# equal; phase 5's regression estimator and a TNML fit exported the same way
# and held to predict. (ii) TensorTrainBatchRegressor(stream="native") at
# phase 10 (iii)'s data and width in each swipe method, the batches the
# native stream gathers checked bit for bit against X[idx], held as phase 10
# (iii) holds the default stream (to the plain routes on the card with the
# same stream, batch_same over BATCH_SAME_REF_ROWS rows, and at BATCH_CPU's
# width to the CPU). (iii) a checkpoint of the headline's node states
# restores a freshly built model to the same forward, bit for bit. (iv)
# epoch_flops of phase 4's flagship swipe and the MFU of its four tiers
# (int8 against the int8 peak, the rest against bf16's; a record, not a
# claim). (v) a small swipe under xla_trace leaves a Chrome trace under
# build/. (vi) reproduce_result digits_flat over seeds 42-51: the mean
# within DIGITS_FLAT_FLOOR of RESULTS.md's 94.36 +/- 1.17 %, the noise floor
# 2 x 1.17 x sqrt(2/10) of two 10-seed means, and every seed's parameters
# finite. Each of these paths that launches kernels (the TNML fit, the
# native-stream fits, the traced swipe, digits_flat) runs with the counts
# reset and records the shapes it gives them; check_growth_shapes then holds
# every kernel to its plain version at each and times the largest under the
# path's name
SERVE_REL = 1e-5
SERVE_BATCH = 2048
SERVE_DIR = "build/chip_smoke_serving"
TRACE_DIR = "build/chip_smoke_trace"
DIGITS_FLAT_TARGET = 94.36
DIGITS_FLAT_FLOOR = 2 * 1.17 * np.sqrt(2 / 10)
NATIVE_CHECK_EVERY = 8  # check every 8th batch the native stream gathers


def _serves(what, f, eager, x, classes: bool):
    """f(x) (the loaded artifact) against eager(x): within SERVE_REL x
    max|eager|, argmax equal where the output holds classes."""
    import torch
    with torch.no_grad():
        got, want = f(x), eager(x)
    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1))) if classes else True
    log(f"[serve] {what}: batch {x.shape[0]}, max|d| {err:.3g} (max|pred| {scale:.3g}, "
        f"rel {err / scale:.3g}, bound {SERVE_REL})" + (f", argmax equal {same}" if classes
                                                         else ""))
    if got.shape != want.shape or not err <= SERVE_REL * scale or not same:
        raise AssertionError(f"{what}: the artifact differs from the eager forward")


def run_serving(device, card: str, model, config, reg):
    """Phase 11 (i): the headline model, phase 5's estimator and a TNML fit
    through export, save and load_forward on the card. The TNML fit runs
    with the launch counters reset and the shapes it gives the kernels
    recorded. Returns the test split (patches on the card) for (iii) and
    {path: (launches, shapes seen)} of the TNML fit."""
    import torch
    from tensornetworksfork_tpu_torch.data.tabular import load_sklearn_dataset
    from tensornetworksfork_tpu_torch.experiments import train_image
    from tensornetworksfork_tpu_torch.models.tnml import TNMLRegressor
    from tensornetworksfork_tpu_torch.utils.serving import (
        export_estimator, export_forward, load_forward, save_forward)

    os.makedirs(SERVE_DIR, exist_ok=True)
    xtr, _, xte, _, synthetic = train_image.load_data(config)
    t0 = time.perf_counter()
    blob = export_forward(model, tuple(xtr.shape[1:]), device=device)
    export_s = time.perf_counter() - t0
    path = os.path.join(SERVE_DIR, "headline.pt2")
    save_forward(path, blob)
    t0 = time.perf_counter()
    f = load_forward(path)
    load_s = time.perf_counter() - t0
    log(f"[serve] headline type-I sum ({model.num_parameters()} params, members of "
        f"1-{len(model.layers)} carriages, r={config['r']}, CB={config['CB']}): export "
        f"{export_s:.2f} s, {len(blob) / 2**20:.2f} MiB at {path}, load {load_s:.2f} s, "
        f"serves on {f.device}")
    xte = xte.to(device)
    batches = {"1": xte[:1], f"{SERVE_BATCH:,}": xtr[:SERVE_BATCH].to(device),
               f"the test split ({xte.shape[0]:,}, synthetic={synthetic})": xte}
    for name, x in batches.items():
        _serves(f"headline artifact, batch {name}", f, model, x, classes=True)
    for name in list(batches)[1:]:
        x = batches[name]
        with torch.no_grad():
            ms_art = time_ms(lambda: f(x), reps=3)
            ms_eager = time_ms(lambda: model(x), reps=3)
        log(f"[serve] {card}: batch {name}: artifact {ms_art:.3f} ms "
            f"({x.shape[0] / ms_art * 1e3:,.0f} images/s), eager forward "
            f"{ms_eager:.3f} ms ({x.shape[0] / ms_eager * 1e3:,.0f} images/s)")

    c = REGRESSION
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    X, _ = make_regression(S=c["fit"] + c["val"], d=c["d"], degree=3, seed=0)
    Xva = X[c["fit"]:]
    t0 = time.perf_counter()
    g = load_forward(export_estimator(reg))
    log(f"[serve] regression estimator (N={c['N']}, r={c['r']}, d={c['d']}): export and "
        f"load {time.perf_counter() - t0:.2f} s")
    for rows in (1, 3, len(Xva)):
        _serves(f"regression artifact vs predict, {rows} rows", g,
                lambda x: reg.predict(x.cpu().numpy()), torch.from_numpy(Xva[:rows]),
                classes=False)
    bc = load_sklearn_dataset("breast_cancer", seed=42)
    tn = TNMLRegressor(r=4, num_swipes=2, eps_start=0.5, task="classification",
                       input_scale="minmax", device=device)
    _, launches, seen, wall = _timed_run(device, lambda: tn.fit(
        bc["X_train"], bc["y_train"], X_val=bc["X_val"], y_val=bc["y_val"]))
    log(f"[serve] tnml fit (breast_cancer, r={tn.r}) on the card: {wall:.3f} s, launches "
        f"{({k: v for k, v in launches.items() if v})}")
    h = load_forward(tn.export())
    for rows in (1, 3, len(bc["X_test"])):
        _serves(f"tnml artifact vs predict (breast_cancer, {tn.N} carriages), {rows} rows",
                h, lambda x: tn.predict(x.cpu().numpy()),
                torch.from_numpy(bc["X_test"][:rows]), classes=True)
    return xte, {"tnml serving fit": (launches, seen)}


def run_native_stream(device, card: str):
    """Phase 11 (ii): TensorTrainBatchRegressor(stream="native") in each swipe
    method at phase 10 (iii)'s width: the stream native, every
    NATIVE_CHECK_EVERY-th batch it gathers equal to X[idx], held to the same
    fit on the plain routes on the card (batch_same over BATCH_SAME_REF_ROWS
    rows) and at BATCH_CPU's width to the CPU. Returns {path: (launches,
    shapes seen)}."""
    from tensornetworksfork_tpu_torch import native
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.models.module import TensorTrainBatchRegressor
    from tensornetworksfork_tpu_torch.utils import data_stream

    # the library builds at its first use: build it before the timed fits
    t0 = time.perf_counter()
    native.require_lib()
    log(f"[native] {native.lib_path()}: built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    opened, checked = [], [0]
    Stream = data_stream.MinibatchStream

    class Checked(Stream):
        def epoch(self):
            for i, (xb, idx) in enumerate(super().epoch()):
                if i % NATIVE_CHECK_EVERY == 0:
                    if not np.array_equal(xb, self._owner[idx]):
                        raise AssertionError("a native batch differs from X[idx]")
                    checked[0] += 1
                yield xb, idx

    def stream(*a, **k):
        opened.append(Checked(*a, **k))
        if not opened[-1].is_native:
            raise AssertionError("the minibatch stream is not the native one")
        return opened[-1]

    def fit(c, method, dev):
        X, y = make_regression(S=c["fit"] + c["val"], d=c["d"], degree=3, seed=0)
        est = TensorTrainBatchRegressor(
            N=c["N"], r=c["r"], batch_size=1024, num_swipes=2, swipe_method=method,
            perturb=False, constrict_bond=False, eps_start=5.0, eps_end=5.0 * 0.25 ** 3,
            seed=42, stream="native", device=dev)
        est.fit(X[:c["fit"]], y[:c["fit"]], X[c["fit"]:], y[c["fit"]:])
        pred = est.predict(X[c["fit"]:])
        return pred, float(np.sqrt(np.mean((pred - y[c["fit"]:]) ** 2)))

    runs = {}
    data_stream.MinibatchStream = stream
    try:
        for method in BATCH_METHODS:
            with env(TNF_GRAM_DTYPE="f32", TNF_AUX_PRECISION="highest"):
                (pred, val), launches, seen, wall = _timed_run(
                    device, lambda: fit(REGRESSION, method, device))
                c = dict(REGRESSION, fit=BATCH_SAME_REF_ROWS) if method == "batch_same" else REGRESSION
                if c is not REGRESSION:
                    pred = fit(c, method, device)[0]
                with env(TNF_KERNELS="0"):
                    ref, ref_val = fit(c, method, device)
            log(f"[native] tt_batch {method} ({card}): native stream fit {wall:.3f} s "
                f"(default stream {BATCH_FIT_S.get(method, float('nan')):.3f} s), val rmse "
                f"{val:.6f}, launches {({k: v for k, v in launches.items() if v})}")
            _held_to(f"native tt_batch {method} ({c['fit']:,} rows), kernels vs plain routes "
                     f"on the card (val rmse {ref_val:.6f})", pred, ref, PHASE10_PRED_REL)
            runs[f"tt_batch native {method}"] = (launches, seen)
            (out, _), (cpu, _) = card_and_cpu(
                device, runs, f"tt_batch native {method} d={BATCH_CPU['d']}",
                lambda dev: fit(BATCH_CPU, method, dev))
            _held_to(f"native tt_batch {method} d={BATCH_CPU['d']}, card vs cpu", out, cpu,
                     PHASE10_PRED_REL)
    finally:
        data_stream.MinibatchStream = Stream
    log(f"[native] {len(opened)} native streams opened, {checked[0]} gathered batches "
        "equal to X[idx]")
    return runs


def check_checkpoint(device, model, config, x):
    """Phase 11 (iii): the headline's node states saved as npz, loaded onto
    the card into a model built afresh (other seeds), forward bit-equal."""
    import torch
    from tensornetworksfork_tpu_torch.data.images import DATASETS
    from tensornetworksfork_tpu_torch.experiments import train_image
    from tensornetworksfork_tpu_torch.utils.checkpoint import load_node_states, save_node_states
    path = os.path.join(SERVE_DIR, "headline_states.npz")
    save_node_states(path, model.node_states())
    classes = DATASETS[config["dataset"].lower()]["num_classes"]
    fresh = train_image.build_model(dict(config, seed=config["seed"] + 100, device=device),
                                    x.shape[1], x.shape[2], classes)
    fresh.load_node_states(load_node_states(path, device=device))
    with torch.no_grad():
        same = torch.equal(fresh(x), model(x))
    log(f"[checkpoint] {path}: {os.path.getsize(path) / 2**20:.2f} MiB, "
        f"{len(model.layers)} members restored on {device}, forward over "
        f"{x.shape[0]:,} images bit-equal {same}")
    if not same:
        raise AssertionError("the restored model's forward differs")


def record_flops(device, card: str, walls):
    """Phase 11 (iv): epoch_flops of phase 4's flagship swipe and each
    tier's MFU from its wall time (a record, not a claim)."""
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    from tensornetworksfork_tpu_torch.utils.flops import device_peak_flops, epoch_flops, mfu
    X, y = flagship_data(SLICE_SAMPLES, 0, device)
    sweeper = Sweeper(flagship_layer(device, 0).network, XEBregman(w=1.0),
                      SweepConfig(**SLICE_CONFIG))
    fl = epoch_flops(sweeper, X, y)
    log(f"[flops] flagship swipe (S={SLICE_SAMPLES:,}, chunks of {BATCH}): "
        + ", ".join(f"{k} {v:.4g}" for k, v in fl.items()))
    peaks = {k: device_peak_flops(k) for k in ("bf16", "int8")}
    for tier, wall in walls.items():
        kind = "int8" if tier == "int8" else "bf16"
        u = mfu(fl["total"], wall, peaks[kind])
        log(f"[flops] {card}: {tier} swipe {wall:.3f} s: {fl['total'] / wall / 1e12:.3f} "
            f"TFLOP/s, MFU {u if u is None else f'{u:.4%}'} of the {kind} peak "
            f"{peaks[kind]}")
    return fl


def check_trace(device):
    """Phase 11 (v): one small conv-TT swipe on the card under xla_trace
    leaves a non-empty Chrome trace under build/; the card's kernels in it
    are counted. The swipe runs with the launch counters reset and the
    shapes it gives the kernels recorded: returns {path: (launches, shapes
    seen)}."""
    import glob
    import torch
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    from tensornetworksfork_tpu_torch.utils.timing import xla_trace
    layer = TensorConvolutionTrainLayer(2, 4, 8, 5, output_shape=(3,), convolution_bond=2,
                                        seed=0, device=device)
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((512, 8, 5), np.float32), device=device)
    y = torch.eye(4, device=device)[torch.from_numpy(rng.integers(0, 4, 512)).to(device)]
    before = set(glob.glob(os.path.join(TRACE_DIR, "trace-*.json")))
    def swipe():
        with xla_trace(TRACE_DIR):
            Sweeper(layer.network, XEBregman(w=1.0), SweepConfig(num_swipes=1)).run(
                [layer.params], X, y)
    _, launches, seen, _ = _timed_run(device, swipe)
    (path,) = set(glob.glob(os.path.join(TRACE_DIR, "trace-*.json"))) - before
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[trace] {path}: {os.path.getsize(path) / 2**10:.1f} KiB, {len(events)} events, "
        f"{kernels} of them kernels on the card; launches "
        f"{({k: v for k, v in launches.items() if v})}")
    if not events:
        raise AssertionError("xla_trace wrote an empty trace")
    return {"trace conv-TT swipe": (launches, seen)}


def run_digits_flat_gate(device, card: str):
    """Phase 11 (vi): reproduce_result digits_flat, seeds 42-51, on the card:
    each seed's accuracy, the mean within DIGITS_FLAT_FLOOR of
    DIGITS_FLAT_TARGET, every model's parameters finite, one of the kernels
    launched. Returns {path: (launches, shapes seen)}."""
    import torch
    from tensornetworksfork_tpu_torch.experiments import reproduce_result, train_tabular
    models, build = [], train_tabular.build_model

    def recording(*args):
        models.append(build(*args))
        return models[-1]

    train_tabular.build_model = recording
    try:
        with env(DEVICE=str(device)):
            accs, launches, seen, wall = _timed_run(
                device, lambda: reproduce_result.main("digits_flat"))
    finally:
        train_tabular.build_model = build
    mean = float(np.mean(accs))
    bad = [i for i, m in enumerate(models)
           if not all(bool(torch.isfinite(v).all()) for v in m._model.params.values())]
    log(f"[digits_flat] {card}: accuracies {[round(a, 2) for a in accs]}, mean {mean:.2f} "
        f"+/- {np.std(accs):.2f} %, |mean - {DIGITS_FLAT_TARGET}| = "
        f"{abs(mean - DIGITS_FLAT_TARGET):.2f} (floor {DIGITS_FLAT_FLOOR:.2f}), wall "
        f"{wall:.1f} s, launches {({k: v for k, v in launches.items() if v})}")
    if bad or not all(np.isfinite(accs)):
        raise AssertionError(f"digits_flat: seeds at {bad} ended with non-finite parameters")
    if not abs(mean - DIGITS_FLAT_TARGET) <= DIGITS_FLAT_FLOOR:
        raise AssertionError(f"digits_flat: mean {mean:.2f} % is outside the noise floor "
                             f"{DIGITS_FLAT_FLOOR:.2f} of {DIGITS_FLAT_TARGET} %")
    if not any(launches.values()):
        raise AssertionError("digits_flat launched none of the kernels")
    return {"digits_flat": (launches, seen)}


# phase 12: the 1-D data mesh (parallel/mesh.py) on 2 gloo ranks sharing the
# card, and the experiment drivers (the module note, item 12)
MESH_RANKS = 2
MESH_TIERS = ("int8", "f32")
# test_parallel.py's tolerances on params (rtol = atol): f32 sums reordered
# over the ranks; int8 codes quantised per rank in other 2,048-row blocks
MESH_TOL = {"int8": 5e-2, "f32": 5e-3}
MESH_TABULAR_SWIPES = 2
# phase 8c's conv-TT, its data and its minres settings (card against CPU
# within 2e-4 there): at eps 0.1 a minres swipe of a wider conv-TT parts
# from itself summed in another order by 9e-2 (Krylov iterates amplify
# reassociation along near-null directions, as test_parallel.py:80 says)
MESH_MINRES = dict(S=96, P=6, pp=5, C=3, N=4, r=4, CB=2, batch=48)
DRIVER_FOLD_TIMEOUT = 2.0  # seconds a fold of the sweep's CV may take
SWEEP_TRIALS = 3
IMAGE_POINT = dict(DATASET="MNIST", KERNEL_SIZE=4, KERNEL_STRIDE=4, N=2, R=8, CB=4,
                   NUM_SWIPES=1, EARLY_STOPPING=1000, VERBOSE=0,
                   DATA_PATH="build/no_mnist_staged",
                   RESULTS_FILE="build/chip_smoke_image_sweep.csv")
IMAGE_SUBPROCESS_TIMEOUT = 300.0


def mesh_tabular_data(device):
    """Phase 5's regression rows (65,536 x 128 features from
    make_regression, seed 0) with the estimator's bias column, and its TT
    (N=3, r=8: A2 has D = 8,256) from seed 0."""
    import torch
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.models.layers import TensorTrainLayer
    c = REGRESSION
    X, y = make_regression(S=c["fit"], d=c["d"], degree=3, seed=0)
    X = np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], axis=1)
    layer = TensorTrainLayer(c["N"], c["r"], c["d"] + 1, output_shape=(1,), seed=0,
                             device=device)
    return layer, torch.tensor(X, device=device), torch.tensor(y, device=device)


def mesh_minres_data(device):
    """A small conv-TT (MESH_MINRES) and its data, for the matrix-free
    sweep under the mesh."""
    import torch
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    c = MESH_MINRES
    rng = np.random.default_rng(3)
    X = rng.standard_normal((c["S"], c["P"], c["pp"])).astype(np.float32)
    y = np.eye(c["C"] + 1, dtype=np.float32)[rng.integers(0, c["C"] + 1, c["S"])]
    layer = TensorConvolutionTrainLayer(c["N"], c["r"], c["P"], c["pp"],
                                        output_shape=(c["C"],), convolution_bond=c["CB"],
                                        seed=0, device=device)
    return layer, torch.tensor(X, device=device), torch.tensor(y, device=device)


MESH_MINRES_CONFIG = dict(num_swipes=1, batch_size=MESH_MINRES["batch"], method="minres",
                          eps=1.0, max_iter=60, tol=1e-5)
MESH_TABULAR_CONFIG = dict(num_swipes=MESH_TABULAR_SWIPES, batch_size=REGRESSION["batch"],
                           method="ridge_cholesky", eps=5.0, eps_decay=0.25)


def _mesh_sweep(mesh, layer, loss, cfg, X, y, tier_env, labels=()):
    """One Sweeper.run (under `mesh` when given, with `labels` its model
    axis labels) with the counters reset just before it and the kernel
    shapes recorded: params (numpy), ok, wall seconds, launches, shapes, the
    collectives' stats by kind and the Krylov iteration counts."""
    import torch
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.ops.cuda import gram as kg
    from tensornetworksfork_tpu_torch.utils.convert import params_to_numpy
    sweeper = Sweeper(layer.network, loss, SweepConfig(**cfg))
    with env(**tier_env), recorded_shapes() as seen:
        torch.cuda.synchronize()
        kg.reset_launches()
        if mesh is not None:
            mesh.reset_stats()
        t0 = time.perf_counter()
        params, ok = sweeper.run([layer.params], X, y, mesh=mesh, model_axis_labels=labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kg.LAUNCHES)
        stats = None if mesh is None else {k: dict(v) for k, v in mesh.stats.items()}
    return dict(params=params_to_numpy(params[0]), ok=ok, wall=wall, launches=launches,
                seen=set(seen), stats=stats,
                iters=[int(k) for _, _, k in sweeper.krylov_iters])


def mesh_rank():
    """One rank of phase 12: the flagship swipe in each MESH_TIERS tier,
    the tabular TT's fit and the minres swipe, each on the 1-D data mesh
    over both ranks (the card shared). Returns each run's _mesh_sweep."""
    import torch
    from tensornetworksfork_tpu_torch.ops.bregman import SquareBregFunction, XEBregman
    from tensornetworksfork_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(MESH_RANKS)
    out = {}
    X, y = flagship_data(SLICE_SAMPLES, 0, mesh.device)
    for tier in MESH_TIERS:
        out[f"flagship {tier}"] = _mesh_sweep(mesh, flagship_layer(mesh.device, 0),
                                              XEBregman(w=1.0), SLICE_CONFIG, X, y,
                                              SLICE_TIERS[tier])
    del X, y
    layer, X, y = mesh_tabular_data(mesh.device)
    out["tabular TT f32"] = _mesh_sweep(mesh, layer, SquareBregFunction(),
                                        MESH_TABULAR_CONFIG, X, y, SLICE_TIERS["f32"])
    del X, y
    layer, X, y = mesh_minres_data(mesh.device)
    out["minres"] = _mesh_sweep(mesh, layer, XEBregman(w=1.0), MESH_MINRES_CONFIG, X, y,
                                SLICE_TIERS["f32"])
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _params_within(what, got, want, tol):
    """got within tol * (1 + |want|) of want, entry by entry (rtol = atol,
    as test_parallel.py holds them); returns the largest |d| / (1 + |want|)."""
    worst = max(float(np.max(np.abs(got[k] - want[k]) / (1.0 + np.abs(want[k]))))
                for k in want)
    if not worst <= tol:
        raise AssertionError(f"{what}: params differ by {worst:.3g} (bound {tol})")
    return worst


def run_mesh(device, card: str, single):
    """Phase 12 (i)-(iii): MESH_RANKS gloo ranks on the one card
    (parallel.launch; the kernel library was built by this process, so no
    rank runs nvcc). Each run is held to the single process from the same
    params: the flagship to phase 4's swipes (`single`: tier -> params),
    the tabular TT and the minres swipe to runs made here. The ranks'
    params must be bit-equal, every kernel of each path launched on each
    rank, and the minres iteration counts equal. Returns {path: (launches
    of both ranks, shapes)}."""
    import torch
    from tensornetworksfork_tpu_torch.ops.bregman import SquareBregFunction, XEBregman
    from tensornetworksfork_tpu_torch.parallel import mesh as pmesh
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    ranks = pmesh.launch(mesh_rank, MESH_RANKS, timeout=600, join_timeout=900)
    log(f"[mesh] {card}: {MESH_RANKS} gloo ranks on one card, spawned, run and joined in "
        f"{time.perf_counter() - t0:.1f} s; peak mem per rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB")
    layer, X, y = mesh_tabular_data(device)
    single["tabular TT f32"] = _mesh_sweep(None, layer, SquareBregFunction(),
                                           MESH_TABULAR_CONFIG, X, y,
                                           SLICE_TIERS["f32"])["params"]
    del X, y
    layer, X, y = mesh_minres_data(device)
    single["minres"] = _mesh_sweep(None, layer, XEBregman(w=1.0), MESH_MINRES_CONFIG, X, y,
                                   SLICE_TIERS["f32"])["params"]
    # the int8 tier's own spread, for scale: one process, int8 against f32
    spread = max(float(np.max(np.abs(single["flagship int8"][k] - single["flagship f32"][k])
                              / (1.0 + np.abs(single["flagship f32"][k]))))
                 for k in single["flagship f32"])
    log(f"[mesh] {card}: for scale, phase 4's int8 swipe against its f32 one: params "
        f"within {spread:.3g}")
    need = {"flagship int8": FLAGSHIP_KERNELS["int8"], "flagship f32": FLAGSHIP_KERNELS["f32"],
            "tabular TT f32": REGRESSION_KERNELS, "minres": ()}
    paths = {}
    for run, kernels in need.items():
        r0, r1 = ranks[0][run], ranks[1][run]
        if not (r0["ok"] and r1["ok"]):
            raise AssertionError(f"mesh {run}: a rank reported a singular solve")
        for k in r0["params"]:
            if not np.array_equal(r0["params"][k], r1["params"][k]):
                raise AssertionError(f"mesh {run}: the ranks' {k} differ")
        tol = MESH_TOL["int8" if run.endswith("int8") else "f32"]
        worst = _params_within(f"mesh {run}", r0["params"], single[run], tol)
        missing = [k for k in kernels for r in (r0, r1) if r["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"mesh {run}: kernels never launched on a rank: {missing}")
        if run == "minres" and (not r0["iters"] or r0["iters"] != r1["iters"]):
            raise AssertionError(f"mesh minres: iterations differ over the ranks: "
                                 f"{r0['iters']} vs {r1['iters']}")
        s = r0["stats"]["all_reduce"]
        log(f"[mesh] {card}: {run}: swipe wall {r0['wall']:.3f} / {r1['wall']:.3f} s "
            f"(rank 0 / 1); all-reduces {s['calls']} calls, "
            f"{s['bytes'] / 2**30:.3f} GiB, {s['seconds']:.3f} s on rank 0 "
            f"({s['bytes'] / max(s['seconds'], 1e-9) / 1e9:.2f} GB/s), of which the "
            f"staging copies to and from the host {s['copy_seconds']:.3f} s; ranks bit-equal; "
            f"params within {worst:.3g} of the single process (bound {tol}); launches "
            f"rank 0 {({k: v for k, v in r0['launches'].items() if v})}"
            + (f"; minres iterations {r0['iters']}" if run == "minres" else ""))
        launches = {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
        paths[f"mesh {run} (2 ranks)"] = (launches, r0["seen"] | r1["seen"])
    return paths


def run_drivers(device, card: str):
    """Phase 12 (iv): the experiment drivers on the card. run_sweep's
    GP-EI search (SWEEP_TRIALS trials, DRIVER_FOLD_TIMEOUT seconds a fold)
    on the sweep CLI's synthetic data; grid_search at test_experiments.py's
    small grid; image_sweep.run_config at the MNIST grid's first point on
    the stand-in, in process and as a subprocess; visualize_topology's
    text of the flagship. reporting, plots and prepare_data need pandas or
    matplotlib, which the card's machine lacks: the CPU tests hold them.
    Returns {path: (launches, shapes)} of the fits."""
    import torch
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.experiments import grid_search, image_sweep, sweep
    from tensornetworksfork_tpu_torch.utils.config import RunConfig
    from tensornetworksfork_tpu_torch.utils.viz import topology_text, visualize_topology
    paths = {}

    X, y = make_regression(S=2048, d=6, degree=3, seed=42)
    cfg = RunConfig(verbose=0, timeout=DRIVER_FOLD_TIMEOUT, device=str(device))
    csv = "build/chip_smoke_sweep.csv"
    if os.path.exists(csv):
        os.remove(csv)
    best, launches, seen, wall = _timed_run(device, lambda: sweep.run_sweep(
        cfg, X, y, n_trials=SWEEP_TRIALS, results_file=csv, use_wandb=False, search="bayes"))
    with open(csv) as f:
        rows = f.read().splitlines()
    log(f"[drivers] {card}: run_sweep (bayes, {SWEEP_TRIALS} trials): {wall:.1f} s, best "
        f"{best}, {len(rows) - 1} rows in {csv}")
    if len(rows) - 1 != SWEEP_TRIALS or best is None or not np.isfinite(best[0]):
        raise AssertionError(f"run_sweep: {len(rows) - 1} rows, best {best}")
    paths["drivers run_sweep"] = (launches, seen)

    gcfg = RunConfig(dataset="synthetic", model_type="tt", num_swipes=2, eps=1e-3,
                     eps_decay=0.7, batch_size=512, verbose=0, device=str(device))
    out, launches, seen, wall = _timed_run(device, lambda: grid_search.grid_search(
        gcfg, {"N": [2], "r": [3, 5]}, val_seeds=[42], test_seeds=[52, 53]))
    r2 = [r["test_r2"] for r in out["test_rows"]]
    log(f"[drivers] {card}: grid_search N=[2], r=[3, 5]: {wall:.1f} s, best "
        f"{out['best_overrides']}, test r2 {r2}")
    if len(out["test_rows"]) != 2 or not all(v > 0.5 for v in r2):
        raise AssertionError(f"grid_search: test rows {out['test_rows']}")
    if not os.path.exists("build/synthetic_ablation_results_tt.csv"):
        raise AssertionError("grid_search wrote no ablation CSV")
    paths["drivers grid_search"] = (launches, seen)

    res, launches, seen, wall = _timed_run(device, lambda: image_sweep.run_config(IMAGE_POINT))
    log(f"[drivers] {card}: image_sweep.run_config {IMAGE_POINT['KERNEL_SIZE']}/"
        f"{IMAGE_POINT['KERNEL_STRIDE']} N={IMAGE_POINT['N']} R={IMAGE_POINT['R']} "
        f"CB={IMAGE_POINT['CB']} in process: {wall:.1f} s, {res['dataset']}, test accuracy "
        f"{res['test_accuracy']} %")
    if not res["test_accuracy"] > 10.0 or res["singular"]:
        raise AssertionError(f"image_sweep in process: {res}")
    paths["drivers image_sweep"] = (launches, seen)
    t0 = time.perf_counter()
    sub = image_sweep.run_config(IMAGE_POINT, timeout=IMAGE_SUBPROCESS_TIMEOUT,
                                 subprocess_mode=True)
    log(f"[drivers] {card}: image_sweep.run_config as a subprocess: "
        f"{time.perf_counter() - t0:.1f} s, {sub}")
    if sub.get("completed") is not True:
        raise AssertionError(f"image_sweep subprocess: {sub}")

    topology = flagship_layer(device, 0).topology
    drawn = visualize_topology(topology)
    text = drawn if isinstance(drawn, str) else topology_text(topology)
    if not text.startswith("topology:\n  column 0:"):
        raise AssertionError(f"visualize_topology: {text[:80]!r}")
    for ln in text.splitlines():
        log(f"[drivers] {ln}")
    torch.cuda.synchronize()
    return paths


# phase 13: the 2-D (data x model) mesh and the high / default precisions.
# (i) 4 gloo ranks sharing the card as a 2 x 2 mesh sweep the flagship with
# its patches split over the model pair (25 a rank), in int8 and in f32, and
# once more in int8 on a 1-D mesh of the 4 ranks: a 2-D rank's Gram rows are
# the rows rank 2i + j holds there, so that swipe is the tight reference
# (the same quantisation blocks; J's f32 sums over the patches reordered);
# (ii) phase 12's minres conv-TT on the same mesh; (iii) the bf16x3 product
# and swipes at the high and default precisions, card against CPU.
MESH2D = (2, 2)
MESH2D_LABELS = ("patches",)
# the 2-D int8 swipe's params against the 4-rank 1-D int8 swipe's, in
# test_parallel.py's measure (|d| / (1 + |want|)). The two hold the same
# rows and quantisation blocks a rank; only J's f32 sums over the patches
# run in another order, and the int8 swipe carries the codes those flip
# through its chained solves: 0.0162 on an H100 (PERF.md §6),
# against 0.045 from one process; predicted ~5e-3 before that reading
MESH2D_INT8_1D_TOL = 2.5e-2
# matmul(..., "high") against float64 of the operands as given, over
# sum|a||b| per entry: bf16x3 drops lo·lo and lo's rounding, about 2^-17 of
# each product, which average out over a sum (8.7e-7 on the CPU at K = 400,
# tests/test_torch_aux.py); the single-pass product ("default") must exceed
# the bound. Shapes (m, k, n): a 1,024-row chunk's packed prediction of A2,
# and a column strip of a 2,048-row chunk's rhs product gᵀJt
HIGH_PRODUCT_BOUND = 2.0 ** -18
HIGH_SHAPES = ((1024 * 9, 16200, 1), (1, 2048 * 9, 2048))
# phase 6's conv-TT and data for the precisions' card-against-CPU swipes:
# the flagship's widths on the CPU's plain int8 Gram take minutes a node
PRECISION_TOL = {"int8, high aux": 2e-2, "precision default": 2e-2, "precision high": 1e-4}


def mesh2d_rank():
    """One rank of phase 13 (i)-(ii): the flagship swipe in int8 and f32 on
    the 2 x 2 mesh (patches over "model"), the int8 swipe on the 4-rank data
    mesh, the minres swipe on the 2 x 2 mesh. Returns each run's
    _mesh_sweep and the rank's peak memory."""
    import torch
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    from tensornetworksfork_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(4, axis=("data", "model"), shape=MESH2D)
    flat = pmesh.make_mesh(4)
    out = {}
    X, y = flagship_data(SLICE_SAMPLES, 0, mesh.device)
    for tier in MESH_TIERS:
        torch.cuda.reset_peak_memory_stats()
        out[f"flagship {tier}"] = _mesh_sweep(mesh, flagship_layer(mesh.device, 0),
                                              XEBregman(w=1.0), SLICE_CONFIG, X, y,
                                              SLICE_TIERS[tier], MESH2D_LABELS)
        torch.cuda.synchronize()
        out[f"flagship {tier}"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["flagship int8, 1-D"] = _mesh_sweep(flat, flagship_layer(mesh.device, 0),
                                            XEBregman(w=1.0), SLICE_CONFIG, X, y,
                                            SLICE_TIERS["int8"])
    del X, y
    layer, X, y = mesh_minres_data(mesh.device)
    out["minres"] = _mesh_sweep(mesh, layer, XEBregman(w=1.0), MESH_MINRES_CONFIG, X, y,
                                SLICE_TIERS["f32"], MESH2D_LABELS)
    return out


def run_mesh2d(device, card: str, single):
    """Phase 13 (i)-(ii): 4 gloo ranks on the one card as a 2 x 2 data x
    model mesh (parallel.launch). The flagship's f32 params held to phase
    4's (`single`) at 5e-3, its int8 params at 5e-2 and to the 4-rank data
    mesh's int8 swipe at MESH2D_INT8_1D_TOL; the minres swipe to one process
    at 5e-3, its iteration counts equal on all ranks; every rank's params
    bit-equal and every kernel of each path launched on every rank. Logs
    each rank's swipe wall time, peak memory and its collectives (calls,
    bytes, seconds, the staging copies' seconds, by kind). Returns {path:
    (launches of all ranks, shapes)}."""
    import torch
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    from tensornetworksfork_tpu_torch.parallel import mesh as pmesh
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    n = MESH2D[0] * MESH2D[1]
    t0 = time.perf_counter()
    ranks = pmesh.launch(mesh2d_rank, n, timeout=600, join_timeout=900)
    log(f"[mesh2d] {card}: {n} gloo ranks on one card as a {MESH2D[0]} x {MESH2D[1]} "
        f"data x model mesh (patches over model, {FLAGSHIP['P'] // MESH2D[1]} a rank), "
        f"spawned, run and joined in {time.perf_counter() - t0:.1f} s")
    layer, X, y = mesh_minres_data(device)
    single["minres"] = _mesh_sweep(None, layer, XEBregman(w=1.0), MESH_MINRES_CONFIG,
                                   X, y, SLICE_TIERS["f32"])["params"]
    del X, y
    need = {"flagship int8": FLAGSHIP_KERNELS["int8"], "flagship f32": FLAGSHIP_KERNELS["f32"],
            "flagship int8, 1-D": FLAGSHIP_KERNELS["int8"], "minres": ()}
    paths = {}
    for run, kernels in need.items():
        rs = [r[run] for r in ranks]
        if not all(r["ok"] for r in rs):
            raise AssertionError(f"mesh2d {run}: a rank reported a singular solve")
        for r in rs[1:]:
            for k in rs[0]["params"]:
                if not np.array_equal(rs[0]["params"][k], r["params"][k]):
                    raise AssertionError(f"mesh2d {run}: the ranks' {k} differ")
        if run.startswith("flagship int8"):
            worst = _params_within(f"mesh2d {run}", rs[0]["params"], single["flagship int8"],
                                   MESH_TOL["int8"])
        else:
            worst = _params_within(f"mesh2d {run}", rs[0]["params"], single[run],
                                   MESH_TOL["f32"])
        missing = [k for k in kernels for r in rs if r["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"mesh2d {run}: kernels never launched on a rank: {missing}")
        if run == "minres" and (not rs[0]["iters"]
                                or any(r["iters"] != rs[0]["iters"] for r in rs)):
            raise AssertionError(f"mesh2d minres: iterations differ over the ranks: "
                                 f"{[r['iters'] for r in rs]}")
        line = [f"[mesh2d] {card}: {run}: ranks bit-equal; params within {worst:.3g} of "
                f"the single process; swipe wall per rank "
                f"{[round(r['wall'], 3) for r in rs]} s"]
        if "peak_gib" in rs[0]:
            line.append(f"peak mem per rank {[round(r['peak_gib'], 2) for r in rs]} GiB")
        for kind in ("all_reduce", "all_to_all", "broadcast"):
            st = rs[0]["stats"][kind]
            line.append(f"{kind} on rank 0: {st['calls']} calls, "
                        f"{st['bytes'] / 2**30:.3f} GiB, {st['seconds']:.3f} s "
                        f"({st['bytes'] / max(st['seconds'], 1e-9) / 1e9:.2f} GB/s), staging "
                        f"copies {st['copy_seconds']:.3f} s")
        line.append(f"launches rank 0 {({k: v for k, v in rs[0]['launches'].items() if v})}"
                    + (f"; minres iterations {rs[0]['iters']}" if run == "minres" else ""))
        log("; ".join(line))
        launches = {k: sum(r["launches"][k] for r in rs) for k in rs[0]["launches"]}
        seen = set().union(*(r["seen"] for r in rs))
        name = "mesh2d " + run + (" (4 ranks)" if run.endswith("1-D") else " (2 x 2)")
        paths[name] = (launches, seen)
    tight = _params_within("mesh2d flagship int8 against the 4-rank 1-D int8 swipe",
                           ranks[0]["flagship int8"]["params"],
                           ranks[0]["flagship int8, 1-D"]["params"], MESH2D_INT8_1D_TOL)
    log(f"[mesh2d] {card}: the 2 x 2 int8 swipe's params within {tight:.3g} of the 4-rank "
        f"1-D int8 swipe's (bound {MESH2D_INT8_1D_TOL})")
    return paths


def check_high_products(device, card: str):
    """Phase 13 (iii): matmul(..., "high") on the card (three bf16 products
    with f32 outputs) against its CPU plain version, and against float64 of
    the operands as given: within HIGH_PRODUCT_BOUND of sum|a||b| per entry,
    which the single-pass product ("default", the lo terms dropped) must
    exceed, and the card's within it of the CPU's; at the flagship's
    packed-prediction and rhs shapes."""
    import torch
    from tensornetworksfork_tpu_torch.core.contract import matmul
    rng = np.random.default_rng(7)
    for m, k, n in HIGH_SHAPES:
        a = torch.tensor(rng.standard_normal((m, k)).astype(np.float32))
        b = torch.tensor(rng.standard_normal((k, n)).astype(np.float32))
        exact = a.double() @ b.double()
        size = a.double().abs() @ b.double().abs()
        card_high = matmul(a.to(device), b.to(device), "high").cpu()
        cpu_high = matmul(a, b, "high")
        errs = {name: float(((v.double() - want).abs() / size).max())
                for name, v, want in (
                    ("card high", card_high, exact), ("cpu high", cpu_high, exact),
                    ("card default", matmul(a.to(device), b.to(device), "default").cpu(),
                     exact),
                    ("card against cpu", card_high, cpu_high.double()))}
        log(f"[precision] {card}: matmul high ({m} x {k}) @ ({k} x {n}): error over "
            f"sum|a||b|, against float64 unless named: "
            + ", ".join(f"{nm} {v:.3g}" for nm, v in errs.items())
            + f" (bound {HIGH_PRODUCT_BOUND:.3g}; card default must exceed it)")
        if not all(v <= HIGH_PRODUCT_BOUND for nm, v in errs.items() if nm != "card default"):
            raise AssertionError(f"matmul high is off by {errs}")
        if errs["card default"] <= HIGH_PRODUCT_BOUND:
            raise AssertionError("the single-pass product passes the bf16x3 bound, so the "
                                 "check cannot see the lo terms")


def run_precisions(device, card: str, single):
    """Phase 13 (iii): the flagship swipe (S=8,192) in the int8 Gram tier
    with TNF_AUX_PRECISION=high on the card (K1, K2, K3, K10 launched; loss
    lowered; params within 5e-2 of phase 4's int8 swipe, which differs only
    in the aux products' precision); then, card against CPU on phase 6's
    conv-TT (S=96: the CPU's plain int8 Gram at the flagship's widths takes
    minutes a node), that tier and swipes of networks built at
    precision "default" and "high" (TNF_PRECISION's counterpart; every
    contraction at that precision, the aux ones following it), each held
    to PRECISION_TOL of max|pred|. Returns {path: (launches, shapes)}."""
    import torch
    from tensornetworksfork_tpu_torch.core.engine import Network
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman
    X, y = flagship_data(SLICE_SAMPLES, 0, device)
    layer = flagship_layer(device, 0)
    loss_fn = XEBregman(w=1.0)
    loss0 = float(loss_fn(layer.forward_batch(X, BATCH), y, only_loss=True).mean())
    tier = dict(TNF_GRAM_DTYPE="int8", TNF_AUX_PRECISION="high")
    sweeper = Sweeper(layer.network, loss_fn, SweepConfig(**SLICE_CONFIG))
    with env(**tier):
        (params, ok), launches, seen, wall = _timed_run(
            device, lambda: sweeper.run([layer.params], X, y))
    layer.params = params[0]
    loss1 = float(loss_fn(layer.forward_batch(X, BATCH), y, only_loss=True).mean())
    got = {k: v.cpu().numpy() for k, v in params[0].items()}
    worst = _params_within("flagship int8 with the high aux tier", got,
                           single["flagship int8"], MESH_TOL["int8"])
    log(f"[precision] {card}: flagship int8 swipe with TNF_AUX_PRECISION=high: wall "
        f"{wall:.3f} s, ok={ok}, loss {loss0:.6f} -> {loss1:.6f}, params within {worst:.3g} "
        f"of phase 4's int8 swipe (f32 aux), launches "
        f"{({k: v for k, v in launches.items() if v})}")
    if not ok or not loss1 < loss0:
        raise AssertionError(f"flagship int8 high-aux swipe: ok={ok}, loss {loss0} -> {loss1}")
    missing = [k for k in FLAGSHIP_KERNELS["int8"] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"flagship int8 high-aux swipe never launched {missing}")
    del X, y

    rng = np.random.default_rng(1)
    S, P, pp, C = 96, 6, 5, 3
    Xn = rng.standard_normal((S, P, pp)).astype(np.float32)
    yn = np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]
    runs = {"int8, high aux": (dict(TNF_GRAM_DTYPE="int8", TNF_AUX_PRECISION="high"), None),
            "precision default": (dict(TNF_GRAM_DTYPE="f32"), "default"),
            "precision high": (dict(TNF_GRAM_DTYPE="f32"), "high")}
    for name, (tier_env, precision) in runs.items():
        outs = {}
        for dev in ("cpu", device):
            with env(**{"TNF_PACKED_SYRK_MIN_D": 1, "TNF_AUX_PRECISION": "", **tier_env}):
                if precision is not None:
                    os.environ.pop("TNF_AUX_PRECISION")  # follow the network's
                small = TensorConvolutionTrainLayer(4, 4, P, pp, output_shape=(C,),
                                                    convolution_bond=2, seed=0, device=dev)
                net = Network(small.topology, device=dev, use_kernels=True,
                              precision=precision)
                if net.aux_precision != (precision or "high"):
                    raise AssertionError(f"{name}: aux precision {net.aux_precision}")
                Xd, yd = torch.tensor(Xn, device=dev), torch.tensor(yn, device=dev)
                params, ok = Sweeper(net, XEBregman(1.0), SweepConfig(
                    num_swipes=1, batch_size=48, method="ridge_cholesky", eps=5.0,
                    eps_decay=0.25)).run([small.params], Xd, yd)
                if not ok:
                    raise AssertionError(f"{name} swipe on {dev} failed")
                outs[dev] = net.forward(params[0], Xd).cpu()
        err = float((outs[device] - outs["cpu"]).abs().max())
        scale = float(outs["cpu"].abs().max())
        log(f"[precision] {card}: {name} swipe (phase 6's conv-TT): card against CPU "
            f"max|d pred| {err:.3g} (max|pred| {scale:.3g}, rtol {PRECISION_TOL[name]})")
        if not err <= PRECISION_TOL[name] * scale:
            raise AssertionError(f"{name}: card and CPU differ by {err}")
    return {"flagship int8, high aux": (launches, seen)}


# phase 14: the kernel baselines, libsvm's SMO (models/_libsvm.py) and
# sklearn's Gaussian processes (models/_gp.py) written out in torch, on the
# tabular CLI's six tables at their full size (experiments/kernel_baselines.py)
# card against CPU: the SVM's iterates are libsvm's arithmetic on both (each
# kernel entry rounded to float32, one float64 op a kernel launch, no fused
# multiply-add), so they match unless the card's exp rounds an entry to the
# other float32 neighbour, which would move the solution within the solver's
# tol (1e-3); labels must be equal
KB_SVM_DEC_ATOL = 1e-3
# GP regression card against CPU: theta (log c, log length_scale), the
# log-marginal likelihood relative, the predictions over max|pred|. The
# synthetic table interpolates a noiseless polynomial (alpha 1e-10, lml
# ~ +17,600): its Cholesky is ill-conditioned, and sklearn against the
# port on the CPU already differ by 1e-5 in theta and 4e-6 in lml
KB_GPR_THETA_ATOL = 1e-3
KB_GPR_LML_RTOL = 1e-4
KB_GPR_PRED_RTOL = 1e-4
# GP classification card against CPU: no optimiser (the kernel is fixed);
# B = I + W^1/2 K W^1/2 is well conditioned (eigenvalues >= 1)
KB_GPC_PROBA_ATOL = 1e-9
KB_GPC_LML_RTOL = 1e-10
# a GP classifier with free hyperparameters (phase 14 (v)) card against
# CPU: its P(class 1) as both fit it, and at one θ (the CPU's mode search
# rerun at the card's θ: the devices' arithmetic alone), each within
# KB_GPC_PROBA_ATOL but where a cell has its own bound here. breast_cancer's
# Matern 1.5 fit reaches k(x, x) = 4,445 and cond(B) = 2.7e4, and the
# latent mean K*ᵀ(y - π) carries the devices' rounding of π at K's scale:
# on an NVIDIA H100 80GB HBM3 at 700 W the card and the CPU part by 5.3e-9
# at one θ, and L-BFGS-B's two paths (θ 1.41e-9 apart) add 6.65e-9 of the
# other sign, 1.35e-9 in all (studies/gpc_card_cpu_study.py). Its bound is
# the two parts added in one sign, 1.2e-8, with a margin of 1.7
KB_GPC_FITTED_PROBA_ATOL = {("matern 1.5", "breast_cancer"): 2e-8}
# sklearn's kernel objects card against CPU: K, ∂K/∂θ and diag over their
# max (float64 elementwise functions, a few ulp apart between the devices)
KB_KERNEL_RTOL = 1e-12


def _kb_timed(device, fn):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_kernel_baselines(device, card: str) -> dict:
    """Phase 14: (i) train_tabular.run(model_type="svm") on each of its six
    tables on the card and with device="cpu": decision values within
    KB_SVM_DEC_ATOL, labels, SMO iterations and support vectors equal; (ii)
    GaussianProcessWrapper regression on diabetes and synthetic and
    classification on iris, wine, breast_cancer and digits, card against
    CPU; (iii) every val/test metric of the card's runs held to sklearn's
    (results/kernel_baselines.json: accuracy within one row, rmse within
    kernel_baselines.RMSE_RTOL); (iv) run_kernel_baseline_options; (v)
    run_gp_kernel_objects; (vi) run_kernel_options_more. Prints
    each fit's seconds on both, the SMO iterations and support vectors per
    pair, the L-BFGS evaluations and the Newton iterations. Returns the
    card's metrics."""
    import torch
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    from tensornetworksfork_tpu_torch.experiments import train_tabular
    from tensornetworksfork_tpu_torch.models.baselines import GaussianProcessWrapper
    from tensornetworksfork_tpu_torch.utils.config import RunConfig
    cpu = torch.device("cpu")
    with open(kb.REFERENCE) as f:
        ref = json.load(f)
    got = {"svm": {}, "gp": {}}
    t14 = time.perf_counter()

    # (i) the SVM through the CLI: build_model wrapped to keep the model and
    # time its fit
    built = []
    build = train_tabular.build_model

    def keep(cfg, input_dim):
        m = build(cfg, input_dim)
        fit = m.fit

        def timed_fit(*a, **k):
            out, s = _kb_timed(m.device, lambda: fit(*a, **k))
            built.append((m, s))
            return out
        m.fit = timed_fit
        return m
    train_tabular.build_model = keep
    try:
        for name in kb.TABLES:
            data, task = kb.table(name)
            X = np.concatenate([data["X_val"], data["X_test"]])
            runs = {}
            for dev in (device, cpu):
                res = train_tabular.run(RunConfig(dataset=name, model_type="svm",
                                                  device=str(dev), verbose=0))
                m, fit_s = built[-1]
                dec = m.model_.decision(m._x(X)).cpu().numpy()
                runs[dev.type] = (res, m, fit_s, dec, m.predict(X))
            (res, m, fit_s, dec, lab), (_, mc, cpu_s, dec_c, lab_c) = runs["cuda"], runs["cpu"]
            d = float(np.abs(dec - dec_c).max())
            sv_pair = (m.model_.coef != 0).sum(0).tolist()
            passes = max(m.n_iter_)
            log(f"[kernel baselines] {card}: svm {name} ({task}, "
                f"{len(data['X_train'])} x {data['X_train'].shape[1]} training rows, "
                f"{len(m.n_iter_)} problem(s)): fit {fit_s:.3f} s on the card "
                f"({1e3 * fit_s / passes:.3f} ms a pass over {passes} passes), "
                f"{cpu_s:.3f} s on the CPU; SMO iterations {m.n_iter_}; support "
                f"vectors {sum(m.model_.n_support) or m.model_.coef.shape[0]} "
                f"(per pair {sv_pair}); max |d decision| card vs CPU {d:.3g} "
                f"(bound {KB_SVM_DEC_ATOL})")
            if not d <= KB_SVM_DEC_ATOL or not np.isfinite(dec).all() \
                    or (task == "classification" and not np.array_equal(lab, lab_c)):
                raise AssertionError(f"svm {name}: card and CPU part: iterations "
                                     f"{m.n_iter_} / {mc.n_iter_}, decision {d}")
            got["svm"][name] = {k: v for k, v in res.items()
                                if k.startswith(("val_", "test_"))}
    finally:
        train_tabular.build_model = build

    # (ii) the Gaussian processes on the same splits
    for name in kb.GP_TABLES:
        data, task = kb.table(name)
        X = torch.as_tensor(np.concatenate([data["X_val"], data["X_test"]]), dtype=torch.float64)
        fits = {}
        for dev in (device, cpu):
            w = GaussianProcessWrapper(task=task, device=str(dev))
            _, s = _kb_timed(dev, lambda: w.fit(data["X_train"], data["y_train"]))
            fits[dev.type] = (w, s)
        (w, card_s), (wc, cpu_s) = fits["cuda"], fits["cpu"]
        got["gp"][name] = kb.metrics(w, data, task)
        lml, lml_c = w.log_marginal_likelihood_value_, wc.log_marginal_likelihood_value_
        dl = abs(lml - lml_c) / abs(lml_c)
        if task == "regression":
            pred, pred_c = w.predict(X.numpy()), wc.predict(X.numpy())
            dt = float(np.abs(w.theta_ - wc.theta_).max())
            dp = float(np.abs(pred - pred_c).max() / np.abs(pred_c).max())
            log(f"[kernel baselines] {card}: gp regression {name} "
                f"({len(data['X_train'])} training rows): fit {card_s:.3f} s on the card, "
                f"{cpu_s:.3f} s on the CPU; L-BFGS evaluations {w.fit_.n_eval} (CPU "
                f"{wc.fit_.n_eval}); theta {w.theta_.tolist()} (CPU {wc.theta_.tolist()}, "
                f"|d| {dt:.3g}, bound {KB_GPR_THETA_ATOL}); lml {lml!r} (CPU {lml_c!r}, "
                f"rel {dl:.3g}, bound {KB_GPR_LML_RTOL}); predictions |d| / max|pred| "
                f"{dp:.3g} (bound {KB_GPR_PRED_RTOL})")
            ok = (dt <= KB_GPR_THETA_ATOL and dl <= KB_GPR_LML_RTOL
                  and dp <= KB_GPR_PRED_RTOL and np.isfinite(pred).all())
        else:
            proba, proba_c = w.predict_proba(X.numpy()), wc.predict_proba(X.numpy())
            same = np.array_equal(w.predict(X.numpy()), wc.predict(X.numpy()))
            dp = float(np.abs(proba - proba_c).max())
            log(f"[kernel baselines] {card}: gp classification {name} "
                f"({len(data['X_train'])} training rows, {len(w.fit_.n_iter)} binary "
                f"fit(s)): fit {card_s:.3f} s on the card, {cpu_s:.3f} s on the CPU; "
                f"Newton iterations {w.fit_.n_iter} (CPU {wc.fit_.n_iter}); lml {lml!r} "
                f"(CPU {lml_c!r}, rel {dl:.3g}, bound {KB_GPC_LML_RTOL}); max |d proba| "
                f"{dp:.3g} (bound {KB_GPC_PROBA_ATOL}); labels equal {same}")
            ok = (dp <= KB_GPC_PROBA_ATOL and dl <= KB_GPC_LML_RTOL and same
                  and np.isfinite(proba).all())
        if not ok:
            raise AssertionError(f"gp {name}: card and CPU part")

    # (iii) sklearn's metrics
    for fam in ("svm", "gp"):
        for name, mets in got[fam].items():
            log(f"[kernel baselines] {card}: {fam} {name}: "
                + ", ".join(f"{k} {v!r} (sklearn {ref[fam][name][k]!r})"
                            for k, v in mets.items()))
    bad = kb.compare(got, ref)
    log(f"[kernel baselines] {card}: against {kb.REFERENCE} (sklearn {ref['sklearn']}; "
        f"accuracy within one row, rmse within {kb.RMSE_RTOL} relative): "
        f"{'all within' if not bad else bad}")
    if bad:
        raise AssertionError(f"kernel baselines part from sklearn's: {bad}")
    got["options"] = run_kernel_baseline_options(device, card)
    got["kernels"] = run_gp_kernel_objects(device, card)
    got["more"] = run_kernel_options_more(device, card)
    log(f"[kernel baselines] {card}: phase 14 took {time.perf_counter() - t14:.1f} s")
    return got


def run_kernel_baseline_options(device, card: str) -> dict:
    """Phase 14 (iv): each of the wrappers' sklearn options
    (kernel_baselines.OPTIONS: SVC class_weight="balanced" and break_ties on
    wine, digits and iris; GPR with 3 restarts from random_state=0 on
    diabetes; GPC one_vs_one and warm_start on iris, wine and digits)
    fitted on the card and on the CPU and held card against CPU at phase
    14's bounds: the SVM's pair decision values within KB_SVM_DEC_ATOL and
    its labels equal; GPR theta, lml and predictions within the KB_GPR
    bounds (each run's -lml and the run kept printed); GPC's pairs' (or
    classes') P(class 1), one_vs_one's decision values and warm_start's
    probabilities within KB_GPC_PROBA_ATOL, the lml within KB_GPC_LML_RTOL,
    labels equal. Every val/test metric of the card's fits held to
    sklearn's (results/kernel_baselines_options.json). Prints each fit's
    seconds on both, SMO iterations, L-BFGS evaluations and Newton
    iterations. Returns the card's metrics."""
    import torch
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    cpu = torch.device("cpu")
    with open(kb.OPTIONS_REFERENCE) as f:
        ref = json.load(f)
    got = {}
    for option, (fam, params, tables) in kb.OPTIONS.items():
        got[option] = {}
        for name in tables:
            data, task = kb.table(name)
            X = np.concatenate([data["X_val"], data["X_test"]])
            fits = {}
            for dev in (device, cpu):
                w = kb.option_model(option, task, str(dev))
                _, sec = _kb_timed(dev, lambda: w.fit(data["X_train"], data["y_train"]))
                fits[dev.type] = (w, sec)
            (w, card_s), (wc, cpu_s) = fits["cuda"], fits["cpu"]
            got[option][name] = kb.metrics(w, data, task)
            what = (f"[kernel baselines] {card}: {option} {name} ({task}, "
                    f"{len(data['X_train'])} training rows): fit {card_s:.3f} s on the "
                    f"card, {cpu_s:.3f} s on the CPU")
            if fam == "svm":
                dec = w.model_.decision(w._x(X)).cpu().numpy()
                dec_c = wc.model_.decision(wc._x(X)).cpu().numpy()
                d = float(np.abs(dec - dec_c).max())
                same = np.array_equal(w.predict(X), wc.predict(X))
                log(f"{what}; class weights {w.class_weight_.tolist()}; SMO iterations "
                    f"{w.n_iter_} (CPU {wc.n_iter_}); support vectors "
                    f"{w.model_.n_support}; max |d decision| card vs CPU {d:.3g} (bound "
                    f"{KB_SVM_DEC_ATOL}); labels equal {same}")
                ok = d <= KB_SVM_DEC_ATOL and np.isfinite(dec).all() and same
            elif task == "regression":
                f, fc = w.fit_, wc.fit_
                lml, lml_c = w.log_marginal_likelihood_value_, wc.log_marginal_likelihood_value_
                dl = abs(lml - lml_c) / abs(lml_c)
                pred, pred_c = w.predict(X), wc.predict(X)
                dt = float(np.abs(w.theta_ - wc.theta_).max())
                dp = float(np.abs(pred - pred_c).max() / np.abs(pred_c).max())
                log(f"{what}; L-BFGS evaluations {f.n_eval} (CPU {fc.n_eval}) over "
                    f"{len(f.optima)} runs, -lml of each "
                    f"{[float(v) for _, v in f.optima]} (CPU "
                    f"{[float(v) for _, v in fc.optima]}), run kept {f.chosen} (CPU "
                    f"{fc.chosen}); theta {w.theta_.tolist()} (|d| {dt:.3g}, bound "
                    f"{KB_GPR_THETA_ATOL}); lml {lml!r} (CPU {lml_c!r}, rel {dl:.3g}, bound "
                    f"{KB_GPR_LML_RTOL}); predictions |d| / max|pred| {dp:.3g} (bound "
                    f"{KB_GPR_PRED_RTOL})")
                ok = (dt <= KB_GPR_THETA_ATOL and dl <= KB_GPR_LML_RTOL
                      and dp <= KB_GPR_PRED_RTOL and np.isfinite(pred).all())
            else:
                Xs = w._x(X)
                p1, p1_c = w.fit_.proba(Xs).cpu().numpy(), wc.fit_.proba(wc._x(X)).numpy()
                lml, lml_c = w.log_marginal_likelihood_value_, wc.log_marginal_likelihood_value_
                dl = abs(lml - lml_c) / abs(lml_c)
                if w._one_vs_one:
                    out, out_c = w.decision_function(X), wc.decision_function(X)
                    held = "decision values"
                else:
                    out, out_c = w.predict_proba(X), wc.predict_proba(X)
                    held = "probabilities"
                dp = float(max(np.abs(p1 - p1_c).max(), np.abs(out - out_c).max()))
                same = np.array_equal(w.predict(X), wc.predict(X))
                newton = (f"{w.first_fit_.n_iter}, then from its f {w.fit_.n_iter}"
                          if params.get("warm_start") else f"{w.fit_.n_iter}")
                log(f"{what}; {len(w.fit_.n_iter)} binary fit(s); Newton iterations "
                    f"{newton}; lml {lml!r} (CPU "
                    f"{lml_c!r}, rel {dl:.3g}, bound {KB_GPC_LML_RTOL}); max |d| of the "
                    f"binary fits' P(class 1) and the {held} {dp:.3g} (bound "
                    f"{KB_GPC_PROBA_ATOL}); labels equal {same}")
                ok = (dp <= KB_GPC_PROBA_ATOL and dl <= KB_GPC_LML_RTOL and same
                      and np.isfinite(out).all())
            if not ok:
                raise AssertionError(f"{option} {name}: card and CPU part")
    for option, tables in got.items():
        for name, mets in tables.items():
            log(f"[kernel baselines] {card}: {option} {name}: "
                + ", ".join(f"{k} {v!r} (sklearn {ref['options'][option][name][k]!r})"
                            for k, v in mets.items()))
    bad = kb.compare_options(got, ref)
    log(f"[kernel baselines] {card}: options against {kb.OPTIONS_REFERENCE} (sklearn "
        f"{ref['sklearn']}; accuracy within one row, rmse within {kb.RMSE_RTOL} "
        f"relative): {'all within' if not bad else bad}")
    if bad:
        raise AssertionError(f"kernel baseline options part from sklearn's: {bad}")
    return got


# the kernel expressions phase 14 (v) holds card against CPU at the tables'
# sizes: each class, anisotropic length scales, "fixed" bounds, and the
# operators
KB_KERNEL_EXPRESSIONS = (
    "C(2.0) * RBF(1.5)", "RBF({ramp})", "Matern(0.7, nu=0.5)", "Matern(1.3, nu=1.5)",
    "Matern({ones}, nu=2.5)", "Matern(2.0, nu=inf)",
    "RationalQuadratic(length_scale=0.8, alpha=2.0)",
    "ExpSineSquared(length_scale=1.2, periodicity=3.0)",
    "DotProduct(sigma_0=1.0) ** 2 + WhiteKernel(1.0)",
    "C(1.0, 'fixed') * RBF(1.0) + WhiteKernel(0.5, 'fixed')",
)


def run_gp_kernel_objects(device, card: str) -> dict:
    """Phase 14 (v): sklearn's GP kernel objects on the card. (a) each of
    KB_KERNEL_EXPRESSIONS at diabetes's and breast_cancer's training rows,
    K, ∂K/∂θ and diag card against CPU within KB_KERNEL_RTOL ({ramp} and
    {ones} are per-feature length scales 1, 2, ... and 1, 1, ...); (b) every
    kernel_baselines.KERNEL_OPTIONS fit on the card and on the CPU: GPR θ,
    lml and predictions within the KB_GPR bounds, GPC each binary problem's
    θ within KB_GPR_THETA_ATOL, the lml within KB_GPC_LML_RTOL, labels
    equal, its P(class 1) (one-vs-one: the decision values too, else the
    probabilities) and its P(class 1) against the CPU's mode search at the
    card's θ within KB_GPC_PROBA_ATOL (KB_GPC_FITTED_PROBA_ATOL where a cell
    has its own); every val/test metric of the
    card's fits held to sklearn's (results/gp_kernels.json); (c) SVC
    probability=True on iris, wine and digits on the card: labels, decision
    values and SMO iterations equal to the default fit's. Prints each fit's
    seconds on both, L-BFGS evaluations and Newton passes. Returns the
    card's records."""
    import dataclasses

    import torch
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    from tensornetworksfork_tpu_torch.models import _gp
    from tensornetworksfork_tpu_torch.models.baselines import SVMClfWrapper
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    with open(kb.KERNELS_REFERENCE) as f:
        ref = json.load(f)
    # (a) the kernels themselves
    worst = 0.0
    for name in ("diabetes", "breast_cancer"):
        X = np.asarray(kb.table(name)[0]["X_train"], np.float64)
        n = X.shape[1]
        for expression in KB_KERNEL_EXPRESSIONS:
            k = kb.kernel_from_expression(expression.format(
                ramp=[float(i + 1) for i in range(n)], ones=[1.0] * n))
            out = []
            for dev in (device, cpu):
                Xd = torch.as_tensor(X, device=dev)
                K, G = k(Xd, eval_gradient=True)
                out.append((K, G, k(Xd[:50], Xd), k.diag(Xd)))
            for a, b in zip(*out):
                diff = float((a.cpu() - b).abs().max()) if b.numel() else 0.0
                scale = float(b.abs().max()) if b.numel() else 0.0
                err = diff / scale if scale > 0 else diff
                worst = max(worst, err)
                if not (err <= KB_KERNEL_RTOL and bool(torch.isfinite(a).all())):
                    raise AssertionError(f"kernel {expression} on {name}: card and CPU "
                                         f"differ by {err:.3g} of the max")
    log(f"[kernel baselines] {card}: GP kernel objects: {len(KB_KERNEL_EXPRESSIONS)} "
        f"kernels at diabetes's and breast_cancer's training rows, K, dK/dtheta and diag "
        f"card vs CPU within {worst:.3g} of their max (bound {KB_KERNEL_RTOL})")
    # (b) the fits
    got = {}
    for option, (expression, params, tables) in kb.KERNEL_OPTIONS.items():
        got[option] = {}
        for name in tables:
            data, task = kb.table(name)
            X = np.concatenate([data["X_val"], data["X_test"]])
            fits = []
            for dev in (device, cpu):
                w = kb.kernel_model(option, task, str(dev))
                _, sec = _kb_timed(dev, lambda: w.fit(data["X_train"], data["y_train"]))
                fits.append((w, sec))
            (w, card_s), (wc, cpu_s) = fits
            got[option][name] = kb.kernel_fit_record(w, data, task)
            lml, lml_c = w.log_marginal_likelihood_value_, wc.log_marginal_likelihood_value_
            dl = abs(lml - lml_c) / abs(lml_c)
            dt = float(np.abs(w.theta_ - wc.theta_).max())
            what = (f"[kernel baselines] {card}: kernel {expression}"
                    f"{' ' + str(params) if params else ''} on {name} "
                    f"({task}, {len(data['X_train'])} training rows): fit {card_s:.3f} s on "
                    f"the card, {cpu_s:.3f} s on the CPU")
            if task == "regression":
                pred, pred_c = w.predict(X), wc.predict(X)
                dp = float(np.abs(pred - pred_c).max() / np.abs(pred_c).max())
                log(f"{what}; L-BFGS evaluations {w.fit_.n_eval} (CPU {wc.fit_.n_eval}); "
                    f"theta {w.theta_.tolist()} (|d| {dt:.3g}, bound {KB_GPR_THETA_ATOL}); "
                    f"lml {lml!r} (CPU {lml_c!r}, rel {dl:.3g}, bound {KB_GPR_LML_RTOL}); "
                    f"predictions |d| / max|pred| {dp:.3g} (bound {KB_GPR_PRED_RTOL})")
                ok = (dt <= KB_GPR_THETA_ATOL and dl <= KB_GPR_LML_RTOL
                      and dp <= KB_GPR_PRED_RTOL and np.isfinite(pred).all())
            else:
                p1, p1_c = w.fit_.proba(w._x(X)).cpu().numpy(), wc.fit_.proba(wc._x(X)).numpy()
                if w._one_vs_one:
                    out, out_c = w.decision_function(X), wc.decision_function(X)
                    held = "decision values"
                else:
                    out, out_c = w.predict_proba(X), wc.predict_proba(X)
                    held = "probabilities"
                dp = float(max(np.abs(p1 - p1_c).max(), np.abs(out - out_c).max()))
                at_card = dataclasses.replace(w.fit_, fits=[
                    _gp.laplace_mode(f.X.cpu(), f.y.cpu(), f.kernel,
                                     int(wc.params["max_iter_predict"]))
                    for f in w.fit_.fits])
                da = float(np.abs(p1 - at_card.proba(wc._x(X)).numpy()).max())
                bound = KB_GPC_FITTED_PROBA_ATOL.get((option, name), KB_GPC_PROBA_ATOL)
                same = np.array_equal(w.predict(X), wc.predict(X))
                log(f"{what}; {len(w.kernels_)} binary problem(s), L-BFGS evaluations "
                    f"{w.fit_.n_eval} (CPU {wc.fit_.n_eval}), final Newton passes "
                    f"{w.fit_.n_iter} (CPU {wc.fit_.n_iter}); theta {w.theta_.tolist()} "
                    f"(|d| {dt:.3g}, bound {KB_GPR_THETA_ATOL}); lml {lml!r} (CPU {lml_c!r}, "
                    f"rel {dl:.3g}, bound {KB_GPC_LML_RTOL}); max |d| of the binary fits' "
                    f"P(class 1) and the {held} {dp:.3g}, P(class 1) against the CPU's "
                    f"at the card's theta {da:.3g} (bound {bound}); labels equal {same}")
                ok = (dt <= KB_GPR_THETA_ATOL and dp <= bound and da <= bound
                      and dl <= KB_GPC_LML_RTOL and same and np.isfinite(out).all())
            if not ok:
                raise AssertionError(f"kernel {option} {name}: card and CPU part")
    for option, tables in got.items():
        for name, rec in tables.items():
            want = ref["kernels"][option][name]
            log(f"[kernel baselines] {card}: kernel {option} {name}: "
                + ", ".join(f"{k} {v!r} (sklearn {want[k]!r})" for k, v in rec.items()))
    bad = kb.compare_kernels(got, ref)
    log(f"[kernel baselines] {card}: kernels against {kb.KERNELS_REFERENCE} (sklearn "
        f"{ref['sklearn']}; accuracy within one row, rmse within {kb.RMSE_RTOL['gp']} "
        f"relative): {'all within' if not bad else bad}")
    if bad:
        raise AssertionError(f"GP kernel fits part from sklearn's: {bad}")
    # (c) SVC probability=True fits the default model
    for name in ("iris", "wine", "digits"):
        data, _ = kb.table(name)
        X = np.concatenate([data["X_val"], data["X_test"]])
        fits = []
        for params in ({"probability": True, "random_state": 0}, {}):
            w = SVMClfWrapper(params, device=str(device))
            _, sec = _kb_timed(device, lambda: w.fit(data["X_train"], data["y_train"]))
            fits.append((w, sec, w.model_.decision(w._x(X)).cpu().numpy(), w.predict(X)))
        (w, s1, d1, l1), (w0, s0, d0, l0) = fits
        d = float(np.abs(d1 - d0).max())
        log(f"[kernel baselines] {card}: svm probability=True {name}: fit {s1:.3f} s on the "
            f"card (default {s0:.3f} s); SMO iterations {w.n_iter_} (default {w0.n_iter_}); "
            f"max |d decision| {d!r}; labels equal {np.array_equal(l1, l0)}")
        if not (w.n_iter_ == w0.n_iter_ and d == 0.0 and np.array_equal(l1, l0)):
            raise AssertionError(f"svm probability=True {name} is not the default fit")
    log(f"[kernel baselines] {card}: phase 14 (v) took {time.perf_counter() - t0:.1f} s")
    return got


# phase 14 (vi): the last kernel options card against CPU. kv against
# scipy's within KB_KV_RTOL relative (0 where scipy's underflows to 0); K
# within KB_KERNEL_RTOL of its max; a finite-difference gradient (ε = 1e-10
# over K's rounding, a few ulp apart between the devices) within
# KB_FD_GRAD_RTOL of its max; a fit through one (general-ν Matern,
# PairwiseKernel) at the CPU tests' bounds: θ within kb.FD_THETA_ATOL, the
# lml within kb.FD_LML_RTOL, predictions within KB_FD_PRED_RTOL x
# max|pred|, probabilities within KB_FD_PROBA_ATOL; the string kernel's
# (a user's numpy K, the same on both) at the KB_GPR / KB_GPC bounds; the
# SVM's Gram matrices are computed on the host, so its float32 entries are
# the same on both devices and the iterates must be equal
KB_KV_RTOL = 1e-13
KB_FD_GRAD_RTOL = 1e-4
KB_FD_PRED_RTOL = 1e-3
KB_FD_PROBA_ATOL = 1e-4
# the kernels (vi) holds card against CPU at diabetes's training rows
# (shifted to be non-negative for chi2). PairwiseKernel's sigmoid
# saturates there (K up to 1, max|∂K/∂θ| 0.011), so one ulp of K parts its
# finite difference by 2e-4 of that max: its reading sits at the bound
# (9.89e-5 on an NVIDIA H100 80GB HBM3 at 700 W)
KB_MORE_EXPRESSIONS = tuple(
    f"PairwiseKernel(gamma=0.3, metric='{m}')" for m in (
        "linear", "poly", "rbf", "laplacian", "sigmoid", "cosine", "chi2", "additive_chi2")) + (
    "Matern(1.1, nu=1.0)", "Matern({ones}, nu=0.75)", "Matern(1.6, nu=3.7)")


def _more_kernels(device, cpu):
    """(vi)(b): each pairwise function and each KB_MORE_EXPRESSIONS kernel
    card against CPU; the worst K and gradient gaps over their max, and the
    number of pairwise functions."""
    import torch
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    from tensornetworksfork_tpu_torch.models import _pairwise
    X = np.asarray(kb.table("diabetes")[0]["X_train"], np.float64)
    X = X - X.min(0)
    worst = {"K": 0.0, "grad": 0.0}

    def held(what, a, b, bound, key):
        diff = float((a.cpu() - b).abs().max()) if b.numel() else 0.0
        scale = float(b.abs().max()) if b.numel() else 0.0
        err = diff / scale if scale > 0 else diff
        worst[key] = max(worst[key], err)
        if not (err <= bound and bool(torch.isfinite(a).all())):
            raise AssertionError(f"{what}: card and CPU differ by {err:.3g} of the max")
    for metric in _pairwise.PAIRWISE_KERNEL_FUNCTIONS:
        a, b = (_pairwise.pairwise_kernels(torch.as_tensor(X, device=d), None, metric=metric)
                for d in (device, cpu))
        held(f"pairwise {metric}", a, b, KB_KERNEL_RTOL, "K")
    for expression in KB_MORE_EXPRESSIONS:
        k = kb.kernel_from_expression(expression.format(ones=[1.0] * X.shape[1]))
        out = []
        for d in (device, cpu):
            Xd = torch.as_tensor(X, device=d)
            K, G = k(Xd, eval_gradient=True)
            out.append((K, G, k(Xd[:40], Xd), k.diag(Xd)))
        for i, (a, b) in enumerate(zip(*out)):
            held(expression, a, b, KB_FD_GRAD_RTOL if i == 1 else KB_KERNEL_RTOL,
                 "grad" if i == 1 else "K")
    return worst, len(_pairwise.PAIRWISE_KERNEL_FUNCTIONS)


def run_kernel_options_more(device, card: str) -> dict:
    """Phase 14 (vi): the last kernel options. (a) kv(ν, x) on the card at
    kernel_baselines.KV_NUS x kv_grid() against scipy.special.kv and the
    reference's values, within KB_KV_RTOL; (b) `_more_kernels`; (c) every
    MORE_KERNEL_OPTIONS fit on the card and on the CPU (torch on one CPU
    thread beside nvcc): GP θ, lml, predictions or probabilities at the
    bounds above (each binary problem's θ), labels equal; SVM SMO iterations
    and support_ equal, decision values within KB_SVM_DEC_ATOL, labels
    equal; the string kernel's fitted kernel holds a HostKernel and its K
    lies on the card; every card record held to sklearn's
    (kernel_baselines.compare_more against results/gp_kernels_more.json).
    Prints each fit's seconds on both, L-BFGS evaluations, Newton passes and
    SMO iterations. Returns the card's records."""
    import scipy.special
    import torch
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    from tensornetworksfork_tpu_torch.models import _gp_kernels
    from tensornetworksfork_tpu_torch.models._special import kv
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    with open(kb.MORE_REFERENCE) as f:
        ref = json.load(f)
    # (a) kv
    x = kb.kv_grid()
    worst = 0.0
    for nu in kb.KV_NUS:
        got = kv(nu, torch.as_tensor(x, device=device)).cpu().numpy()
        for want in (scipy.special.kv(nu, x), np.asarray(ref["kv"]["values"][repr(nu)])):
            nz = want != 0
            err = float(np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz])))
            worst = max(worst, err)
            if not (err <= KB_KV_RTOL and np.array_equal(got == 0, want == 0)):
                raise AssertionError(f"kv({nu}) on the card parts from scipy's by {err:.3g}")
    log(f"[kernel baselines] {card}: kv on the card at {len(kb.KV_NUS)} orders x {x.size} "
        f"points (1e-12 to 700) against scipy {scipy.__version__} and the reference: "
        f"max relative {worst:.3g} (bound {KB_KV_RTOL}), zeros where scipy underflows equal")
    # (b) the kernels
    w, n_functions = _more_kernels(device, cpu)
    log(f"[kernel baselines] {card}: {len(KB_MORE_EXPRESSIONS)} kernels and the "
        f"{n_functions} pairwise functions at diabetes's training rows: "
        f"K and diag card vs CPU within {w['K']:.3g} of their max (bound {KB_KERNEL_RTOL}), "
        f"finite-difference dK/dtheta within {w['grad']:.3g} (bound {KB_FD_GRAD_RTOL})")
    # (c) the fits
    got = {}
    threads = torch.get_num_threads()
    for option, (fam, expression, _, tables, split) in kb.MORE_KERNEL_OPTIONS.items():
        got[option] = {}
        fd = "Matern" in expression or "Pairwise" in expression
        for name in tables:
            data, task = kb.more_table(option, name)
            X = data["X_test"]
            fits = []
            for dev in (device, cpu):
                m = kb.more_model(option, task, str(dev))
                torch.set_num_threads(1 if dev.type == "cpu" else threads)
                try:
                    _, sec = _kb_timed(dev, lambda: m.fit(data["X_train"], data["y_train"]))
                finally:
                    torch.set_num_threads(threads)
                fits.append((m, sec))
            (m, card_s), (mc, cpu_s) = fits
            got[option][name] = kb.more_fit_record(option, m, data, task)
            what = (f"[kernel baselines] {card}: {option} on {name} ({task}, {split}, "
                    f"{len(data['y_train'])} training rows): fit {card_s:.3f} s on the card, "
                    f"{cpu_s:.3f} s on the CPU")
            same = np.array_equal(m.predict(X), mc.predict(X)) or task == "regression"
            if fam == "svm":
                dec = kb.svm_decision(m, X, task)
                d = float(np.abs(dec - kb.svm_decision(mc, X, task)).max())
                ok = (m.n_iter_ == mc.n_iter_ and np.array_equal(m.support_, mc.support_)
                      and d <= KB_SVM_DEC_ATOL and same and np.isfinite(dec).all())
                log(f"{what}; SMO iterations {m.n_iter_} (CPU equal {m.n_iter_ == mc.n_iter_}), "
                    f"support vectors {len(m.support_)} (CPU equal "
                    f"{np.array_equal(m.support_, mc.support_)}); max |d decision| {d!r} "
                    f"(bound {KB_SVM_DEC_ATOL}); labels equal {same}")
            else:
                lml, lml_c = m.log_marginal_likelihood_value_, mc.log_marginal_likelihood_value_
                dl = abs(lml - lml_c) / abs(lml_c)
                dt = float(np.abs(m.theta_ - mc.theta_).max())
                if task == "regression":
                    pred, pred_c = m.predict(X), mc.predict(X)
                    dp = float(np.abs(pred - pred_c).max() / np.abs(pred_c).max())
                    pbound = KB_FD_PRED_RTOL if fd else KB_GPR_PRED_RTOL
                else:
                    pred, pred_c = m.predict_proba(X), mc.predict_proba(X)
                    dp = float(np.abs(pred - pred_c).max())
                    pbound = KB_FD_PROBA_ATOL if fd else KB_GPC_PROBA_ATOL
                tbound = kb.FD_THETA_ATOL if fd else KB_GPR_THETA_ATOL
                lbound = kb.FD_LML_RTOL if fd else (
                    KB_GPR_LML_RTOL if task == "regression" else KB_GPC_LML_RTOL)
                host = not fd and any(isinstance(k, _gp_kernels.HostKernel) for k in (
                    getattr(m.kernels_[0], "k1", None), getattr(m.kernels_[0], "k2", None)))
                on_card = m.kernels_[0](m._x(X[:3])).device == device
                ok = (dt <= tbound and dl <= lbound and dp <= pbound and same and on_card
                      and np.isfinite(pred).all() and (fd or host))
                evals = m.fit_.n_eval
                log(f"{what}; L-BFGS evaluations {evals} (CPU {mc.fit_.n_eval}); theta "
                    f"{m.theta_.tolist()} (|d| {dt:.3g}, bound {tbound}); lml {lml!r} (CPU "
                    f"{lml_c!r}, rel {dl:.3g}, bound {lbound}); "
                    f"{'predictions |d| / max|pred|' if task == 'regression' else 'max |d proba|'}"
                    f" {dp:.3g} (bound {pbound}); labels equal {same}"
                    + ("" if fd else f"; a HostKernel {host}, its K on the card {on_card}"))
            if not ok:
                raise AssertionError(f"{option} {name}: card and CPU part")
    for option, tables in got.items():
        for name, rec in tables.items():
            want = ref["options"][option][name]
            log(f"[kernel baselines] {card}: {option} {name}: "
                + ", ".join(f"{k} {v!r} (sklearn {want[k]!r})" for k, v in rec.items()
                            if k not in ("support", "decision")))
    bad = kb.compare_more(got, ref)
    log(f"[kernel baselines] {card}: last options against {kb.MORE_REFERENCE} (sklearn "
        f"{ref['sklearn']}; metrics at the GP and SVM bounds, theta within "
        f"{kb.FD_THETA_ATOL}, lml within {kb.FD_LML_RTOL}, support_ equal, decisions "
        f"within 1e-3): {'all within' if not bad else bad}")
    if bad:
        raise AssertionError(f"the last kernel options part from sklearn's: {bad}")
    log(f"[kernel baselines] {card}: phase 14 (vi) took {time.perf_counter() - t0:.1f} s")
    return got


# phases every run takes: the environment, the build, the kernel checks and
# the main path (phase 4's flagship swipes and phase 5's regression fit),
# whose launches the kernels line gives phase 3's entries
ALWAYS = (1, 2, 3, 4, 5)
# the phases whose outputs a phase takes: phase 4's params and walls, phase
# 5's estimator, phase 7's headline model and config
NEEDS = {11: (4, 5, 7), 12: (4,), 13: (4,)}
N_PHASES = 14


def parse_phases(spec):
    """The phases that a --phases value asks for ("1-10", "11-14", "3,7,14";
    None: all), with ALWAYS and, transitively, the phases each of them
    needs (NEEDS), in order."""
    if spec is None:
        want = set(range(1, N_PHASES + 1))
    else:
        want = set()
        for part in spec.split(","):
            lo, _, hi = part.strip().partition("-")
            a, b = int(lo), int(hi or lo)
            if not 1 <= a <= b <= N_PHASES:
                raise ValueError(f"--phases {spec!r}: {part!r} is not a range within "
                                 f"1-{N_PHASES}")
            want.update(range(a, b + 1))
    want.update(ALWAYS)
    todo = sorted(want)
    while todo:
        for p in NEEDS.get(todo.pop(), ()):
            if p not in want:
                want.add(p)
                todo.append(p)
    return sorted(want)


def main(argv=None) -> int:
    import argparse
    import threading

    import torch
    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch + CUDA port "
                                 "on one NVIDIA GPU.")
    ap.add_argument("--phases", default=None,
                    help="the phases to run, e.g. 1-10 or 11-14 or 3,14 (default: all); "
                         f"phases {ALWAYS} always run, and a phase runs the phases "
                         "whose outputs it takes")
    args = ap.parse_args(argv)
    phases = parse_phases(args.phases)
    start = time.perf_counter()

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
    log(f"[env] phases {phases}" + ("" if args.phases is None else
                                    f" (--phases {args.phases}, with phases {ALWAYS} "
                                    "and the phases they take outputs from)"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # the build: nvcc runs in subprocesses, beside phase 14 where that runs
    # (no Gram kernel runs there), else alone
    from tensornetworksfork_tpu_torch.ops.cuda import _build
    built = {}

    def build():
        t = time.perf_counter()
        try:
            built["path"] = _build.lib()._name
        except BaseException as err:  # raised in the main thread below
            built["error"] = err
        built["seconds"] = time.perf_counter() - t

    if 14 in phases:
        builder = threading.Thread(target=build, name="nvcc build")
        builder.start()
        t14 = time.perf_counter()
        run_kernel_baselines(device, smi)
        log(f"[env] phase 14 took {time.perf_counter() - t14:.1f} s, beside the build")
        builder.join()
    else:
        build()
    if "error" in built:
        raise built["error"]
    # per kernel: its name, registers, spills, and ptxas's warnings (C7517:
    # a wgmma serialised by an injected warpgroup.wait)
    ptxas = [ln for ln in _build.BUILD_INFO["log"].splitlines()
             if any(w in ln for w in ("Compiling entry", "registers", "spill", "arning"))]
    log(f"[build] {built['path']}: {built['seconds']:.2f} s "
        f"(nvcc {_build.BUILD_INFO['seconds']})")
    for ln in ptxas:
        log(f"[build] {ln.strip()}")

    t3 = time.perf_counter()
    kernels = check_kernels(device) + check_weighted_kernels(device)
    log(f"[env] phase 3 took {time.perf_counter() - t3:.1f} s")
    # each entry's launches: phase 3's from the main path's runs (below),
    # every later phase's from the run of the path its dtype names
    base, by_path = {}, {}
    # the paths' launches beside the kernels of the operand type each gives
    # them: bf16 J (int8 codes) in the fastest tier, f32 J in the others
    low, full = ("bf16", "int8"), ("f32",)
    paths = {}
    # every kernel is held once at a shape (K6 in f32 and K10 against
    # float64 too), unless a path times it there
    done = set()

    t4 = time.perf_counter()
    int8 = run_slice(device, "int8")
    slice32, slice16 = run_slice(device, "f32"), run_slice(device, "bf16")
    fastest = run_slice(device, "fastest")
    drift = abs(fastest["loss1"] - int8["loss1"]) / int8["loss1"]
    log(f"[slice] {smi}: fastest (bench.py's tier) {fastest['wall']:.3f} s, loss "
        f"{fastest['loss1']:.6f}; int8 with f32 aux {int8['wall']:.3f} s, loss "
        f"{int8['loss1']:.6f}; |d loss| / loss {drift:.3g} (bound {AUX_LOSS_RTOL})")
    if not drift <= AUX_LOSS_RTOL:
        raise AssertionError(f"the bf16 aux tier moved the swipe's loss by {drift:.3g}")
    # the flagship's int8 swipe (K10 on bf16 operands), its f32 swipe (K6
    # and K10 on f32 operands), its bf16 swipe (K6 on bf16 operands)
    flagship, flagship32 = int8["launches"], slice32["launches"]
    base.update({("retile_hmix", "bf16"): flagship["retile_hmix"],
                 ("retile_hmix", "f32"): flagship32["retile_hmix"],
                 ("quantize_tiled", "bf16"): flagship["quantize_tiled"],
                 ("gram_pair_q", "int8"): flagship["gram_pair_q"],
                 ("gram_pair", "bf16"): flagship["gram_pair"],
                 ("gram_pair_tiled", "f32"): flagship32["gram_pair_tiled"],
                 ("gram_pair_tiled", "bf16"): slice16["launches"]["gram_pair_tiled"],
                 ("gram_pair", "f32"): flagship32["gram_pair"]})
    paths["flagship fastest"] = (fastest["launches"], low)
    log(f"[env] phase 4 took {time.perf_counter() - t4:.1f} s")

    t5 = time.perf_counter()
    fit, own, fit8, reg = run_regression(device)
    # the regression fit, its own-out swipe (K11) and its int8 swipe (K3 at
    # the regression's chunk)
    base.update({**{(k, "f32"): fit[k] for k in REGRESSION_KERNELS},
                 ("own_out_gram", "f32"): own["own_out_gram"],
                 ("gram_pair_q", "int8, regression chunk"): fit8["gram_pair_q"]})
    log(f"[env] phase 5 took {time.perf_counter() - t5:.1f} s")

    if 6 in phases:
        t6 = time.perf_counter()
        check_reference(device)
        log(f"[env] phase 6 took {time.perf_counter() - t6:.1f} s")

    if 7 in phases:
        t7 = time.perf_counter()
        image, image_seen, headline, headline_config = run_image_trainer(device)
        digits, digits_seen = {}, {}
        for tier in ("reference", "fastest"):
            digits[tier], digits_seen[tier] = run_digits_gate(device, tier)
        # the kernels at every shape phase 7's paths gave them
        path_runs = {"train_image fastest": (image, image_seen, low),
                     "digits reference": (digits["reference"], digits_seen["reference"], full),
                     "digits fastest": (digits["fastest"], digits_seen["fastest"], low)}
        for path, (runs, seen, kind) in path_runs.items():
            kernels += check_path_shapes(device, path, seen, done)
            by_path[path] = runs
            paths[path] = (runs, kind)
        log(f"[env] phase 7 took {time.perf_counter() - t7:.1f} s, its shape checks "
            "included")

    if 8 in phases:
        t8 = time.perf_counter()
        check_f64_ladder(device)
        f64_solve_times(device, smi)
        fit64 = run_regression_f64(device, smi)
        check_krylov(device, card=smi)
        check_iterative_sweeps(device)
        t8d = time.perf_counter()
        cifar, _ = run_cifar_minres(device, smi)
        # the float64 fit (f32 operands), and the matrix-free CIFAR_minres
        # swipe, which launches none of the kernels
        paths["regression float64"] = (fit64, full)
        paths["train_image cifar_minres"] = (cifar, low + full)
        log(f"[env] phase 8 took {time.perf_counter() - t8:.1f} s, its headline "
            f"{time.perf_counter() - t8d:.1f} s")

    if 9 in phases:
        t9 = time.perf_counter()
        check_zoo_reference(device)
        zoo_width = run_zoo_width(device, smi)
        for path, (runs, seen) in zoo_width.items():
            kernels += check_zoo_shapes(device, f"zoo width {path}", seen, done)
            by_path[f"zoo width {path}"] = runs
            paths[f"zoo width {path}"] = (runs, full)
        zoo_table = run_zoo_table(device, smi)
        paths["zoo table"] = (zoo_table["launches"], full)
        log(f"[env] phase 9 took {time.perf_counter() - t9:.1f} s, its table "
            f"{zoo_table['wall']:.1f} s")

    def check_shapes(grow):
        """Every kernel at every shape each of these paths gave it; their
        launches beside the kernels of their operand type: grow_cart in the
        fastest tier, the meshes' int8 swipes and the high aux tier's swipe
        in bf16 J (int8 codes), every other path of phases 10-13 in f32."""
        nonlocal kernels
        for path, (runs, seen) in grow.items():
            kernels += check_growth_shapes(device, path, seen, done)
            by_path[path] = runs
            paths[path] = (runs, low if path in (
                "grow_cart fastest", "mesh flagship int8 (2 ranks)",
                "mesh2d flagship int8 (2 x 2)", "mesh2d flagship int8, 1-D (4 ranks)",
                "flagship int8, high aux") else full)

    if 10 in phases:
        t10 = time.perf_counter()
        grow = {f"grow_cart {tier}": run_grow_cart_path(device, tier, smi)
                for tier in ("fastest", "f32")}
        grow.update(run_dmrg_path(device, smi))
        grow.update(run_batch_paths(device, smi))
        grow.update(check_phase10_rest(device, smi))
        t10c = time.perf_counter()
        check_shapes(grow)
        log(f"[env] phase 10 took {time.perf_counter() - t10:.1f} s, its shape checks "
            f"{time.perf_counter() - t10c:.1f} s")

    if 11 in phases:
        t11 = time.perf_counter()
        test_split, phase11 = run_serving(device, smi, headline, headline_config, reg)
        phase11.update(run_native_stream(device, smi))
        check_checkpoint(device, headline, headline_config, test_split)
        record_flops(device, smi, {"int8": int8["wall"], "bf16": slice16["wall"],
                                   "f32": slice32["wall"], "fastest": fastest["wall"]})
        phase11.update(check_trace(device))
        phase11.update(run_digits_flat_gate(device, smi))
        t11c = time.perf_counter()
        check_shapes(phase11)
        log(f"[env] phase 11 took {time.perf_counter() - t11:.1f} s, its shape checks "
            f"{time.perf_counter() - t11c:.1f} s")

    single = {"flagship int8": int8["params"], "flagship f32": slice32["params"]}
    if 12 in phases:
        t12 = time.perf_counter()
        phase12 = run_mesh(device, smi, single)
        t12d = time.perf_counter()
        phase12.update(run_drivers(device, smi))
        t12c = time.perf_counter()
        check_shapes(phase12)
        log(f"[env] phase 12 took {time.perf_counter() - t12:.1f} s: the mesh "
            f"{t12d - t12:.1f} s, the drivers {t12c - t12d:.1f} s, the shape checks "
            f"{time.perf_counter() - t12c:.1f} s")

    if 13 in phases:
        t13 = time.perf_counter()
        phase13 = run_mesh2d(device, smi, single)
        t13d = time.perf_counter()
        check_high_products(device, smi)
        phase13.update(run_precisions(device, smi, single))
        t13c = time.perf_counter()
        check_shapes(phase13)
        log(f"[env] phase 13 took {time.perf_counter() - t13:.1f} s: the 2-D mesh "
            f"{t13d - t13:.1f} s, the precisions {t13c - t13d:.1f} s, the shape checks "
            f"{time.perf_counter() - t13c:.1f} s")

    def entry_launches(k):
        path = k["dtype"].split(", ", 1)[-1]
        return by_path[path][k["name"]] if path in by_path else base[k["name"], k["dtype"]]

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
    log(f"[env] chip_smoke.py took {time.perf_counter() - start:.1f} s, the build included "
        f"(phases {phases})")
    print(json.dumps({"kernels": [
        {"name": k["name"], "dtype": k["dtype"], "route": "cuda",
         "source": f"{csrc}/{source_file(k['name'])}",
         "replaces": f"{pallas}:{sources[k['name']]}",
         "launches": entry_launches(k),
         "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
         "bound_type": k["bound"][2] + (", 3 products a multiply-add" if k["bound"][2] == "tf32" else ""),
         "library_ms": k["library_ms"],
         **({"int_mm_ms": k["int_mm_ms"]} if "int_mm_ms" in k else {}),
         # launches of this slice's paths, each run with the counts reset,
         # under the kernels whose operand type the path gives them
         "launches_by_path": {
             path: counts[k["name"]] for path, (counts, kind) in paths.items()
             if k["dtype"].split(",")[0] in kind}}
        for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
