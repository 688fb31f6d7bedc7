"""Gram-path kernels: Python wrappers, plain versions, tile plan and finishers.

Port of tensornetworksfork_tpu/ops/pallas/gram.py: every Pallas kernel of
the JAX package has a counterpart here. Each wrapper takes the plain PyTorch
version (`<fn>_plain`, beside it) only for tensors that lie on the CPU; for
CUDA tensors it launches its kernel from `csrc/gram.cu` or raises — there is
no fallback. Each wrapper checks device, dtype, shape and contiguity, raises
when the launch reports an error, and adds one to `LAUNCHES[<name>]` per
kernel launch.

Layouts differ from the TPU's where the TPU's were schedule choices: the
class-major operands are row-major (C*S, Dp) matrices instead of (n, rows,
tile) slabs, and the Gram kernels write the upper triangle of a (Dp, Dp)
matrix. What fixes the numbers is kept: the reference plan's 512-wide slabs
(padding D to Dp and, for int8, which slab pairs are "far"), the 2048-row
quantisation blocks, the class-major row order and the bf16 rounding of K.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

# Launch counts per kernel, incremented where a wrapper launches its kernel
# and nowhere else (plain versions do not count). gram_pair counts its flat
# launches (K10) under "gram_pair" and those into a carry (K6) under
# "gram_pair_tiled".
LAUNCHES = {"retile_hmix": 0, "quantize_tiled": 0, "gram_pair_q": 0,
            "gram_pair": 0, "gram_pair_tiled": 0, "retile_rows": 0,
            "weighted_gram_tiled": 0, "weighted_gram": 0, "own_out_gram": 0}

TILE = 512    # the reference plan's D slab (plan_tiles): padding and band map
BLOCK = 2048  # the reference plan's sample block: int8 quantisation rows


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gram_dtype() -> Optional[torch.dtype]:
    """Gram operand dtype (TNF_GRAM_DTYPE=f32|bf16|int8): bf16 for the bf16
    and int8 tiers (J storage, K build, rhs and predictions run bf16
    operands with f32 accumulation either way), None for f32."""
    name = os.environ.get("TNF_GRAM_DTYPE", "f32").lower()
    if name not in ("f32", "bf16", "int8"):
        raise ValueError(f"TNF_GRAM_DTYPE must be f32, bf16 or int8, not {name!r}")
    return torch.bfloat16 if name in ("bf16", "int8") else None


def gram_quant() -> bool:
    """int8-quantised Gram operands on the tiled route (TNF_GRAM_DTYPE=int8)."""
    return os.environ.get("TNF_GRAM_DTYPE", "f32").lower() == "int8"


def plan_tiles(D: int) -> Tuple[int, int, int, int]:
    """(tile, block, n, Dp) of the tiled route, as the reference plans it at
    its defaults: 512-wide slabs, D padded to Dp = n * 512, 2048-row blocks."""
    n = (D + TILE - 1) // TILE
    return TILE, BLOCK, n, n * TILE


def quant_block(rows: int, block: int = BLOCK) -> int:
    """Quantisation block rows: `block` if rows >= block, else rows rounded
    up to 32 (the reference's rule, gram.py quantize_tiled)."""
    return block if rows >= block else ((rows + 31) // 32) * 32


# ------------------------------------------------------------------ checks
def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on mixed devices: {sorted(devs)}")
    dev = devs.pop()
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {dev!r}")
    return dev == "cpu"


def _check(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(status: int, kernel: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {status}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ----------------------------------------------------------- pair tables
@functools.lru_cache(maxsize=64)
def _pair_table_np(ntiles: int, slab_tiles: int, band: bool) -> np.ndarray:
    """(npairs, 3) int32 rows (ti, tj, swap) of the kernel tiles to compute.

    slab_tiles = 0: every tile, natural orientation (K11's whole blocks).
    slab_tiles = 1: the exact upper triangle ti <= tj, natural orientation.
    slab_tiles > 1 (int8): every tile whose 512-slab pair (p, q) has p <= q,
    the diagonal slabs whole, as the reference's int8 kernels compute them;
    with `band`, slab pairs at circular distance > n/2 get swap = 1 — the
    reference band schedule computes those as Q1_qᵀQ2_p (gram.py
    _make_band_kernel_q), and the swap reproduces that rounding."""
    if slab_tiles == 0:
        ti, tj = np.divmod(np.arange(ntiles * ntiles), ntiles)
        return np.stack([ti, tj, 0 * ti], 1).astype(np.int32)
    nslab = ntiles // slab_tiles
    rows = []
    for ti in range(ntiles):
        p = ti // slab_tiles
        for tj in range(ntiles):
            q = tj // slab_tiles
            if (slab_tiles == 1 and ti > tj) or p > q:
                continue
            rows.append((ti, tj, int(band and 2 * (q - p) > nslab)))
    return np.asarray(rows, np.int32).reshape(-1, 3)


_TABLES = {}


def _pair_table(ntiles: int, slab_tiles: int, band: bool,
                device: torch.device) -> torch.Tensor:
    key = (ntiles, slab_tiles, band, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(
            _pair_table_np(ntiles, slab_tiles, band)).to(device)
    return _TABLES[key]


# ---------------------------------------------------------------- K1
def retile_hmix(J3: torch.Tensor, H: torch.Tensor, Dp: int):
    """Fused class-major retile + Hessian class mixing.

    J3 (S, C, D) packed Jacobian (bf16 or f32), H (S, C, C) f32. Returns
    (Jt, Kt), both (C*S, Dp) in J3's dtype, rows class-major (row c*S + s),
    columns zero-padded from D to Dp, with Kt[c*S+s] = sum_e H[s,c,e] J[s,e]
    mixed in f32 in order e = 0..C-1 and rounded once.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:retile_hmix
    (_make_retile_hmix_kernel). Bound on the card: memory — it reads J once
    and writes 2x its bytes; one thread per (s, d) column keeps the C class
    values in registers, so J is read exactly once and both outputs are
    written in coalesced rows."""
    S, C, D = J3.shape
    if _on_cpu(J3, H):
        return retile_hmix_plain(J3, H, Dp)
    _check(J3, "J3", (torch.bfloat16, torch.float32), 3)
    _check(H, "H", (torch.float32,), 3)
    if tuple(H.shape) != (S, C, C):
        raise ValueError(f"H shape {tuple(H.shape)} != {(S, C, C)}")
    if Dp < D or C > 16:
        raise ValueError(f"retile_hmix: need Dp >= D and C <= 16 (D={D}, Dp={Dp}, C={C})")
    Jt = torch.empty((C * S, Dp), dtype=J3.dtype, device=J3.device)
    Kt = torch.empty_like(Jt)
    fn = (_build.lib().tnf_retile_hmix_bf16 if J3.dtype == torch.bfloat16
          else _build.lib().tnf_retile_hmix_f32)
    _raise_on(fn(J3.data_ptr(), H.data_ptr(), Jt.data_ptr(), Kt.data_ptr(),
                 S, C, D, Dp, _stream()), "retile_hmix")
    LAUNCHES["retile_hmix"] += 1
    return Jt, Kt


def retile_hmix_plain(J3: torch.Tensor, H: torch.Tensor, Dp: int):
    S, C, D = J3.shape
    jf = J3.float()
    Hf = H.float()
    K = Hf[:, :, 0, None] * jf[:, 0, None, :]
    for e in range(1, C):
        K = K + Hf[:, :, e, None] * jf[:, e, None, :]
    pad = (0, Dp - D)
    Jt = torch.nn.functional.pad(J3.transpose(0, 1), pad).reshape(C * S, Dp)
    Kt = torch.nn.functional.pad(K.to(J3.dtype).transpose(0, 1), pad)
    return Jt.contiguous(), Kt.reshape(C * S, Dp).contiguous()


# ---------------------------------------------------------------- K8
def retile_rows(X: torch.Tensor, Dp: int, h: Optional[torch.Tensor] = None):
    """(rows, D) -> the tiled layout: (rows, Dp) in X's dtype, columns
    zero-padded. With h ((rows,) f32) also Kt = X * h[r] multiplied in f32
    and rounded once to X's dtype (zero in the padding) — the K of the int8
    diagonal route, formed in the same pass. Returns (Jt, Kt), Kt None
    without h. Both are bit-equal to retile_rows_plain.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:retile_rows
    (_retile_copy_kernel), with the reference engine's separate K = h*J
    pass (engine.py packed_gram_rhs, int8 diagonal branch) fused in. Bound
    on the card: memory — one read of X, one or two writes; threads run
    along the columns so every read and write is coalesced."""
    rows, D = X.shape
    if _on_cpu(X, *(() if h is None else (h,))):
        return retile_rows_plain(X, Dp, h)
    _check(X, "X", (torch.bfloat16, torch.float32), 2)
    if Dp < D:
        raise ValueError(f"retile_rows: Dp={Dp} < D={D}")
    if h is not None:
        _check(h, "h", (torch.float32,), 1)
        if h.shape[0] != rows:
            raise ValueError(f"h has {h.shape[0]} rows, X {rows}")
    Jt = torch.empty((rows, Dp), dtype=X.dtype, device=X.device)
    Kt = None if h is None else torch.empty_like(Jt)
    fn = (_build.lib().tnf_retile_rows_bf16 if X.dtype == torch.bfloat16
          else _build.lib().tnf_retile_rows_f32)
    _raise_on(fn(X.data_ptr(), None if h is None else h.data_ptr(),
                 Jt.data_ptr(), None if Kt is None else Kt.data_ptr(),
                 rows, D, Dp, _stream()), "retile_rows")
    LAUNCHES["retile_rows"] += 1
    return Jt, Kt


def retile_rows_plain(X: torch.Tensor, Dp: int, h: Optional[torch.Tensor] = None):
    pad = (0, Dp - X.shape[1])
    Jt = torch.nn.functional.pad(X, pad)
    if h is None:
        return Jt, None
    Kt = torch.nn.functional.pad((X.float() * h.float()[:, None]).to(X.dtype), pad)
    return Jt, Kt


# ---------------------------------------------------------------- K2
def quantize_tiled(X: torch.Tensor, block: int = BLOCK):
    """Absmax int8 quantisation of a (rows, Dp) bf16 operand per (block of
    BS rows, column): s = max|x| * f32(1/127) (1 for a zero column),
    q = round-half-even(x * (1/s)). BS = quant_block(rows, block); rows are zero-padded to
    Bp = nb * BS. Returns Q (Bp, Dp) int8 and s (nb, Dp) f32.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:quantize_tiled
    (_quant_kernel). Bound on the card: memory — two reads of the bf16 block
    (the second from L2) and one int8 write; one CTA per (64-column strip,
    block) reduces the column max in shared memory, so the scale never goes
    through device memory before the quantise pass."""
    rows, Dp = X.shape
    BS = quant_block(rows, block)
    nb = (rows + BS - 1) // BS
    if _on_cpu(X):
        return quantize_tiled_plain(X, block)
    _check(X, "X", (torch.bfloat16,), 2)
    if Dp % 64:
        raise ValueError(f"quantize_tiled: Dp={Dp} must be a multiple of 64")
    Q = torch.empty((nb * BS, Dp), dtype=torch.int8, device=X.device)
    s = torch.empty((nb, Dp), dtype=torch.float32, device=X.device)
    _raise_on(_build.lib().tnf_quantize_bf16(
        X.data_ptr(), Q.data_ptr(), s.data_ptr(), rows, Dp, BS, nb, _stream()),
        "quantize_tiled")
    LAUNCHES["quantize_tiled"] += 1
    return Q, s


def quantize_tiled_plain(X: torch.Tensor, block: int = BLOCK):
    rows, Dp = X.shape
    BS = quant_block(rows, block)
    nb = (rows + BS - 1) // BS
    Xp = torch.nn.functional.pad(X.float(), (0, 0, 0, nb * BS - rows))
    X4 = Xp.reshape(nb, BS, Dp)
    m = X4.abs().amax(dim=1)
    # s = m * f32(1/127): the reference's m / 127.0, which XLA evaluates as a
    # multiply by the constant's reciprocal; 1/s is an IEEE tensor division
    s = torch.where(m > 0, m * (1.0 / 127.0), torch.ones_like(m))
    inv = torch.ones_like(s) / s
    q = torch.round(X4 * inv[:, None, :]).to(torch.int8)
    return q.reshape(nb * BS, Dp), s


# ---------------------------------------------------------------- K3 / K4
def gram_pair_band_q(Q1, s1, Q2, s2, acc: torch.Tensor) -> torch.Tensor:
    """acc += the int8 Gram of (Q1, s1) and (Q2, s2), in place; returns acc.

    Computes sum_b (Q1_bᵀ Q2_b exact in int32) * (s1_b ⊗ s2_b) in f32 over
    the upper 512-slab pairs (diagonal slabs whole), far slab pairs in the
    reference band's orientation; `mirror_band` finishes the layout.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:gram_pair_band_q
    (_make_band_kernel_q, _gram_pair_band_q_jit). Bound on the card: integer
    dot throughput (dp4a) and the operand re-reads from L2; each 64x64
    output tile is owned by one CTA, which loops over the rows, keeps the
    block's int32 sum in registers and rescales it at each block's end, and
    read-modify-writes the carry once, so the carry needs no atomics."""
    return _gram_pair_q(Q1, s1, Q2, s2, acc, band=True)


def gram_pair_tiled_q(Q1, s1, Q2, s2) -> torch.Tensor:
    """The int8 Gram without a carry, upper slab pairs in natural
    orientation (raw: lower slabs zero). Replaces
    tensornetworksfork_tpu/ops/pallas/gram.py:gram_pair_tiled_q
    (_pair_kernel_tiled_q): the same kernel as gram_pair_band_q."""
    Dp = Q1.shape[1]
    acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=Q1.device)
    return _gram_pair_q(Q1, s1, Q2, s2, acc, band=False, has_acc=False)


def _gram_pair_q(Q1, s1, Q2, s2, acc, band: bool, has_acc: bool = True):
    if Q1.shape != Q2.shape or s1.shape != s2.shape:
        raise ValueError(
            f"int8 Gram operands must share one quantisation layout: "
            f"Q {tuple(Q1.shape)} vs {tuple(Q2.shape)}, "
            f"scales {tuple(s1.shape)} vs {tuple(s2.shape)}")
    Bp, Dp = Q1.shape
    nb = s1.shape[0]
    if Dp % TILE or Bp % nb or tuple(acc.shape) != (Dp, Dp):
        raise ValueError(f"int8 Gram shapes: Q {tuple(Q1.shape)}, s "
                         f"{tuple(s1.shape)}, acc {tuple(acc.shape)}")
    if _on_cpu(Q1, s1, Q2, s2, acc):
        return gram_pair_q_plain(Q1, s1, Q2, s2, acc, band, has_acc)
    for t, n in ((Q1, "Q1"), (Q2, "Q2")):
        _check(t, n, (torch.int8,), 2)
    for t, n in ((s1, "s1"), (s2, "s2"), (acc, "acc")):
        _check(t, n, (torch.float32,), 2)
    BS = Bp // nb
    lib = _build.lib()
    T = lib.tnf_gram_tile()
    pairs = _pair_table(Dp // T, TILE // T, band, Q1.device)
    _raise_on(lib.tnf_gram_q(Q1.data_ptr(), s1.data_ptr(), Q2.data_ptr(),
                             s2.data_ptr(), acc.data_ptr(), pairs.data_ptr(),
                             pairs.shape[0], Bp, Dp, BS, int(has_acc), _stream()),
              "gram_pair_q")
    LAUNCHES["gram_pair_q"] += 1
    return acc


def gram_pair_q_plain(Q1, s1, Q2, s2, acc, band: bool = True,
                      has_acc: bool = True):
    """Plain int8 Gram: block products in float64 (exact for |q| <= 127 over
    2048 rows: 3.3e7 < 2^53), rounded to f32 and rescaled in f32, added to
    acc block by block in order; updates acc in place over the computed
    set (upper slab pairs) and returns it."""
    Bp, Dp = Q1.shape
    nb = s1.shape[0]
    BS = Bp // nb
    sl = torch.arange(Dp, device=acc.device) // TILE
    upper = sl[:, None] <= sl[None, :]
    far = (2 * (sl[None, :] - sl[:, None]) > Dp // TILE) if band else None
    out = acc if has_acc else torch.zeros_like(acc)
    for b in range(nb):
        rs = slice(b * BS, (b + 1) * BS)
        P = (Q1[rs].double().T @ Q2[rs].double()).float()
        tf = P * (s1[b][:, None] * s2[b][None, :])
        if far is not None:
            tf = torch.where(far, tf.T, tf)
        out = out + tf
    acc.copy_(torch.where(upper, out, acc))
    return acc


def mirror_band(A: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Full symmetric A from a gram_pair_band_q carry: each slab pair was
    computed once, in the upper slab triangle (diagonal slabs whole, as the
    reference's mirror_band keeps them); lower slabs take the transpose."""
    sl = torch.arange(A.shape[0], device=A.device) // tile
    return torch.where(sl[:, None] > sl[None, :], A.T, A)


# ---------------------------------------------------------------- K6 / K10
def gram_pair(X: torch.Tensor, Y: torch.Tensor,
              acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric Gram A = Xᵀ Y over the upper triangle, f32 accumulation.

    X, Y (rows, D), f32 or bf16. Returns the raw (D, D) A (upper triangle
    valid; mirror with mirror_gram). With acc ((D, D) f32) the chunk's sum is
    added to acc in place and acc is returned — the carry epilogue that
    replaces the reference's separate add_packed_upper pass.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:gram_pair (K10,
    _gram_pair_jit) and gram_pair_tiled (K6, _pair_kernel_tiled), with
    add_packed_upper (K5) folded in. Bound on the card: f32 FMA throughput
    (f32 operands must match HIGHEST, so no TF32); 64x64 output tiles, one
    CTA each over the upper triangle only, shared-memory operand tiles
    reused 64x, the sum kept in registers until one epilogue write."""
    rows, D = X.shape
    if _on_cpu(X, Y, *(() if acc is None else (acc,))):
        return gram_pair_plain(X, Y, acc)
    _check(X, "X", (torch.bfloat16, torch.float32), 2)
    if Y.dtype != X.dtype or Y.shape != X.shape:
        raise ValueError(f"Y {Y.dtype}{tuple(Y.shape)} must match X "
                         f"{X.dtype}{tuple(X.shape)}")
    _check(Y, "Y", (X.dtype,), 2)
    if acc is None:
        out, has_acc = torch.zeros((D, D), dtype=torch.float32,
                                   device=X.device), 0
    else:
        _check(acc, "acc", (torch.float32,), 2)
        if tuple(acc.shape) != (D, D):
            raise ValueError(f"acc shape {tuple(acc.shape)} != {(D, D)}")
        out, has_acc = acc, 1
    lib = _build.lib()
    T = lib.tnf_gram_tile()
    pairs = _pair_table((D + T - 1) // T, 1, False, X.device)
    fn = lib.tnf_gram_bf16 if X.dtype == torch.bfloat16 else lib.tnf_gram_f32
    _raise_on(fn(X.data_ptr(), Y.data_ptr(), out.data_ptr(), pairs.data_ptr(),
                 pairs.shape[0], rows, D, D, D, has_acc, _stream()), "gram_pair")
    LAUNCHES["gram_pair_tiled" if has_acc else "gram_pair"] += 1
    return out


def _weighted_operand(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X * w per row, multiplied in f32 and rounded to X's dtype, as f32:
    the reference's (j1 * w).astype(j1.dtype)."""
    return (X.float() * w.float()[:, None]).to(X.dtype).float()


def _check_weighted(X: torch.Tensor, h: torch.Tensor) -> None:
    _check(X, "X", (torch.bfloat16, torch.float32), 2)
    _check(h, "h", (torch.float32,), 1)
    if h.shape[0] != X.shape[0]:
        raise ValueError(f"h has {h.shape[0]} rows, X {X.shape[0]}")


def _launch_wgram(X, h, hstride, cls, out, D, has_acc, key) -> None:
    rows, ld = X.shape
    lib = _build.lib()
    T = lib.tnf_gram_tile()
    # K11's class-pair blocks are whole; K7/K9 compute the upper tiles
    pairs = _pair_table((D + T - 1) // T, 0 if cls is not None else 1, False,
                        X.device)
    ncls = 1 if cls is None else cls.shape[0]
    fn = lib.tnf_wgram_bf16 if X.dtype == torch.bfloat16 else lib.tnf_wgram_f32
    _raise_on(fn(X.data_ptr(), h.data_ptr(), hstride,
                 None if cls is None else cls.data_ptr(), ncls, out.data_ptr(),
                 pairs.data_ptr(), pairs.shape[0], rows, D, ld, out.shape[-1],
                 has_acc, _stream()), key)
    LAUNCHES[key] += 1


# ---------------------------------------------------------------- K7
def weighted_gram_tiled(Xt: torch.Tensor, h: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
    """acc += Xtᵀ diag(h) Xt over the upper 64x64 tiles, in place; returns
    acc (raw: finish with mirror_gram).

    Xt (rows, Dp) f32 or bf16 in the tiled layout (retile_rows), h (rows,)
    f32, acc (Dp, Dp) f32. The left operand is Xt * h rounded once to Xt's
    dtype, as the reference rounds it; sums are f32 FMAs, never TF32. The
    chunk's sum is formed in registers and added to the carry once per
    output tile (carry + chunk sum, the order of the reference's separate
    add_packed_upper), by the one CTA that owns the tile, so no atomics.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:weighted_gram_tiled
    (_weighted_gram_tiled_jit, _make_weighted_kernel_tiled_acc). Bound on
    the card: f32 FMA throughput, as gram_pair — the weighting rides the
    operand load, so the weighted copy of J never reaches device memory."""
    rows, Dp = Xt.shape
    if _on_cpu(Xt, h, acc):
        return weighted_gram_tiled_plain(Xt, h, acc)
    _check_weighted(Xt, h)
    _check(acc, "acc", (torch.float32,), 2)
    if tuple(acc.shape) != (Dp, Dp):
        raise ValueError(f"acc shape {tuple(acc.shape)} != {(Dp, Dp)}")
    _launch_wgram(Xt, h, 1, None, acc, Dp, 1, "weighted_gram_tiled")
    return acc


def weighted_gram_tiled_plain(Xt, h, acc):
    acc.add_(_weighted_operand(Xt, h).T @ Xt.float())
    return acc


# ---------------------------------------------------------------- K9
def weighted_gram(X: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """A = Xᵀ diag(h) X of a flat (rows, D) operand over the upper 64x64
    tiles, ragged D masked; returns the raw (D, D) f32 A (finish with
    mirror_gram). X f32 or bf16, h (rows,) f32; numerics as
    weighted_gram_tiled.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:weighted_gram
    (_weighted_gram_jit, _weighted_kernel_tiled). Bound on the card: f32 FMA
    throughput; at a small D (the regression A3: 1,032) the upper triangle
    is only 153 output tiles, about one CTA per SM, each looping over all
    rows."""
    rows, D = X.shape
    if _on_cpu(X, h):
        return weighted_gram_plain(X, h)
    _check_weighted(X, h)
    out = torch.zeros((D, D), dtype=torch.float32, device=X.device)
    _launch_wgram(X, h, 1, None, out, D, 0, "weighted_gram")
    return out


def weighted_gram_plain(X, h):
    return _weighted_operand(X, h).T @ X.float()


# ---------------------------------------------------------------- K11
@functools.lru_cache(maxsize=16)
def _class_pairs_np(C: int) -> np.ndarray:
    """p*C + q for the upper class pairs p <= q, in np.triu_indices order."""
    iu, ju = np.triu_indices(C)
    return (iu * C + ju).astype(np.int32)


def own_out_gram(Jt: torch.Tensor, H: torch.Tensor, C: int,
                 D: Optional[int] = None) -> torch.Tensor:
    """Raw own-out Gram A[p, q, d, e] = sum_s H[s, p, q] J[s, d] J[s, e]
    for the upper class pairs p <= q; the lower pairs are zero (finish with
    mirror_own_out). Each block is computed whole over (d, e): it is not
    symmetric in d for p != q.

    Jt (S, Dp) f32 or bf16 in the tiled layout, H (S, C, C) f32; returns
    (C, C, Dp, Dp) f32. Only the first D columns (default all) are computed;
    the rest of each block stays zero. J * H[s, p, q] is rounded once to
    Jt's dtype, as the reference rounds it.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:own_out_gram
    (_own_out_gram_jit, _make_own_out_kernel). Bound on the card: f32 FMA
    throughput; the same weighted tile body as K7/K9 with the class pair on
    the grid's y axis, so the (S, C², DJ) weighted copy of J never exists."""
    S, Dp = Jt.shape
    D = Dp if D is None else D
    if _on_cpu(Jt, H):
        return own_out_gram_plain(Jt, H, C, D)
    _check(Jt, "Jt", (torch.bfloat16, torch.float32), 2)
    _check(H, "H", (torch.float32,), 3)
    if tuple(H.shape) != (S, C, C) or not 0 < D <= Dp:
        raise ValueError(f"own_out_gram: H {tuple(H.shape)}, Jt {tuple(Jt.shape)}, "
                         f"C={C}, D={D}")
    key = ("cls", C, str(Jt.device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(_class_pairs_np(C)).to(Jt.device)
    out = torch.zeros((C, C, Dp, Dp), dtype=torch.float32, device=Jt.device)
    _launch_wgram(Jt, H, C * C, _TABLES[key], out, D, 0, "own_out_gram")
    return out


def own_out_gram_plain(Jt, H, C, D=None):
    S, Dp = Jt.shape
    D = Dp if D is None else D
    out = torch.zeros((C, C, Dp, Dp), dtype=torch.float32, device=Jt.device)
    J = Jt[:, :D]
    Jf = J.float()
    for pq in _class_pairs_np(C).tolist():
        p, q = divmod(pq, C)
        out[p, q, :D, :D] = _weighted_operand(J, H[:, p, q]).T @ Jf
    return out


def mirror_own_out(A4: torch.Tensor) -> torch.Tensor:
    """Fill the lower class-pair blocks of a raw own_out_gram output:
    A[q, p] = A[p, q] with the d axes swapped."""
    C = A4.shape[0]
    iu = torch.ones((C, C), dtype=torch.bool, device=A4.device).triu()
    return torch.where(iu[:, :, None, None], A4, A4.permute(1, 0, 3, 2))


def gram_pair_plain(X, Y, acc=None):
    A = X.float().T @ Y.float()
    if acc is None:
        return A
    acc.add_(A)
    return acc


def mirror_gram(A: torch.Tensor) -> torch.Tensor:
    """Full symmetric A from a raw upper-valid Gram (exact no-op on a
    symmetric A)."""
    return torch.triu(A) + torch.triu(A, 1).T
