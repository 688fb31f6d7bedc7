"""Gram-path kernels: Python wrappers, plain versions, tile plan and finishers.

Port of tensornetworksfork_tpu/ops/pallas/gram.py: every Pallas kernel of
the JAX package has a counterpart here. Each wrapper takes the plain PyTorch
version (`<fn>_plain`, beside it) only for tensors that lie on the CPU; for
CUDA tensors it launches its kernel from `csrc/gram.cu` (the int8 Gram K3/K4:
`csrc/qgram.cu`; the float Grams K6, K7, K9, K10 and K11: `csrc/wgram.cu`)
or raises — there is no fallback. Each wrapper checks device, dtype, shape
and layout, launches on its operands' device and that device's current
stream (whatever device is current; operands on different devices raise),
raises when the launch reports an error, and adds one to
`LAUNCHES[<name>]` per call that launches its kernel.

Layouts differ from the TPU's where the TPU's were schedule choices: the
class-major operands are row-major (C*S, Dp) matrices instead of (n, rows,
tile) slabs, the int8 codes are stored K-major (quantize_tiled returns a
transposed view), and the Gram kernels write the upper triangle of a
(Dp, Dp) matrix. What fixes the numbers is kept: the reference plan's
512-wide slabs (padding D to Dp and, for int8, which slab pairs are "far"),
the 2048-row quantisation blocks, the class-major row order and the bf16
rounding of K.
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
# "gram_pair_tiled", and of those the ones on the clustered bf16 kernel
# also under "gram_pair_tiled_cluster".
LAUNCHES = {"retile_hmix": 0, "quantize_tiled": 0, "gram_pair_q": 0,
            "gram_pair": 0, "gram_pair_tiled": 0, "gram_pair_tiled_cluster": 0,
            "retile_rows": 0, "weighted_gram_tiled": 0, "weighted_gram": 0,
            "own_out_gram": 0}

TILE = 512    # the reference plan's D slab (plan_tiles): padding and band map
BLOCK = 2048  # the reference plan's sample block: int8 quantisation rows
# The int8 Gram (K3/K4; csrc/qgram.cu): its output tile and the rows of a
# stage, to which quantize_tiled pads each column's codes; and the
# quantiser's threads a CTA (csrc/gram.cu)
QTILE = 128
QUANT_THREADS = 512
# K1 (csrc/gram.cu retile_hmix_kernel): threads a CTA, each on one 16-byte
# pack of a column strip, and the CTAs one SM holds at once (its launch
# bounds promise two)
HMIX_THREADS = 256
HMIX_RESIDENT = 2

# The split Gram (K7, K9, K10, K11; csrc/wgram.cu): its output tile, the
# shortest split it plans, and how many of its f32 kernel's CTAs one SM holds
# at once (256 threads of at most 128 registers, ~99 KB of shared memory
# each). The bf16 kernel's hold one (a 133 KB ring) but take the same plan:
# planned for one an SM, K10 and K9 in bf16 split more and ran no faster.
WTILE = 128
SPLIT_MIN_ROWS = 4096
WGRAM_RESIDENT = 2
# The upper-triangle tile tables walk GROUP x GROUP blocks of tiles, so the
# CTAs on the card at once (132 for K6's 8,128 tiles) read at most ~4 GROUP
# operand strips (49) rather than up to 129 in row order, and the strips
# stay in L2.
GROUP = 12
# K6 in bf16 (csrc/wgram.cu cluster_wgram_bf16_kernel): clusters of
# CLUSTER_ROWS x 2 output tiles, each operand strip loaded from L2 once for
# the cluster's tiles that read it and multicast to them by TMA (2: X's
# strips and Y's, halving the L2 reads; 1 shares X's alone: 9.2 ms a
# flagship chunk on an H100 against 2's 8.5, though 2 x 2 clusters leave 12
# of the 132 SMs idle).
CLUSTER_ROWS = 2


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


def wgram_splits(ctas: int, rows: int, sms: int) -> int:
    """Row splits for a split Gram grid of `ctas` CTAs (output tiles x
    class pairs) on `sms` SMs. 1 when the grid already holds 4 CTAs per SM.
    Otherwise the count, at most rows // SPLIT_MIN_ROWS, whose waves of
    WGRAM_RESIDENT CTAs per SM take the least time per row —
    ceil(ctas * s / (WGRAM_RESIDENT * sms)) / s, the smaller s on a tie — so
    a near-empty last wave is avoided."""
    if ctas >= 4 * sms:
        return 1
    slots = WGRAM_RESIDENT * sms
    best, best_waves = 1, None
    for s in range(1, max(1, rows // SPLIT_MIN_ROWS) + 1):
        waves = -(-ctas * s // slots)
        if best_waves is None or waves * best < best_waves * s:
            best, best_waves = s, waves
    return best


def split_rows(rows: int, splits: int) -> Tuple[int, int]:
    """(splits, rows per split) for cutting `rows` into at most `splits`
    ranges [z * rps, min(rows, (z + 1) * rps)): every range non-empty, the
    last one ragged."""
    rps = -(-max(rows, 1) // max(splits, 1))
    return max(1, -(-rows // rps)), rps


def wgram_plan(rows: int, D: int, ncls: int, upper: bool, sms: int,
               splits: Optional[int] = None) -> Tuple[int, int, int]:
    """(output tiles, splits, rows per split) of the split Gram: WTILE-wide
    tiles over D (the upper triangle, or all of them), `ncls` class pairs;
    the split count from wgram_splits unless given."""
    nt = -(-D // WTILE)
    npairs = nt * (nt + 1) // 2 if upper else nt * nt
    if splits is None:
        splits = wgram_splits(npairs * ncls, rows, sms)
    return (npairs,) + split_rows(rows, splits)


# ------------------------------------------------------------------ checks
def _on_cpu(*ts) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = devs.pop().type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {dev!r}")
    return dev == "cpu"


def _on_operands_device(fn):
    """Runs a launching wrapper with its tensor operands' CUDA device made
    current (a device guard), so the kernel launches on that device and on
    its stream whatever device the caller has made current. Operands on
    different devices raise; CPU operands pass straight through."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        ts = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
        devs = {t.device for t in ts}
        if len(devs) != 1:
            raise ValueError(f"{fn.__name__}: operands on different devices: "
                             f"{sorted(map(str, devs))}")
        dev = devs.pop()
        if dev.type != "cuda":
            return fn(*args, **kwargs)
        with torch.cuda.device(dev):
            return fn(*args, **kwargs)
    return wrapped


def _check(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(status: int, kernel: str) -> None:
    """Raise on an entry point's status: a cudaError_t, or (csrc/qgram.cu)
    -1 when libcuda has no TMA encoder and -1000 - CUresult when a
    tensor map cannot be made."""
    if status == -1:
        raise RuntimeError(f"CUDA kernel {kernel}: libcuda has no cuTensorMapEncodeTiled")
    if status <= -1000:
        raise RuntimeError(f"CUDA kernel {kernel}: cuTensorMapEncodeTiled failed, "
                           f"CUresult {-1000 - status}")
    if status != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {status}")


def _stream(device: torch.device) -> int:
    """`device`'s current CUDA stream, as an integer handle, read through
    the raw-stream call that PyTorch's own generated kernels use: building a
    torch.cuda.Stream instead took ~7 us a launch on an H100 host, about as
    long as K8 takes on the card. Launch under _on_operands_device, so the
    stream's device is the current one."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return _sm_count(index)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    _make_band_kernel_q), and the swap reproduces that rounding.
    Both (slab_tiles >= 1) list their tiles in GROUP x GROUP blocks (blocks,
    then tiles, in row order)."""
    ti, tj = np.divmod(np.arange(ntiles * ntiles), ntiles)
    if slab_tiles == 0:
        return np.stack([ti, tj, 0 * ti], 1).astype(np.int32)
    if slab_tiles == 1:
        keep = ti <= tj
        swap = np.zeros_like(ti)
    else:
        p, q = ti // slab_tiles, tj // slab_tiles
        keep = p <= q
        swap = (band & (2 * (q - p) > ntiles // slab_tiles)).astype(ti.dtype)
    ti, tj, swap = ti[keep], tj[keep], swap[keep]
    order = np.lexsort((tj, ti, tj // GROUP, ti // GROUP))
    return np.stack([ti[order], tj[order], swap[order]], 1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _cluster_table_np(ntiles: int, cluster_rows: int = CLUSTER_ROWS) -> np.ndarray:
    """(ctas, 3) int32 rows (ti, tj, store) of the clustered bf16 Gram: the
    clusters of cluster_rows x 2 tiles (rows cluster_rows·si.., columns
    2·sj..) that hold an upper tile of the ntiles x ntiles tiles, listed in
    GROUP x GROUP-tile blocks (blocks, then clusters, in row order), each
    cluster's CTAs in rank order (rank 2 i + j: tile (cluster_rows·si + i,
    2·sj + j)). store marks the upper tiles over D (ti <= tj < ntiles),
    each listed once: a CTA of a tile below the diagonal (in a cluster on
    it) or past D loads its share of the cluster's operands and multiplies
    with the others, but stores nothing."""
    rows = -(-ntiles // cluster_rows)
    cols = -(-ntiles // 2)
    si, sj = np.divmod(np.arange(rows * cols), cols)
    keep = cluster_rows * si <= 2 * sj + 1
    si, sj = si[keep], sj[keep]
    order = np.lexsort((sj, si, 2 * sj // GROUP, cluster_rows * si // GROUP))
    si, sj = si[order], sj[order]
    i, j = np.divmod(np.arange(2 * cluster_rows), 2)
    ti = (cluster_rows * si[:, None] + i).ravel()
    tj = (2 * sj[:, None] + j).ravel()
    store = (ti <= tj) & (tj < ntiles)
    return np.stack([ti, tj, store], 1).astype(np.int32)


_TABLES = {}


def _table(key, values: np.ndarray, device: torch.device) -> torch.Tensor:
    """int32 `values` on `device`, cached under `key`."""
    key = (*key, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(np.ascontiguousarray(values, np.int32)).to(device)
    return _TABLES[key]


def _pair_table(ntiles: int, slab_tiles: int, band: bool,
                device: torch.device) -> torch.Tensor:
    return _table(("pairs", ntiles, slab_tiles, band),
                  _pair_table_np(ntiles, slab_tiles, band), device)


# ---------------------------------------------------------------- K1
def hmix_pack_values(C: int, itemsize: int) -> int:
    """Values of a pack of K1's packed path: 16 bytes, or 8 for bf16 beyond
    10 classes (csrc/gram.cu hmix_pack_values: wider packs would spill)."""
    return 4 if itemsize == 2 and C > 10 else 16 // itemsize


def hmix_plan(S: int, C: int, Dp: int, itemsize: int, sms: int) -> Tuple[int, int]:
    """(runs, samples per run) of K1's grid: strips of HMIX_THREADS packs
    across Dp, times runs of samples, make one wave of HMIX_RESIDENT CTAs an
    SM (fewer runs than that where S is short; more strips where K1 takes
    its one-value path, whose CTAs then run in more waves)."""
    strips = -(-Dp // (hmix_pack_values(C, itemsize) * HMIX_THREADS))
    return split_rows(S, max(1, min(S, HMIX_RESIDENT * sms // strips)))


@_on_operands_device
def retile_hmix(J3: torch.Tensor, H: torch.Tensor, Dp: int,
                gvec: Optional[torch.Tensor] = None):
    """Fused class-major retile + Hessian class mixing (+ the rhs).

    J3 (S, C, D) packed Jacobian (bf16 or f32), H (S, C, C) f32, gvec
    (C*S,) class-major gradient (row c*S + s) in J3's dtype, or None.
    Returns (Jt, Kt, b): Jt and Kt (C*S, Dp) in J3's dtype, rows class-major
    (row c*S + s), columns zero-padded from D to Dp, with Kt[c*S+s] =
    sum_e H[s,c,e] J[s,e] mixed in f32 in order e = 0..C-1 and rounded once;
    b = Jtᵀ gvec, (Dp,) f32 summed in f32 (None without gvec).

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:retile_hmix
    (_make_retile_hmix_kernel), and the reference engine's separate rhs dot
    over Jt (engine.py packed_gram_rhs): b is summed from the J values the
    retile has in registers. Bound on the card: memory — one read of J and
    two writes of its size. csrc/gram.cu retile_hmix_kernel: a CTA owns a strip of 16-byte
    packs and a run of samples (hmix_plan), stages the run's H rows and g in
    shared memory, and a thread moves the C class packs of a sample or
    several; b's per-run partials are added in run order by a second small
    kernel, so b is the same from run to run. Jt is bit-equal to the plain
    version; Kt too where both round the same f32 products and sums (the
    card's plain version does); b agrees to the order of its f32 sums."""
    S, C, D = J3.shape
    if _on_cpu(J3, H, *(() if gvec is None else (gvec,))):
        return retile_hmix_plain(J3, H, Dp, gvec)
    _check(J3, "J3", (torch.bfloat16, torch.float32), 3)
    _check(H, "H", (torch.float32,), 3)
    if tuple(H.shape) != (S, C, C):
        raise ValueError(f"H shape {tuple(H.shape)} != {(S, C, C)}")
    if Dp < D or C > 16:
        raise ValueError(f"retile_hmix: need Dp >= D and C <= 16 (D={D}, Dp={Dp}, C={C})")
    if gvec is not None:
        _check(gvec, "gvec", (J3.dtype,), 1)
        if gvec.shape[0] != C * S:
            raise ValueError(f"gvec has {gvec.shape[0]} rows, Jt {C * S}")
    Jt = J3.new_empty((C * S, Dp))
    Kt = J3.new_empty((C * S, Dp))
    runs, rps = hmix_plan(S, C, Dp, J3.element_size(), sm_count(J3.device))
    b = part = None
    if gvec is not None:
        b = torch.empty(Dp, dtype=torch.float32, device=J3.device)
        if runs > 1:
            part = torch.empty((runs, Dp), dtype=torch.float32, device=J3.device)
    fn = (_build.lib().tnf_retile_hmix_bf16 if J3.dtype == torch.bfloat16
          else _build.lib().tnf_retile_hmix_f32)
    _raise_on(fn(J3.data_ptr(), H.data_ptr(), None if gvec is None else gvec.data_ptr(),
                 Jt.data_ptr(), Kt.data_ptr(), None if part is None else part.data_ptr(),
                 None if b is None else b.data_ptr(), S, C, D, Dp, rps, _stream(J3.device)),
              "retile_hmix")
    LAUNCHES["retile_hmix"] += 1
    return Jt, Kt, b


def retile_hmix_plain(J3: torch.Tensor, H: torch.Tensor, Dp: int,
                      gvec: Optional[torch.Tensor] = None):
    S, C, D = J3.shape
    jf = J3.float()
    Hf = H.float()
    K = Hf[:, :, 0, None] * jf[:, 0, None, :]
    for e in range(1, C):
        K = K + Hf[:, :, e, None] * jf[:, e, None, :]
    pad = (0, Dp - D)
    Jt = torch.nn.functional.pad(J3.transpose(0, 1), pad).reshape(C * S, Dp).contiguous()
    Kt = torch.nn.functional.pad(K.to(J3.dtype).transpose(0, 1), pad)
    b = None if gvec is None else gvec.float() @ Jt.float()
    return Jt, Kt.reshape(C * S, Dp).contiguous(), b


# ---------------------------------------------------------------- K8
@_on_operands_device
def retile_rows(X: torch.Tensor, Dp: int, h: Optional[torch.Tensor] = None):
    """(rows, D) -> the tiled layout: (rows, Dp) in X's dtype, columns
    zero-padded. With h ((rows,) f32) also Kt = X * h[r] multiplied in f32
    and rounded once to X's dtype (zero in the padding) — the K of the int8
    diagonal route, formed in the same pass. Returns (Jt, Kt), Kt None
    without h. Both are bit-equal to retile_rows_plain.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:retile_rows
    (_retile_copy_kernel), with the reference engine's separate K = h*J
    pass (engine.py packed_gram_rhs, int8 diagonal branch) fused in. Bound
    on the card: memory — one read of X, one or two writes (the
    regression's A2 chunk, 512 x 8,256 f32 -> 8,704: 0.010 ms). Each thread
    moves 16-byte packs (4 f32 or 8 bf16 values; one value at a time where
    D or a pointer is not aligned to them), several in flight, on a grid
    sized to the SMs; the padding is written as zero packs."""
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
    Jt = X.new_empty((rows, Dp))
    Kt = None if h is None else X.new_empty((rows, Dp))
    fn = (_build.lib().tnf_retile_rows_bf16 if X.dtype == torch.bfloat16
          else _build.lib().tnf_retile_rows_f32)
    _raise_on(fn(X.data_ptr(), None if h is None else h.data_ptr(),
                 Jt.data_ptr(), None if Kt is None else Kt.data_ptr(),
                 rows, D, Dp, sm_count(X.device), _stream(X.device)), "retile_rows")
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
def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def quant_strip(BS: int) -> int:
    """Columns a CTA of the quantiser takes for blocks of BS rows: 32 (64
    bytes of each bf16 row), fewer where the block's 16-row x 8-column units
    would exceed the kernel's 512 threads."""
    for W in (32, 16, 8):
        if BS // 16 * (W // 8) <= QUANT_THREADS:
            return W
    raise ValueError(f"quantize_tiled: blocks of {BS} rows exceed the kernel's "
                     f"{QUANT_THREADS * 16} rows")


@_on_operands_device
def quantize_tiled(X: torch.Tensor, block: int = BLOCK):
    """Absmax int8 quantisation of a (rows, Dp) bf16 operand per (block of
    BS rows, column): s = max|x| * f32(1/127) (1 for a zero column),
    q = round-half-even(x * (1/s)). BS = quant_block(rows, block); rows are
    zero-padded to Bp = nb * BS. Returns Q (Bp, Dp) int8 and s (nb, Dp) f32.

    Q is a transposed view: the codes are stored K-major, as Qt (Dp, ldq)
    with ldq = Bp rounded up to QTILE (the pad holds zero codes), and
    Q = Qt[:, :Bp].T, so each column's codes are contiguous — the layout the
    int8 Gram's tensor cores read. Its values are the reference's.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:quantize_tiled
    (_quant_kernel). Bound on the card: memory — one read of the bf16 block
    and one int8 write (the flagship's 18,432 x 16,384 operand: 0.27 ms).
    Each CTA holds a (BS rows x 32 columns) block in registers, reduces the
    column max by shuffles and shared memory, and writes each column's
    codes of 16 rows as one 16-byte store, so X is read once and the
    transpose costs nothing."""
    rows, Dp = X.shape
    BS = quant_block(rows, block)
    nb = (rows + BS - 1) // BS
    Bp = nb * BS
    if _on_cpu(X):
        return quantize_tiled_plain(X, block)
    _check(X, "X", (torch.bfloat16,), 2)
    if Dp % 64:
        raise ValueError(f"quantize_tiled: Dp={Dp} must be a multiple of 64")
    W = quant_strip(BS)
    ldq = _round_up(Bp, QTILE)
    Qt = torch.empty((Dp, ldq), dtype=torch.int8, device=X.device)
    s = torch.empty((nb, Dp), dtype=torch.float32, device=X.device)
    _raise_on(_build.lib().tnf_quantize_bf16(
        X.data_ptr(), Qt.data_ptr(), s.data_ptr(), rows, Dp, BS, nb, ldq, W, _stream(X.device)),
        "quantize_tiled")
    LAUNCHES["quantize_tiled"] += 1
    return Qt[:, :Bp].T, s


def quantize_tiled_plain(X: torch.Tensor, block: int = BLOCK):
    rows, Dp = X.shape
    BS = quant_block(rows, block)
    nb = (rows + BS - 1) // BS
    Bp = nb * BS
    Xp = torch.nn.functional.pad(X.float(), (0, 0, 0, Bp - rows))
    X4 = Xp.reshape(nb, BS, Dp)
    m = X4.abs().amax(dim=1)
    # s = m * f32(1/127): the reference's m / 127.0, which XLA evaluates as a
    # multiply by the constant's reciprocal; 1/s is an IEEE tensor division
    s = torch.where(m > 0, m * (1.0 / 127.0), torch.ones_like(m))
    inv = torch.ones_like(s) / s
    q = torch.round(X4 * inv[:, None, :]).to(torch.int8)
    # the kernel's K-major layout: Qt (Dp, ldq), zero codes past Bp
    Qt = torch.zeros((Dp, _round_up(Bp, QTILE)), dtype=torch.int8, device=X.device)
    Qt[:, :Bp] = q.reshape(Bp, Dp).T
    return Qt[:, :Bp].T, s


# ---------------------------------------------------------------- K3 / K4
def gram_pair_band_q(Q1, s1, Q2, s2, acc: torch.Tensor) -> torch.Tensor:
    """acc += the int8 Gram of (Q1, s1) and (Q2, s2), in place; returns acc.

    Computes sum_b (Q1_bᵀ Q2_b exact in int32) * (s1_b ⊗ s2_b) in f32 over
    the upper 512-slab pairs (diagonal slabs whole), far slab pairs in the
    reference band's orientation; `mirror_band` finishes the layout. On the
    card Q1 and Q2 must be quantize_tiled's K-major views (Q.T row-major,
    its row stride a multiple of 16 bytes); the plain version takes any.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:gram_pair_band_q
    (_make_band_kernel_q, _gram_pair_band_q_jit). Bound on the card: int8
    tensor-core work (the flagship's 18,432 x 16,384 chunk: 2.58 ms), with
    ~40 GB of operand reads from L2. csrc/qgram.cu: one CTA per 128x128 tile,
    TMA loads of the K-major codes into a 6-stage ring, s8 wgmma into int32
    sums that are rescaled and added in f32 at each block's end, the carry
    read and written once by the tile's owner (no atomics)."""
    return _gram_pair_q(Q1, s1, Q2, s2, acc, band=True)


def gram_pair_tiled_q(Q1, s1, Q2, s2) -> torch.Tensor:
    """The int8 Gram without a carry, upper slab pairs in natural
    orientation (raw: lower slabs zero). Replaces
    tensornetworksfork_tpu/ops/pallas/gram.py:gram_pair_tiled_q
    (_pair_kernel_tiled_q): the same kernel as gram_pair_band_q."""
    Dp = Q1.shape[1]
    acc = torch.zeros((Dp, Dp), dtype=torch.float32, device=Q1.device)
    return _gram_pair_q(Q1, s1, Q2, s2, acc, band=False, has_acc=False)


def _check_kmajor(Q: torch.Tensor, name: str) -> None:
    """Q (Bp, Dp) int8 in quantize_tiled's layout: Q.T row-major with a row
    stride of at least Bp that is a multiple of 16 bytes, 16-byte aligned
    (what the int8 Gram's TMA loads need). No silent copy."""
    if Q.dtype != torch.int8 or Q.ndim != 2:
        raise TypeError(f"{name}: expected a 2-d int8 tensor, got {Q.dtype}{tuple(Q.shape)}")
    ld = Q.stride(1)
    if Q.stride(0) != 1 or ld < Q.shape[0] or ld % 16 or Q.data_ptr() % 16:
        raise ValueError(f"{name}: the int8 Gram takes quantize_tiled's K-major codes "
                         f"(Q.T row-major, row stride a multiple of 16 bytes); got "
                         f"strides {Q.stride()} for shape {tuple(Q.shape)}")


def _qgram_lib():
    """The kernel library, checked to tile the int8 Gram as QTILE does."""
    lib = _build.lib()
    if lib.tnf_gram_tile() != QTILE:
        raise RuntimeError("csrc/qgram.cu and ops/cuda/gram.py disagree on the "
                           "int8 Gram's tile")
    return lib


@_on_operands_device
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
    _check_kmajor(Q1, "Q1")
    _check_kmajor(Q2, "Q2")
    for t, n in ((s1, "s1"), (s2, "s2"), (acc, "acc")):
        _check(t, n, (torch.float32,), 2)
    BS = Bp // nb
    if BS % 32:
        raise ValueError(f"int8 Gram: blocks of {BS} rows; the kernel takes multiples of 32")
    lib = _qgram_lib()
    pairs = _pair_table(Dp // QTILE, TILE // QTILE, band, Q1.device)
    _raise_on(lib.tnf_gram_q(Q1.data_ptr(), Q1.stride(1), s1.data_ptr(), Q2.data_ptr(),
                             Q2.stride(1), s2.data_ptr(), acc.data_ptr(), pairs.data_ptr(),
                             pairs.shape[0], Bp, Dp, BS, int(has_acc), _stream(Q1.device)),
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
def k6_kernel(dtype: torch.dtype, ld: int, *addresses: int) -> str:
    """The kernel K6 (gram_pair with a carry) takes for operands of `dtype`
    with row stride `ld` values at the given base addresses: "tf32x3" for
    f32; for bf16, "cluster" where TMA can address the operands (a row
    stride of a multiple of 8 values, 16 bytes, and 16-byte-aligned bases),
    else "split" (the split Gram in one split)."""
    if dtype == torch.float32:
        return "tf32x3"
    if ld % 8 == 0 and all(a % 16 == 0 for a in addresses):
        return "cluster"
    return "split"


@_on_operands_device
def gram_pair(X: torch.Tensor, Y: torch.Tensor,
              acc: Optional[torch.Tensor] = None,
              splits: Optional[int] = None, D: Optional[int] = None) -> torch.Tensor:
    """Symmetric Gram A = Xᵀ Y over the upper triangle, f32 accumulation.

    X, Y (rows, W), f32 or bf16. Returns the raw (W, W) A (upper triangle
    valid; mirror with mirror_gram). With acc ((W, W) f32) the chunk's sum
    is added to acc in place and acc is returned — the carry epilogue that
    replaces the reference's separate add_packed_upper pass; D (default W)
    is then the node's real width: tiles past it are skipped and acc[D:, :],
    acc[:, D:] keep what they hold beyond those tiles (the tiled layout's
    columns past D are zero, so the result over [:D, :D] is the same).

    Without acc (K10: replaces tensornetworksfork_tpu/ops/pallas/gram.py
    gram_pair, _gram_pair_jit): the split Gram of csrc/wgram.cu, unweighted,
    with Y as the e-operand. Bound on the card, at the conv-TT flagship's A4
    (73,728 x 900): bf16, the bytes of the two operands (0.080 ms); f32, f32
    FMA throughput (0.89 ms; never TF32). 900 columns are 36 upper 128²
    tiles, so the rows are split until the grid fills the card (wgram_plan;
    `splits` overrides it) and the partial sums added in split order; bf16
    operands run on the tensor cores (wgmma) with each 128-row sum added in
    f32, f32 ones on f32 FMA with 8x8 accumulators a thread.

    With acc (K6: gram_pair_tiled, _pair_kernel_tiled, with add_packed_upper,
    K5, folded in), at the flagship's A2/A3 chunk (18,432 x 16,384, D =
    16,200: 8,128 upper 128² tiles, one CTA each, no split): f32 operands
    run on csrc/wgram.cu's 3xTF32 kernel (each operand split into TF32 hi +
    lo, three TF32 tensor-core products per multiply-add, each 128-row sum
    added in f32; bound by that work, 29 ms), bf16 ones (k6_kernel) on the
    clustered bf16 Gram where TMA can address them, else on the split Gram's
    wgmma kernel: the same wgmmas and f32 sums, bit-equal. Bound on paper by
    bf16 tensor-core work (4.9 ms), in fact first by reading two operand
    strips from L2 a tile (76.7 GB a call, 13.4 ms on the split Gram);
    clusters of 2 x 2 tiles load each strip once for two tiles and
    multicast it (39.3 GB, 8.5 ms on an H100 at 700 W)."""
    rows, W = X.shape
    D = W if D is None else D
    if _on_cpu(X, Y, *(() if acc is None else (acc,))):
        return gram_pair_plain(X, Y, acc)
    _check(X, "X", (torch.bfloat16, torch.float32), 2)
    if Y.dtype != X.dtype or Y.shape != X.shape:
        raise ValueError(f"Y {Y.dtype}{tuple(Y.shape)} must match X "
                         f"{X.dtype}{tuple(X.shape)}")
    _check(Y, "Y", (X.dtype,), 2)
    if acc is None:
        if D != W:
            raise ValueError(f"gram_pair: D={D} below X's width {W} needs a carry")
        out = torch.zeros((W, W), dtype=torch.float32, device=X.device)
        _launch_wgram_split(X, None, 0, None, out, W, True, splits, "gram_pair", Y=Y)
        LAUNCHES["gram_pair"] += 1
        return out
    _check(acc, "acc", (torch.float32,), 2)
    if tuple(acc.shape) != (W, W) or not 0 < D <= W or rows < 1:
        raise ValueError(f"gram_pair: acc {tuple(acc.shape)}, X {tuple(X.shape)}, D={D}")
    kernel = k6_kernel(X.dtype, W, X.data_ptr(), Y.data_ptr())
    if kernel == "tf32x3":
        pairs = _pair_table(-(-D // WTILE), 1, False, X.device)
        _raise_on(_wgram_lib().tnf_gram_tf32x3(
            X.data_ptr(), Y.data_ptr(), W, pairs.data_ptr(), pairs.shape[0], rows, D,
            acc.data_ptr(), W, 1, _stream(X.device)), "gram_pair")
    elif kernel == "cluster":
        _launch_gram_cluster(X, Y, acc, D)
        LAUNCHES["gram_pair_tiled_cluster"] += 1
    else:
        _launch_wgram_split(X, None, 0, None, acc, D, True, 1, "gram_pair", Y=Y,
                            has_acc=True)
    LAUNCHES["gram_pair_tiled"] += 1
    return acc


def _launch_gram_cluster(X, Y, acc, D, cluster_rows: int = CLUSTER_ROWS) -> None:
    """acc += Xᵀ Y over the upper tiles over D on csrc/wgram.cu's clustered
    bf16 Gram (X, Y (rows, W) bf16 that k6_kernel sends there, acc (W, W)
    f32), in clusters of cluster_rows x 2 tiles."""
    rows, W = X.shape
    tiles = _table(("cluster", -(-D // WTILE), cluster_rows),
                   _cluster_table_np(-(-D // WTILE), cluster_rows), X.device)
    _raise_on(_wgram_lib().tnf_gram_bf16_cluster(
        X.data_ptr(), Y.data_ptr(), W, tiles.data_ptr(), tiles.shape[0], cluster_rows, rows,
        D, acc.data_ptr(), W, _stream(X.device)), "gram_pair")


def _weighted_operand(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X * w per row, multiplied in f32 and rounded to X's dtype, as f32:
    the reference's (j1 * w).astype(j1.dtype)."""
    return (X.float() * w.float()[:, None]).to(X.dtype).float()


def _check_weighted(X: torch.Tensor, h: torch.Tensor) -> None:
    _check(X, "X", (torch.bfloat16, torch.float32), 2)
    _check(h, "h", (torch.float32,), 1)
    if h.shape[0] != X.shape[0]:
        raise ValueError(f"h has {h.shape[0]} rows, X {X.shape[0]}")


def _wgram_lib():
    """The kernel library, checked to tile as WTILE does."""
    lib = _build.lib()
    if lib.tnf_wgram_tile() != WTILE:
        raise RuntimeError("csrc/wgram.cu and ops/cuda/gram.py disagree on "
                           "the output tile")
    return lib


def _launch_wgram_split(X, h, hstride, cls, out, D, upper, splits, key,
                        Y=None, has_acc=False) -> None:
    """The split Gram of csrc/wgram.cu into `out` (its last two dims the
    block; `key` names the wrapper in errors): X weighted by h against X,
    or, with h None, X against Y. With has_acc the sums are added to what
    `out` holds — by the kernel's epilogue in one split, else by the
    reduction, carry first and then the splits in order."""
    rows, ld = X.shape
    Y = X if Y is None else Y
    lib = _wgram_lib()
    ncls = 1 if cls is None else cls.shape[0]
    npairs, splits, rps = wgram_plan(rows, D, ncls, upper, sm_count(X.device), splits)
    pairs = _pair_table(-(-D // WTILE), 1 if upper else 0, False, X.device)
    ldc = out.shape[-1]
    cls_p = None if cls is None else cls.data_ptr()
    h_p = None if h is None else h.data_ptr()
    if splits == 1:  # straight into the output blocks
        ws, tgt, ocls, ostride, ldo, sstride = None, out, cls_p, ldc * ldc, ldc, 0
    else:
        ws = torch.empty((splits, ncls, D, D), dtype=torch.float32, device=X.device)
        tgt, ocls, ostride, ldo, sstride = ws, None, D * D, D, ncls * D * D
    fn = (lib.tnf_wgram_split_bf16 if X.dtype == torch.bfloat16
          else lib.tnf_wgram_split_f32)
    _raise_on(fn(X.data_ptr(), Y.data_ptr(), ld, h_p, hstride, cls_p, ncls,
                 pairs.data_ptr(), npairs, int(upper), rows, rps, splits, D,
                 tgt.data_ptr(), ocls, ostride, ldo, sstride,
                 int(has_acc and ws is None), _stream(X.device)), key)
    if ws is not None:
        _raise_on(lib.tnf_wgram_reduce(ws.data_ptr(), splits, ncls, D, int(upper),
                                       int(has_acc), out.data_ptr(), cls_p,
                                       ldc * ldc, ldc, _stream(X.device)), key)


# ---------------------------------------------------------------- K7
@_on_operands_device
def weighted_gram_tiled(Xt: torch.Tensor, h: torch.Tensor,
                        acc: torch.Tensor, D: Optional[int] = None) -> torch.Tensor:
    """acc += Xtᵀ diag(h) Xt over the upper 128x128 tiles, in place; returns
    acc (raw: finish with mirror_gram).

    Xt (rows, Dp) f32 or bf16 in the tiled layout (retile_rows), h (rows,)
    f32, acc (Dp, Dp) f32. D (default Dp) is the node's real width: tiles
    and quadrants past it are skipped and acc[D:, :] and acc[:, D:] are left
    as they are (the tiled layout's columns past D are zero, so the result
    over [:D, :D] is the same). The left operand is Xt * h rounded once to
    Xt's dtype, as the reference rounds it; f32 sums are f32 FMAs, never
    TF32, bf16 operands run on the tensor cores with f32 sums. The chunk's
    sum is added to the carry once per element (carry + chunk sum, the order
    of the reference's separate add_packed_upper), by the one CTA that owns
    the tile, so no atomics.

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:weighted_gram_tiled
    (_weighted_gram_tiled_jit, _make_weighted_kernel_tiled_acc). Bound on
    the card: f32 FMA throughput (the regression's A2 chunk, 512 x 8,256:
    0.52 ms). The split Gram of csrc/wgram.cu with a carry: 2,145 upper
    tiles fill the card without a row split; the weighting is applied once
    per staged element, so the weighted copy of J never reaches device
    memory."""
    rows, Dp = Xt.shape
    D = Dp if D is None else D
    if _on_cpu(Xt, h, acc):
        return weighted_gram_tiled_plain(Xt, h, acc)
    _check_weighted(Xt, h)
    _check(acc, "acc", (torch.float32,), 2)
    if tuple(acc.shape) != (Dp, Dp) or not 0 < D <= Dp:
        raise ValueError(f"weighted_gram_tiled: acc {tuple(acc.shape)}, "
                         f"Xt {tuple(Xt.shape)}, D={D}")
    _launch_wgram_split(Xt, h, 1, None, acc, D, True, None, "weighted_gram_tiled",
                        has_acc=True)
    LAUNCHES["weighted_gram_tiled"] += 1
    return acc


def weighted_gram_tiled_plain(Xt, h, acc):
    acc.add_(_weighted_operand(Xt, h).T @ Xt.float())
    return acc


# ---------------------------------------------------------------- K9
@_on_operands_device
def weighted_gram(X: torch.Tensor, h: torch.Tensor,
                  splits: Optional[int] = None) -> torch.Tensor:
    """A = Xᵀ diag(h) X of a flat (rows, D) operand over the upper 128x128
    tiles, ragged D masked; returns the raw (D, D) f32 A (upper triangle
    valid, lower tiles zero; finish with mirror_gram). X f32 or bf16, h
    (rows,) f32. The left operand is X * h rounded once to X's dtype, as the
    reference rounds it; f32 operands sum on f32 FMA (never TF32), bf16 ones
    on the bf16 tensor cores with f32 sums. `splits` fixes the row split
    (default: wgram_plan's).

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:weighted_gram
    (_weighted_gram_jit, _weighted_kernel_tiled). Bound on the card: f32
    FMA throughput (the regression A3, 65,536 x 1,032: 1.04 ms); the upper
    triangle of so narrow an output is 45 tiles, so the rows are split
    across CTAs and the partial sums added in split order (csrc/wgram.cu)."""
    rows, D = X.shape
    if _on_cpu(X, h):
        return weighted_gram_plain(X, h)
    _check_weighted(X, h)
    out = torch.zeros((D, D), dtype=torch.float32, device=X.device)
    _launch_wgram_split(X, h, 1, None, out, D, True, splits, "weighted_gram")
    LAUNCHES["weighted_gram"] += 1
    return out


def weighted_gram_plain(X, h):
    return _weighted_operand(X, h).T @ X.float()


# ---------------------------------------------------------------- K11
@functools.lru_cache(maxsize=16)
def _class_pairs_np(C: int) -> np.ndarray:
    """p*C + q for the upper class pairs p <= q, in np.triu_indices order."""
    iu, ju = np.triu_indices(C)
    return (iu * C + ju).astype(np.int32)


@_on_operands_device
def own_out_gram(Jt: torch.Tensor, H: torch.Tensor, C: int,
                 D: Optional[int] = None,
                 splits: Optional[int] = None) -> torch.Tensor:
    """Raw own-out Gram A[p, q, d, e] = sum_s H[s, p, q] J[s, d] J[s, e]
    for the upper class pairs p <= q; the lower pairs are zero (finish with
    mirror_own_out). Each block is whole over (d, e): it is not symmetric in
    d for p != q. With f32 J a p = q block is computed over its upper tiles
    and mirrored (it is symmetric up to the f32 rounding of J * H).

    Jt (S, Dp) f32 or bf16 in the tiled layout, H (S, C, C) f32; returns
    (C, C, Dp, Dp) f32. Only the first D columns (default all) are computed;
    the rest of each block stays zero. J * H[s, p, q] is rounded once to
    Jt's dtype, as the reference rounds it. `splits` fixes the row split
    (default: wgram_plan's).

    Replaces tensornetworksfork_tpu/ops/pallas/gram.py:own_out_gram
    (_own_out_gram_jit, _make_own_out_kernel). Bound on the card: f32 FMA
    throughput for f32 J (the regression A1, C=1, DJ=1,032: 1.04 ms for its
    one, symmetric, block; 2.08 ms whole), bf16 tensor-core throughput for
    bf16 J (the conv-TT flagship A1, 45 class pairs, DJ=900: 0.60 ms). The
    split weighted Gram of csrc/wgram.cu with the class pair on the grid's
    y axis, so the (S, C², DJ) weighted copy of J never exists; a narrow
    C=1 grid is split over the rows."""
    S, Dp = Jt.shape
    D = Dp if D is None else D
    if _on_cpu(Jt, H):
        return own_out_gram_plain(Jt, H, C, D)
    _check(Jt, "Jt", (torch.bfloat16, torch.float32), 2)
    _check(H, "H", (torch.float32,), 3)
    if tuple(H.shape) != (S, C, C) or not 0 < D <= Dp:
        raise ValueError(f"own_out_gram: H {tuple(H.shape)}, Jt {tuple(Jt.shape)}, "
                         f"C={C}, D={D}")
    out = torch.zeros((C, C, Dp, Dp), dtype=torch.float32, device=Jt.device)
    pq = _class_pairs_np(C)
    if Jt.dtype == torch.float32:
        # a p = q block is symmetric up to the f32 rounding of J * H (a
        # reordering's worth), so only its upper tiles are computed and then
        # mirrored; in bf16 the rounding (~2^-9 of a term) would show, so
        # there every block is computed whole, as the reference does
        diag = pq % (C + 1) == 0
        _launch_wgram_split(Jt, H, C * C, _table(("cls_diag", C), pq[diag], Jt.device),
                            out, D, True, splits, "own_out_gram")
        if not diag.all():
            _launch_wgram_split(Jt, H, C * C, _table(("cls_off", C), pq[~diag], Jt.device),
                                out, D, False, splits, "own_out_gram")
        ii = torch.arange(C, device=Jt.device)
        out[ii, ii, :D, :D] = mirror_gram(out[ii, ii, :D, :D])
    else:
        _launch_wgram_split(Jt, H, C * C, _table(("cls", C), pq, Jt.device), out, D,
                            False, splits, "own_out_gram")
    LAUNCHES["own_out_gram"] += 1
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
    symmetric A); over the last two dims of a batch."""
    return torch.triu(A) + torch.triu(A, 1).transpose(-1, -2)
