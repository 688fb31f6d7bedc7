"""TT compression of polynomial design tensors (port of
tensornetworksfork_tpu/ops/compression.py).

The degree-d feature tensor of a dataset is held as a tensor train whose
last bond is the sample axis, so the design matrix of a high-degree
polynomial model never materialises. Blocks have shape (k_left, p, d,
k_right): left bond, physical feature, a dummy axis, right bond. The first
block is xᵀ reshaped (1, p, 1, B); the middle blocks are diagonal
embeddings of xᵀ (B, p, 1, B). `compress` splits a contracted pair back into
two blocks by a truncated SVD; `concat` is the direct sum along both bonds;
`DataCompression` streams batches through them (sequential), merges them by
a binary tree (parallel) or also splits the physical axis (feature).

Everything runs in f32 on the blocks' device: `torch.einsum` for the pair
contractions (TF32 is off for the whole package) and
`torch.linalg.svd(full_matrices=False)`. Singular vectors are fixed only up
to sign (and, for repeated singular values, up to a rotation), and LAPACK,
torch on the CPU and cuSOLVER choose differently: the blocks of two
libraries agree as contracted products, not factor by factor.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


def _truncated_svd(matrix: torch.Tensor, rank: int, cut_off: Optional[float]):
    """(u[:, :rank], s, v, rank, split_err) with the rank cut to the
    singular values whose flipped cumulative share exceeds cut_off."""
    rank = min(rank, min(matrix.shape))
    u, s, v = torch.linalg.svd(matrix, full_matrices=False)
    s_cumsum = torch.cumsum(torch.flip(s, (0,)), 0)
    total = torch.sum(s)
    if cut_off is not None:
        k = int(torch.sum(s_cumsum / total > cut_off))
        rank = max(min(rank, k), 1)
    split_err = float(s_cumsum[-rank] / total)
    return u[:, :rank], s, v, rank, split_err


def compress(block_left: torch.Tensor, block_right: torch.Tensor, rank: int = 5,
             cut_off: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """SVD-split the pair contraction back into two blocks, truncated to
    `rank` (or by `cut_off`). Returns (left, right, split_err)."""
    sl, sr = tuple(block_left.shape), tuple(block_right.shape)
    contract = torch.einsum("abcd,defg->abcefg", block_left, block_right)
    matrix = contract.reshape(int(np.prod(sl[:3])), -1)
    u, s, v, rank, split_err = _truncated_svd(matrix, rank, cut_off)
    v = s[:rank, None] * v[:rank]
    return (u.reshape(sl[:-1] + (rank,)), v.reshape((rank,) + sr[1:]),
            split_err)


def train_compress(blocks: List[torch.Tensor], rank: int = 5,
                   cut_off: Optional[float] = None):
    """Left-to-right pairwise compression pass. Returns (blocks, errors)."""
    errors = []
    blocks = list(blocks)
    for i in range(len(blocks) - 1):
        u, v, err = compress(blocks[i], blocks[i + 1], rank=rank, cut_off=cut_off)
        blocks[i], blocks[i + 1] = u, v
        errors.append(err)
    return blocks, errors


def concat(block1: torch.Tensor, block2: torch.Tensor) -> torch.Tensor:
    """Block-diagonal direct sum along both bonds (a bond of size 1 on
    either side is shared, not stacked)."""
    rl = (max(block1.shape[0], block2.shape[0])
          if 1 in (block1.shape[0], block2.shape[0])
          else block1.shape[0] + block2.shape[0])
    rr = (max(block1.shape[3], block2.shape[3])
          if 1 in (block1.shape[3], block2.shape[3])
          else block1.shape[3] + block2.shape[3])
    out = block1.new_zeros((rl, block1.shape[1], block1.shape[2], rr))
    out[: block1.shape[0], ..., : block1.shape[3]] = block1
    out[rl - block2.shape[0]:, ..., rr - block2.shape[3]:] = block2
    return out


def train_concat(blocks1: List[torch.Tensor], blocks2: List[torch.Tensor]):
    if len(blocks1) != len(blocks2):
        raise ValueError("blocks1 and blocks2 must have the same length")
    return [concat(b1, b2) for b1, b2 in zip(blocks1, blocks2)]


def block_left_feature_compress(block: torch.Tensor, rank: int = 5,
                                cut_off: Optional[float] = None):
    """Split the two leading axes off a block by SVD. Returns (left, rest,
    split_err)."""
    sb = tuple(block.shape)
    matrix = block.reshape(sb[0] * sb[1], -1)
    u, s, v, rank, split_err = _truncated_svd(matrix, rank, cut_off)
    u = u.reshape(sb[0], sb[1], sb[-2], rank)
    v = (s[:rank, None] * v[:rank]).reshape((rank,) + sb[2:])
    return u, v, split_err


def feature_split(block: torch.Tensor, feature_shape, rank: int = 5,
                  cut_off: Optional[float] = None):
    """Split one physical axis into factor axes. Returns (blocks, mean
    split_err)."""
    block = block.reshape((block.shape[0],) + tuple(feature_shape)
                          + tuple(block.shape[-2:]))
    split_blocks, errors = [], []
    for _ in range(len(feature_shape) - 1):
        u, block, err = block_left_feature_compress(block, rank=rank,
                                                    cut_off=cut_off)
        split_blocks.append(u)
        errors.append(err)
    return split_blocks + [block], float(np.mean(errors)) if errors else 0.0


def _raw_blocks(batch: torch.Tensor, degree: int) -> List[torch.Tensor]:
    """Uncompressed data-tensor blocks of one batch (B, p): the first block
    xᵀ (1, p, 1, B); each middle block the diagonal embedding
    D[b, p, 0, b'] = x[b, p] δ(b, b'), (B, p, 1, B). A middle block is kept
    dense, as in the JAX package: B²·p values, 4·B²·p bytes in f32 (a
    4,096-row batch of 17 features makes 1.1 GB)."""
    xt = batch.T
    left = xt.reshape(1, xt.shape[0], 1, xt.shape[1])
    if degree == 1:
        return [left]
    B = batch.shape[0]
    eye = torch.eye(B, dtype=batch.dtype, device=batch.device)
    mid = torch.einsum("bp,bc->bpc", batch, eye)[:, :, None, :]
    return [left] + [mid] * (degree - 1)


class DataCompression:
    """Compression of the rows of X: `non_compressed`,
    `sequential_compress`, `parallel_compress` and `feature_compress`.
    X goes to `device` (the card unless the caller asks for the CPU) as
    f32; the blocks live there."""

    def __init__(self, X, full_svd: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.X = torch.as_tensor(np.asarray(X) if not torch.is_tensor(X) else X,
                                 dtype=torch.float32, device=self.device)
        self.blocks = None

    def _batch(self, i: int, batch_size: int) -> torch.Tensor:
        return self.X[i * batch_size:(i + 1) * batch_size]

    def _num_batches(self, batch_size: int) -> int:
        return (self.X.shape[0] + batch_size - 1) // batch_size

    def non_compressed(self, degree: int, batch_index=None, batch_size=None):
        if batch_index is None or batch_size is None:
            batch_index, batch_size = 0, self.X.shape[0]
        self.blocks = _raw_blocks(self._batch(batch_index, batch_size), degree)
        return self.blocks

    def sequential_compress(self, batch_size: int, degree: int, rank: int = 5,
                            cut_off: Optional[float] = None):
        """Stream batches: the previous TT and the new batch's raw blocks
        are direct-summed, then recompressed."""
        previous = []
        for i in range(self._num_batches(batch_size)):
            raw = _raw_blocks(self._batch(i, batch_size), degree)
            blocks = train_concat(previous, raw) if previous else raw
            previous, _ = train_compress(blocks, rank=rank, cut_off=cut_off)
        self.blocks = previous
        return self.blocks

    def parallel_compress(self, batch_size: int, degree: int,
                          iterations: Optional[int] = None, cut_size: int = 2,
                          rank: int = 5, cut_off: Optional[float] = None,
                          rank_factor: float = 1.5):
        """Compress each batch, then merge `cut_size` at a time by a binary
        tree, over-provisioning the rank by rank_factor until the last
        level."""
        blocks = []
        for i in range(self._num_batches(batch_size)):
            blk, _ = train_compress(_raw_blocks(self._batch(i, batch_size), degree),
                                    rank=int(rank_factor * rank / cut_size),
                                    cut_off=cut_off)
            blocks.append(blk)
        if iterations is None:
            iterations = (1 + int(np.log(max(len(blocks), 1)) / np.log(cut_size))
                          if len(blocks) > 1 else 0)
        for it in range(iterations):
            new_blocks = []
            _rank = rank if it == iterations - 1 else int(rank_factor * rank / cut_size)
            for i in range(0, len(blocks), cut_size):
                merged = blocks[i]
                for b in blocks[i + 1:i + cut_size]:
                    merged = train_concat(merged, b)
                merged, _ = train_compress(merged, rank=_rank, cut_off=cut_off)
                new_blocks.append(merged)
            blocks = new_blocks
        if len(blocks) > 1:
            merged = blocks[0]
            for b in blocks[1:]:
                merged = train_concat(merged, b)
            blocks = [train_compress(merged, rank=rank, cut_off=cut_off)[0]]
        self.blocks = blocks[0] if blocks else []
        return self.blocks

    def feature_compress(self, batch_size: int, degree: int, feature_dim,
                         rank: int = 5, cut_off: Optional[float] = None):
        """Sequential compression with each block's physical axis split
        into `feature_dim` factors."""
        previous = []
        for i in range(self._num_batches(batch_size)):
            new_blocks = []
            for blk in _raw_blocks(self._batch(i, batch_size), degree):
                split, _ = feature_split(blk, feature_dim, rank=rank,
                                         cut_off=cut_off)
                new_blocks.extend(split)
            blocks = train_concat(previous, new_blocks) if previous else new_blocks
            previous, _ = train_compress(blocks, rank=rank, cut_off=cut_off)
        self.blocks = previous
        return self.blocks
