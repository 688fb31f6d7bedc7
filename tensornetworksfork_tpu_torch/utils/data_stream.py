"""Shuffled-minibatch streaming over the native prefetcher (port of
tensornetworksfork_tpu/utils/data_stream.py).

`MinibatchStream` yields (batch, indices) pairs in a fresh seeded
permutation each epoch, gathered on the host by the C++ worker thread
(`native/tnf_stream.cpp`) into a ring of staging buffers while the trainer
consumes the previous batch. Sources: a host numpy array, or a .npy file
streamed through mmap (the worker touches only the rows of the current
batch). The permutations come from the library's mt19937_64 shuffle, the
same source as the JAX package's, so one seed gives the same index sequence
in both packages.

Without the native library (`native.get_lib()` is None) the stream keeps
its API over a numpy gather whose permutations come from a numpy Generator:
a different sequence, and `is_native` is False. Callers that must have the
native sequence check `is_native` (`TensorTrainBatchRegressor(stream=
"native")` raises instead of taking the numpy one).
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, Tuple

import numpy as np

from ..native import get_lib


def _npy_layout(path: str):
    """(offset, shape, dtype) of a .npy file without loading it."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        np.lib.format._check_version(version)
        shape, fortran, dtype = np.lib.format._read_array_header(f, version)
        if fortran:
            raise ValueError("fortran-order .npy not supported for streaming")
        return f.tell(), shape, dtype


class MinibatchStream:
    """Iterate shuffled minibatches of a (n, ...) array or .npy file.

    for xb, idx in stream.epoch():   # one full permutation of the data
        ...                          # xb: (rows, ...) copy; idx: (rows,)
    """

    def __init__(self, X, batch_size: int, seed: int = 0, buffers: int = 3):
        self._lib = get_lib()
        self._native = self._lib is not None
        self._handle = None
        self._owner = None  # keeps a mem-backed source alive
        if isinstance(X, (str, os.PathLike)):
            offset, shape, dtype = _npy_layout(os.fspath(X))
            self.n = int(shape[0])
            self.row_shape = tuple(shape[1:])
            self.dtype = dtype
            self.batch_size = min(int(batch_size), self.n)
            sample_bytes = int(np.prod(self.row_shape, dtype=np.int64)
                               * dtype.itemsize) or dtype.itemsize
            if self._native:
                self._handle = self._lib.tnf_stream_open_file(
                    os.fspath(X).encode(), offset, self.n, sample_bytes,
                    self.batch_size, seed, buffers)
                if self._handle < 0:
                    raise OSError(f"tnf_stream_open_file failed "
                                  f"({self._handle}) for {X}")
            else:
                self._owner = np.load(X, mmap_mode="r")
        else:
            X = np.ascontiguousarray(X)
            self.n = int(X.shape[0])
            self.row_shape = tuple(X.shape[1:])
            self.dtype = X.dtype
            self.batch_size = min(int(batch_size), self.n)
            sample_bytes = X.strides[0] if X.ndim > 1 else X.itemsize
            self._owner = X
            if self._native:
                self._handle = self._lib.tnf_stream_open_mem(
                    X.ctypes.data_as(ctypes.c_void_p), self.n, sample_bytes,
                    self.batch_size, seed, buffers)
                if self._handle < 0:
                    raise OSError(
                        f"tnf_stream_open_mem failed ({self._handle})")
        self._rng = np.random.default_rng(seed)  # numpy path only
        self.batches_per_epoch = -(-self.n // self.batch_size)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One full pass: batches_per_epoch (batch, indices) pairs covering
        every sample exactly once in this epoch's permutation."""
        if self._handle is not None:
            for _ in range(self.batches_per_epoch):
                yield self._next_native()
        else:
            perm = self._rng.permutation(self.n)
            src = self._owner
            for pos in range(0, self.n, self.batch_size):
                idx = perm[pos:pos + self.batch_size]
                yield np.ascontiguousarray(src[idx]), idx

    def _next_native(self):
        buf = np.empty((self.batch_size, *self.row_shape), self.dtype)
        idx = np.empty(self.batch_size, np.int64)
        rows = self._lib.tnf_stream_next(
            self._handle, buf.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
        if rows < 0:
            raise OSError(f"tnf_stream_next failed ({rows})")
        return buf[:rows], idx[:rows]

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def close(self):
        if self._handle is not None:
            self._lib.tnf_stream_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
