"""Native host-IO runtime (C++ via ctypes; port of
tensornetworksfork_tpu/native/__init__.py).

Builds and binds `libtnf_io.so` from this package's copies of `tnf_io.cpp`
(idx-ubyte and numeric CSV parsers) and `tnf_stream.cpp` (the shuffled
minibatch prefetcher of `utils/data_stream.py`). g++ compiles both at the
first `get_lib()` of a process into `build/tnf_native/` at the repository
root (next to the package, as the CUDA kernels' `build/tnf_torch_kernels/`),
named by a hash of the sources and the flags; nothing is written into the
package. Nothing here runs at import time.

`get_lib()` keeps the JAX package's contract: None when the library cannot
be built or loaded, so that `read_idx` / `parse_csv` callers take their
numpy readers. Why it failed (g++'s stderr, or the loader's error) stays in
`build_error()`; `require_lib()` raises with it, for callers that must not
take another path (`TensorTrainBatchRegressor(stream="native")`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = ("tnf_io.cpp", "tnf_stream.cpp")
BUILD_DIR = _DIR.parents[1] / "build" / "tnf_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None


def lib_path() -> Path:
    """Where the library of these sources and flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"libtnf_io-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> Optional[str]:
    """Compiles the sources into `path` (through a temporary file, so that
    a concurrent build never loads a half-written library). Returns None, or
    why the build failed."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, *(str(_DIR / s) for s in SOURCES), "-o", tmp,
           "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        return f"{' '.join(cmd)}: {e}"
    if res.returncode != 0:
        os.unlink(tmp)
        return f"{' '.join(cmd)} exited {res.returncode}:\n{res.stderr}"
    os.replace(tmp, path)
    return None


def _bind(lib: ctypes.CDLL) -> None:
    lib.tnf_stream_open_mem.restype = ctypes.c_long
    lib.tnf_stream_open_mem.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_ulong, ctypes.c_int]
    lib.tnf_stream_open_file.restype = ctypes.c_long
    lib.tnf_stream_open_file.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_ulong, ctypes.c_int]
    lib.tnf_stream_next.restype = ctypes.c_long
    lib.tnf_stream_next.argtypes = [
        ctypes.c_long, ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
    lib.tnf_stream_close.restype = None
    lib.tnf_stream_close.argtypes = [ctypes.c_long]
    lib.tnf_read_idx.restype = ctypes.c_long
    lib.tnf_read_idx.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
    lib.tnf_parse_csv.restype = ctypes.c_long
    lib.tnf_parse_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built at the first call of the process; None
    when it cannot be built or loaded (`build_error()` says why)."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not path.exists():
            _error = _build(path)
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _error = f"loading {path}: {e}"
            return None
        _bind(lib)
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the library is unavailable (g++'s stderr, or the loader's
    error), or None."""
    return _error


def require_lib() -> ctypes.CDLL:
    """The native library, or RuntimeError carrying why it is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "the native library (tensornetworksfork_tpu_torch/native, built "
            f"with g++ into {BUILD_DIR}) is unavailable:\n"
            f"{build_error() or 'get_lib() returned None'}")
    return lib


def read_idx(path: str) -> Optional[np.ndarray]:
    """idx ubyte file -> uint8 ndarray, or None if the native lib is
    unavailable or the file is not a valid idx file (the caller takes the
    Python parser)."""
    lib = get_lib()
    if lib is None:
        return None
    shape = (ctypes.c_long * 4)()
    ndim = ctypes.c_int()
    total = lib.tnf_read_idx(path.encode(), None, 0, shape, ctypes.byref(ndim))
    if total < 0:
        return None
    out = np.empty(total, np.uint8)
    got = lib.tnf_read_idx(path.encode(),
                           out.ctypes.data_as(ctypes.c_void_p), total, shape,
                           ctypes.byref(ndim))
    if got != total:
        return None
    return out.reshape(tuple(shape[i] for i in range(ndim.value)))


def parse_csv(path: str, skip_header: bool = True
              ) -> Optional[Tuple[np.ndarray, int]]:
    """Numeric CSV -> (float32 array (rows, ncols), ncols), or None without
    the lib or for a file it rejects (jagged rows)."""
    lib = get_lib()
    if lib is None:
        return None
    capacity = max(os.path.getsize(path), 1024)  # floats <= bytes
    out = np.empty(capacity, np.float32)
    ncols = ctypes.c_int()
    rows = lib.tnf_parse_csv(path.encode(),
                             out.ctypes.data_as(ctypes.c_void_p), capacity,
                             ctypes.byref(ncols), 1 if skip_header else 0)
    if rows < 0 or ncols.value == 0:
        return None
    return out[: rows * ncols.value].reshape(rows, ncols.value), ncols.value
