"""Build and load the package's CUDA kernels (`csrc/gram.cu`).

nvcc compiles the source into a shared library with a plain C interface,
which ctypes loads; no PyTorch header is compiled, so a build takes seconds.
The library lands in `build/tnf_torch_kernels/` at the repository root (next
to the package), named by a hash of the source and the flags, and is built
at the first kernel launch of a process. Nothing here runs at import time.

There is no fallback: a missing nvcc, a failed build or a failed load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "gram.cu"
BUILD_DIR = _PKG.parent / "build" / "tnf_torch_kernels"

# IEEE division, reciprocal and rounding are part of the quantiser's
# contract, so never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tnf_retile_hmix_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tnf_retile_hmix_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tnf_quantize_bf16": (_P, _P, _P, _I, _I, _I, _I, _P),
    "tnf_gram_q": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tnf_gram_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tnf_gram_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tnf_retile_rows_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "tnf_retile_rows_bf16": (_P, _P, _P, _P, _I, _I, _I, _P),
    "tnf_wgram_f32": (_P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tnf_wgram_bf16": (_P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tnf_gram_tile": (),
}

_lock = threading.Lock()
_lib = None
# what the last build in this process reported: seconds and nvcc's output
# (ptxas -v: registers, shared memory and spills per kernel)
BUILD_INFO = {"seconds": None, "log": "", "path": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of tensornetworksfork_tpu_torch cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtnf_gram_{digest}.so"


def build() -> Path:
    """Compile `csrc/gram.cu` unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr, path=str(out))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib
