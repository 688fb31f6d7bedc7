"""Build and load the package's CUDA kernels (every `csrc/*.cu`, with the
headers `csrc/*.cuh` they include).

nvcc compiles each source to an object, all at once in parallel, and links
them into one shared library with a plain C interface, which ctypes loads;
no PyTorch header is compiled, so a build takes seconds. The library lands
in `build/tnf_torch_kernels/` at the repository root (next to the package),
named by a hash of the sources and the flags, and is built at the first
kernel launch of a process. Nothing here runs at import time.

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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tnf_torch_kernels"

# IEEE division, reciprocal and rounding are part of the quantiser's
# contract, so never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "tnf_retile_hmix_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tnf_retile_hmix_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tnf_quantize_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tnf_gram_q": (_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tnf_retile_rows_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tnf_retile_rows_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tnf_gram_tile": (),
    "tnf_wgram_split_f32": (_P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                            _I, _P, _P, _L, _I, _L, _I, _P),
    "tnf_wgram_split_bf16": (_P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                             _I, _P, _P, _L, _I, _L, _I, _P),
    "tnf_wgram_reduce": (_P, _I, _I, _I, _I, _I, _P, _P, _L, _I, _P),
    "tnf_gram_tf32x3": (_P, _P, _I, _P, _I, _I, _I, _P, _I, _I, _P),
    "tnf_gram_bf16_cluster": (_P, _P, _I, _P, _I, _I, _I, _I, _P, _I, _P),
    "tnf_gram_bf16_cluster_occupancy": (_I,),
    "tnf_wgram_tile": (),
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


def sources() -> list:
    """The kernel sources: every `csrc/*.cu`, in name order."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    """The headers they include: every `csrc/*.cuh`."""
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """The library for these sources, headers and flags."""
    digest = hashlib.sha256()
    for src in sources() + headers():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtnf_gram_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every `csrc/*.cu` (one nvcc each, started together) and link
    them into one library, unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    srcs = sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        logs = [os.path.join(tmp, src.stem + ".log") for src in srcs]
        procs = []
        for src, obj, lg in zip(srcs, objs, logs):
            with open(lg, "w") as f:  # a file, not a pipe, so no nvcc blocks on it
                procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                              stdout=f, stderr=subprocess.STDOUT))
        rcs = [proc.wait() for proc in procs]
        log = [Path(lg).read_text() for lg in logs]
        for src, rc, text in zip(srcs, rcs, log):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) on {src}:\n{text}")
        lib_tmp = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(lib_tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log="".join(log),
                      path=str(out))
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
