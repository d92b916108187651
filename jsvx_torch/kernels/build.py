"""Build the port's CUDA kernels on first use and bind them with ctypes.

``nvcc`` compiles ``jsvx_torch/csrc/*.cu`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, under ``build/jsvx_torch/<key>/``
at the root of the checkout (``build/`` is git-ignored).  The key is a hash
of the sources and the command, so an edited source builds anew and an
unchanged one is loaded from disk.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("fused_decode.cu",)
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "jsvx_torch")
LIB_NAME = "libjsvx_torch_kernels.so"

_lock = threading.Lock()
_built: "BuiltLibrary | None" = None


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: str
    seconds: float          # time spent in nvcc (0.0 when loaded from disk)
    log: str                # nvcc's output (ptxas register/smem report)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def nvcc_command(sources: list[str], out: str) -> list[str]:
    """The compile command: sm_90a, no FMA contraction (the IDCT's bits
    must not depend on the compiler's choice), ptxas resource report."""
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", out, *sources]


def _key(sources: list[str]) -> str:
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(nvcc_command(["SRC"], "OUT")[1:]).encode())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.jsvx_fused_decode_plane
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])


def load() -> BuiltLibrary:
    """Build (if needed) and load the kernel library; once per process."""
    global _built
    with _lock:
        if _built is not None:
            return _built
        sources = [os.path.join(CSRC, s) for s in SOURCES]
        out_dir = os.path.join(BUILD_ROOT, _key(sources))
        path = os.path.join(out_dir, LIB_NAME)
        seconds, log = 0.0, ""
        if not os.path.exists(path):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            t0 = time.perf_counter()
            proc = subprocess.run(nvcc_command(sources, tmp),
                                  capture_output=True, text=True,
                                  timeout=600)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        _declare(lib)
        _built = BuiltLibrary(lib=lib, path=path, seconds=seconds, log=log)
        return _built
