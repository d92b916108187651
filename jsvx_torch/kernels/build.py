"""Build the port's CUDA kernels on first use and bind them with ctypes.

``nvcc`` compiles each ``jsvx_torch/csrc/*.cu`` for Hopper (``sm_90a``),
all at once in parallel processes, and links them into one shared library
with a plain C interface, under ``build/jsvx_torch/<key>/`` at the root of
the checkout (``build/`` is git-ignored).  The key is a hash of every
source and header in ``csrc/`` and of the command, so an edited file
builds anew and an unchanged tree is loaded from disk.  Nothing is built
at import time.
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
#: ``fused_decode_baseline.cu`` is the fused kernel's first design, which
#: only ``chip_smoke.py`` launches (its baseline in turns)
SOURCES = ("fused_decode.cu", "recon.cu", "mc.cu", "fused_decode_baseline.cu")
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


def nvcc_command(sources: list[str], out: str, *,
                 compile_only: bool = False) -> list[str]:
    """The nvcc command: sm_90a, no FMA contraction (the IDCT's bits must
    not depend on the compiler's choice), ptxas resource report.  It
    compiles one source to an object with ``compile_only``, and otherwise
    compiles and links ``sources`` (sources or objects) into a shared
    library."""
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
            "-Xcompiler", "-fPIC",
            *(["-c"] if compile_only else ["-shared"]), "-o", out, *sources]


def _key(csrc: str = CSRC) -> str:
    """Hash of every ``*.cu`` and ``*.cuh`` in ``csrc`` (names and bytes)
    and of the commands: a header edit changes it as a source edit does."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(csrc)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode() + b"\0")
            with open(os.path.join(csrc, name), "rb") as f:
                h.update(f.read())
    for compile_only in (True, False):
        h.update(" ".join(nvcc_command(["SRC"], "OUT",
                                       compile_only=compile_only)[1:])
                 .encode())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
            ("jsvx_fused_decode_picture",
             [i32, ptr, ptr, i32, ptr, ptr, ptr, i32, i32, ptr]),
            ("jsvx_fused_decode_plane_baseline",
             [ptr] * 11 + [i32] * 5 + [ptr]),
            ("jsvx_recon_plane", [ptr] * 7 + [i32] * 4 + [ptr]),
            ("jsvx_mc_plane", [ptr] * 4 + [i32] * 4 + [ptr])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes


def _run_nvcc(commands: list[list[str]]) -> tuple[str, list[int]]:
    """Start every command at once, wait for all; (output, exit codes)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in commands]
    logs, codes = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
            codes.append(p.returncode)
    finally:                             # a timeout leaves none running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return "".join(logs), codes


def load() -> BuiltLibrary:
    """Build (if needed) and load the kernel library; once per process."""
    global _built
    with _lock:
        if _built is not None:
            return _built
        out_dir = os.path.join(BUILD_ROOT, _key())
        path = os.path.join(out_dir, LIB_NAME)
        seconds, log = 0.0, ""
        if not os.path.exists(path):
            os.makedirs(out_dir, exist_ok=True)
            tag = f"tmp{os.getpid()}"
            objs = [os.path.join(out_dir, f"{s}.{tag}.o") for s in SOURCES]
            t0 = time.perf_counter()
            log, codes = _run_nvcc([
                nvcc_command([os.path.join(CSRC, s)], o, compile_only=True)
                for s, o in zip(SOURCES, objs)])
            if any(codes):
                raise RuntimeError(f"nvcc failed ({codes}):\n{log}")
            tmp = f"{path}.{tag}"
            link_log, (code,) = _run_nvcc([nvcc_command(objs, tmp)])
            seconds = time.perf_counter() - t0
            log += link_log
            if code:
                raise RuntimeError(f"nvcc link failed ({code}):\n{log}")
            for o in objs:
                os.remove(o)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        _declare(lib)
        _built = BuiltLibrary(lib=lib, path=path, seconds=seconds, log=log)
        return _built
