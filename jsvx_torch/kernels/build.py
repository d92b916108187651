"""Build the port's CUDA kernels on first use and bind them with ctypes.

``nvcc`` compiles each source in ``jsvx_torch/csrc/`` for Hopper
(``sm_90a``), all at once in parallel processes, and links them into one
shared library with a plain C interface, under ``build/jsvx_torch/<key>/``
at the root of the checkout (``build/`` is git-ignored): the five kernels
of the port's paths (the three picture kernels, the compact wire's
expansion and the display colour).  The key is a hash of the sources, of
every header in ``csrc/`` and of the command, so an edited file builds
anew and an unchanged tree is loaded from disk.  Nothing is built at
import time.
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
#: the kernels the decode and the display run
SOURCES = ("fused_decode.cu", "recon.cu", "mc.cu", "expand.cu", "color.cu")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "jsvx_torch")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the argument types of the picture kernels' entry points (fused, recon)
_PICTURE_ARGS = [_I, _P, _P, _I, _P, _P, _P, _I, _I, _P]
#: the library's C entry points and their argument types
ENTRY_POINTS = {
    "jsvx_fused_decode_picture": _PICTURE_ARGS,
    "jsvx_recon_picture": _PICTURE_ARGS,
    "jsvx_mc_picture": [_I, _P, _P, _I, _I, _P],
    "jsvx_expand_gop": [_I, _P, _P, _I, _P, _I, _P],
    "jsvx_colour_frame": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
}

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
    """Hash of :data:`SOURCES` and every ``*.cuh`` in ``csrc`` (names and
    bytes) and of the commands: a header edit changes it as a source edit
    does."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(csrc)):
        if name in SOURCES or name.endswith(".cuh"):
            h.update(name.encode() + b"\0")
            with open(os.path.join(csrc, name), "rb") as f:
                h.update(f.read())
    for compile_only in (True, False):
        h.update(" ".join(nvcc_command(["SRC"], "OUT",
                                       compile_only=compile_only)[1:])
                 .encode())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    for fn_name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, fn_name)
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
    """Build (if needed) and load the kernels' library; once per
    process."""
    global _built
    with _lock:
        if _built is not None:
            return _built
        out_dir = os.path.join(BUILD_ROOT, _key())
        path = os.path.join(out_dir, "libjsvx_torch_kernels.so")
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
