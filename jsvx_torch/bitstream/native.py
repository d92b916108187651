"""ctypes binding to the C++ slice/macroblock/block parser.

Builds ``jsvx_torch/native/jsv_parse.cc`` (a verbatim copy of
``jsvx/native/jsv_parse.cc``) on first use with ``g++ -O3`` into
``build/jsvx_torch/native/<key>/`` at the root of the checkout
(``build/`` is git-ignored; the key hashes the source and the command, so
an edited source builds anew), never next to the source, and exposes
:class:`NativeStreamParser`, a drop-in accelerated replacement for the
slice layer of :class:`jsvx_torch.bitstream.parser.StreamParser`.  A
failed build raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..coding import tables as T
from ..coding.vlc import compiled_tables

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "jsv_parse.cc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "jsvx_torch",
                          "native")

_lock = threading.Lock()
_lib = None

_ERRORS = {
    -1: "bitstream exhausted mid-picture",
    -2: "invalid VLC code",
    -3: "macroblock address out of range",
}


def gxx_command(out: str) -> list[str]:
    return ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
            "-o", out, _SRC]


def library_path() -> str:
    """Where the parser library of this source and command lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(gxx_command("OUT")).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libjsv_parse.so")


def _build(path: str) -> None:
    """Compile the parser to ``path`` unless it is there; raise with the
    compiler's output when the build fails."""
    if os.path.exists(path):
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        proc = subprocess.run(gxx_command(tmp), capture_output=True,
                              text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build the C++ parser: {e}") \
            from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the C++ parser "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        _build(path)
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.jsv_parser_new.restype = ctypes.c_void_p
        lib.jsv_parser_new.argtypes = [i32p, u8p, ctypes.c_int] * 8 + [u8p]
        lib.jsv_parser_free.argtypes = [ctypes.c_void_p]
        lib.jsv_parse_picture_slices.restype = ctypes.c_int64
        lib.jsv_parse_picture_slices.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            i16p, i16p, i16p, i16p, u8p, u8p, u8p, u8p,
            u8p, u8p, i16p, u8p,
            u8p, u8p, i16p, i16p, i16p, i16p, u8p, u8p, u8p, u8p,
            ctypes.c_int32,
        ]
        u16p = ctypes.POINTER(ctypes.c_uint16)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.jsv_parse_picture_slices_compact.restype = ctypes.c_int64
        lib.jsv_parse_picture_slices_compact.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            u16p, u16p, u16p, u16p, i64p, i64p,
            u8p, u8p, u8p, u8p,
            u8p, u8p, i16p, u8p, i32p,
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def _as(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeStreamParser:
    """Owns a C++ parser handle initialised with the shared VLC LUTs."""

    def __init__(self):
        lib = self._lib = _load()
        v = compiled_tables()
        # keep LUT arrays alive for the lifetime of the handle
        self._keep = []

        def lut_args(name):
            t = v[name]
            val = np.ascontiguousarray(t.lut_value, dtype=np.int32)
            ln = np.ascontiguousarray(t.lut_length, dtype=np.uint8)
            self._keep += [val, ln]
            return [_as(val, ctypes.c_int32), _as(ln, ctypes.c_uint8),
                    t.max_len]

        zz = np.ascontiguousarray(T.ZIG_ZAG, dtype=np.uint8)
        self._keep.append(zz)
        args = (lut_args("mb_addr_inc") + lut_args("mb_type_i")
                + lut_args("mb_type_p") + lut_args("cbp")
                + lut_args("motion") + lut_args("dc_size_lum")
                + lut_args("dc_size_chrom") + lut_args("dct_coeff")
                + [_as(zz, ctypes.c_uint8)])
        self._handle = lib.jsv_parser_new(*args)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.jsv_parser_free(self._handle)
        except Exception:
            pass

    def parse_picture_slices(self, data: np.ndarray, start_bit: int,
                             ft, mb_w: int, mb_h: int,
                             seq=None, n_threads: int = 1) -> int:
        """Parse all slices of one picture into ``ft`` (FrameTensors).

        ``data`` is the full stream as a contiguous uint8 array;
        ``start_bit`` the absolute bit position just after the picture
        header.  With ``seq`` (for its quant matrices) the per-pixel
        dequant sideband (``ft.mult``/``ft.flags``) is emitted in the
        same pass.  ``n_threads > 1`` fans the picture's slices out over
        C++ threads (use when pictures are NOT already parsed in
        parallel).  Returns the byte offset of the picture-terminating
        start code (or len(data)).
        """
        assert data.dtype == np.uint8 and data.flags.c_contiguous
        null16 = ctypes.POINTER(ctypes.c_int16)()
        null8 = ctypes.POINTER(ctypes.c_uint8)()
        yuva = ft.n_comps == 4
        lv_a = (_as(ft.levels[3], ctypes.c_int16) if yuva else null16)
        lnz_a = (_as(ft.lnz[3], ctypes.c_uint8) if yuva else null8)
        if seq is not None:
            iq = np.ascontiguousarray(seq.intra_q, dtype=np.uint8)
            nq = np.ascontiguousarray(seq.non_intra_q, dtype=np.uint8)
            ft.mult = tuple(np.zeros(p.shape, np.int16)
                            for p in ft.levels)
            ft.flags = tuple(np.zeros(p.shape, np.uint8)
                             for p in ft.levels)
            extra = [_as(iq, ctypes.c_uint8), _as(nq, ctypes.c_uint8),
                     _as(ft.mult[0], ctypes.c_int16),
                     _as(ft.mult[1], ctypes.c_int16),
                     _as(ft.mult[2], ctypes.c_int16),
                     (_as(ft.mult[3], ctypes.c_int16) if yuva else null16),
                     _as(ft.flags[0], ctypes.c_uint8),
                     _as(ft.flags[1], ctypes.c_uint8),
                     _as(ft.flags[2], ctypes.c_uint8),
                     (_as(ft.flags[3], ctypes.c_uint8) if yuva else null8)]
            keep = (iq, nq)
        else:
            extra = [null8, null8, null16, null16, null16, null16,
                     null8, null8, null8, null8]
            keep = ()
        rc = self._lib.jsv_parse_picture_slices(
            self._handle, _as(data, ctypes.c_uint8), data.size, start_bit,
            mb_w, mb_h, ft.picture_type,
            1 if ft.full_pel else 0, ft.f_code, 1 if yuva else 0,
            _as(ft.levels[0], ctypes.c_int16),
            _as(ft.levels[1], ctypes.c_int16),
            _as(ft.levels[2], ctypes.c_int16),
            lv_a,
            _as(ft.lnz[0], ctypes.c_uint8),
            _as(ft.lnz[1], ctypes.c_uint8),
            _as(ft.lnz[2], ctypes.c_uint8),
            lnz_a,
            _as(ft.mb_quant, ctypes.c_uint8),
            _as(ft.mb_intra, ctypes.c_uint8),
            _as(ft.mb_mv, ctypes.c_int16),
            _as(ft.mb_rep_add, ctypes.c_uint8),
            *extra,
            int(n_threads),
        )
        del keep
        if rc < 0:
            raise ValueError(
                f"native parse failed: {_ERRORS.get(rc, rc)}")
        return int(rc)

    def parse_picture_compact(self, data: np.ndarray, start_bit: int,
                              hdr, mb_w: int, mb_h: int, yuva: bool,
                              cpk: tuple, counts: tuple,
                              mb_quant: np.ndarray, mb_intra: np.ndarray,
                              mb_mv: np.ndarray, mb_rep_add: np.ndarray,
                              n_threads: int = 1) -> tuple:
        """Parse one picture into the compact coefficient wire format.

        ``cpk`` are per-component uint16 entry buffers (capacity must be
        >= n_blocks(comp) * 64; buffers may be pooled/uninitialised) and
        ``counts`` the per-block entry-count arrays (uint8, MUST be
        zeroed; (mb*4+block)-indexed for Y/alpha, mb-indexed chroma).
        Returns ``(n_entries_per_comp, dirty)``; ``dirty`` means the
        stream emitted blocks out of order (overlapping slices) and the
        caller must fall back to the dense parse.
        """
        assert data.dtype == np.uint8 and data.flags.c_contiguous
        null16 = ctypes.POINTER(ctypes.c_uint16)()
        null8 = ctypes.POINTER(ctypes.c_uint8)()
        n_out = np.zeros(4, np.int64)
        dirty = np.zeros(1, np.int32)
        caps = np.array([int(c.size) if c is not None else 0
                         for c in (list(cpk) + [None] * 4)[:4]], np.int64)
        rc = self._lib.jsv_parse_picture_slices_compact(
            self._handle, _as(data, ctypes.c_uint8), data.size, start_bit,
            mb_w, mb_h, hdr.picture_type,
            1 if hdr.full_pel else 0, hdr.f_code, 1 if yuva else 0,
            _as(cpk[0], ctypes.c_uint16),
            _as(cpk[1], ctypes.c_uint16),
            _as(cpk[2], ctypes.c_uint16),
            (_as(cpk[3], ctypes.c_uint16) if yuva else null16),
            _as(caps, ctypes.c_int64),
            _as(n_out, ctypes.c_int64),
            _as(counts[0], ctypes.c_uint8),
            _as(counts[1], ctypes.c_uint8),
            _as(counts[2], ctypes.c_uint8),
            (_as(counts[3], ctypes.c_uint8) if yuva else null8),
            _as(mb_quant, ctypes.c_uint8),
            _as(mb_intra, ctypes.c_uint8),
            _as(mb_mv, ctypes.c_int16),
            _as(mb_rep_add, ctypes.c_uint8),
            _as(dirty, ctypes.c_int32),
            int(n_threads),
        )
        if rc < 0:
            raise ValueError(
                f"native compact parse failed: {_ERRORS.get(rc, rc)}")
        return tuple(int(x) for x in n_out), bool(dirty[0])


_parser_singleton = None


def get_native_parser() -> NativeStreamParser:
    """Shared instance, built on first use; raises if the build fails."""
    global _parser_singleton
    if _parser_singleton is None:
        _parser_singleton = NativeStreamParser()
    return _parser_singleton
