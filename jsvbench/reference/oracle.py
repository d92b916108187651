"""The plain reference: a float64 decode of a JSV stream's bytes.

The benchmark's frozen copy of the port's float64 oracle
(``tools/oracle.py``), on the pure-Python parser of this folder, with the
motion compensation over whole planes.  It imports nothing of the program.
:func:`decode_gop` decodes one GOP's bytes; ``idct=idct_plane_tf32`` is
the control, the same decode with its IDCT in TF32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitio import BitReader
from .container import (StartCodeIndex, parse_container_header)
from .parser import FrameTensors, SequenceInfo, StreamParser
from . import tables as T
from . import refmath


@dataclass
class DecodedFrame:
    planes: tuple                # uint8 (Y, Cb, Cr) or (Y, Cb, Cr, A)
    picture_type: int
    gop_time_ms: float


def _expand_mb_to_blocks(arr: np.ndarray, comp: int) -> np.ndarray:
    """Per-MB array (mbH, mbW) -> per-block array matching plane blocks.

    Components 0 (luma) and 3 (YUVA alpha) are full resolution: 2x2
    blocks per macroblock."""
    if comp in (0, 3):
        return np.repeat(np.repeat(arr, 2, axis=0), 2, axis=1)
    return arr


def _expand_blocks_to_pixels(arr: np.ndarray) -> np.ndarray:
    return np.repeat(np.repeat(arr, 8, axis=0), 8, axis=1)


def dequant_plane(ft: FrameTensors, seq: SequenceInfo, comp: int,
                  quirk_oddify_zeros: bool = False) -> np.ndarray:
    """Vectorised dequantisation of a whole coefficient plane (float64).

    Implements the column-shader semantics (COLUMNS/COL_* fragments of
    decoders/shaders/mpeg1video.js): positions at/after each block's
    last-non-zero scan count stay zero; intra blocks override the DC with
    8*dc; everything else gets the x2 (+sign), xq, xM/16 floor chain with
    mismatch control and the +/-2048 clamp.
    """
    levels = ft.levels[comp].astype(np.float64)
    h, w = levels.shape
    q_blk = _expand_mb_to_blocks(ft.mb_quant, comp).astype(np.float64)
    intra_blk = _expand_mb_to_blocks(ft.mb_intra, comp).astype(bool)
    lnz_blk = ft.lnz[comp].astype(np.int32)

    q = _expand_blocks_to_pixels(q_blk)
    intra = _expand_blocks_to_pixels(intra_blk)
    lnz = _expand_blocks_to_pixels(lnz_blk)

    zz = T.ZIG_ZAG_INVERSE.reshape(8, 8).astype(np.int32)
    scan_pos = np.tile(zz, (h // 8, w // 8))
    in_range = scan_pos < lnz

    mi = np.tile(seq.intra_q.reshape(8, 8).astype(np.float64),
                 (h // 8, w // 8))
    mn = np.tile(seq.non_intra_q.reshape(8, 8).astype(np.float64),
                 (h // 8, w // 8))

    d_intra = refmath.dequant_intra(levels, q, mi, quirk_oddify_zeros)
    d_inter = refmath.dequant_inter(levels, q, mn, quirk_oddify_zeros)
    d = np.where(intra, d_intra, d_inter)
    d = np.where(in_range, d, 0.0)

    # Intra DC override: D[0,0] of each intra block = 8 * dc level
    # (COL_INT_31: X[0] = dc*256 at the shader's 32x scale).
    is_dc = np.zeros((8, 8), dtype=bool)
    is_dc[0, 0] = True
    dc_mask = np.tile(is_dc, (h // 8, w // 8)) & intra
    d = np.where(dc_mask, 8.0 * levels, d)
    return d


def idct_plane(d: np.ndarray) -> np.ndarray:
    """Blockwise 2-D IDCT of a plane of 8x8 frequency blocks."""
    h, w = d.shape
    c = refmath.C_BASIS
    cols = np.einsum("xu,bul->bxl", c, d.reshape(h // 8, 8, w))
    z = cols.reshape(h, w // 8, 8)
    return np.einsum("yv,hbv->hby", c, z).reshape(h, w)


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` in float32 rounded to TF32's 10 mantissa bits, to nearest
    with ties away from zero (the tensor cores' ``cvt.rna.tf32.f32``)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def idct_plane_tf32(d: np.ndarray) -> np.ndarray:
    """:func:`idct_plane` as two TF32 matrix products would compute it:
    each product's inputs rounded to TF32, the sums in float32."""
    h, w = d.shape
    c = tf32(refmath.C_BASIS)
    cols = np.einsum("xu,bul->bxl", c, tf32(d).reshape(h // 8, 8, w))
    z = tf32(cols).reshape(h, w // 8, 8)
    return np.einsum("yv,hbv->hby", c, z).reshape(h, w).astype(np.float64)


def predict_plane(ref: np.ndarray, mv: np.ndarray, predicted: np.ndarray,
                  size: int) -> np.ndarray:
    """Motion-compensated prediction of a whole plane from ``ref``, every
    macroblock at once: ``mv`` (mb_h, mb_w, 2) are the luma vectors (vy,
    vx) in half-pel, ``predicted`` the macroblocks that take a prediction
    (the others predict 0), ``size`` 16 for luma and alpha, 8 for chroma,
    which halves the vectors (trunc toward zero).  Each block reads its
    (size+1)^2 window, clamped to the plane, with MPEG-1's half-pel
    rounding (``refmath.mc_luma_block`` and ``mc_chroma_block``)."""
    ref = np.asarray(ref).astype(np.int32)
    h, w = ref.shape
    mb_h, mb_w = mv.shape[:2]
    vy = mv[..., 0].astype(np.int64)
    vx = mv[..., 1].astype(np.int64)
    if size == 8:
        vy = np.sign(vy) * (np.abs(vy) // 2)
        vx = np.sign(vx) * (np.abs(vx) // 2)
    span = np.arange(size + 1)
    rows = np.clip(np.arange(mb_h)[:, None, None] * size
                   + (vy >> 1)[:, :, None] + span, 0, h - 1)
    cols = np.clip(np.arange(mb_w)[None, :, None] * size
                   + (vx >> 1)[:, :, None] + span, 0, w - 1)
    g = ref[rows[:, :, :, None], cols[:, :, None, :]]
    a = g[..., :size, :size]
    oy = (vy & 1).astype(bool)[..., None, None]
    ox = (vx & 1).astype(bool)[..., None, None]
    # every case as (a + b + c + d + 2) >> 2: floor((a+b+1)/2) is
    # (a + b + a + b + 2) >> 2, and a itself (4a + 2) >> 2
    b = np.where(ox, g[..., :size, 1:], a)
    c = np.where(oy, g[..., 1:, :size], a)
    d = np.where(oy & ox, g[..., 1:, 1:], np.where(ox, b, c))
    out = (a + b + c + d + 2) >> 2
    out = np.where(predicted[..., None, None], out, 0)
    return out.transpose(0, 2, 1, 3).reshape(mb_h * size,
                                             mb_w * size).astype(np.float64)


def reconstruct_frame(ft: FrameTensors, seq: SequenceInfo,
                      ref: tuple | None,
                      quirk_oddify_zeros: bool = False,
                      idct=idct_plane) -> tuple:
    """FrameTensors -> (Y, Cb, Cr[, A]) uint8 planes, float64 math."""
    planes = []
    for comp in range(ft.n_comps):
        d = dequant_plane(ft, seq, comp, quirk_oddify_zeros)
        res = idct(d)
        if ft.is_intra_picture:
            pix = np.clip(np.round(res), 0, 255)
        else:
            assert ref is not None, "P picture without reference"
            pred = predict_plane(ref[comp], ft.mb_mv, ft.mb_rep_add == 0,
                                 16 if comp in (0, 3) else 8)
            pix = np.clip(np.round(pred + res), 0, 255)
        planes.append(pix.astype(np.uint8))
    return tuple(planes)


class OracleDecoder:
    """Full-stream float64 decoder built on the shared parser."""

    def __init__(self, data: bytes, quirk_oddify_zeros: bool = False):
        self.data = bytes(data)
        self.quirk = quirk_oddify_zeros
        self.reader = BitReader(self.data)
        self.meta = parse_container_header(self.reader)
        self.index = StartCodeIndex.scan(self.data)
        self.parser = StreamParser(yuva=self.meta.yuva)
        self._ref: tuple | None = None

    def frames(self):
        """Yield :class:`DecodedFrame` for every I/P picture in the stream."""
        r = self.reader
        parser = self.parser
        while True:
            nxt = self.index.next_code(r.byte_pos)
            if nxt is None:
                return
            off, code = nxt
            r.seek_bits((off + 4) << 3)
            if code == T.START_SEQUENCE:
                parser.parse_sequence_header(r)
            elif code == T.START_GOP:
                parser.parse_gop_header(r)
            elif code == T.START_PICTURE:
                ft = parser.parse_picture(r, self.index, len(self.data))
                if ft is None:
                    continue
                planes = reconstruct_frame(ft, parser.seq, self._ref,
                                           self.quirk)
                self._ref = planes
                yield DecodedFrame(planes=planes,
                                   picture_type=ft.picture_type,
                                   gop_time_ms=ft.gop_time_ms)
            # other codes (extension/user data/map) are skipped


def decode_stream_oracle(data: bytes,
                         quirk_oddify_zeros: bool = False) -> list:
    return list(OracleDecoder(data, quirk_oddify_zeros).frames())


def decode_gop(gop: bytes, yuva: bool = False, idct=idct_plane,
               keep: list | None = None) -> list:
    """The planes of every picture of one GOP, given its bytes from its
    sequence header to the next GOP's; ``keep`` collects each picture's
    parse (:class:`FrameTensors`)."""
    r = BitReader(gop)
    index = StartCodeIndex.scan(gop)
    parser = StreamParser(yuva=yuva)
    ref, out = None, []
    while True:
        nxt = index.next_code(r.byte_pos)
        if nxt is None:
            return out
        off, code = nxt
        r.seek_bits((off + 4) << 3)
        if code == T.START_SEQUENCE:
            parser.parse_sequence_header(r)
        elif code == T.START_GOP:
            parser.parse_gop_header(r)
        elif code == T.START_PICTURE:
            ft = parser.parse_picture(r, index, len(gop))
            if ft is None:
                continue
            ref = reconstruct_frame(ft, parser.seq, ref, idct=idct)
            out.append(ref)
            if keep is not None:
                keep.append(ft)
