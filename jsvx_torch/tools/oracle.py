"""Float64 golden decoder ("double-precision IDCT oracle").

Decodes a JSV byte stream with the shared Python parser and reconstructs
frames with exact float64 math per :mod:`jsvx_torch.tools.refmath`.  This is the
accuracy yardstick: the TPU kernels must land at least as close to this
oracle as the reference's integer-shader reconstruction does
(``reconstruct_frame_intsim`` reproduces that integer path bit-for-bit for
the comparison).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.bitio import BitReader
from ..bitstream.container import (StartCodeIndex, parse_container_header)
from ..bitstream.parser import FrameTensors, SequenceInfo, StreamParser
from ..coding import tables as T
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


def predict_plane(ref: np.ndarray, ft: FrameTensors, comp: int) -> np.ndarray:
    """Motion-compensated prediction of a full plane from ``ref``.

    Luma (0) and YUVA alpha (3) use the full-resolution luma vectors;
    chroma halves them (trunc toward zero)."""
    mb_h, mb_w = ft.mb_mv.shape[:2]
    out = np.zeros_like(ref, dtype=np.float64)
    for r in range(mb_h):
        for c in range(mb_w):
            if ft.mb_rep_add[r, c]:
                continue                    # intra MB in P: zero prediction
            mv = ft.mb_mv[r, c]
            if comp in (0, 3):
                out[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] = (
                    refmath.mc_luma_block(ref, r, c, mv))
            else:
                out[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] = (
                    refmath.mc_chroma_block(ref, r, c, mv))
    return out


def reconstruct_frame(ft: FrameTensors, seq: SequenceInfo,
                      ref: tuple | None,
                      quirk_oddify_zeros: bool = False) -> tuple:
    """FrameTensors -> (Y, Cb, Cr[, A]) uint8 planes, float64 math."""
    planes = []
    for comp in range(ft.n_comps):
        d = dequant_plane(ft, seq, comp, quirk_oddify_zeros)
        res = idct_plane(d)
        if ft.is_intra_picture:
            pix = np.clip(np.round(res), 0, 255)
        else:
            assert ref is not None, "P picture without reference"
            pred = predict_plane(ref[comp].astype(np.float64), ft, comp)
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


# ---------------------------------------------------------------------------
# Bit-faithful simulation of the reference integer shader path.

def _fast_idct_1d_int(X: np.ndarray) -> np.ndarray:
    """The reference's integer 8-point fast IDCT (COL_INT_5 / ROWSCOM_INT4).

    Operates along axis 0 of an int64 array of shape (8, ...).  Integer
    divisions are GLSL-style truncations toward zero.
    """
    X = X.astype(np.int64)
    tdiv = lambda a, b: np.trunc(a / b).astype(np.int64) if isinstance(
        a, np.ndarray) else int(a / b)
    b1 = X[4]
    b3 = X[2] + X[6]
    b4 = X[5] - X[3]
    tmp1 = X[1] + X[7]
    tmp2 = X[3] + X[5]
    b6 = X[1] - X[7]
    b7 = tmp1 + tmp2
    m0 = X[0]
    x4 = tdiv(b6 * 473 - b4 * 196 + 128, 256) - b7
    x0 = x4 - tdiv((tmp1 - tmp2) * 362 + 128, 256)
    x1 = m0 - b1
    x2 = tdiv((X[2] - X[6]) * 362 + 128, 256) - b3
    x3 = m0 + b1
    y3 = x1 + x2
    y4 = x3 + b3
    y5 = x1 - x2
    y6 = x3 - b3
    y7 = -x0 - tdiv(b4 * 473 + b6 * 196 + 128, 256)
    return np.stack([b7 + y4, x4 + y3, y5 - x0, y6 - y7,
                     y6 + y7, x0 + y5, y3 - x4, y4 - b7])


def reconstruct_frame_intsim(ft: FrameTensors, seq: SequenceInfo,
                             ref: tuple | None) -> tuple:
    """Bit-exact model of the reference WebGL *integer* path, including its
    0.4x pass-1 packing scale and truncating descale — the baseline whose
    oracle-PSNR the TPU kernels must meet or beat."""
    planes = []
    for comp in range(ft.n_comps):
        d = dequant_plane(ft, seq, comp, quirk_oddify_zeros=True)
        h, w = d.shape
        # premultiplier (uint8 AAN prescale), except the intra-DC override
        # which the shader assigns after premultiplication at dc*256.
        prem = np.tile(T.PREMULTIPLIER.astype(np.float64), (h // 8, w // 8))
        intra = _expand_blocks_to_pixels(
            _expand_mb_to_blocks(ft.mb_intra, comp).astype(bool))
        is_dc = np.zeros((8, 8), dtype=bool)
        is_dc[0, 0] = True
        dc_mask = np.tile(is_dc, (h // 8, w // 8)) & intra
        levels = ft.levels[comp].astype(np.float64)
        x = np.where(dc_mask, 256.0 * levels, d * prem).astype(np.int64)

        # Pass 1: column IDCT + 0.4 pack (floor), per 8-row block.
        xb = x.reshape(h // 8, 8, w)
        cols = np.stack([_fast_idct_1d_int(xb[i]) for i in range(h // 8)])
        packed = np.floor(cols.astype(np.float64) * 0.4).astype(np.int64)
        # Pass 2: /0.4 unpack (trunc toward zero) + row IDCT.
        unpacked = np.trunc(packed.reshape(h, w) / 0.4).astype(np.int64)
        zb = unpacked.reshape(h, w // 8, 8).transpose(2, 0, 1)
        rows = _fast_idct_1d_int(zb).transpose(1, 2, 0).reshape(h, w)
        # Descale: trunc((x + 128) / 256)  (ROWS_*_1 fragments).
        res = np.trunc((rows + 128) / 256.0).astype(np.int64)

        if ft.is_intra_picture:
            pix = np.clip(res, 0, 255)
        else:
            pred = predict_plane(ref[comp].astype(np.float64), ft, comp)
            pix = np.clip(np.round(pred + res), 0, 255)
        planes.append(pix.astype(np.uint8))
    return tuple(planes)
