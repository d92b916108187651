"""JSV/MPEG-1 syntax parser: bitstream -> dense per-frame tensors.

This is the TPU-first inversion of the reference's streaming state machine
(``decoders/jsv.js:426-828,1338-1525``): instead of interleaving parse and
GPU upload per picture, a whole picture (or GOP) is parsed on the host into
dense arrays that feed the device kernels directly:

* ``levels``  — int16 coefficient planes, raw VLC levels placed at their
  de-zig-zagged spatial positions (what the reference stores in
  ``currentYDCT16``/``currentCbDCT16``/``currentCrDCT16``, jsv.js:1501).
* ``lnz``     — per-8x8-block "last non-zero" scan count used by the
  dequantiser to skip uncoded positions (jsv.js:1488).
* ``mb_*``    — per-macroblock sideband: quantiser scale, intra flag,
  half-pel motion vector, and the "intra MB inside a P picture" flag that
  zeroes the temporal prediction (``macroblockRepAdd``, jsv.js:1502-1505).

The benchmark's frozen copy of the port's pure-Python parser (its C++
back-end left out): the reference decodes the stream's bytes with this
alone, and imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import tables as T
from .vlc import compiled_tables
from .bitio import BitReader, BitStallError
from .container import StartCodeIndex


@dataclass
class SequenceInfo:
    width: int
    height: int
    picture_rate: float
    bit_rate: int
    vbv_buffer_bytes: int        # per-picture byte gate (jsv.js:531)
    intra_q: np.ndarray          # uint8[64], spatial order
    non_intra_q: np.ndarray      # uint8[64]
    custom_intra: bool = False
    custom_non_intra: bool = False

    @property
    def mb_width(self) -> int:
        return (self.width + 15) >> 4

    @property
    def mb_height(self) -> int:
        return (self.height + 15) >> 4

    @property
    def coded_width(self) -> int:
        return self.mb_width << 4

    @property
    def coded_height(self) -> int:
        return self.mb_height << 4


@dataclass
class FrameTensors:
    """Dense parse products for one picture (the device-kernel inputs).

    ``levels``/``lnz`` hold one entry per component: (Y, Cb, Cr) or, for
    YUVA streams (container alpha flag, ``decoders/jsv.js:256-259``),
    (Y, Cb, Cr, A) with the alpha plane at full luma resolution.
    """

    picture_type: int            # PICTURE_TYPE_I or _P
    temporal_ref: int
    full_pel: bool
    f_code: int                  # forward_f_code (0 for I pictures)
    gop_time_ms: float           # GOP timecode resync carried by this frame
    levels: tuple                # per-component int16 coefficient planes
    lnz: tuple                   # per-component per-block uint8
    mb_quant: np.ndarray         # uint8[mbH, mbW]
    mb_intra: np.ndarray         # uint8[mbH, mbW] (0/1)
    mb_mv: np.ndarray            # int16[mbH, mbW, 2] (vy, vx) half-pel
    mb_rep_add: np.ndarray       # uint8[mbH, mbW] zero-prediction flag

    @property
    def is_intra_picture(self) -> bool:
        return self.picture_type == T.PICTURE_TYPE_I

    @property
    def n_comps(self) -> int:
        return len(self.levels)


def alloc_frame_tensors(seq: SequenceInfo, ptype: int, temporal_ref: int,
                        full_pel: bool, f_code: int, gop_time_ms: float,
                        yuva: bool = False) -> FrameTensors:
    """Allocate zeroed FrameTensors for one picture of ``seq``."""
    mb_h, mb_w = seq.mb_height, seq.mb_width
    ch, cw = seq.coded_height, seq.coded_width
    levels = [np.zeros((ch, cw), dtype=np.int16),
              np.zeros((ch >> 1, cw >> 1), dtype=np.int16),
              np.zeros((ch >> 1, cw >> 1), dtype=np.int16)]
    lnz = [np.zeros((mb_h * 2, mb_w * 2), dtype=np.uint8),
           np.zeros((mb_h, mb_w), dtype=np.uint8),
           np.zeros((mb_h, mb_w), dtype=np.uint8)]
    if yuva:
        levels.append(np.zeros((ch, cw), dtype=np.int16))
        lnz.append(np.zeros((mb_h * 2, mb_w * 2), dtype=np.uint8))
    return FrameTensors(
        picture_type=ptype,
        temporal_ref=temporal_ref,
        full_pel=full_pel,
        f_code=f_code,
        gop_time_ms=gop_time_ms,
        levels=tuple(levels),
        lnz=tuple(lnz),
        mb_quant=np.ones((mb_h, mb_w), dtype=np.uint8),
        mb_intra=np.zeros((mb_h, mb_w), dtype=np.uint8),
        mb_mv=np.zeros((mb_h, mb_w, 2), dtype=np.int16),
        mb_rep_add=np.zeros((mb_h, mb_w), dtype=np.uint8),
    )


class StreamParser:
    """Stateful elementary-stream parser (sequence/GOP/picture layers).

    ``yuva`` (settable any time before the first picture; normally copied
    from :class:`jsvx_torch.bitstream.container.ContainerMeta`) enables the
    4th alpha component.  The reference only plumbs the flag through its
    GL pools (``decoders/jsv.js:256-259,60-75``) without defining the
    alpha coding; this framework defines it concretely: each macroblock
    carries 4 extra alpha blocks (6..9, spatially the 4 luma positions),
    always coded for intra macroblocks, gated by a 4-bit alpha coded
    pattern immediately after the cbp VLC otherwise; alpha DC uses its
    own per-slice predictor with the luminance DC-size table; alpha
    prediction uses the luma motion vectors at full resolution.

    """

    def __init__(self, yuva: bool = False):
        self.yuva = yuva
        v = compiled_tables()
        self._t_addr = v["mb_addr_inc"]
        self._t_cbp = v["cbp"]
        self._t_motion = v["motion"]
        self._t_dc_lum = v["dc_size_lum"]
        self._t_dc_chrom = v["dc_size_chrom"]
        self._t_coeff = v["dct_coeff"]
        self._t_type = {
            T.PICTURE_TYPE_I: v["mb_type_i"],
            T.PICTURE_TYPE_P: v["mb_type_p"],
            T.PICTURE_TYPE_B: v["mb_type_b"],
        }
        self.seq: SequenceInfo | None = None
        self.current_time_ms: float = 0.0
        self._pending_gop_time: float = 0.0
        self._have_pending_gop = False

    # ------------------------------------------------------------------
    # Headers

    def parse_sequence_header(self, r: BitReader) -> SequenceInfo:
        """After a 00 00 01 C3 start code (jsv.js:491-561)."""
        width = r.get_bits(12)
        height = r.get_bits(12)
        r.advance(4)                       # pixel aspect ratio
        rate = float(T.PICTURE_RATE[r.get_bits(4)])
        bit_rate = r.get_bits(18)
        r.advance(1)                       # marker
        vbv = 16 * 1024 * r.get_bits(10)
        r.advance(1)                       # constrained flag

        intra_q = T.DEFAULT_INTRA_QUANT_MATRIX
        non_intra_q = T.DEFAULT_NON_INTRA_QUANT_MATRIX
        custom_intra = bool(r.get_bits(1))
        if custom_intra:
            intra_q = np.zeros(64, dtype=np.uint8)
            for i in range(64):
                intra_q[T.ZIG_ZAG[i]] = r.get_bits(8)
        custom_non_intra = bool(r.get_bits(1))
        if custom_non_intra:
            non_intra_q = np.zeros(64, dtype=np.uint8)
            for i in range(64):
                non_intra_q[T.ZIG_ZAG[i]] = r.get_bits(8)

        self.seq = SequenceInfo(
            width=width, height=height, picture_rate=rate, bit_rate=bit_rate,
            vbv_buffer_bytes=vbv, intra_q=intra_q, non_intra_q=non_intra_q,
            custom_intra=custom_intra, custom_non_intra=custom_non_intra)
        return self.seq

    def parse_gop_header(self, r: BitReader) -> float:
        """After 00 00 01 B8; returns the GOP timecode in ms (jsv.js:471-489)."""
        r.advance(1)                       # drop-frame flag
        hour = r.get_bits(5)
        minute = r.get_bits(6)
        r.advance(1)                       # marker
        second = r.get_bits(6)
        frame = r.get_bits(6)
        rate = self.seq.picture_rate if self.seq else 30.0
        t = ((hour * 60 + minute) * 60 + second + (frame + 1) / rate) * 1000.0
        self.current_time_ms = t
        self._pending_gop_time = t
        self._have_pending_gop = True
        return t

    # ------------------------------------------------------------------
    # Picture layer

    def parse_picture(self, r: BitReader, index: StartCodeIndex,
                      eos_byte: int | None = None) -> FrameTensors | None:
        """Parse one picture after its 00 00 01 00 start code.

        ``eos_byte`` is the absolute end of a *complete* stream: past the
        last start code it bounds the final slice (the reference treats
        end-of-file as a start code, jsv.js:1711-1713).  When ``None`` and
        data runs out, :class:`BitStallError` propagates so a streaming
        caller can refill.

        Returns ``None`` for skipped picture types (B/D; jsv.js:613) —
        the reader is left positioned after the picture header in that
        case, and at the next start code prefix otherwise.
        """
        seq = self.seq
        assert seq is not None, "picture before sequence header"
        temporal_ref = r.get_bits(10)
        ptype = r.get_bits(3)
        r.advance(16)                      # vbv_delay
        if ptype <= 0 or ptype >= T.PICTURE_TYPE_B:
            return None

        full_pel = False
        f_code = 0
        if ptype == T.PICTURE_TYPE_P:
            full_pel = bool(r.get_bits(1))
            f_code = r.get_bits(3)
            if f_code == 0:                # jsv.js:625-629
                return None

        mb_h, mb_w = seq.mb_height, seq.mb_width
        ft = alloc_frame_tensors(seq, ptype, temporal_ref, full_pel, f_code,
                                 self._pending_gop_time
                                 if self._have_pending_gop else 0.0,
                                 yuva=self.yuva)
        self._have_pending_gop = False

        # Skip extension / user data sections, then run the slice loop.
        while True:
            nxt = index.next_code(r.byte_pos)
            if nxt is None:
                if eos_byte is None:
                    raise BitStallError(r.byte_pos)
                r.seek_bits(eos_byte << 3)
                break
            off, code = nxt
            if T.START_SLICE_FIRST <= code <= T.START_SLICE_LAST:
                r.seek_bits((off + 4) << 3)
                self._parse_slice(r, code, ft, index, eos_byte)
            elif code in (T.START_EXTENSION, T.START_USER_DATA):
                r.seek_bits((off + 4) << 3)
            else:
                r.seek_bits(off << 3)      # leave at next start code prefix
                break
        return ft

    # ------------------------------------------------------------------
    # Slice / macroblock / block layers

    def _parse_slice(self, r: BitReader, slice_code: int, ft: FrameTensors,
                     index: StartCodeIndex,
                     eos_byte: int | None = None) -> None:
        """jsv.js:683-706."""
        seq = self.seq
        mb_w = seq.mb_width
        mb_size = seq.mb_width * seq.mb_height
        nxt = index.next_code(r.byte_pos)
        if nxt is not None:
            slice_end_byte = nxt[0]
        elif eos_byte is not None:
            slice_end_byte = eos_byte
        else:
            raise BitStallError(r.byte_pos)

        mb_address = (slice_code - 1) * mb_w - 1
        state = _SliceState()
        state.quantizer_scale = r.get_bits(5)
        while r.get_bits(1):
            r.advance(8)                   # extra slice information

        slice_begin = True
        while ((r.bit_pos + 7) >> 3) < slice_end_byte:
            mb_address = self._parse_macroblock(
                r, ft, state, mb_address, slice_begin, mb_size)
            slice_begin = False
            if mb_address >= mb_size:
                break

    def _parse_macroblock(self, r: BitReader, ft: FrameTensors,
                          state: "_SliceState", mb_address: int,
                          slice_begin: bool, mb_size: int) -> int:
        """jsv.js:725-828."""
        seq = self.seq
        mb_w = seq.mb_width
        ptype = ft.picture_type

        increment = 0
        t = r.read_vlc(self._t_addr)
        while t == T.MB_ADDRESS_INCREMENT_STUFFING:
            t = r.read_vlc(self._t_addr)
        while t == T.MB_ADDRESS_INCREMENT_ESCAPE:
            increment += 33
            t = r.read_vlc(self._t_addr)
        increment += t

        if slice_begin:
            # First increment is relative to the previous row's start.
            mb_address += increment
            if mb_address >= mb_size:
                return mb_size             # corrupt stream guard
        else:
            if mb_address + increment >= mb_size:
                return mb_size             # illegal increment: drop (jsv.js:750)
            if increment > 1:
                state.reset_dc()
                if ptype == T.PICTURE_TYPE_P:
                    state.reset_mv()
            while increment > 1:
                # Skipped macroblocks propagate the (reset) motion vector.
                mb_address += 1
                row, col = divmod(mb_address, mb_w)
                ft.mb_mv[row, col, 0] = state.motion_v
                ft.mb_mv[row, col, 1] = state.motion_h
                ft.mb_quant[row, col] = state.quantizer_scale
                increment -= 1
            mb_address += 1
        row, col = divmod(mb_address, mb_w)

        mb_type = r.read_vlc(self._t_type[ptype])
        intra = bool(mb_type & 0x01)
        motion_fw = bool(mb_type & 0x08)
        if mb_type & 0x10:
            state.quantizer_scale = r.get_bits(5)

        ft.mb_quant[row, col] = state.quantizer_scale
        ft.mb_intra[row, col] = 1 if intra else 0

        if intra:
            state.reset_mv()
            if ptype == T.PICTURE_TYPE_P:
                ft.mb_rep_add[row, col] = 1
        else:
            state.reset_dc()
            if motion_fw:
                state.motion_h = self._decode_motion_component(
                    r, state, ft, "h")
                state.motion_v = self._decode_motion_component(
                    r, state, ft, "v")
            elif ptype == T.PICTURE_TYPE_P:
                state.reset_mv()
            ft.mb_mv[row, col, 0] = state.motion_v
            ft.mb_mv[row, col, 1] = state.motion_h

        if mb_type & 0x02:
            cbp = r.read_vlc(self._t_cbp)
            acbp = r.get_bits(4) if ft.n_comps == 4 else 0
        else:
            cbp = 0x3F if intra else 0
            acbp = 0xF if (intra and ft.n_comps == 4) else 0

        for block in range(6):
            if cbp & (0x20 >> block):
                self._parse_block(r, ft, state, row, col, block, intra)
        for ab in range(4):                # alpha blocks 6..9 (YUVA)
            if acbp & (0x8 >> ab):
                self._parse_block(r, ft, state, row, col, 6 + ab, intra)
        return mb_address

    def _decode_motion_component(self, r: BitReader, state: "_SliceState",
                                 ft: FrameTensors, axis: str) -> int:
        """Differential motion decode with +/-(16*F) wrap (jsv.js:831-893)."""
        f_code = ft.f_code
        r_size = f_code - 1
        F = 1 << r_size
        code = r.read_vlc(self._t_motion)
        if code != 0 and F != 1:
            residual = r.get_bits(r_size)
            d = ((abs(code) - 1) << r_size) + residual + 1
            if code < 0:
                d = -d
        else:
            d = code

        prev = state.motion_h_prev if axis == "h" else state.motion_v_prev
        prev += d
        if prev > (F << 4) - 1:
            prev -= F << 5
        elif prev < -(F << 4):
            prev += F << 5
        if axis == "h":
            state.motion_h_prev = prev
        else:
            state.motion_v_prev = prev
        return prev << 1 if ft.full_pel else prev

    def _parse_block(self, r: BitReader, ft: FrameTensors,
                     state: "_SliceState", row: int, col: int,
                     block: int, intra: bool) -> None:
        """jsv.js:1338-1525 — raw levels into plane layout + lnz."""
        block_data = np.zeros(64, dtype=np.int32)
        n = 0
        if intra:
            if block < 4:
                predictor = state.dc_y
                size = r.read_vlc(self._t_dc_lum)
            elif block >= 6:               # alpha: own predictor, lum table
                predictor = state.dc_a
                size = r.read_vlc(self._t_dc_lum)
            else:
                predictor = state.dc_cb if block == 4 else state.dc_cr
                size = r.read_vlc(self._t_dc_chrom)
            if size > 0:
                diff = r.get_bits(size)
                if diff & (1 << (size - 1)):
                    dc = predictor + diff
                else:
                    dc = predictor + ((-1 << size) | (diff + 1))
            else:
                dc = predictor
            block_data[0] = dc
            if block < 4:
                state.dc_y = dc
            elif block >= 6:
                state.dc_a = dc
            elif block == 4:
                state.dc_cb = dc
            else:
                state.dc_cr = dc
            n = 1

        while True:
            coeff = r.read_vlc(self._t_coeff)
            if coeff == 0x0001 and n > 0 and r.get_bits(1) == 0:
                break                      # end_of_block ('10')
            if coeff == T.DCT_COEFF_ESCAPE:
                run = r.get_bits(6)
                level = r.get_bits(8)
                if level == 0:
                    level = r.get_bits(8)
                elif level == 128:
                    level = r.get_bits(8) - 256
                elif level > 128:
                    level -= 256
            else:
                run = coeff >> 8
                level = coeff & 0xFF
                if r.get_bits(1):
                    level = -level
            n += run
            if n > 63:
                break                      # corrupt stream guard
            block_data[T.ZIG_ZAG[n]] = level
            n += 1

        # Place the 8x8 block into the plane and record last-non-zero.
        if block < 4 or block >= 6:
            comp = 0 if block < 4 else 3
            b = block if block < 4 else block - 6
            by = row * 2 + (1 if b & 2 else 0)
            bx = col * 2 + (1 if b & 1 else 0)
        else:
            comp = 1 if block == 4 else 2
            by, bx = row, col
        plane = ft.levels[comp]
        plane[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] = (
            block_data.reshape(8, 8).astype(np.int16))
        ft.lnz[comp][by, bx] = min(n, 255)


class _SliceState:
    """Per-slice predictors (reset rules: jsv.js:687-692)."""

    __slots__ = ("quantizer_scale", "dc_y", "dc_cb", "dc_cr", "dc_a",
                 "motion_h", "motion_v", "motion_h_prev", "motion_v_prev")

    def __init__(self):
        self.quantizer_scale = 0
        self.reset_dc()
        self.reset_mv()

    def reset_dc(self):
        self.dc_y = self.dc_cb = self.dc_cr = self.dc_a = 128

    def reset_mv(self):
        self.motion_h = self.motion_v = 0
        self.motion_h_prev = self.motion_v_prev = 0
