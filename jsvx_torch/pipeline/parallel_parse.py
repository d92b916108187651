"""Parallel host parsing: pictures across the process's parse pool.

The port's copy of ``jsvx/pipeline/parallel_parse.py``.  Pictures are
independently parseable once the sequence state (quant matrices, f_code
in the picture header) is known: slice predictors reset per slice, and
nothing in the slice layer depends on other pictures.  So the structural
walk (sequence/GOP/picture headers) stays serial and cheap while the
slice payloads, nearly all of the bits, fan out over the process's parse
pool (:mod:`.parse_pool`).  The C++ back end releases the GIL during
``jsv_parse_picture_slices``, so threads scale on real cores.

jsvx's serial branch through the Python slice parser is not carried: it
runs only when jsvx's native parser is missing, and the port's
:func:`jsvx_torch.bitstream.native.get_native_parser` raises instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.bitio import BitReader
from ..bitstream.container import (StartCodeIndex, parse_container_header)
from ..bitstream.parser import (FrameTensors, SequenceInfo, StreamParser,
                                alloc_frame_tensors)
from ..bitstream.native import get_native_parser
from ..coding import tables as T
from .parse_pool import Lane, picture_bytes


@dataclass
class ParsedStream:
    meta: object
    seq: SequenceInfo
    frames: list            # FrameTensors in stream order
    gop_starts: list        # indices into frames where GOPs begin


@dataclass(slots=True)
class PictureHeader:
    """The fields of one picture header that the decode reads: what the
    header walk records of each picture, with no planes."""

    picture_type: int            # PICTURE_TYPE_I or _P
    temporal_ref: int
    full_pel: bool
    f_code: int                  # forward_f_code (0 for I pictures)
    gop_time_ms: float           # GOP timecode resync carried by this frame

    @property
    def is_intra_picture(self) -> bool:
        return self.picture_type == T.PICTURE_TYPE_I


def parse_stream_parallel(data: bytes, n_threads: int | None = None,
                          parser: StreamParser | None = None
                          ) -> ParsedStream:
    """Parse a complete stream with picture-level parallelism (the C++
    parser, built on first use; a failed build raises).  ``n_threads``
    as :class:`~jsvx_torch.pipeline.parse_pool.Lane` takes it."""
    data = bytes(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    r = BitReader(data)
    meta = parse_container_header(r)
    index = StartCodeIndex.scan(data)
    stops = _picture_stops(index)
    parser = parser or StreamParser()
    parser.yuva = meta.yuva
    native = get_native_parser()

    frames: list[FrameTensors] = []
    gop_starts: list[int] = []
    jobs = []

    pos = r.byte_pos
    while True:
        nxt = index.next_code(pos)
        if nxt is None:
            break
        off, code = nxt
        rr = BitReader(data, pos_bits=(off + 4) << 3)
        if code == T.START_SEQUENCE:
            parser.parse_sequence_header(rr)
            pos = rr.byte_pos
        elif code == T.START_GOP:
            parser.parse_gop_header(rr)
            gop_starts.append(len(frames))
            pos = rr.byte_pos
        elif code == T.START_PICTURE:
            hdr, start_bit = _parse_picture_header(parser, rr)
            if hdr is None:
                pos = rr.byte_pos
                continue
            ft = alloc_frame_tensors(
                parser.seq, hdr.picture_type, hdr.temporal_ref,
                hdr.full_pel, hdr.f_code, hdr.gop_time_ms, yuva=parser.yuva)
            frames.append(ft)
            jobs.append((ft, start_bit, parser.seq))
            # jump to the next non-slice code to keep the walk O(codes)
            pos = _picture_end(stops, rr.byte_pos, len(data))
        else:
            pos = off + 4

    def run(i):
        ft, start_bit, seq = jobs[i]
        native.parse_picture_slices(arr, start_bit, ft,
                                    seq.mb_width, seq.mb_height, seq)

    Lane(n_threads).submit(
        run, picture_bytes([start_bit for _, start_bit, _ in jobs])).wait()

    return ParsedStream(meta=meta, seq=parser.seq, frames=frames,
                        gop_starts=gop_starts)


def _parse_picture_header(parser: StreamParser, r: BitReader):
    """Picture-header fields (serial part): (PictureHeader, start bit of
    the slices), or (None, 0) for a picture the decode skips (B, D, or P
    with ``f_code`` 0)."""
    temporal_ref = r.get_bits(10)
    ptype = r.get_bits(3)
    r.advance(16)
    if ptype <= 0 or ptype >= T.PICTURE_TYPE_B:
        return None, 0
    full_pel = False
    f_code = 0
    if ptype == T.PICTURE_TYPE_P:
        full_pel = bool(r.get_bits(1))
        f_code = r.get_bits(3)
        if f_code == 0:
            return None, 0
    hdr = PictureHeader(ptype, temporal_ref, full_pel, f_code,
                        parser._pending_gop_time
                        if parser._have_pending_gop else 0.0)
    parser._have_pending_gop = False
    return hdr, r.bit_pos


def _picture_stops(index: StartCodeIndex) -> np.ndarray:
    """Offsets of the index's codes that can end a picture: all but
    slice, extension and user-data codes."""
    codes = index.entries[:, 1]
    inner = (((codes >= T.START_SLICE_FIRST) & (codes <= T.START_SLICE_LAST))
             | (codes == T.START_EXTENSION) | (codes == T.START_USER_DATA))
    return index.entries[~inner, 0]


def _picture_end(stops: np.ndarray, from_byte: int, eos: int) -> int:
    """The first of ``stops`` (:func:`_picture_stops`) at or after
    ``from_byte``, else ``eos``."""
    i = int(np.searchsorted(stops, from_byte))
    return int(stops[i]) if i < len(stops) else eos
