"""Parallel host parsing: pictures across a thread pool.

The port's copy of ``jsvx/pipeline/parallel_parse.py``.  Pictures are
independently parseable once the sequence state (quant matrices, f_code
in the picture header) is known: slice predictors reset per slice, and
nothing in the slice layer depends on other pictures.  So the structural
walk (sequence/GOP/picture headers) stays serial and cheap while the
slice payloads, nearly all of the bits, fan out over a thread pool.  The
C++ back end releases the GIL during ``jsv_parse_picture_slices``, so
threads scale on real cores.

jsvx's serial branch through the Python slice parser is not carried: it
runs only when jsvx's native parser is missing, and the port's
:func:`jsvx_torch.bitstream.native.get_native_parser` raises instead.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ..bitstream.bitio import BitReader
from ..bitstream.container import (StartCodeIndex, parse_container_header)
from ..bitstream.parser import (FrameTensors, SequenceInfo, StreamParser,
                                alloc_frame_tensors)
from ..bitstream.native import get_native_parser
from ..coding import tables as T


@dataclass
class ParsedStream:
    meta: object
    seq: SequenceInfo
    frames: list            # FrameTensors in stream order
    gop_starts: list        # indices into frames where GOPs begin


def parse_stream_parallel(data: bytes, n_threads: int | None = None,
                          parser: StreamParser | None = None
                          ) -> ParsedStream:
    """Parse a complete stream with picture-level parallelism (the C++
    parser, built on first use; a failed build raises)."""
    data = bytes(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    r = BitReader(data)
    meta = parse_container_header(r)
    index = StartCodeIndex.scan(data)
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
            ft, start_bit = _parse_picture_header(parser, rr)
            if ft is None:
                pos = rr.byte_pos
                continue
            frames.append(ft)
            jobs.append((ft, start_bit, parser.seq))
            # jump to the next non-slice code to keep the walk O(codes)
            pos = _picture_end(index, rr.byte_pos, len(data))
        else:
            pos = off + 4

    def run(job):
        ft, start_bit, seq = job
        native.parse_picture_slices(arr, start_bit, ft,
                                    seq.mb_width, seq.mb_height, seq)

    if jobs:
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            list(pool.map(run, jobs))

    return ParsedStream(meta=meta, seq=parser.seq, frames=frames,
                        gop_starts=gop_starts)


def _parse_picture_header(parser: StreamParser, r: BitReader):
    """Picture-header fields + FrameTensors allocation (serial part)."""
    seq = parser.seq
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
    ft = alloc_frame_tensors(seq, ptype, temporal_ref, full_pel, f_code,
                             parser._pending_gop_time
                             if parser._have_pending_gop else 0.0,
                             yuva=parser.yuva)
    parser._have_pending_gop = False
    return ft, r.bit_pos


def _picture_end(index: StartCodeIndex, from_byte: int, eos: int) -> int:
    entries = index.entries
    i = int(np.searchsorted(entries[:, 0], from_byte))
    skip = (T.START_EXTENSION, T.START_USER_DATA)
    while i < len(entries):
        code = int(entries[i, 1])
        if not (T.START_SLICE_FIRST <= code <= T.START_SLICE_LAST
                or code in skip):
            return int(entries[i, 0])
        i += 1
    return eos
