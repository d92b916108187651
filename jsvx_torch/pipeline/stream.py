"""Whole-stream decode on one device: the dense stream decoder.

The port of ``jsvx/pipeline/stream.py``.  The host parses every picture
with the port's ``StreamParser`` (its C++ back end),
packs each picture with :func:`jsvx_torch.kernels.decode.frame_to_device`,
stacks a GOP's pictures, and copies the GOP to the device as one wire;
the device decodes it with the ``impl`` chosen (see
:mod:`jsvx_torch.pipeline.gop`).  The reference planes carry from GOP to
GOP.  Stages are timed in ``Metrics``: ``parse``, ``pack``, ``h2d`` and
``device_decode`` (ends when the GOP's planes are complete).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bitstream.bitio import BitReader
from ..bitstream.container import StartCodeIndex, parse_container_header
from ..bitstream.parser import StreamParser
from ..coding import tables as T
from ..kernels.decode import frame_to_device, make_constants
from .gop import (decode_gop, frame_at, frame_decoder, stack_device_frames,
                  zero_refs)
from .packed_parse import BufferPool
from .transcode import pack, synchronize, to_device
from ..runtime.profiler import Metrics
from .wire import unflatten_wire


def decode_group(fts: list, refs: tuple, consts, device: torch.device, *,
                 quirk: bool = False, impl: str = "fused",
                 use_gop_scan: bool = True, pool: BufferPool | None = None,
                 metrics: Metrics | None = None) -> tuple:
    """Decode a group of parsed pictures on ``device`` through one dense
    wire; returns (a (Y, Cb, Cr[, A]) tuple of uint8 planes per picture,
    the last picture's planes as the next reference).

    The pictures are packed with ``frame_to_device``, stacked, packed into
    one pooled buffer and copied to ``device`` once.  ``use_gop_scan``
    decodes them with the GOP loop (``decode_gop``); ``False``
    decodes them one after the other, each from the reference before it,
    through the per-frame decode of ``impl``.  Returns once the planes
    are complete.  Stages ``pack``, ``h2d``, ``device_decode`` go to
    ``metrics``.
    """
    pool = pool or BufferPool()
    metrics = metrics or Metrics()
    with metrics.timers.stage("pack"):
        spec, buf = pack(stack_device_frames(
            [frame_to_device(ft) for ft in fts]), pool)
    with metrics.timers.stage("h2d"):
        wire = to_device(buf, device)
    pool.release(buf)
    with metrics.timers.stage("device_decode"):
        stacked = unflatten_wire(wire, spec)
        if use_gop_scan:
            outs, refs = decode_gop(stacked, refs, consts, quirk, impl)
            frames = [tuple(p[i] for p in outs) for i in range(len(fts))]
        else:
            decode_frame = frame_decoder(impl)
            frames = []
            for i in range(len(fts)):
                refs = decode_frame(frame_at(stacked, i), refs, consts,
                                    quirk)
                frames.append(refs)
        synchronize(device)
    metrics.count("frames", len(fts))
    return frames, refs


@dataclass
class StreamResult:
    frames: list            # (Y, Cb, Cr[, A]) uint8 tensors per picture
    picture_types: list
    width: int
    height: int
    metrics: Metrics


class StreamDecoder:
    """Decode a complete in-memory JSV stream on ``device`` (a CUDA card
    unless the caller asks for ``"cpu"``)."""

    def __init__(self, data: bytes, quirk_oddify_zeros: bool = False, *,
                 device="cuda"):
        self.data = bytes(data)
        self.quirk = quirk_oddify_zeros
        self.device = torch.device(device)
        self.reader = BitReader(self.data)
        self.meta = parse_container_header(self.reader)
        self.index = StartCodeIndex.scan(self.data)
        self.parser = StreamParser(yuva=self.meta.yuva)

    def parse_all(self) -> list:
        """Host pass: all FrameTensors in stream order."""
        r, parser = self.reader, self.parser
        out = []
        while True:
            nxt = self.index.next_code(r.byte_pos)
            if nxt is None:
                return out
            off, code = nxt
            r.seek_bits((off + 4) << 3)
            if code == T.START_SEQUENCE:
                parser.parse_sequence_header(r)
            elif code == T.START_GOP:
                parser.parse_gop_header(r)
            elif code == T.START_PICTURE:
                ft = parser.parse_picture(r, self.index, len(self.data))
                if ft is not None:
                    out.append(ft)

    def decode(self, use_gop_scan: bool = True, impl: str | None = None,
               metrics: Metrics | None = None) -> StreamResult:
        """Decode every picture.  ``impl``: ``"fused"`` (None) or
        ``"two_kernel"``.  ``use_gop_scan`` decodes a GOP (split at I
        pictures) per wire through the GOP loop; ``False`` ships and
        decodes one picture at a time through the same ``impl``."""
        impl = impl or "fused"
        frame_decoder(impl)              # reject an unknown impl early
        metrics = metrics or Metrics()
        dev = self.device
        with metrics.timers.stage("parse"):
            fts = self.parse_all()
        seq = self.parser.seq
        consts = make_constants(seq, dev)
        refs = zero_refs(seq.coded_height, seq.coded_width,
                         self.meta.n_components, dev)
        if use_gop_scan:
            groups, cur = [], []
            for ft in fts:
                if ft.is_intra_picture and cur:
                    groups.append(cur)
                    cur = []
                cur.append(ft)
            if cur:
                groups.append(cur)
        else:
            groups = [[ft] for ft in fts]

        pool = BufferPool()
        frames = []
        for group in groups:
            outs, refs = decode_group(group, refs, consts, dev,
                                      quirk=self.quirk, impl=impl,
                                      use_gop_scan=use_gop_scan, pool=pool,
                                      metrics=metrics)
            frames.extend(outs)
        return StreamResult(frames=frames,
                            picture_types=[f.picture_type for f in fts],
                            width=self.meta.width, height=self.meta.height,
                            metrics=metrics)
