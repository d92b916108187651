"""Streaming Decoder on a torch device.

The port of ``jsvx/api/decoder.py``.  It subclasses jsvx's
:class:`jsvx.api.decoder.Decoder`, which is JAX-free until it reaches the
device: the byte buffer, container and key map, availability gates,
``stalled``/``frame``/``ended``/``seeked`` events and key-map seeking are
jsvx's own code.  Only the device methods are replaced:

* ``_reconstruct`` (one picture): the picture is packed, copied to
  ``device`` as one wire and decoded by the fused decode kernel, one
  launch per plane, from the carried reference planes;
* ``_decode_gop_batch`` (a fully buffered key-map GOP): every picture of
  the GOP is parsed, the GOP goes to ``device`` as one dense wire and
  through the GOP loop, the fused kernel once per picture and plane; the
  first frame returns and the rest queue.

Both go through :func:`jsvx_torch.pipeline.stream.decode_group`.  jsvx
batches only on its JAX backend; here the batch runs on the ``"torch"``
backend.  ``backend="oracle"`` is jsvx's float64 path, unchanged.
``DecodedFrame.planes`` are uint8 tensors on ``device``.
"""

from __future__ import annotations

import torch

from jsvx.api.decoder import DecodedFrame
from jsvx.api.decoder import Decoder as _JsvxDecoder
from jsvx.bitstream.bitio import BitReader, BitStallError
from jsvx.coding import tables as T
from jsvx.runtime.profiler import Metrics

from ..kernels.decode import make_constants
from ..pipeline.gop import zero_refs
from ..pipeline.packed_parse import BufferPool
from ..pipeline.stream import decode_group

BACKENDS = ("torch", "oracle")


class Decoder(_JsvxDecoder):
    """jsvx's streaming Decoder, reconstructing on ``device``.

    ``metrics`` holds the device path's stages: ``parse`` (the GOP batch's
    picture parse), ``pack``, ``h2d`` and ``device_decode``.
    """

    def __init__(self, config=None, backend: str = "torch", *, device):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        super().__init__(config, backend=backend)
        self.device = torch.device(device)
        self.metrics = Metrics()
        self._pool = BufferPool()

    def decode_frame(self) -> DecodedFrame | None:
        """jsvx's ``decode_frame``, with its GOP batch opened to the torch
        backend: a fully buffered key-map GOP decodes as one batch, and
        anything else picture by picture."""
        if (self.backend == "torch" and self.config.use_gop_scan
                and not self._pending and self.meta is not None):
            span = self._buffered_gop_span()
            if span is not None:
                got = self._decode_gop_batch(span)
                if got is not None:
                    return got
        return super().decode_frame()

    def _decode(self, fts: list, use_gop_scan: bool) -> list:
        """Parsed pictures -> their planes, the reference carried."""
        seq = self.parser.seq
        if self._consts is None:
            self._consts = make_constants(seq, self.device)
        if self._refs is None:
            self._refs = zero_refs(seq.coded_height, seq.coded_width,
                                   fts[0].n_comps, self.device)
        frames, self._refs = decode_group(
            fts, self._refs, self._consts, self.device,
            quirk=self.config.quirk_oddify_zeros, use_gop_scan=use_gop_scan,
            pool=self._pool, metrics=self.metrics)
        return frames

    def _reconstruct(self, ft) -> DecodedFrame:
        if self.backend != "torch":
            return super()._reconstruct(ft)
        planes, = self._decode([ft], use_gop_scan=False)
        return DecodedFrame(planes=planes, picture_type=ft.picture_type,
                            ts_ms=ft.gop_time_ms)

    def _decode_gop_batch(self, span) -> DecodedFrame | None:
        """Parse every picture in the buffered span and decode them as one
        batch; the first frame returns, the rest queue in ``_pending``.
        Any surprise stall ends the parse early (the pictures parsed so far
        still decode), as in jsvx."""
        with self.metrics.timers.stage("parse"):
            fts = self._parse_span(span[1])
        if not fts:
            return None
        planes = self._decode(fts, use_gop_scan=True)
        frames = [DecodedFrame(planes=p, picture_type=ft.picture_type,
                               ts_ms=ft.gop_time_ms)
                  for p, ft in zip(planes, fts)]
        self._pending = frames[1:]
        self.emit("frame", frames[0])
        return frames[0]

    def _parse_span(self, end: int) -> list:
        """The byte-span parse of jsvx's ``_decode_gop_batch``
        (``jsvx/api/decoder.py:240-276``): headers and pictures from
        ``read_pos`` up to ``end``."""
        fts = []
        while True:
            pos = self.buffer.read_pos
            if pos >= end:
                break
            vi = self._view_and_index()
            if vi is None:
                break
            data, base, index = vi
            nxt = index.next_code(pos)
            if nxt is None or nxt[0] >= end:
                self.buffer.advance_to(min(end, base + len(data)))
                break
            off, code = nxt
            r = BitReader(data.tobytes(), base=base,
                          pos_bits=(off + 4) << 3)
            try:
                if code == T.START_SEQUENCE:
                    self._on_sequence(self.parser.parse_sequence_header(r))
                    self.buffer.advance_to(r.byte_pos)
                elif code == T.START_GOP:
                    self.current_time_ms = self.parser.parse_gop_header(r)
                    self.buffer.advance_to(r.byte_pos)
                elif code == T.START_PICTURE:
                    ft = self.parser.parse_picture(
                        r, index, self._known_end(base, len(data)) or end)
                    self.buffer.advance_to(min(r.byte_pos, end))
                    if ft is not None:
                        fts.append(ft)
                else:
                    self.buffer.advance_to(off + 4)
            except BitStallError as e:
                self.emit("stalled", e.needed_byte)
                break
        return fts
