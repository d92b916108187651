"""Streaming Decoder: the public decode API over a sparse byte buffer.

The port of ``jsvx/api/decoder.py``, the framework equivalent of the
reference's ``jsv_dec`` object (``decoders/jsv.js:20-50,426-465,
1618-1648``): it owns the stream buffer, parses the container header and
GOP key map when enough bytes arrive, pulls one picture per
``decode_frame()`` against availability gates (emitting ``stalled`` with
the missing byte offset for the streaming layer to refill), reconstructs
on the configured backend, and seeks via the key map to <= 150 ms
precision.

Backends: ``"torch"`` (the default) reconstructs on ``device`` (a CUDA
card unless the caller asks for ``"cpu"``), ``"oracle"`` with the float64
oracle on the host.  On the torch backend:

* ``_reconstruct`` (one picture): the picture is packed, copied to
  ``device`` as one wire and decoded by the fused decode kernel, one
  launch per picture, from the carried reference planes;
* ``_decode_gop_batch`` (a fully buffered key-map GOP): the GOP's bytes
  are read from the buffer once, its headers parsed, and its pictures
  parsed serially into the compact wire (the coded coefficients, as
  ``transcode`` ships them), which goes to ``device`` as one wire and
  through the GOP program that expands it and runs the GOP loop
  (:func:`jsvx_torch.pipeline.stream.decode_compact_group`); the first
  frame returns and the rest queue.  The batch goes as dense planes
  instead (:func:`jsvx_torch.pipeline.stream.decode_group`) with the
  oddify-zeros quirk, without the C++ parser, or for a GOP whose blocks
  come out of order (``dirty``), which is parsed again dense.

Either way the decode goes through a GOP program
(:mod:`jsvx_torch.pipeline.program`: the picture's or the GOP's, a CUDA
graph replayed on a card), checked out of the process's cache for that
call only: a Decoder that is dropped or seeks holds none.  The compact
wire's entry buckets are the Decoder's and only grow, so a stream's
batches keep one or two program keys.
``DecodedFrame.planes`` are uint8 tensors on ``device`` (numpy arrays on
the oracle backend).

Events: ``meta``(ContainerMeta), ``seq``(dict), ``frame``(DecodedFrame),
``ended``, ``seeked``(target_ms, actual_ms), ``stalled``(byte).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.bitio import BitReader, BitStallError
from ..bitstream.container import (ContainerMeta, StartCodeIndex,
                                   parse_container_header)
from ..bitstream.parser import (FrameTensors, StreamParser,
                                alloc_frame_tensors)
from ..bitstream.ranges import RangeBuffer
from ..coding import tables as T
from ..kernels.decode import make_constants, quant_key
from ..pipeline.gop import zero_refs
from ..pipeline.packed_parse import (BufferPool, CompactGop,
                                     parse_gop_compact, start_gop_compact)
from ..pipeline.parallel_parse import (_parse_picture_header, _picture_end,
                                       _picture_stops)
from ..pipeline.parse_pool import Lane
from ..pipeline.stream import decode_compact_group, decode_group
from ..runtime.profiler import Metrics, span
from .config import PlayerConfig
from .events import EventDispatcher

BACKENDS = ("torch", "oracle")
_BOUNDS = frozenset((T.START_PICTURE, T.START_GOP, T.START_SEQUENCE))


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")


@dataclass
class DecodedFrame:
    planes: tuple                 # (Y, Cb, Cr[, A]) uint8 tensors or arrays
    picture_type: int
    ts_ms: float                  # GOP timecode resync (0 = none)

    @property
    def is_intra(self) -> bool:
        return self.picture_type == T.PICTURE_TYPE_I


class _PictureSpans(Lane):
    """The Decoder's lane of the compact parse: serial, on the calling
    thread, each picture's parse a ``picture_parse`` span."""

    def __init__(self, decoder: "Decoder"):
        super().__init__(1)
        self.decoder = decoder

    def submit(self, fn, sizes: list):
        dec = self.decoder

        def one(i):
            with span("picture_parse", picture=dec._pictures):
                dec._pictures += 1
                fn(i)

        return super().submit(one, sizes)


class Decoder(EventDispatcher):
    """The streaming Decoder, reconstructing on ``device``.

    ``metrics`` holds the torch backend's stages: ``parse`` (the GOP
    batch's headers and picture parse; its span's ``wire`` attribute is
    the batch's wire, ``compact`` or ``dense``), ``pack``, ``h2d`` and
    ``device_decode``; the counters ``decoder.gop_batches.compact`` and
    ``.dense`` (the GOP batches on each wire); the buffer's counters
    ``scanned_bytes`` and ``copied_bytes`` (:class:`RangeBuffer`); and on
    a card the counters ``gop_program.captures`` and ``.replays``.  While
    a profiler records, the span log also gets each start-code ``scan``
    (in ``feed``: the buffer indexes the bytes each chunk brings), each
    ``buffer_copy`` of the bytes a reader reads and each
    ``picture_parse``.
    """

    def __init__(self, config: PlayerConfig | None = None,
                 backend: str = "torch", *, device="cuda"):
        check_backend(backend)
        super().__init__()
        self.config = config or PlayerConfig()
        self.backend = backend
        self.device = torch.device(device)
        self.metrics = Metrics()
        self._pool = BufferPool()
        self.buffer = RangeBuffer(self.metrics)
        self.buffer.on("stalled", lambda pos: self.emit("stalled", pos))
        self.parser = StreamParser(use_native=self.config.use_native_parser)
        self.meta: ContainerMeta | None = None
        self.current_time_ms = 0.0
        self._skip_till_gop = False
        self._ended = False
        self._refs = None
        self._consts = None
        self._pending: list[DecodedFrame] = []   # GOP-batch output queue
        self._pictures = 0                # pictures parsed, for the spans
        self._buckets: dict = {}          # the compact wire's, sticky

    # ------------------------------------------------------------------
    # Ingest

    def feed(self, start: int, data: bytes, total: int | None = None) -> None:
        """Add downloaded bytes; parses metadata once the header is in."""
        self.buffer.add(start, data, total)
        if self.meta is None:
            self._try_init_meta()

    def _try_init_meta(self) -> None:
        view = self.buffer.contiguous_view(0)
        if view is None:
            return
        data, base = view
        try:
            r = BitReader(data.tobytes(), base=base)
            meta = parse_container_header(r)
        except BitStallError:
            return                        # not enough header bytes yet
        self.meta = meta
        self.parser.yuva = meta.yuva       # 4th component (jsv.js:256-259)
        self.buffer.read_pos = meta.header_bytes
        self.emit("meta", meta)

    # ------------------------------------------------------------------
    # Helpers

    def _view_and_index(self):
        """(start, length, start-code index) of the buffered run at
        ``read_pos``: the buffer's own index, kept as bytes arrive."""
        got = self.buffer.start_codes(self.buffer.read_pos)
        if got is None:
            self.emit("stalled", self.buffer.read_pos)
        return got

    def _reader(self, index: StartCodeIndex, off: int) -> BitReader:
        """A reader at the start code at ``off``, over a copy of the bytes
        up to the next picture, GOP or sequence start code and its four
        bytes (what bounds the parse), or to the end of the buffered run
        when that code is not buffered yet."""
        nxt = index.next_code(off + 1, codes=_BOUNDS)
        buf = self.buffer.read(off, nxt[0] + 4 if nxt else 1 << 62)
        return BitReader(buf, base=off, pos_bits=(off + 4) << 3)

    def _parse_picture(self, r: BitReader, index, eos):
        with span("picture_parse", picture=self._pictures):
            self._pictures += 1
            return self.parser.parse_picture(r, index, eos)

    def _known_end(self, base: int, data_len: int) -> int | None:
        """Absolute end-of-stream byte when this view reaches it."""
        total = self.buffer.total_length
        if total and base + data_len >= total:
            return total
        if self.buffer.fully_loaded:
            return base + data_len
        return None

    @property
    def sequence(self):
        return self.parser.seq

    # ------------------------------------------------------------------
    # Decode

    def decode_frame(self) -> DecodedFrame | None:
        """Decode the next picture; None on stall or end (check
        ``ended``).  Mirrors the reference decode loop (jsv.js:426-465).

        With ``config.use_gop_scan``, a key map and the torch backend, a
        fully-buffered GOP is decoded as ONE batch (one copy and one GOP
        loop); frames stream out of an internal queue.  Falls back to
        picture-at-a-time whenever the next GOP is not fully buffered yet.
        """
        if self._pending:
            frame = self._pending.pop(0)
            self.emit("frame", frame)
            return frame
        if self.meta is None:
            self.emit("stalled", 0)
            return None
        if self.config.use_gop_scan and self.backend == "torch":
            span = self._buffered_gop_span()
            if span is not None:
                got = self._decode_gop_batch(span)
                if got is not None:
                    return got
        while True:
            total = self.buffer.total_length
            if ((total and self.buffer.read_pos >= total)
                    or (self.buffer.fully_loaded
                        and self.buffer.buffered_from(
                            self.buffer.read_pos) == 0)):
                self._ended = True
                self.emit("ended")
                return None
            vi = self._view_and_index()
            if vi is None:
                return None
            base, n, index = vi
            pos = self.buffer.read_pos
            nxt = index.next_code(pos)
            if nxt is None:
                end = self._known_end(base, n)
                if end is not None:
                    self._ended = True
                    self.emit("ended")
                else:
                    self.emit("stalled", base + n)
                return None
            off, code = nxt
            try:
                if code == T.START_SEQUENCE:
                    if not self.buffer.has(18, off):   # header size gate
                        return None
                    r = self._reader(index, off)
                    seq = self.parser.parse_sequence_header(r)
                    if self._skip_till_gop:
                        self._skip_till_gop = False
                    self._on_sequence(seq)
                    self.buffer.advance_to(r.byte_pos)
                elif self._skip_till_gop:
                    self.buffer.advance_to(off + 4)
                elif code == T.START_GOP:
                    if not self.buffer.has(8, off):
                        return None
                    r = self._reader(index, off)
                    t = self.parser.parse_gop_header(r)
                    self.current_time_ms = t
                    self.buffer.advance_to(r.byte_pos)
                elif code == T.START_PICTURE:
                    gate = (self.parser.seq.vbv_buffer_bytes
                            if self.parser.seq else 300000)
                    if not self.buffer.has(gate, off):
                        return None
                    r = self._reader(index, off)
                    ft = self._parse_picture(r, index,
                                             self._known_end(base, n))
                    self.buffer.advance_to(r.byte_pos)
                    if ft is None:
                        continue           # skipped picture type
                    frame = self._reconstruct(ft)
                    self.emit("frame", frame)
                    return frame
                else:
                    self.buffer.advance_to(off + 4)
            except BitStallError as e:
                self.emit("stalled", e.needed_byte)
                return None

    # ------------------------------------------------------------------
    # GOP-batched decode (one wire and one GOP loop over a buffered GOP)

    def _buffered_gop_span(self) -> tuple | None:
        """Byte span [start, end) of the key-map GOP containing read_pos
        iff every byte of it is buffered; None otherwise."""
        if self._skip_till_gop or self.meta is None:
            return None
        km = self.meta.key_map
        if km is None or km.count == 0:
            return None
        pos = self.buffer.read_pos
        offs = km.offsets
        i = int(np.searchsorted(offs, pos, side="right")) - 1
        if i < 0:
            return None
        if i + 1 < km.count:
            end = int(offs[i + 1])
            # +4: the next GOP's start code must be visible so the native
            # parser can bound this GOP's final picture
            need = end - pos + 4
        else:
            total = self.buffer.total_length
            if not total:
                return None
            end = total
            need = end - pos
        if end <= pos:
            return None
        if self.buffer.buffered_from(pos) < need:
            return None
        return (pos, end)

    def _decode_gop_batch(self, span) -> DecodedFrame | None:
        """Parse every picture in the buffered span and decode them as one
        batch; the first frame returns, the rest queue in ``_pending``.
        Any surprise stall ends the parse early (the pictures parsed so far
        still decode), and with none parsed the caller falls back to the
        picture-at-a-time loop.  The batch ships the compact wire where
        :meth:`_compact_route` allows and the GOP's parse is not
        ``dirty``, else the dense wire."""
        compact = self._compact_route()
        with self.metrics.timers.stage(
                "parse", start=span[0],
                wire="compact" if compact else "dense") as s:
            if compact:
                hdrs, gop, fts = self._parse_span_compact(*span)
                if gop is None and fts:
                    s.set(wire="dense")
            else:
                fts = self._parse_span(span[1])
                hdrs, gop = fts, None
        if not hdrs:
            return None
        if gop is not None:
            planes = self._decode_compact(gop)
        else:
            planes = self._decode(fts, use_gop_scan=True)
        self.metrics.count("decoder.gop_batches."
                           + ("compact" if gop is not None else "dense"))
        frames = [DecodedFrame(planes=p, picture_type=h.picture_type,
                               ts_ms=h.gop_time_ms)
                  for p, h in zip(planes, hdrs)]
        self._pending = frames[1:]
        self.emit("frame", frames[0])
        return frames[0]

    def _compact_route(self) -> bool:
        """Whether a GOP batch goes on the compact wire: not with the
        oddify-zeros quirk, which changes positions the compact wire does
        not carry, and only with the C++ parser, the one that writes it."""
        return (not self.config.quirk_oddify_zeros
                and self.parser._native is not None)

    def _parse_span_compact(self, start: int, end: int) -> tuple:
        """The span [``start``, ``end``) of a buffered GOP: its headers by
        the Decoder's parser (as :meth:`_parse_span`), each picture's
        header only, then its pictures in one compact parse of the span's
        bytes, read once -> (the pictures' headers, their
        :class:`CompactGop`, None); a GOP the compact wire cannot express
        (``dirty``) is parsed again into dense pictures -> (headers, None,
        FrameTensors)."""
        _, _, index = self._view_and_index()
        entries = index.entries
        lo, hi = np.searchsorted(entries[:, 0], [start, end])
        index = StartCodeIndex(entries[lo:hi])
        stops = _picture_stops(index)
        data = self.buffer.read(start, end + 4)   # + the next start code
        r = BitReader(data, base=start)
        group, pos = [], start
        try:
            while (nxt := index.next_code(pos)) is not None:
                off, code = nxt
                r.seek_bits((off + 4) << 3)
                if code == T.START_SEQUENCE:
                    self._on_sequence(self.parser.parse_sequence_header(r))
                    pos = r.byte_pos
                elif code == T.START_GOP:
                    self.current_time_ms = self.parser.parse_gop_header(r)
                    pos = r.byte_pos
                elif code == T.START_PICTURE:
                    hdr, bit = _parse_picture_header(self.parser, r)
                    pos = r.byte_pos
                    if hdr is not None:
                        group.append((hdr, bit - (start << 3)))
                        pos = _picture_end(stops, pos, end)
                else:
                    pos = off + 4
            pos = end
        except BitStallError as e:
            self.emit("stalled", e.needed_byte)
            pos = off
        self.buffer.advance_to(pos)
        hdrs = [h for h, _ in group]
        if not group:
            return hdrs, None, []
        arr = np.frombuffer(data, dtype=np.uint8)
        seq = self.parser.seq
        gop = parse_gop_compact(
            arr, group, seq, self.meta, self._pool, self._buckets,
            started=start_gop_compact(arr, group, seq, self.meta,
                                      self._pool, _PictureSpans(self)))
        if not gop.dirty:
            return hdrs, gop, None
        for buf in gop.pooled:
            self._pool.release(buf)
        return hdrs, None, [self._parse_dense(arr, h, bit, seq)
                            for h, bit in group]

    def _parse_dense(self, arr: np.ndarray, hdr, bit: int, seq):
        """One picture of a GOP's bytes ``arr`` (its slices from ``bit``)
        into dense FrameTensors, as :meth:`StreamParser.parse_picture`
        parses it."""
        ft = alloc_frame_tensors(seq, hdr.picture_type, hdr.temporal_ref,
                                 hdr.full_pel, hdr.f_code, hdr.gop_time_ms,
                                 yuva=self.parser.yuva)
        with span("picture_parse", picture=self._pictures):
            self._pictures += 1
            self.parser._native.parse_picture_slices(
                arr, bit, ft, seq.mb_width, seq.mb_height,
                seq if self.parser.emit_sideband else None)
        return ft

    def _parse_span(self, end: int) -> list:
        """Headers and pictures from ``read_pos`` up to ``end``."""
        fts = []
        while True:
            pos = self.buffer.read_pos
            if pos >= end:
                break
            vi = self._view_and_index()
            if vi is None:
                break
            base, n, index = vi
            nxt = index.next_code(pos)
            if nxt is None or nxt[0] >= end:
                self.buffer.advance_to(min(end, base + n))
                break
            off, code = nxt
            try:
                if code == T.START_SEQUENCE:
                    r = self._reader(index, off)
                    self._on_sequence(self.parser.parse_sequence_header(r))
                    self.buffer.advance_to(r.byte_pos)
                elif code == T.START_GOP:
                    r = self._reader(index, off)
                    self.current_time_ms = self.parser.parse_gop_header(r)
                    self.buffer.advance_to(r.byte_pos)
                elif code == T.START_PICTURE:
                    r = self._reader(index, off)
                    ft = self._parse_picture(
                        r, index, self._known_end(base, n) or end)
                    self.buffer.advance_to(min(r.byte_pos, end))
                    if ft is not None:
                        fts.append(ft)
                else:
                    self.buffer.advance_to(off + 4)
            except BitStallError as e:
                self.emit("stalled", e.needed_byte)
                break
        return fts

    @property
    def ended(self) -> bool:
        return self._ended

    def iter_frames(self):
        """Yield frames until end of stream (data must be fed; stops at a
        stall — check ``ended`` to distinguish starvation from EOS)."""
        while True:
            frame = self.decode_frame()
            if frame is None:
                return
            yield frame

    def _on_sequence(self, seq) -> None:
        if self.meta and seq.bit_rate:
            self.buffer.bytes_backward_limit = int(
                seq.bit_rate * self.config.seconds_played_limit) >> 3
        self.emit("seq", {"r": seq.picture_rate, "w": seq.width,
                          "h": seq.height})

    # ------------------------------------------------------------------
    # Reconstruction backends

    def _prepare(self, n_comps: int):
        """The sequence header the next pictures decode with: the
        constants of its quant matrices (rebuilt when a header, or a seek,
        brings other matrices) and, at the start or after a seek, zero
        reference planes."""
        seq = self.parser.seq
        if self._consts is None or self._consts.quant_key != quant_key(seq):
            self._consts = make_constants(seq, self.device)
        if self._refs is None:
            self._refs = zero_refs(seq.coded_height, seq.coded_width,
                                   n_comps, self.device)
        return seq

    def _decode(self, fts: list, use_gop_scan: bool) -> list:
        """Parsed pictures -> their planes on ``device``, the reference
        carried, with the quant matrices of the current sequence header."""
        self._prepare(fts[0].n_comps)
        frames, self._refs = decode_group(
            fts, self._refs, self._consts, self.device,
            quirk=self.config.quirk_oddify_zeros, use_gop_scan=use_gop_scan,
            pool=self._pool, metrics=self.metrics)
        return frames

    def _decode_compact(self, gop: CompactGop) -> list:
        """A GOP's compact parse -> its planes, as :meth:`_decode`."""
        n_comps = self.meta.n_components
        seq = self._prepare(n_comps)
        frames, self._refs = decode_compact_group(
            gop, self._refs, self._consts, self.device, seq.mb_height,
            seq.mb_width, n_comps, self._pool, self.metrics)
        return frames

    def _reconstruct(self, ft: FrameTensors) -> DecodedFrame:
        if self.backend == "oracle":
            from ..tools.oracle import reconstruct_frame

            planes = reconstruct_frame(ft, self.parser.seq, self._refs,
                                       self.config.quirk_oddify_zeros)
            self._refs = planes
        else:
            planes, = self._decode([ft], use_gop_scan=False)
        return DecodedFrame(planes=planes, picture_type=ft.picture_type,
                            ts_ms=ft.gop_time_ms)

    # ------------------------------------------------------------------
    # Seeking (jsv.js:1618-1648)

    def seek(self, target_ms: float) -> bool:
        """Key-map (or linear-estimate) seek to <= 150 ms precision.
        Returns False when more data must be fetched first (a ``stalled``
        event carries the byte to fetch)."""
        meta = self.meta
        if meta is None:
            return False
        if meta.key_map is not None and meta.key_map.count > 0:
            rate = (self.parser.seq.picture_rate
                    if self.parser.seq is not None else 30.0)
            byte = meta.key_map.byte_for_time(
                target_ms / 1000.0, meta.duration, rate)
        else:
            total = self.buffer.total_length or 1
            byte = int(round(total * (target_ms / 1000.0)
                             / max(meta.duration, 1e-9)))
        if not self.buffer.seek(byte):
            return False

        while True:
            if not self._seek_find_and_parse(T.START_SEQUENCE):
                return False
            if not self._seek_find_and_parse(T.START_GOP):
                return False
            if (target_ms - self.parser.current_time_ms
                    <= self.config.seek_precision_ms):
                break
        self.current_time_ms = self.parser.current_time_ms
        self._refs = None                 # next picture is an I frame
        self._ended = False
        self._pending.clear()             # drop batched frames pre-seek
        self.emit("seeked", target_ms, self.current_time_ms)
        return True

    def _seek_find_and_parse(self, want_code: int) -> bool:
        vi = self._view_and_index()
        if vi is None:
            return False
        base, n, index = vi
        nxt = index.next_code(self.buffer.read_pos, codes={want_code})
        if nxt is None:
            self.emit("stalled", base + n)
            return False
        off, _ = nxt
        r = self._reader(index, off)
        try:
            if want_code == T.START_SEQUENCE:
                self.parser.parse_sequence_header(r)
                self._on_sequence(self.parser.seq)
            else:
                self.parser.parse_gop_header(r)
        except BitStallError as e:
            self.emit("stalled", e.needed_byte)
            return False
        self.buffer.advance_to(r.byte_pos)
        return True
