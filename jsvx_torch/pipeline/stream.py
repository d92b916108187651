"""Whole-stream decode on one device: the dense stream decoder.

The port of ``jsvx/pipeline/stream.py``.  The host parses every picture
with the port's ``StreamParser`` (its C++ back end),
packs each picture with :func:`jsvx_torch.kernels.decode.frame_to_device`,
stacks a GOP's pictures, and copies the GOP to the device as one wire,
straight into the static wire of its GOP program
(:mod:`jsvx_torch.pipeline.program`); the program decodes it with the
``impl`` chosen (see :mod:`jsvx_torch.pipeline.gop`) from the reference
planes copied into its slots, which carry from GOP to GOP.  A call holds
its programs until it returns; they then stay in the process's cache (on
a card up to 8, see README for what they hold at 1080p;
``program.CACHE.clear()`` frees them).  Stages are timed in ``Metrics``:
``parse``, ``pack``, ``h2d`` and ``device_decode`` (ends when the GOP's
planes are complete); on a card the counters ``gop_program.captures``
and ``gop_program.replays``.  :func:`decode_compact_group` takes a GOP
parsed into the compact wire instead (the Decoder's GOP batch) through
the same stages and the same kind of program.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bitstream.bitio import BitReader
from ..bitstream.container import StartCodeIndex, parse_container_header
from ..bitstream.parser import StreamParser
from ..coding import tables as T
from ..kernels.decode import (constants_per_seq, frame_comp_keys,
                              frame_to_device)
from ..runtime.profiler import Metrics
from .gop import frame_decoder, stack_device_frames, zero_refs
from .packed_parse import BufferPool, CompactGop
from .program import CACHE, GopProgram, ProgramSet, program_key
from .transcode import pack, synchronize


def decode_group(fts: list, refs: tuple, consts, device: torch.device, *,
                 quirk: bool = False, impl: str = "fused",
                 use_gop_scan: bool = True, pool: BufferPool | None = None,
                 metrics: Metrics | None = None,
                 programs: ProgramSet | None = None) -> tuple:
    """Decode a group of parsed pictures on ``device``; returns (a (Y, Cb,
    Cr[, A]) tuple of uint8 planes per picture, the last picture's planes
    as the next reference).

    ``use_gop_scan`` decodes the group as one GOP (jsvx's
    ``decode_gop_scan``); ``False`` decodes its pictures one after the
    other, each from the reference before it (jsvx's per-picture
    ``decode_frame_jit``).  Either way each unit (the group, or one
    picture) is packed with ``frame_to_device`` and stacked into one
    pooled buffer, which is copied straight into the static wire of the
    GOP program of its dense layout (:mod:`jsvx_torch.pipeline.program`,
    key with ``refs_in``), with ``refs`` copied into the program's
    reference slots, both on the current stream once the device has
    passed the program's "consumed" event; then the program runs (on a
    card: on the key's first sight its eager body, then its capture;
    afterwards one replay and a copy per plane stack).  A picture's
    layout depends on the picture size, the plane count and whether the
    parser emitted ``mult``/``flags``, so every picture of a stream has
    one key.  The programs come from ``programs`` (the caller's, held for
    its call), else from the process cache, checked out for this call
    only.  Returns once the planes are complete.  Stages ``pack``,
    ``h2d``, ``device_decode`` and the counters ``gop_program.captures``
    and ``.replays`` go to ``metrics``.
    """
    pool = pool or BufferPool()
    metrics = metrics or Metrics()
    held = programs if programs is not None else ProgramSet(CACHE)
    frames = []
    try:
        for unit in [fts] if use_gop_scan else [[ft] for ft in fts]:
            outs = _decode_unit(unit, refs, consts, device, quirk, impl,
                                pool, metrics, held)
            refs = tuple(o[-1] for o in outs)
            frames.extend(tuple(o[i] for o in outs) for i in range(len(unit)))
    finally:
        if programs is None:
            held.close()
    metrics.count("frames", len(fts))
    return frames, refs


def _decode_unit(fts: list, refs: tuple, consts, device: torch.device,
                 quirk: bool, impl: str, pool: BufferPool, metrics: Metrics,
                 programs: ProgramSet) -> tuple:
    """One dense wire of ``fts`` through its program, from ``refs`` ->
    the (Y, Cb, Cr[, A]) stacks."""
    with metrics.timers.stage("pack", pictures=len(fts)):
        stacked = stack_device_frames([frame_to_device(ft) for ft in fts])
        spec, buf = pack(stacked, pool)
    h, w = stacked["y"]["levels"].shape[-2:]
    return _run_wire(spec, buf, len(fts), h // 16, w // 16,
                     len(frame_comp_keys(stacked)), refs, consts, device,
                     quirk, impl, pool, metrics, programs)


def _run_wire(spec: tuple, buf, n: int, mb_h: int, mb_w: int, n_comps: int,
              refs: tuple, consts, device: torch.device, quirk: bool,
              impl: str, pool: BufferPool, metrics: Metrics,
              programs: ProgramSet) -> tuple:
    """The packed wire ``buf`` of ``n`` pictures and ``refs`` copied into
    the program of its layout (``buf`` then goes back to ``pool``), and
    the program run -> the (Y, Cb, Cr[, A]) stacks."""
    key = program_key(spec, mb_h, mb_w, n_comps, impl, quirk, consts,
                      device, refs_in=True)
    prog = programs.get(key, lambda: GopProgram(key, consts))
    with metrics.timers.stage("h2d", pictures=n):
        prog.fill(pool.host_tensor(buf), refs)
    pool.release(buf)
    with metrics.timers.stage("device_decode", pictures=n):
        outs, _ = prog.run(None, metrics)
        synchronize(device)
    return outs


def decode_compact_group(gop: CompactGop, refs: tuple, consts,
                         device: torch.device, mb_h: int, mb_w: int,
                         n_comps: int, pool: BufferPool,
                         metrics: Metrics) -> tuple:
    """:func:`decode_group` of one GOP parsed into the compact wire
    (:func:`~jsvx_torch.pipeline.packed_parse.parse_gop_compact` into
    ``pool``; never ``dirty``, never with the oddify-zeros quirk): the
    same (planes per picture, next reference) from the same program
    route, with the coded coefficients on the wire instead of dense
    planes.  Its stacked dict is packed into one pooled buffer (stage
    ``pack``; the parse's pooled buffers then go back to ``pool``), which
    is copied with ``refs`` into the GOP program of its layout (key with
    ``refs_in``, stage ``h2d``), whose body expands the coefficients on
    the device (on a card one launch of the expansion kernel) and runs
    the GOP loop (stage ``device_decode``).  The program is checked out
    of the process cache for this call only."""
    n = len(gop.hdrs)
    with metrics.timers.stage("pack", pictures=n):
        spec, buf = pack(gop.stacked, pool)
    for b in gop.pooled:
        pool.release(b)
    gop.pooled = []
    held = ProgramSet(CACHE)
    try:
        outs = _run_wire(spec, buf, n, mb_h, mb_w, n_comps, refs, consts,
                         device, False, "fused", pool, metrics, held)
    finally:
        held.close()
    metrics.count("frames", n)
    return ([tuple(o[i] for o in outs) for i in range(n)],
            tuple(o[-1] for o in outs))


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
        return [ft for ft, _ in self._parse_pictures()]

    def _parse_pictures(self) -> list:
        """Host pass: (FrameTensors, the sequence header current at it)
        for every picture, in stream order."""
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
                    out.append((ft, parser.seq))

    def decode(self, use_gop_scan: bool = True, impl: str | None = None,
               metrics: Metrics | None = None) -> StreamResult:
        """Decode every picture, each with the quant matrices of the
        sequence header before it.  ``impl``: ``"fused"`` (None) or
        ``"two_kernel"``.  ``use_gop_scan`` decodes a GOP (split at I
        pictures, and where the matrices change) per wire through its GOP
        program; ``False`` ships and decodes one picture at a time through
        the one-picture program of the same ``impl`` and matrices
        (:func:`decode_group`).  The reference planes carry across every
        split."""
        impl = impl or "fused"
        frame_decoder(impl)              # reject an unknown impl early
        metrics = metrics or Metrics()
        dev = self.device
        with metrics.timers.stage("parse"):
            pictures = self._parse_pictures()
        fts = [ft for ft, _ in pictures]
        # one constants set per distinct pair of matrices, so a change of
        # matrices is a change of object
        consts = constants_per_seq([s for _, s in pictures], dev)
        seq = self.parser.seq
        refs = zero_refs(seq.coded_height, seq.coded_width,
                         self.meta.n_components, dev)
        groups = []                      # (pictures, their constants)
        for ft, c in zip(fts, consts):
            if (not use_gop_scan or ft.is_intra_picture or not groups
                    or c is not groups[-1][1]):
                groups.append(([], c))
            groups[-1][0].append(ft)

        pool = BufferPool()
        programs = ProgramSet(CACHE)
        frames = []
        try:
            for group, c in groups:
                outs, refs = decode_group(group, refs, c, dev,
                                          quirk=self.quirk, impl=impl,
                                          use_gop_scan=use_gop_scan,
                                          pool=pool, metrics=metrics,
                                          programs=programs)
                frames.extend(outs)
        finally:
            programs.close()
        return StreamResult(frames=frames,
                            picture_types=[f.picture_type for f in fts],
                            width=self.meta.width, height=self.meta.height,
                            metrics=metrics)
