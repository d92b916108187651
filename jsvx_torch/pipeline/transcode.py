"""End-to-end batch decode: compact parse -> one wire copy -> GOP decode
-> sink.

The port of the compact-wire path of ``jsvx/pipeline/transcode.py``.  Per
GOP the host parses the pictures with the C++ parser, packs them into one
uint8 wire, and copies it to ``device`` once; on the device the wire is
unpacked, the coefficients expanded, and each plane of each frame decoded
by the fused kernel.  Stages are timed in ``Metrics``: ``parse``, ``h2d``,
``device_decode`` (ends when the GOP's planes are complete) and ``sink``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from jsvx.bitstream.native import get_native_parser
from jsvx.runtime.multihost import GopManifest
from jsvx.runtime.profiler import Metrics

from ..kernels.decode import make_constants
from .gop import decode_gop_wire, zero_refs
from .packed_parse import BufferPool, parse_gop_compact, walk_stream
from .wire import flatten_wire, wire_spec


@dataclass
class TranscodeResult:
    n_frames: int
    n_gops: int
    metrics: Metrics
    width: int
    height: int


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def transcode(data: bytes, sink=None, *, device,
              manifest: GopManifest | None = None,
              process_id: int = 0, process_count: int = 1,
              n_parse_threads: int | None = None,
              quirk_oddify_zeros: bool = False,
              metrics: Metrics | None = None) -> TranscodeResult:
    """Decode every (assigned, pending) GOP of ``data`` on ``device``.

    ``sink(gop_index, frames)`` receives each GOP's decoded (Y, Cb, Cr[,
    A]) stacks, uint8 tensors on ``device``.  With a ``manifest``,
    completed GOPs are journaled and skipped on resume; with
    ``process_count > 1`` only this process's round-robin share is
    decoded.
    """
    device = torch.device(device)
    if quirk_oddify_zeros:
        raise NotImplementedError(
            "quirk_oddify_zeros needs the dense-wire transcode, which is "
            "not ported yet (ROADMAP A4)")
    if get_native_parser() is None:
        raise NotImplementedError(
            "transcode without the C++ parser is not ported yet "
            "(ROADMAP A4)")
    metrics = metrics or Metrics()
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    with metrics.timers.stage("parse"):
        meta, seq, groups = walk_stream(data)
    consts = make_constants(seq, device)
    if manifest is None:
        todo = list(range(len(groups)))
    else:
        todo = [s.index for s in manifest.pending(process_id, process_count)
                if s.index < len(groups)]

    pool = BufferPool()
    buckets: dict = {}                   # sticky per-component buckets
    n_frames = 0
    wire_total = 0
    for gi in todo:
        with metrics.timers.stage("parse"):
            g = parse_gop_compact(arr, groups[gi], seq, meta, pool, buckets,
                                  n_threads=n_parse_threads)
            if g.dirty:
                raise NotImplementedError(
                    f"GOP {gi} emits blocks out of order; its dense-wire "
                    f"fallback is not ported yet (ROADMAP A4)")
            spec = wire_spec(g.stacked)
            buf = pool.acquire((spec[1],), np.uint8)
            flatten_wire(g.stacked, spec, out=buf)
        with metrics.timers.stage("h2d"):
            host = torch.from_numpy(buf)
            # on the CPU from_numpy aliases the pooled buffer: clone it
            # before the pool hands it to the next parse.  A copy from
            # pageable memory to the card is complete when .to() returns.
            wire = host.clone() if device.type == "cpu" else host.to(device)
        for b in g.pooled + [buf]:
            pool.release(b)
        wire_total += buf.nbytes
        with metrics.timers.stage("device_decode"):
            refs = zero_refs(seq.coded_height, seq.coded_width,
                             meta.n_components, device)
            outs, _ = decode_gop_wire(wire, spec, refs, consts,
                                      seq.mb_height, seq.mb_width)
            _synchronize(device)
        if sink is not None:
            with metrics.timers.stage("sink"):
                sink(gi, outs)
        nf = len(g.hdrs)
        n_frames += nf
        metrics.count("frames", nf)
        metrics.count("gops")
        if manifest is not None:
            manifest.mark_done(gi, frames=nf)

    metrics.gauge("width", meta.width)
    metrics.gauge("height", meta.height)
    metrics.gauge("wire_bytes", wire_total)
    return TranscodeResult(n_frames=n_frames, n_gops=len(todo),
                           metrics=metrics, width=meta.width,
                           height=meta.height)
