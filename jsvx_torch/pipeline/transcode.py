"""End-to-end batch decode: parse -> one wire copy -> GOP decode -> sink.

The port of ``jsvx/pipeline/transcode.py``.  Per GOP the host parses the
pictures with the C++ parser, packs them into one uint8 wire, and copies
it to ``device`` once; on the device the wire is unpacked and each plane
of each frame decoded by the ``impl`` chosen (see
:mod:`jsvx_torch.pipeline.gop`).  Two wires:

* compact (the default): the coded coefficients only, expanded on the
  device (``_transcode_compact``).  A GOP whose stream emits blocks out
  of order (overlapping slices) cannot be expressed in it and falls back
  to the dense wire, GOP by GOP;
* dense: stacked coefficient planes (``_transcode_packed``), the route of
  the oddify-zeros quirk, which changes positions the compact wire does
  not carry.

Stages are timed in ``Metrics``: ``parse``, ``h2d``, ``device_decode``
(ends when the GOP's planes are complete) and ``sink``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.decode import make_constants
from ..runtime.multihost import GopManifest
from ..runtime.profiler import Metrics
from .gop import decode_gop_wire, frame_decoder, zero_refs
from .packed_parse import (BufferPool, parse_gop_compact, parse_gop_packed,
                           walk_stream)
from .wire import flatten_wire, wire_spec


@dataclass
class TranscodeResult:
    n_frames: int
    n_gops: int
    metrics: Metrics
    width: int
    height: int


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pack(stacked: dict, pool: BufferPool) -> tuple:
    """Pack every leaf of ``stacked`` into one pooled uint8 buffer;
    returns (spec, buffer)."""
    spec = wire_spec(stacked)
    buf = pool.acquire((spec[1],), np.uint8)
    flatten_wire(stacked, spec, out=buf)
    return spec, buf


def to_device(buf: np.ndarray, device: torch.device) -> torch.Tensor:
    """One copy of a host wire to ``device``.  On the CPU ``from_numpy``
    aliases the buffer, so it is cloned before a pool can hand the buffer
    to the next parse; a copy from pageable memory to the card is
    complete when ``.to()`` returns."""
    host = torch.from_numpy(buf)
    return host.clone() if device.type == "cpu" else host.to(device)


def transcode(data: bytes, sink=None, *, device="cuda",
              impl: str = "fused",
              manifest: GopManifest | None = None,
              process_id: int = 0, process_count: int = 1,
              n_parse_threads: int | None = None,
              quirk_oddify_zeros: bool = False,
              metrics: Metrics | None = None) -> TranscodeResult:
    """Decode every (assigned, pending) GOP of ``data`` on ``device`` (a
    CUDA card unless the caller asks for ``"cpu"``).  The host parse runs
    in the C++ parser, built on first use; a failed build raises.

    ``sink(gop_index, frames)`` receives each GOP's decoded (Y, Cb, Cr[,
    A]) stacks, uint8 tensors on ``device``.  ``impl`` is ``"fused"`` or
    ``"two_kernel"``.  With a ``manifest``, completed GOPs are journaled
    and skipped on resume; with ``process_count > 1`` only this process's
    round-robin share is decoded.
    """
    frame_decoder(impl)                  # reject an unknown impl early
    run = _transcode_packed if quirk_oddify_zeros else _transcode_compact
    return run(data, sink, device=torch.device(device), impl=impl,
               manifest=manifest, process_id=process_id,
               process_count=process_count, n_parse_threads=n_parse_threads,
               quirk_oddify_zeros=quirk_oddify_zeros,
               metrics=metrics or Metrics())


def _transcode_compact(data: bytes, sink, **kw) -> TranscodeResult:
    """The compact wire, with the per-GOP dense fallback for dirty GOPs."""
    buckets: dict = {}                   # sticky per-component buckets

    def parse(arr, group, seq, meta, pool, n_threads):
        g = parse_gop_compact(arr, group, seq, meta, pool, buckets,
                              n_threads=n_threads)
        if not g.dirty:
            return g.stacked, g.pooled, len(g.hdrs)
        for b in g.pooled:
            pool.release(b)
        return _parse_dense(arr, group, seq, meta, pool, n_threads)

    return _run_gops(data, sink, parse, **kw)


def _transcode_packed(data: bytes, sink, **kw) -> TranscodeResult:
    """The dense wire for every GOP (the oddify-zeros quirk's route)."""
    return _run_gops(data, sink, _parse_dense, **kw)


def _parse_dense(arr, group, seq, meta, pool, n_threads):
    g = parse_gop_packed(arr, group, seq, meta, pool, n_threads=n_threads)
    return g.stacked, g.pooled, len(g.fts)


def _run_gops(data: bytes, sink, parse, *, device: torch.device, impl: str,
              manifest: GopManifest | None, process_id: int,
              process_count: int, n_parse_threads: int | None,
              quirk_oddify_zeros: bool,
              metrics: Metrics) -> TranscodeResult:
    """The GOP loop both wires share: ``parse(arr, group, seq, meta, pool,
    n_threads)`` gives (stacked dict, pooled buffers, frame count)."""
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
    n_frames = 0
    wire_total = 0
    for gi in todo:
        with metrics.timers.stage("parse"):
            stacked, pooled, nf = parse(arr, groups[gi], seq, meta, pool,
                                        n_parse_threads)
            spec, buf = pack(stacked, pool)
        with metrics.timers.stage("h2d"):
            wire = to_device(buf, device)
        for b in pooled + [buf]:
            pool.release(b)
        wire_total += buf.nbytes
        with metrics.timers.stage("device_decode"):
            refs = zero_refs(seq.coded_height, seq.coded_width,
                             meta.n_components, device)
            outs, _ = decode_gop_wire(wire, spec, refs, consts,
                                      seq.mb_height, seq.mb_width,
                                      quirk_oddify_zeros, impl)
            synchronize(device)
        if sink is not None:
            with metrics.timers.stage("sink"):
                sink(gi, outs)
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
