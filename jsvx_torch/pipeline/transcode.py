"""End-to-end batch decode: parse GOP g+1 while GOP g decodes -> sink.

The port of ``jsvx/pipeline/transcode.py``, in jsvx's order of work and
under jsvx's stage names.  Per GOP the host parses the pictures with the
C++ parser into pooled buffers and packs them into one uint8 wire; the
wire's copy to ``device`` starts at once, and the host parses the next
GOP while the device decodes this one (each plane of each frame by the
``impl`` chosen, see :mod:`jsvx_torch.pipeline.gop`).  The pictures parse
on the process's parse pool (:mod:`jsvx_torch.pipeline.parse_pool`), and
each GOP's are queued there one GOP ahead: before the host waits on GOP
g's parse and packs it, GOP g+1's is queued behind it.  Packing stays in
GOP order.  Two wires:

* compact (the default): the coded coefficients only, expanded on the
  device, on a card by one launch of the expansion kernel per GOP
  (``_transcode_compact``).  A GOP whose stream emits blocks out
  of order (overlapping slices) cannot be expressed in it and falls back
  to the dense wire, GOP by GOP;
* dense: stacked coefficient planes (``_transcode_packed``), the route of
  the oddify-zeros quirk, which changes positions the compact wire does
  not carry.

Each GOP decodes with the quant matrices of the sequence header before it
(the header walk records each GOP's, :func:`~jsvx_torch.pipeline.
packed_parse.walk_stream_seqs`; one constants set per distinct pair of
matrices), by the GOP program of its wire layout and matrices
(:mod:`jsvx_torch.pipeline.program`, the port's counterpart of jsvx's
compiled ``decode_gop_scan_wire``), which the call checks out for its
duration; each wire is copied from its pooled host buffer straight into
the program's static wire.  On a card the pooled buffers are pinned, and
the copy runs on a copy stream that belongs to the call, with an event
recorded after it.  That copy first waits, on the device, for the
program's "consumed" event, recorded after the previous GOP that used the
same static wire (its replay and the copies of its outputs).  The
dispatch makes the current stream wait for the copy's event, then runs
the program: on the key's first sight the eager loop
(:func:`jsvx_torch.pipeline.gop.decode_gop_wire`) and its capture, after
that one graph replay and one copy per plane stack into new tensors; the
"consumed" event is also the GOP's "decoded" event.  On the CPU the same
order runs, every GOP through the eager loop, and nothing overlaps.

The programs stay in the process's cache (``program.CACHE``) after the
call, for the next call of the same layouts: on a card up to 8 of them,
about 55-76 MB each at 1080p.  ``program.CACHE.clear()`` gives that
memory back.

Stages in ``Metrics``:

* ``parse``: the header walk, then per GOP the wait for its parse (and
  the queueing of the next GOP's), the pack and the start of the wire's
  copy;
* ``wire_wait`` (compact GOPs): the host waits for the copy's event, the
  un-overlapped tail of the upload; the GOP's pooled buffers then go
  back to the pool, in time for the next parse;
* ``device_dispatch``: the GOP's launches are enqueued (a replay; on a
  key's first sight the eager run and the capture);
* ``device_wait``: the host waits for the GOP's "decoded" event (on the
  compact route one GOP behind: after the next GOP is dispatched and the
  one after it parsed);
* ``sink``: the caller's sink;
* ``expand_probe_compile`` (``probe_expand=True``): the probe's first run.

While a torch profiler records, each stage is also a span of the span
log (:mod:`jsvx_torch.runtime.profiler`), with its GOP's index (a GOP's
``parse`` also with its wire, its ``tasks`` on the pool and whether it
was queued ``ahead``, before the previous GOP was packed), and the log
gets, besides: ``transcode`` around the call (its id, route and GOP
count), ``walk`` (the header walk, inside the call's first ``parse``),
``call_setup`` (the constants, the pool, the copier) and ``call_close``
(the programs' check-in), and the programs' own spans and events
(:mod:`jsvx_torch.pipeline.program`).

Counter: ``parse_threads_started``, the parse pool's threads the call
started (the process's first parse starts them all; 0 after).  Gauges:
``width``, ``height``, ``wire_bytes`` (every wire copied, dense
fallbacks included) and, with ``probe_expand``,
``expand_probe_s_per_gop``; on a card, the counters
``gop_program.captures`` and ``gop_program.replays`` and, once a call
captured, the gauge ``gop_program.capture_s`` (the captures' seconds,
inside ``device_dispatch``).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.decode import constants_per_seq
from ..kernels.expand import expand_compact_gop
from ..runtime.multihost import GopManifest
from ..runtime.profiler import Metrics, recording, span
from .gop import frame_decoder
from .packed_parse import (BufferPool, parse_gop_compact, parse_gop_packed,
                           start_gop_compact, start_gop_packed,
                           walk_stream_seqs)
from .parse_pool import Lane
from .program import CACHE, GopProgram, ProgramSet, program_key
from .wire import flatten_wire, unflatten_wire, wire_spec


#: each call's id in the span log
_CALLS = itertools.count()


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


@dataclass
class Upload:
    """One GOP's wire on its way to the device."""

    index: int
    n_frames: int
    compact: bool
    spec: tuple
    wire: torch.Tensor           # its program's static wire
    pooled: list                 # host buffers held until the copy is done
    copied: object               # the copy's CUDA event (None on the CPU)
    program: GopProgram          # its decode


class WireCopier:
    """The copies of one call's wires to ``device``.

    Each into a GOP program's static wire ``out``.  On a card: from the
    pool's pinned buffer, ``non_blocking``, on a copy stream of its own
    that first waits for ``after`` (the program's "consumed" event), each
    followed by an event the decode's stream waits for.  On the CPU: a
    copy, complete when it returns.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)

    def copy(self, host: torch.Tensor, out: torch.Tensor, after) -> tuple:
        """Start the copy of ``host`` into ``out``; returns (``out``, the
        copy's event)."""
        if not self.cuda:
            return out.copy_(host), None
        with torch.cuda.stream(self.stream):
            if after is not None:
                self.stream.wait_event(after)
            out.copy_(host, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        return out, copied


def wait(event) -> None:
    """The host waits for ``event`` (nothing to wait for on the CPU)."""
    if event is not None:
        event.synchronize()


def transcode(data: bytes, sink=None, *, device="cuda",
              impl: str = "fused",
              manifest: GopManifest | None = None,
              process_id: int = 0, process_count: int = 1,
              n_parse_threads: int | None = None,
              quirk_oddify_zeros: bool = False,
              metrics: Metrics | None = None,
              probe_expand: bool = False) -> TranscodeResult:
    """Decode every (assigned, pending) GOP of ``data`` on ``device`` (a
    CUDA card unless the caller asks for ``"cpu"``).  The host parse runs
    in the C++ parser, built on first use; a failed build raises.

    ``sink(gop_index, frames)`` receives each GOP's decoded (Y, Cb, Cr[,
    A]) stacks, uint8 tensors on ``device``, new for each GOP; on the
    compact route it runs one GOP behind the dispatch, so a sink that
    copies to the host also waits for the next GOP's launches.  ``impl``
    is ``"fused"`` or ``"two_kernel"``.  With a ``manifest``, completed
    GOPs are journaled and skipped on resume; with ``process_count > 1``
    only this process's round-robin share is decoded.
    ``n_parse_threads``: 1 parses each GOP serially on the calling thread,
    nothing ahead; None cuts each GOP into tasks by its coded bytes on the
    process's parse pool; an int k does so with at most k tasks of the
    call in flight (:class:`~jsvx_torch.pipeline.parse_pool.Lane`).

    The call leaves its GOP programs in the process's cache for the next
    call (on a card about 55-76 MB each at 1080p, at most 8 programs);
    ``jsvx_torch.pipeline.program.CACHE.clear()`` frees them.

    ``probe_expand=True`` times, after the loop, the unflatten and
    expansion of the last compact GOP's device wire on its own (on a card
    one launch of the expansion kernel, ``csrc/expand.cu``; each run ending
    in a synchronise; the best of 3 after a first run) as the gauge
    ``expand_probe_s_per_gop``: inside the loop the expansion and the
    decode run back to back on the device.  The probe's launches add to
    the expansion kernel's count.
    """
    frame_decoder(impl)                  # reject an unknown impl early
    device = torch.device(device)
    kw = dict(device=device, impl=impl, manifest=manifest,
              process_id=process_id, process_count=process_count,
              n_parse_threads=n_parse_threads,
              metrics=metrics or Metrics())
    # the compact wire cannot express the oddify-zeros quirk (it oddifies
    # positions the compact wire elides by design)
    route = "dense" if quirk_oddify_zeros else "compact"
    with span("transcode", call=next(_CALLS), route=route) as s:
        if quirk_oddify_zeros:
            res = _transcode_packed(data, sink, **kw)
        else:
            res = _transcode_compact(data, sink, probe_expand=probe_expand,
                                     **kw)
        s.set(gops=res.n_gops)
    return res


class _Run:
    """What the two routes share: the header walk, the GOPs to do, the
    pool, the copies, the GOP programs, the dispatch and the delivery.
    ``quirk`` is the route's: the dense quirk route, or the compact route
    with its dense fallback."""

    def __init__(self, data: bytes, sink, *, device: torch.device,
                 impl: str, manifest: GopManifest | None, process_id: int,
                 process_count: int, n_parse_threads: int | None,
                 metrics: Metrics, quirk: bool):
        self.arr = np.frombuffer(bytes(data), dtype=np.uint8)
        self.sink, self.device, self.impl = sink, device, impl
        self.manifest, self.metrics, self.quirk = manifest, metrics, quirk
        self.lane = Lane(n_parse_threads)
        self.queued = None               # (GOP, its parse) queued ahead
        with metrics.timers.stage("parse"), span("walk") as walk:
            self.meta, self.seqs, self.groups = walk_stream_seqs(data)
            if recording():
                walk.set(gops=len(self.groups),
                         pictures=sum(map(len, self.groups)))
        with span("call_setup"):
            # each GOP decodes with the matrices of its own sequence
            # header: one constants set per distinct pair of matrices
            self.consts = constants_per_seq(self.seqs, device)
            if manifest is None:
                self.todo = list(range(len(self.groups)))
            else:
                self.todo = [s.index for s in
                             manifest.pending(process_id, process_count)
                             if s.index < len(self.groups)]
            if device.type == "cuda":
                # each basis's one copy from the card, before GOP 0: a key
                # first seen later runs its eager loop without a sync
                for gi in self.todo:
                    self.consts[gi].c_basis_host
            self.pool = BufferPool(pin=device.type == "cuda")
            self.copier = WireCopier(device)
            self.programs = ProgramSet(CACHE)
        self.n_frames = 0
        self.wire_total = 0

    def start_compact(self, gi: int):
        return start_gop_compact(self.arr, self.groups[gi], self.seqs[gi],
                                 self.meta, self.pool, self.lane)

    def start_dense(self, gi: int):
        return start_gop_packed(self.arr, self.groups[gi], self.seqs[gi],
                                self.meta, self.pool, self.lane)

    def take(self, i: int, start) -> tuple:
        """(the parse by ``start`` of GOP ``todo[i]``, whether it was
        queued before the previous GOP was packed).  It is queued now
        unless it was queued ahead; on a pooled lane the next GOP's parse
        is then queued behind it, before the caller waits on this one:
        one GOP ahead, so the parses' pooled buffers stay bounded at two
        GOPs."""
        gi = self.todo[i]
        if self.queued is not None and self.queued[0] == gi:
            started, early = self.queued[1], True
        else:
            started, early = start(gi), False
        self.queued = None
        if i + 1 < len(self.todo) and not self.lane.serial:
            nxt = self.todo[i + 1]
            self.queued = (nxt, start(nxt))
        return started, early

    def parse_dense(self, gi: int, started):
        return parse_gop_packed(self.arr, self.groups[gi], self.seqs[gi],
                                self.meta, self.pool, index=gi,
                                started=started)

    def upload(self, stacked: dict, gi: int, n_frames: int, pooled: list,
               compact: bool) -> Upload:
        """Pack ``stacked`` into one pooled wire and start its copy into
        the static wire of its layout's GOP program.  The parse's
        ``pooled`` buffers go back to the pool once packed."""
        spec, buf = pack(stacked, self.pool)
        for b in pooled:
            self.pool.release(b)
        seq, consts = self.seqs[gi], self.consts[gi]
        key = program_key(spec, seq.mb_height, seq.mb_width,
                          self.meta.n_components, self.impl, self.quirk,
                          consts, self.device)
        program = self.programs.get(key, lambda: GopProgram(key, consts))
        wire, copied = self.copier.copy(self.pool.host_tensor(buf),
                                        *program.load())
        self.wire_total += buf.nbytes
        return Upload(index=gi, n_frames=n_frames, compact=compact,
                      spec=spec, wire=wire, pooled=[buf],
                      copied=copied, program=program)

    def release(self, up: Upload) -> None:
        for buf in up.pooled:
            self.pool.release(buf)
        up.pooled = []

    def dispatch(self, up: Upload) -> tuple:
        """Enqueue GOP ``up``'s decode; returns (its output planes, the
        event recorded after its device work; None on the CPU)."""
        with self.metrics.timers.stage("device_dispatch", gop=up.index):
            return up.program.run(up.copied, self.metrics)

    def deliver(self, up: Upload, outs: tuple) -> None:
        """Hand a complete GOP to the sink; count and journal it."""
        if self.sink is not None:
            with self.metrics.timers.stage("sink", gop=up.index):
                self.sink(up.index, outs)
        self.n_frames += up.n_frames
        self.metrics.count("frames", up.n_frames)
        self.metrics.count("gops")
        if self.manifest is not None:
            self.manifest.mark_done(up.index, frames=up.n_frames)

    def close(self) -> None:
        """Wait out a parse still queued (a call that failed ends after
        its tasks) and give the call's GOP programs back to the cache."""
        with span("call_close"):
            if self.queued is not None:
                self.queued[1].batch.join()
                self.queued = None
            self.programs.close()

    def result(self) -> TranscodeResult:
        m = self.metrics
        m.gauge("width", self.meta.width)
        m.gauge("height", self.meta.height)
        m.gauge("wire_bytes", self.wire_total)
        m.count("parse_threads_started", self.lane.threads_started)
        return TranscodeResult(n_frames=self.n_frames, n_gops=len(self.todo),
                               metrics=m, width=self.meta.width,
                               height=self.meta.height)


def _transcode_compact(data: bytes, sink, *, probe_expand: bool = False,
                       **kw) -> TranscodeResult:
    """The compact wire, pipelined: parse(g+1) overlaps GOP g's upload
    tail and decode, and GOP g-1 is delivered after GOP g is dispatched.
    GOPs whose streams emit blocks out of order fall back to the dense
    wire per GOP (uploaded the same way, waited for by the device only)."""
    run = _Run(data, sink, quirk=False, **kw)
    try:
        _compact_loop(run, probe_expand)
    finally:
        run.close()
    return run.result()


def _compact_loop(run: _Run, probe_expand: bool) -> None:
    metrics = run.metrics
    buckets: dict = {}                   # sticky per-component buckets

    def parse_one(i: int) -> Upload:
        gi = run.todo[i]
        with metrics.timers.stage("parse", gop=gi, wire="compact") as s:
            started, early = run.take(i, run.start_compact)
            s.set(tasks=started.batch.tasks, ahead=early)
            g = parse_gop_compact(run.arr, run.groups[gi], run.seqs[gi],
                                  run.meta, run.pool, buckets, index=gi,
                                  started=started)
            if not g.dirty:
                return run.upload(g.stacked, gi, len(g.hdrs), g.pooled,
                                  compact=True)
            for buf in g.pooled:
                run.pool.release(buf)
            # the dense fallback, in order: the next GOP's compact parse
            # stays queued behind it
            started = run.start_dense(gi)
            s.set(wire="dense", tasks=started.batch.tasks, ahead=False)
            g = run.parse_dense(gi, started)
            return run.upload(g.stacked, gi, len(g.fts), g.pooled,
                              compact=False)

    def flush(pending) -> None:
        """Complete and deliver a dispatched GOP (one GOP behind the
        dispatch, so its delivery overlaps the next GOP's device work)."""
        up, outs, decoded = pending
        with metrics.timers.stage("device_wait", gop=up.index):
            wait(decoded)
        run.release(up)                  # dense fallback: freed here
        run.deliver(up, outs)

    todo = run.todo
    last = None
    pending = None
    nxt = parse_one(0) if todo else None
    for i, gi in enumerate(todo):
        up = nxt
        if up.compact:
            last = up
            # whatever is left of the upload here is its un-overlapped
            # tail; once it is done the pooled host buffers are free for
            # the next parse (released one GOP later, every parse would
            # allocate fresh multi-MB buffers)
            with metrics.timers.stage("wire_wait", gop=up.index):
                wait(up.copied)
            run.release(up)
        outs, decoded = run.dispatch(up)
        nxt = parse_one(i + 1) if i + 1 < len(todo) else None
        if pending is not None:
            flush(pending)
        pending = (up, outs, decoded)
    if pending is not None:
        flush(pending)

    if probe_expand and last is not None:
        _probe_expand(run, last)


def _probe_expand(run: _Run, up: Upload) -> None:
    """Unflatten + expansion of ``up``'s device wire alone (the expansion
    kernel's launch on a card, its plain version on the CPU): a first run
    (stage ``expand_probe_compile``), then the best of 3, each ending in a
    synchronise, as the gauge ``expand_probe_s_per_gop``: the host's
    unflatten and launch plus the kernel's device time."""
    seq = run.seqs[up.index]

    def expand() -> None:
        expand_compact_gop(unflatten_wire(up.wire, up.spec), seq.mb_height,
                           seq.mb_width)
        synchronize(run.device)

    with run.metrics.timers.stage("expand_probe_compile"):
        expand()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        expand()
        best = min(best, time.perf_counter() - t0)
    run.metrics.gauge("expand_probe_s_per_gop", best)


def _transcode_packed(data: bytes, sink, **kw) -> TranscodeResult:
    """The dense wire for every GOP (the oddify-zeros quirk's route): while
    the device decodes GOP g the host parses GOP g+1; GOP g is then waited
    for, its buffers recycled and delivered before GOP g+1 is dispatched."""
    run = _Run(data, sink, quirk=True, **kw)
    try:
        _packed_loop(run)
    finally:
        run.close()
    return run.result()


def _packed_loop(run: _Run) -> None:
    metrics = run.metrics

    def parse_one(i: int) -> Upload:
        gi = run.todo[i]
        with metrics.timers.stage("parse", gop=gi, wire="dense") as s:
            started, early = run.take(i, run.start_dense)
            s.set(tasks=started.batch.tasks, ahead=early)
            g = run.parse_dense(gi, started)
            return run.upload(g.stacked, gi, len(g.fts), g.pooled,
                              compact=False)

    todo = run.todo
    nxt = parse_one(0) if todo else None
    for i, gi in enumerate(todo):
        up = nxt
        outs, decoded = run.dispatch(up)
        # overlap: the host parses the next GOP while the device decodes
        nxt = parse_one(i + 1) if i + 1 < len(todo) else None
        with metrics.timers.stage("device_wait", gop=up.index):
            wait(decoded)
        run.release(up)
        run.deliver(up, outs)
