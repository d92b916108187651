"""The GOP program: one captured CUDA graph per wire layout, replayed once
per GOP.

The port's counterpart of the programs jsvx compiles per static key:
``jsvx/pipeline/gop.py``'s ``decode_gop_scan_wire`` and
``decode_gop_scan`` (behind ``transcode``, ``StreamDecoder`` and the
Decoder's GOP batch), the per-picture ``decode_frame_jit`` (the
picture-at-a-time paths) and ``jsvx/shard/gop_parallel.py``'s jitted
``run`` are each a ``jax.jit`` with the wire layout, the picture size and
the route static, compiled on the first sight of a key, cached, and
dispatched with one host call per GOP.  Here a :class:`GopProgram` holds,
for one key:

* a static device wire of the layout's ``spec[1]`` bytes, allocated
  outside the graph so its address is fixed: each GOP's upload copies
  into it;
* with ``refs_in`` (``decode_group``: the reference planes carried from
  the GOP or picture before, which jsvx traces as ``init_refs``), static
  reference slots beside it, which the caller copies its planes into;
  otherwise the body starts from zero planes it makes itself;
* a ``torch.cuda.CUDAGraph`` of :meth:`GopProgram.body`, the eager GOP
  loop: the wire's unflatten, the compact wire's expansion (one launch of
  ``csrc/expand.cu``), the reference planes, and the frame loop of
  :func:`jsvx_torch.pipeline.gop.decode_gop_wire` through the kernels'
  wrappers (with ``gops``, :func:`~jsvx_torch.pipeline.gop.
  decode_gop_batch` over the GOPs stacked on the wire), writing output
  stacks that live in the graph's memory pool.

On a card, on the first sight of a key the body runs eagerly on the real
wire (its planes are that GOP's result, and the run loads every kernel's
module), then it is captured; each later GOP of the key replays the graph
and copies the static outputs into new stacks, which the caller owns (the
next GOP's reference planes are views of those copies, never of the
graph's outputs, which the next replay overwrites).  A capture or a
replay that fails raises: nothing runs the eager loop in its place.
Captures take a process lock (one capture at a time, as
``torch.cuda.graphs`` requires) and run in ``thread_local`` mode, so
another thread's CUDA calls cannot break them.  On the CPU a program has
no graph: every GOP runs the body, which allocates its outputs.

The key (:func:`program_key`) is what jsvx's jit keeps static: the layout
(``spec``, and with it the frame count and, stacked, the GOP count),
``mb_h``, ``mb_w``, the number of planes, ``impl``, the oddify-zeros
quirk, the device, whether the references come in (``refs_in``) and the
GOPs stacked (``gops``); plus the quant matrices, which jsvx traces as
data but which the kernels here take as launch arguments, so a graph
holds them.  A dense picture's layout depends only on the picture size,
the plane count and whether the parser emitted ``mult``/``flags``, so
every picture of a stream decodes through one one-picture program.

While a torch profiler records, :meth:`GopProgram.run` logs a span
``capture`` (a key's first sight: its eager run and its capture), or
``replay`` (the host's ``graph.replay()`` call) and ``copy_out`` (the
output stacks' copies), each with the key's id (``GopProgram.key_id``,
from the key's hash); the cache logs an event ``checkout`` (a hit, or a
build) and ``evict`` (a program closed on check-in) to the span log of
:mod:`jsvx_torch.runtime.profiler`.

The kernels' launch counters (:mod:`jsvx_torch.kernels.counters`) are
Python integers, which a replay does not move.  A program records, at its
capture, how far the capture moved each counter (then takes that back:
nothing ran), and adds it at each replay, so a count still says how many
times each kernel ran.

:data:`CACHE` is process-wide and LRU by key, at most ``MAX_PROGRAMS``
programs.  A call checks its programs out for its duration
(:class:`ProgramSet`), so two concurrent calls never share a static
buffer: a call that finds its key checked out builds a second instance.
A program holds its wire, its slots and its graph's pool
(``held_bytes``): for a 4-frame 1080p GOP on the compact wire, 6.6 MB of
wire and, as the card's allocator reserves it during the capture, 48 MB
of pool on the fused route (25 MB of expanded levels, 12.5 MB of output
stacks, 3 MB of zero planes, in whole segments) and 69 MB on the
two-kernel route (a picture's int16 prediction more); so a full cache of
1080p programs holds about 0.6 GB (measured in PR 9 on an NVIDIA H100
80GB HBM3 at 700 W).  The dense programs of ``decode_group`` and
``decode_gops_parallel`` hold more (README).  That memory stays held after the calls return, as long as the
process lives; ``CACHE.clear()`` closes the idle programs and gives it
back to the caching allocator (``torch.cuda.empty_cache()`` then returns
it to the card).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import NamedTuple

import torch

from ..kernels import counters
from ..kernels.decode import DecodeConstants
from ..runtime.profiler import event, span
from .gop import decode_gop_batch, decode_gop_wire, zero_refs
from .wire import unflatten_wire

#: the most programs the process cache keeps (checked out and idle)
MAX_PROGRAMS = 8

#: one capture at a time in the process; the counters move under it
_LOCK = threading.Lock()


def _record(device: torch.device):
    """An event after everything enqueued so far on ``device``'s current
    stream (None on the CPU, where each call has returned its work)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class ProgramKey(NamedTuple):
    spec: tuple
    mb_h: int
    mb_w: int
    n_comps: int
    impl: str
    quirk: bool
    quant: tuple                 # intra + non-intra matrices, spatial order
    device: str
    refs_in: bool = False        # reference planes from the caller's slots
    gops: int = 0                # GOPs stacked on the wire (0: one GOP)


def program_key(spec: tuple, mb_h: int, mb_w: int, n_comps: int, impl: str,
                quirk: bool, consts: DecodeConstants, device, *,
                refs_in: bool = False, gops: int = 0) -> ProgramKey:
    """The key of the program that decodes a GOP of wire layout ``spec``:
    from zero reference planes, or with ``refs_in`` from the reference
    planes the caller copies into the program's slots; with ``gops`` the
    wire holds that many GOPs on a leading axis, each decoded from those
    reference planes."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return ProgramKey(spec, mb_h, mb_w, n_comps, impl, bool(quirk),
                      consts.quant_key,
                      str(device), bool(refs_in), int(gops))


def copy_in(pairs, after) -> None:
    """Copy each (static buffer, source) pair on the current stream, once
    the device has passed ``after`` (a program's "consumed" event; None
    before its first run and on the CPU).  A source on the host is a
    pageable buffer: the host waits for its copy."""
    for dst, src in pairs:
        if dst.shape != src.shape:
            raise ValueError(f"a source of shape {tuple(src.shape)} for a "
                             f"static buffer of {tuple(dst.shape)}")
    if after is not None:
        torch.cuda.current_stream(pairs[0][0].device).wait_event(after)
    for dst, src in pairs:
        dst.copy_(src)


class GopProgram:
    """The decode of one key's GOPs: a static wire and, on a card after
    the first run, the graph of :meth:`body`.  ``consts`` are the
    constants of the call that builds it (any call of the key has the same
    matrices)."""

    def __init__(self, key: ProgramKey, consts: DecodeConstants):
        self.key = key
        self.key_id = hash(key) & 0xffffffff    # its id in the span log
        self.consts = consts
        self.device = torch.device(key.device)
        self.wire = torch.empty(key.spec[1], dtype=torch.uint8,
                                device=self.device)
        # the reference slots the caller copies its planes into
        self.slots = (zero_refs(16 * key.mb_h, 16 * key.mb_w, key.n_comps,
                                self.device) if key.refs_in else None)
        self.graph = None
        self.outs = None             # the graph's output stacks
        self.launches = None         # counter moves per replay, by name
        self.consumed = None         # event after the last read of the
        #                              wire and of the output stacks
        self.loaded = False          # the wire holds a GOP not yet run
        self.capture_s = 0.0
        self.pool_bytes = 0          # reserved by the capture

    @property
    def held_bytes(self) -> int:
        slots = sum(s.numel() for s in self.slots or ())
        return self.key.spec[1] + slots + self.pool_bytes

    def body(self) -> tuple:
        """The eager GOP loop on the static wire -> (Y, Cb, Cr[, A])
        stacks ((G, F, H, W) each with ``gops``): what the graph captures,
        and what the first sight runs.  The reference planes are the slots
        (``refs_in``), else zero planes made inside the body."""
        k = self.key
        refs = self.slots or zero_refs(16 * k.mb_h, 16 * k.mb_w, k.n_comps,
                                       self.device)
        if k.gops:
            return decode_gop_batch(unflatten_wire(self.wire, k.spec), refs,
                                    self.consts, k.quirk, k.impl)
        outs, _ = decode_gop_wire(self.wire, k.spec, refs, self.consts,
                                  k.mb_h, k.mb_w, k.quirk, k.impl)
        return outs

    def load(self) -> tuple:
        """The static wire to copy the next GOP into, and the event that
        copy must wait for on the device (None before the first run).  A
        ``refs_in`` program's reference planes go into :attr:`slots`,
        after the same event."""
        if self.loaded:
            raise RuntimeError("the program's wire holds a GOP not yet "
                               "decoded")
        self.loaded = True
        return self.wire, self.consumed

    def fill(self, wire: torch.Tensor, refs: tuple = ()) -> None:
        """:meth:`load` the next GOP from ``wire``, a packed host buffer of
        the key's layout, and ``refs``, the reference planes (``refs_in``
        only), by :func:`copy_in` on the current stream."""
        static, after = self.load()
        slots = self.slots or ()
        if len(refs) < len(slots):
            raise ValueError(f"{len(refs)} reference planes for "
                             f"{len(slots)} slots")
        copy_in(((static, wire),) + tuple(zip(slots, refs)), after)

    def run(self, copied, metrics) -> tuple:
        """Decode the loaded GOP -> (new output stacks, the event after
        this GOP's device work, None on the CPU).  On a card, on the
        current stream once ``copied`` (the upload's event, None for a
        copy on that stream) has passed: the first run is the body,
        eagerly, then its capture; after that one replay and a copy per
        plane stack.  On the CPU: the body.  The last picture of each
        stack is the next GOP's reference plane: a view of the stacks
        returned, never of the graph's own outputs, which the next replay
        overwrites."""
        if self.device.type != "cuda":
            outs = self.body()
        else:
            if copied is not None:
                torch.cuda.current_stream(self.device).wait_event(copied)
            if self.graph is None:
                with span("capture", key=self.key_id), _LOCK:
                    outs = self.body()
                    self._capture()
                metrics.count("gop_program.captures")
                metrics.gauge("gop_program.capture_s",
                              metrics.gauges.get("gop_program.capture_s",
                                                 0.0) + self.capture_s)
            else:
                with span("replay", key=self.key_id):
                    self.graph.replay()
                with _LOCK:
                    counters.add(self.launches)
                with span("copy_out", key=self.key_id):
                    outs = tuple(o.clone() for o in self.outs)
                metrics.count("gop_program.replays")
        self.consumed = _record(self.device)
        self.loaded = False
        return outs, self.consumed

    def _capture(self) -> None:
        """Capture :meth:`body` (under ``_LOCK``)."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.device)  # a graph is never captured
        #                                        on the default stream
        before = counters.snapshot()
        reserved = torch.cuda.memory_reserved(self.device)
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = self.body()
            finally:
                graph.capture_end()
        moved = {n: k - before[n] for n, k in counters.snapshot().items()}
        counters.add({n: -k for n, k in moved.items()})
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self.outs, self.launches = graph, outs, moved
        self.capture_s = time.perf_counter() - t0

    def close(self) -> None:
        """Free the program once the device is done with its buffers: a
        GOP uploaded and never run (a call that failed) is waited for with
        the whole device, otherwise the last run's event."""
        if self.device.type == "cuda":
            if self.loaded:
                torch.cuda.synchronize(self.device)
            elif self.consumed is not None:
                self.consumed.synchronize()
        self.graph = self.outs = self.wire = self.slots = None


class ProgramCache:
    """Programs by key, each checked out by one call at a time; at most
    ``capacity`` programs, the least recently used idle ones closed
    first."""

    def __init__(self, capacity: int = MAX_PROGRAMS):
        self.capacity = capacity
        self._idle: OrderedDict = OrderedDict()   # key -> [program]
        self._busy: list = []
        self._lock = threading.Lock()

    def checkout(self, key, build):
        """An idle program of ``key``, else ``build()``'s; the caller has
        it until :meth:`checkin`.  Each is an event ``checkout`` of the
        span log (the key's id, a hit or a build)."""
        with self._lock:
            idle = self._idle.get(key)
            if idle:
                prog = idle.pop()
                if not idle:
                    del self._idle[key]
                self._busy.append(prog)
                event("checkout", key=prog.key_id, hit=True)
                return prog
        prog = build()
        event("checkout", key=prog.key_id, hit=False)
        with self._lock:
            self._busy.append(prog)
        return prog

    def checkin(self, prog) -> None:
        """Give ``prog`` back.  One that still holds a GOP it never ran
        (its call failed) is closed; then idle programs are closed, least
        recently used first, while more than ``capacity`` are held: each
        closed one is an event ``evict`` of the span log (the key's id,
        the bytes it held)."""
        closing = []
        with self._lock:
            self._busy.remove(prog)
            if prog.loaded:
                closing.append(prog)
            else:
                self._idle.setdefault(prog.key, []).append(prog)
                self._idle.move_to_end(prog.key)
            while self._idle and len(self._busy) + sum(
                    map(len, self._idle.values())) > self.capacity:
                key, progs = next(iter(self._idle.items()))
                closing.append(progs.pop(0))
                if not progs:
                    del self._idle[key]
        for p in closing:
            event("evict", key=p.key_id, held_bytes=p.held_bytes)
            p.close()

    def clear(self) -> None:
        """Close every idle program (and so give back what it holds)."""
        with self._lock:
            closing = [p for progs in self._idle.values() for p in progs]
            self._idle.clear()
        for p in closing:
            p.close()

    def programs(self) -> list:
        """Every program held, checked out or idle."""
        with self._lock:
            return self._busy + [p for progs in self._idle.values()
                                 for p in progs]

    def held_bytes(self) -> int:
        return sum(p.held_bytes for p in self.programs())


#: the process's GOP programs
CACHE = ProgramCache()


class ProgramSet:
    """The programs of one call: a program per key, checked out of
    ``cache`` at the key's first GOP and back in by :meth:`close`."""

    def __init__(self, cache: ProgramCache):
        self.cache = cache
        self.held: dict = {}

    def get(self, key, build):
        if key not in self.held:
            self.held[key] = self.cache.checkout(key, build)
        return self.held[key]

    def close(self) -> None:
        held, self.held = self.held, {}
        for prog in held.values():
            self.cache.checkin(prog)
