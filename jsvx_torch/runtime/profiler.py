"""Tracing / profiling / metrics subsystem (the port's copy of
``jsvx/runtime/profiler.py``, its device trace on ``torch.profiler``).

The reference has only console logging and ad-hoc frame-lateness counters
(SURVEY.md section 5).  This is the first-class replacement:

* :class:`StageTimer` — per-stage wall-clock accounting (parse, H2D,
  device decode, color, sink) with EMA rates;
* :class:`FpsMeter`   — sliding-window frames/s;
* :func:`device_trace` — context manager around ``torch.profiler`` that
  writes a Chrome trace (host ops, the program's spans and, on a CUDA
  card, the kernels);
* :class:`Metrics`    — counter/gauge registry that serialises to one
  JSON line (the shape a benchmark consumes);
* :func:`span`, :func:`event`, :func:`spans` and :func:`recording` — the
  span log.

The span log holds timestamped host spans of the program: a name, its
start and end in Unix nanoseconds (``time.time_ns()``, the clock of
``torch.profiler``'s events, so a span lines up with the kernels and
copies of the same trace), the native id of its thread and its
attributes (a GOP's index, a program key's id, a call's id).  It records
only while a torch profiler is recording in the process (torch's own
flag, any thread): otherwise :func:`span` returns one shared no-op
context and :func:`event` returns, after one flag check.  The log is
process-wide, a ring of :data:`LOG_ENTRIES` preallocated slots: past
that the oldest entries drop first, and the drops are counted; an entry
leaves no object for the garbage collector to track.  Every
:meth:`StageTimer.stage` is also a span of the log under the stage's
name, with the attributes its call site gives; the other spans live in
the log alone, so no ``Metrics`` name changes.  Nothing here opens a
``torch.profiler.record_function`` range: such a range leaves a shadow
on the device's timeline and costs microseconds even with no profiler.
:func:`device_trace` merges the log's spans of its window into the
Chrome trace it writes, as complete host events on the trace's time
base, beside the profiler's own host ops.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field

from torch.autograd import profiler as _torch_profiler

#: the most entries the span log holds; past it the oldest drop first
LOG_ENTRIES = 1 << 17
#: the most attributes an entry keeps (a site's first ones)
MAX_ATTRS = 4


_THREAD = threading.local()


def _native_id() -> int:
    """The calling thread's native id, asked of the system once a thread
    (a system call, which costs microseconds on some hosts)."""
    try:
        return _THREAD.native_id
    except AttributeError:
        _THREAD.native_id = threading.get_native_id()
        return _THREAD.native_id


class SpanLog:
    """A bounded log of (name, start_ns, end_ns, thread id, attrs)
    entries; :func:`span` and :func:`event` write the process's
    :data:`LOG`.  It is a ring of slots, one list a field (an attribute's
    key and value each a field), made at the first add: an entry's place
    in the order of adds picks its slot, so an add takes no lock (the
    count's ``next`` is atomic) and keeps no container object (attributes
    are numbers and strings).  An entry thus leaves the garbage
    collector's count as it found it, and tracing does not hasten the
    collections of the program's own objects."""

    def __init__(self, capacity: int = LOG_ENTRIES):
        self.capacity = capacity
        self._added = itertools.count()
        self._slots = None
        self._lock = threading.Lock()

    def _make(self) -> tuple:
        with self._lock:
            if self._slots is None:
                n = self.capacity
                self._slots = ([-1] * n, [None] * n, [0] * n, [0] * n,
                               [0] * n, [0] * n,
                               [[None] * n for _ in range(2 * MAX_ATTRS)])
        return self._slots

    def add(self, name: str, start_ns: int, end_ns: int, attrs) -> None:
        seq, names, starts, ends, tids, n_kv, kv = \
            self._slots or self._make()
        n = next(self._added)
        i = n % self.capacity
        names[i], starts[i], ends[i], tids[i] = name, start_ns, end_ns, \
            _native_id()
        j = 0
        for key, value in attrs.items():
            if j == 2 * MAX_ATTRS:
                break
            kv[j][i], kv[j + 1][i] = key, value
            j += 2
        n_kv[i] = j
        seq[i] = n

    def window(self, start_ns: int, end_ns: int) -> tuple[list, int]:
        """The entries that lie inside [start_ns, end_ns] in the order they
        were added, and the drops: every entry added before the oldest
        kept one, or 0 when that one ended before ``start_ns`` (so did
        every entry dropped)."""
        if self._slots is None:
            return [], 0
        seq, names, starts, ends, tids, n_kv, kv = self._slots
        kept = sorted((n, i) for i, n in enumerate(seq) if n >= 0)
        got = [(names[i], starts[i], ends[i], tids[i],
                {kv[j][i]: kv[j + 1][i] for j in range(0, n_kv[i], 2)})
               for _, i in kept if start_ns <= starts[i] and ends[i] <= end_ns]
        if not kept or ends[kept[0][1]] < start_ns:
            return got, 0
        return got, kept[0][0]


#: the process's span log
LOG = SpanLog()


class _Span:
    __slots__ = ("name", "attrs", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        LOG.add(self.name, self.start, time.time_ns(), self.attrs)

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


def recording() -> bool:
    """Whether the span log takes entries now (a profiler records): for a
    site that would compute an attribute only for the log."""
    return _torch_profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A context that logs ``name`` from entry to exit with ``attrs``
    (more by ``.set(...)`` inside it) while a profiler is recording."""
    if not _torch_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def event(name: str, **attrs) -> None:
    """A zero-length entry, logged while a profiler is recording."""
    if _torch_profiler._is_profiler_enabled:
        now = time.time_ns()
        LOG.add(name, now, now, attrs)


def spans(start_ns: int, end_ns: int) -> tuple[list, int]:
    """The log's entries inside [start_ns, end_ns] (Unix ns), each (name,
    start_ns, end_ns, thread id, attrs), and the drops that may have
    fallen inside (see :meth:`SpanLog.window`)."""
    return LOG.window(start_ns, end_ns)


class _Stage:
    __slots__ = ("timer", "name", "span", "t0")

    def __init__(self, timer: "StageTimer", name: str, span):
        self.timer, self.name, self.span = timer, name, span

    def __enter__(self):
        s = self.span.__enter__()
        self.t0 = time.perf_counter()
        return s

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        self.timer.totals[self.name] += dt
        self.timer.counts[self.name] += 1
        self.span.__exit__(*exc)


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def stage(self, name: str, **attrs):
        """A context that times its body into ``name``'s total and count;
        while a profiler records, also a span of the log (what ``with``
        gives, for ``.set``)."""
        return _Stage(self, name, span(name, **attrs))

    def mean_ms(self, name: str) -> float:
        n = self.counts.get(name, 0)
        return 1e3 * self.totals[name] / n if n else 0.0

    def report(self) -> dict:
        return {
            name: {"total_s": round(self.totals[name], 4),
                   "count": self.counts[name],
                   "mean_ms": round(self.mean_ms(name), 3)}
            for name in sorted(self.totals)
        }


class FpsMeter:
    def __init__(self, window: int = 120):
        self._stamps: deque[float] = deque(maxlen=window)

    def tick(self) -> None:
        self._stamps.append(time.perf_counter())

    @property
    def fps(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0


#: the file :func:`device_trace` writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str | None, device=None):
    """A ``torch.profiler`` trace of the body when a log dir is given
    (no-op otherwise): CPU activity, and CUDA activity (every kernel the
    process launches, by symbol) when ``device`` is a CUDA device.  On
    exit the Chrome trace is written to ``log_dir/trace.json``, with the
    span log's entries of the body merged in (:func:`_merge_spans`)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    start = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _merge_spans(path, *spans(start, time.time_ns()))


def _merge_spans(path: str, entries: list, dropped: int) -> None:
    """Add ``entries`` of the span log to the Chrome trace at ``path`` on
    its own time base (``baseTimeNanoseconds``, microseconds from it):
    each span a complete ("X") event, each zero-length event an instant
    ("i"), on its thread's row of this process, category ``jsvx_torch``;
    ``dropped`` goes under the trace's key ``jsvx_torch_spans_dropped``."""
    with open(path) as f:
        trace = json.load(f)
    base, pid = trace.get("baseTimeNanoseconds", 0), os.getpid()
    for name, start, end, tid, attrs in entries:
        e = {"ph": "X", "cat": "jsvx_torch", "name": name, "pid": pid,
             "tid": tid, "ts": (start - base) / 1e3,
             "dur": (end - start) / 1e3, "args": attrs}
        if end == start:
            del e["dur"]
            e.update(ph="i", s="t")
        trace["traceEvents"].append(e)
    trace["jsvx_torch_spans_dropped"] = dropped
    with open(path, "w") as f:
        json.dump(trace, f)


@dataclass
class Metrics:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    gauges: dict = field(default_factory=dict)
    timers: StageTimer = field(default_factory=StageTimer)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def gauge(self, name: str, value) -> None:
        self.gauges[name] = value

    def to_dict(self) -> dict:
        return {"counters": dict(self.counters), "gauges": dict(self.gauges),
                "stages": self.timers.report()}

    def json_line(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)
