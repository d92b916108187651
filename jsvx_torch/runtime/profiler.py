"""Tracing / profiling / metrics subsystem (the port's copy of
``jsvx/runtime/profiler.py``, its device trace on ``torch.profiler``).

The reference has only console logging and ad-hoc frame-lateness counters
(SURVEY.md section 5).  This is the first-class replacement:

* :class:`StageTimer` — per-stage wall-clock accounting (parse, H2D,
  device decode, color, sink) with EMA rates;
* :class:`FpsMeter`   — sliding-window frames/s;
* :func:`device_trace` — context manager around ``torch.profiler`` that
  writes a Chrome trace (host ops and, on a CUDA card, the kernels);
* :class:`Metrics`    — counter/gauge registry that serialises to one
  JSON line (the shape a benchmark consumes).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

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
    exit the Chrome trace is written to ``log_dir/trace.json``."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
