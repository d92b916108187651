"""What the entry points share: the sink's clock, the seeded sample of
outputs kept for the check, the program's stage sums, percentiles."""

from __future__ import annotations

import random
import time

import numpy as np


def p95_ms(gaps: list) -> float:
    return float(np.percentile(np.asarray(gaps), 95)) * 1e3


class Sampler:
    """A seeded uniform sample of ``k`` of the units a window delivers
    (reservoir sampling): the same seed and count keep the same units."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed)
        self.k = k
        self.seen = 0
        self.kept: list = []

    def offer(self, key, value) -> None:
        if len(self.kept) < self.k:
            self.kept.append((key, value))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = (key, value)
        self.seen += 1


def add_stages(total: dict, metrics) -> None:
    """Add a ``Metrics``' stage seconds and counters to ``total``."""
    for name, s in metrics.timers.totals.items():
        total["stages"][name] = total["stages"].get(name, 0.0) + s
    for name, n in metrics.counters.items():
        total["counters"][name] = total["counters"].get(name, 0) + n


class Clock:
    """The times between consecutive deliveries at the sink: from
    :meth:`start` (a unit's start) to its first delivery in ``firsts``,
    every later one in ``gaps``."""

    def __init__(self):
        self.last = None
        self.fresh = False
        self.gaps: list = []
        self.firsts: list = []

    def start(self) -> None:
        self.last = time.perf_counter()
        self.fresh = True

    def tick(self) -> None:
        now = time.perf_counter()
        (self.firsts if self.fresh else self.gaps).append(now - self.last)
        self.last, self.fresh = now, False
