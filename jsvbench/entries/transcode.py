"""The ``transcode`` entry: ``jsvx_torch.transcode`` over whole streams.

Each unit is one call on a whole segment, bytes in host memory to
planes on the card; the sink keeps each GOP's planes on the card (an
on-card consumer: a re-encoder, an ML pipeline) and drops them, except a
seeded sample of GOPs kept for the check.  The sink's clock gives the
segment's start stall (from the call's start to its first GOP) apart from
the gaps between its later GOPs.  Set-up is one call on a short stream of
the seed's GOPs, which builds or loads the kernels and the parser,
captures the GOP program of each wire layout and replays it.

Workload keys: ``impl`` (``fused`` or ``two_kernel``), ``sample_gops``.
"""

from __future__ import annotations

import time

import torch

from jsvbench.units import Clock, Sampler, add_stages, p95_ms
from jsvx_torch import transcode
from jsvx_torch.pipeline import program
from jsvx_torch.runtime.profiler import Metrics


class Entry:
    def __init__(self, workload: dict, config: dict, device, window,
                 seed: int):
        self.impl = workload["impl"]
        self.device = torch.device(device)
        self.window = window
        self.sampler = Sampler(seed, int(workload["sample_gops"]))
        self.gop_size = int(config["gop_size"])
        self.gops = int(workload["gops_per_stream"])
        self.clock = Clock()
        self.totals = {"stages": {}, "counters": {}}
        self.frames = self.delivered = self.calls = self.missing = 0
        self.sink_s = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def set_up(self, data: bytes, warm: bytes) -> None:
        self.data = data
        transcode(warm, None, device=self.device, impl=self.impl)
        self._sync()

    def _sink(self, gop_index: int, planes) -> None:
        with self.window.span("sink"):
            self.clock.tick()
            self.sampler.offer(gop_index, planes)
            self.delivered += 1

    def measure(self, seconds: float) -> float:
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            metrics = Metrics()
            self.clock.start()
            with self.window.span("transcode"):
                res = transcode(self.data, self._sink, device=self.device,
                                impl=self.impl, metrics=metrics)
            add_stages(self.totals, metrics)
            self.calls += 1
            self.frames += res.n_frames
            self.missing += self.gops * self.gop_size - res.n_frames
            if time.perf_counter() >= end:
                break
        self._sync()                    # the last GOP's decode done
        return time.perf_counter() - t0

    # -- after the window ------------------------------------------------

    @property
    def stages(self) -> dict:
        return self.totals["stages"]

    @property
    def counters(self) -> dict:
        return self.totals["counters"]

    @property
    def units(self) -> dict:
        return dict(calls=self.calls, gops=self.delivered,
                    frames=self.frames, pictures=self.frames)

    @property
    def attempted(self) -> int:
        return self.calls * self.gops

    @property
    def failed(self) -> int:
        return self.attempted - self.delivered

    def end_to_end(self, window_s: float) -> dict:
        return dict(transcode_fps=self.frames / window_s,
                    gop_gap_p95_ms=p95_ms(self.clock.gaps),
                    segment_start_p95_ms=p95_ms(self.clock.firsts))

    def samples(self) -> list:
        """The sampled GOPs, planes copied to the host."""
        return [(g, tuple(p.cpu().numpy() for p in planes[:3]))
                for g, planes in self.sampler.kept]


    def close(self) -> None:
        self.sampler.kept = []
        self.data = None
        program.CACHE.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
