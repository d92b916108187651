"""The ``play`` entry: the port's ``Player`` with RGB output.

Each unit is one playback of the whole stream: a new ``Player`` with the
workload's ``PlayerConfig`` (``emit_rgb``), the stream set as ``src`` in
memory, ``play()``, and the virtual clock advanced one picture period a
tick, as fast as the host goes, to ``ended``.  The sink copies each RGB
frame (the display crop) to host memory; a seeded sample of frames is
kept for the check.  Set-up is one playback of a short stream of the
seed's GOPs, which builds or loads the kernels and the parser and
captures the programs of the Decoder's groups.

Workload keys: ``player`` (``PlayerConfig`` fields), ``sample_frames``.
"""

from __future__ import annotations

import time

import torch

from jsvbench.units import Clock, Sampler, add_stages, p95_ms
from jsvx_torch.api import Player, PlayerConfig
from jsvx_torch.pipeline import program


class Entry:
    def __init__(self, workload: dict, config: dict, device, window,
                 seed: int):
        self.device = torch.device(device)
        self.window = window
        self.player_config = dict(workload["player"], emit_rgb=True)
        self.sampler = Sampler(seed, int(workload["sample_frames"]))
        self.gop_size = int(config["gop_size"])
        self.n_frames = self.gop_size * int(workload["gops_per_stream"])
        self.period = 1.0 / float(config["frame_rate_hz"])
        self.display = (int(config["height"]), int(config["width"]))
        self.clock = Clock()
        self.totals = {"stages": {}, "counters": {}}
        self.shown = self.playbacks = self.missing = 0
        self.copy_s = 0.0
        self.index = 0
        self.keep = False

    def _sink(self, rgb, t: float) -> None:
        with self.window.span("sink"):
            t0 = time.perf_counter()
            host = rgb.cpu()
            self.copy_s += time.perf_counter() - t0
            if self.keep:
                self.clock.tick()
                self.sampler.offer(self.index, host)
            self.index += 1

    def _playback(self, data: bytes, n_frames: int) -> int:
        p = Player(PlayerConfig(**self.player_config), device=self.device)
        p.set_frame_sink(self._sink)
        self.index = 0
        p.src = data
        p.play()
        t, limit = 0.0, n_frames * self.period + 60.0
        while not p.ended and t < limit:
            t += self.period
            with self.window.span("tick"):
                p.tick(t)
        add_stages(self.totals, p.decoder.metrics)
        return self.index

    def set_up(self, data: bytes, warm: bytes) -> None:
        self.data = data
        self._playback(warm, self.n_frames)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.copy_s = 0.0

    def measure(self, seconds: float) -> float:
        self.totals = {"stages": {}, "counters": {}}
        self.keep = True
        t0 = time.perf_counter()
        self.clock.start()
        end = t0 + seconds
        while True:
            shown = self._playback(self.data, self.n_frames)
            self.playbacks += 1
            self.shown += shown
            self.missing += self.n_frames - shown
            if time.perf_counter() >= end:
                break
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
        return dict(playbacks=self.playbacks, frames=self.shown)

    @property
    def sink_s(self) -> dict:
        return dict(rgb_copy=self.copy_s)

    @property
    def attempted(self) -> int:
        return self.playbacks * self.n_frames

    @property
    def failed(self) -> int:
        return self.attempted - self.shown

    def end_to_end(self, window_s: float) -> dict:
        return dict(play_fps=self.shown / window_s,
                    frame_gap_p95_ms=p95_ms(self.clock.firsts
                                            + self.clock.gaps))

    def samples(self) -> list:
        return [(k, (rgb.numpy(),)) for k, rgb in self.sampler.kept]


    def close(self) -> None:
        self.data = None
        program.CACHE.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
