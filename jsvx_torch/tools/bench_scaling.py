"""Multi-process scaling-efficiency bench.

The port of ``jsvx/tools/bench_scaling.py``.  Measures wall-clock
frames/s of the SAME stream decoded by 1 process vs N processes, each
taking its round-robin GOP share through
:class:`jsvx_torch.runtime.multihost.GopManifest` and decoding it with
:func:`jsvx_torch.transcode` on ``--device`` (the card unless ``--device
cpu``) — the protocol a multi-host deployment runs (GOPs across hosts, no
tensor traffic between them).  Efficiency = t(1 proc) / (N * max_i t(proc
i)).  Each process decodes its share once to warm up (kernel and parser
libraries loaded, pages faulted) and reports the best of three runs.

Run: ``python -m jsvx_torch.tools.bench_scaling [n_procs] [stream.jsv]
[--device cuda]``.  Without a stream it takes the cached 1080p fixture
(``jsvx_torch.tools.fixture``) when present, else a CIF stream it encodes
once under ``build/jsvx_torch/``.

Note on shared boxes: each process models one HOST; on a single machine
the processes contend for the same cores and device, so the reported
efficiency is a LOWER bound on real multi-host scaling (where the
per-host parse and device work are physically private).  The pinned
variant (``taskset``, one core per process on both sides) isolates the
manifest protocol's overhead from core contention.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from .fixture import CACHE_DIR, fixture_path

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_WORKER = r"""
import json, sys, time
data = open(sys.argv[1], "rb").read()
pid, pcount, device = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
from jsvx_torch.pipeline.transcode import transcode
from jsvx_torch.runtime.multihost import GopManifest

def run():
    m = GopManifest.from_stream(data)
    return transcode(data, manifest=m, process_id=pid,
                     process_count=pcount, device=device)

res = run()                      # warm: libraries loaded, pages faulted
best = float("inf")
for _ in range(3):
    t0 = time.perf_counter()
    res = run()
    best = min(best, time.perf_counter() - t0)
print(json.dumps({"pid": pid, "frames": res.n_frames,
                  "seconds": round(best, 4)}))
"""


def _make_stream(path: str) -> None:
    from .encoder import EncoderConfig, JsvEncoder

    h, w = 288, 352
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(24):
        y = np.clip(110 + 70 * np.sin(2 * np.pi * (xx + 5 * t) / w)
                    + 30 * np.cos(2 * np.pi * (yy + 3 * t) / 64)
                    + rng.normal(0, 6, (h, w)), 0, 255)
        cb = np.clip(128 + 30 * np.sin(2 * np.pi * xx[::2, ::2] / w), 0, 255)
        cr = np.clip(128 + 30 * np.cos(2 * np.pi * yy[::2, ::2] / h), 0, 255)
        frames.append(tuple(p.astype(np.uint8) for p in (y, cb, cr)))
    data = JsvEncoder(w, h, EncoderConfig(
        gop_size=4, quantizer_scale=6, me_range=3)).encode(frames)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _run_procs(stream: str, n: int, device: str, pin: bool = False,
               timeout_s: float = 600.0) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    ncores = os.cpu_count() or 1
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in range(n):
            cmd = [sys.executable, "-c", _WORKER, stream, str(pid), str(n),
                   device]
            if pin:
                cmd = ["taskset", "-c", str(pid % ncores)] + cmd
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=env, text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, t0 + timeout_s - time.perf_counter()))
            if p.returncode != 0:
                raise RuntimeError(f"scaling worker exited {p.returncode}:"
                                   f"\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    results = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    return {
        "n_procs": n,
        "per_proc": results,
        "max_proc_seconds": max(r["seconds"] for r in results),
        "total_frames": sum(r["frames"] for r in results),
        "launch_wall_seconds": round(wall, 2),
    }


def report(stream: str, n: int = 2, device: str = "cuda") -> dict:
    """The scaling report of ``n`` processes against one on ``stream``,
    with shared and with private (pinned) cores."""
    one = _run_procs(stream, 1, device)
    many = _run_procs(stream, n, device)
    eff = one["max_proc_seconds"] / (n * many["max_proc_seconds"])
    one_p = _run_procs(stream, 1, device, pin=True)
    many_p = _run_procs(stream, n, device, pin=True)
    eff_p = one_p["max_proc_seconds"] / (n * many_p["max_proc_seconds"])
    frames = one["total_frames"]
    return {
        "metric": "multiprocess_scaling_efficiency",
        "stream": stream,
        "device": device,
        "frames": frames,
        "one_proc_seconds": one["max_proc_seconds"],
        f"{n}_proc_max_seconds": many["max_proc_seconds"],
        "one_proc_frames_per_s": frames / one["max_proc_seconds"],
        f"{n}_proc_frames_per_s": frames / many["max_proc_seconds"],
        "efficiency_shared_cores": round(eff, 3),
        "one_proc_1core_seconds": one_p["max_proc_seconds"],
        f"{n}_proc_1core_each_max_seconds": many_p["max_proc_seconds"],
        "efficiency_private_cores": round(eff_p, 3),
        "host_cores": os.cpu_count(),
        "note": ("private-cores efficiency models multi-host scaling "
                 "(each host has its own cores/chip); shared is the "
                 "same-box lower bound"),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m jsvx_torch.tools."
                                      "bench_scaling")
    ap.add_argument("n_procs", nargs="?", type=int, default=2)
    ap.add_argument("stream", nargs="?")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    stream = a.stream
    if stream is None:
        stream = fixture_path()
        if not os.path.exists(stream):
            stream = os.path.join(CACHE_DIR, "scaling_cif.jsv")
            if not os.path.exists(stream):
                _make_stream(stream)
    print(json.dumps(report(stream, a.n_procs, a.device)))


if __name__ == "__main__":
    main()
