"""Host-parse throughput micro-bench: Python vs C++ back end (host only).

The port of ``jsvx/tools/bench_parse.py``: the serial picture parse with
each back end of :class:`jsvx_torch.bitstream.parser.StreamParser`, the
picture-parallel parse (:mod:`jsvx_torch.pipeline.parallel_parse`) and the
stacked dense parse (:func:`jsvx_torch.pipeline.packed_parse.
parse_stream_packed`, without jsvx's distinct-vector sideband), on a
synthetic 352x288 stream.

``--pool CLIP [CLIP ...]`` instead times ``transcode``'s host parse of
each clip per GOP (:func:`bench_pool`): its pictures cut into 1 to
CPUs tasks on the process's parse pool, each GOP's tasks queued a GOP
ahead, then waited for and packed into one wire; the serial parse
(``n_parse_threads=1``) and the byte rule (``parse_pool.TASK_BYTES``)
beside them.  One JSON line a clip.

Run: ``python -m jsvx_torch.tools.bench_parse [--pool CLIP ...]``
"""

from __future__ import annotations

import json
import time

import numpy as np


def make_stream(n_frames=24, h=288, w=352, gop=12, q=6):
    from .encoder import EncoderConfig, JsvEncoder

    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n_frames):
        y = np.clip(110 + 70 * np.sin(2 * np.pi * (xx + 5 * t) / w)
                    + 30 * np.cos(2 * np.pi * (yy + 3 * t) / 64)
                    + rng.normal(0, 6, (h, w)), 0, 255)
        cb = np.clip(128 + 30 * np.sin(2 * np.pi * (xx[::2, ::2]) / w),
                     0, 255)
        cr = np.clip(128 + 30 * np.cos(2 * np.pi * (yy[::2, ::2]) / h),
                     0, 255)
        frames.append((y.astype(np.uint8), cb.astype(np.uint8),
                       cr.astype(np.uint8)))
    return JsvEncoder(w, h, EncoderConfig(
        gop_size=gop, quantizer_scale=q, me_range=3)).encode(frames)


def bench(data: bytes, use_native: bool, reps: int = 1) -> dict:
    from ..bitstream.bitio import BitReader
    from ..bitstream.container import StartCodeIndex, parse_container_header
    from ..bitstream.parser import StreamParser
    from ..coding import tables as T

    t0 = time.perf_counter()
    n_pics = 0
    n_mb = 0
    for _ in range(reps):
        r = BitReader(data)
        parse_container_header(r)
        index = StartCodeIndex.scan(data)
        parser = StreamParser(use_native=use_native)
        while True:
            nxt = index.next_code(r.byte_pos)
            if nxt is None:
                break
            off, code = nxt
            r.seek_bits((off + 4) << 3)
            if code == T.START_SEQUENCE:
                parser.parse_sequence_header(r)
            elif code == T.START_GOP:
                parser.parse_gop_header(r)
            elif code == T.START_PICTURE:
                ft = parser.parse_picture(r, index, len(data))
                if ft is not None:
                    n_pics += 1
                    n_mb += parser.seq.mb_width * parser.seq.mb_height
    dt = time.perf_counter() - t0
    return dict(seconds=dt, pictures=n_pics, mb_per_s=n_mb / dt,
                pictures_per_s=n_pics / dt)


def bench_parallel(data: bytes, n_threads=None, reps: int = 3) -> float:
    from ..pipeline.parallel_parse import parse_stream_parallel

    t0 = time.perf_counter()
    for _ in range(reps):
        parsed = parse_stream_parallel(data, n_threads=n_threads)
    dt = (time.perf_counter() - t0) / reps
    return len(parsed.frames) / dt


def bench_packed(data: bytes, reps: int = 3, slice_threads: int = 1,
                 n_threads=None) -> float:
    """The dense stacked parse of every GOP, buffers recycled."""
    from ..pipeline.packed_parse import BufferPool, parse_stream_packed

    pool = BufferPool()
    parsed = parse_stream_packed(data, pool=pool,
                                 slice_threads=slice_threads,
                                 n_threads=n_threads)   # warm pool
    n = parsed.n_frames
    t0 = time.perf_counter()
    for _ in range(reps):
        for g in parse_stream_packed(data, pool=pool,
                                     slice_threads=slice_threads,
                                     n_threads=n_threads).gops:
            for buf in g.pooled:
                pool.release(buf)
    dt = (time.perf_counter() - t0) / reps
    return n / dt


def bench_pool(data: bytes, tasks: list, passes: int = 9) -> dict:
    """Milliseconds a GOP of ``transcode``'s host parse over every GOP of
    ``data`` (compact wire, no device), for each count in ``tasks`` (the
    tasks a GOP is cut into: ``parse_pool.TASK_BYTES`` set for the
    largest GOP), ``"serial"`` (a lane of one thread: no pool, nothing
    ahead) and ``"rule"`` (``TASK_BYTES`` as it stands); the median of
    ``passes`` passes, the settings in turns."""
    from ..pipeline import parse_pool
    from ..pipeline.packed_parse import (BufferPool, parse_gop_compact,
                                         start_gop_compact,
                                         walk_stream_seqs)
    from ..pipeline.transcode import pack

    arr = np.frombuffer(data, np.uint8)
    meta, seqs, groups = walk_stream_seqs(data)
    gop_bytes = max(sum(parse_pool.picture_bytes([b for _, b in g]))
                    for g in groups)
    pool = BufferPool()
    rule = parse_pool.TASK_BYTES

    def one_pass(setting) -> float:
        lane = parse_pool.Lane(1 if setting == "serial" else None)
        parse_pool.TASK_BYTES = (-(-gop_bytes // setting)
                                 if isinstance(setting, int) else rule)

        def start(gi):
            return start_gop_compact(arr, groups[gi], seqs[gi], meta, pool,
                                     lane)

        buckets: dict = {}
        t0 = time.perf_counter()
        queued = start(0)
        for gi in range(len(groups)):
            started = queued
            queued = start(gi + 1) if gi + 1 < len(groups) else None
            g = parse_gop_compact(arr, groups[gi], seqs[gi], meta, pool,
                                  buckets, index=gi, started=started)
            _, buf = pack(g.stacked, pool)
            for b in g.pooled + [buf]:
                pool.release(b)
        return 1e3 * (time.perf_counter() - t0) / len(groups)

    settings = ["serial", "rule"] + list(tasks)
    times = {str(k): [] for k in settings}
    try:
        for p in range(passes + 1):
            for k in settings[p % len(settings):] + \
                    settings[:p % len(settings)]:
                ms = one_pass(k)
                if p:                    # the first pass warms the pools
                    times[str(k)].append(ms)
    finally:
        parse_pool.TASK_BYTES = rule
    n = len(groups[0])
    return dict(gops=len(groups), pictures_per_gop=n, gop_bytes=gop_bytes,
                cpus=parse_pool.POOL.size(),
                rule_tasks=parse_pool.task_count(
                    gop_bytes, n, parse_pool.POOL.size()),
                ms_per_gop={k: float(np.median(v))
                            for k, v in times.items()},
                spread={k: float(np.percentile(v, 75) - np.percentile(v, 25))
                        for k, v in times.items()})


def main(argv=None):
    import argparse
    import os

    ap = argparse.ArgumentParser(prog="python -m jsvx_torch.tools.bench_parse")
    ap.add_argument("--pool", nargs="+", metavar="CLIP",
                    help="time transcode's per-GOP parse of each clip "
                         "against the tasks a GOP is cut into")
    ap.add_argument("--passes", type=int, default=9)
    args = ap.parse_args(argv)
    if args.pool:
        from ..pipeline.parse_pool import cpus

        for clip in args.pool:
            with open(clip, "rb") as f:
                data = f.read()
            res = bench_pool(data, list(range(1, cpus() + 1)), args.passes)
            print(json.dumps(dict(clip=os.path.basename(clip), **res)),
                  flush=True)
        return

    data = make_stream()
    print(f"stream: {len(data)} bytes")
    res_native = bench(data, use_native=True, reps=5)
    res_py = bench(data, use_native=False, reps=1)
    speedup = res_native["mb_per_s"] / res_py["mb_per_s"]
    print(json.dumps({
        "python_mb_per_s": round(res_py["mb_per_s"]),
        "native_mb_per_s": round(res_native["mb_per_s"]),
        "native_pictures_per_s": round(res_native["pictures_per_s"], 1),
        "parallel_pictures_per_s": round(bench_parallel(data), 1),
        "packed_pictures_per_s": round(bench_packed(data), 1),
        "packed_slice_threads_pictures_per_s": round(
            bench_packed(data, slice_threads=os.cpu_count() or 2,
                         n_threads=1), 1),
        "host_cores": os.cpu_count(),
        "speedup": round(speedup, 1),
        "device": "host",
    }))


if __name__ == "__main__":
    main()
