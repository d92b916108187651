"""Host-parse throughput micro-bench: Python vs C++ back end (host only).

The port of ``jsvx/tools/bench_parse.py``: the serial picture parse with
each back end of :class:`jsvx_torch.bitstream.parser.StreamParser`, the
picture-parallel parse (:mod:`jsvx_torch.pipeline.parallel_parse`) and the
stacked dense parse (:func:`jsvx_torch.pipeline.packed_parse.
parse_stream_packed`, without jsvx's distinct-vector sideband), on a
synthetic 352x288 stream.

Run: ``python -m jsvx_torch.tools.bench_parse``
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


def main():
    import os

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
