"""Smoke run of the PyTorch / H100 port (``jsvx_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(the kernel is built for sm_90a with ``nvcc`` at first use).  Phases, each
printing its own lines:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. the build of ``jsvx_torch/csrc/`` into ``build/jsvx_torch/``;
3. the fused decode kernel against its plain PyTorch version on the same
   CUDA tensors, required bit-equal (0 differing pixels): every frame and
   plane of GOP 0 of the 1080p bench fixture, one frame with the
   oddify-zeros quirk, and a 320x320 stream with 256 distinct motion
   vectors in one P frame;
4. the slice end to end: ``jsvx_torch.transcode`` of the 1080p fixture on
   the card (the kernel must launch once per frame and plane), bit-equal
   to the same call on the CPU; and CIF and YUVA streams within 1 LSB of
   the float64 oracle;
5. timings (CUDA events, median of 30 after warm-up; host clock for the
   end-to-end run), each with the card's name and power limit.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises (non-zero
exit, no result line); without a CUDA card it exits non-zero at once.
JAX is never imported.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import bench
from jsvx.tools import EncoderConfig, JsvEncoder, decode_stream_oracle, psnr
from jsvx.runtime.profiler import Metrics
from jsvx_torch.kernels import build, fused
from jsvx_torch.kernels.decode import (comp_is_chroma, decode_frame_plane,
                                       frame_comp_keys, make_constants)
from jsvx_torch.kernels.expand import expand_compact_gop
from jsvx_torch.pipeline.gop import decode_gop_wire, frame_at, zero_refs
from jsvx_torch.pipeline.packed_parse import (BufferPool, parse_gop_compact,
                                              walk_stream)
from jsvx_torch.pipeline.transcode import transcode
from jsvx_torch.pipeline.wire import flatten_wire, unflatten_wire, wire_spec

KERNEL_SOURCE = "jsvx_torch/csrc/fused_decode.cu"
KERNEL_REPLACES = "jsvx/kernels/pallas_fused.py:51"
N_TIMED = 30
SLEEP_MS = 25.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


# ---------------------------------------------------------------------------
# Streams

def yuva_clip(n: int, h: int, w: int) -> list:
    """The bench's zooming pattern plus a moving alpha plane."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t, (y, cb, cr) in enumerate(bench._zoom_clip(h, w, n, seed=5)):
        a = np.clip(128 + 80 * np.sin(2 * np.pi * (xx + 5 * t) / w)
                    + 40 * (yy > 4 * t), 0, 255).astype(np.uint8)
        out.append((y, cb, cr, a))
    return out


def high_motion_stream() -> bytes:
    """20x20 macroblocks, GOP 2: the first P frame moves its interior by
    (2, 2), the second carries 256 distinct vectors (the stream of
    tests/test_high_motion.py, on the bench's pattern)."""
    mbs = 20
    enc = JsvEncoder(mbs * 16, mbs * 16, EncoderConfig(
        gop_size=2, quantizer_scale=8, f_code=3, intra_sad_threshold=1e9,
        key_map=True))
    calls = []

    def forced(y, ref_y):
        mv = np.zeros((mbs, mbs, 2), np.int64)
        if not calls:
            mv[2:18, 2:18] = (2, 2)
        else:
            idx = np.arange(256)
            mv[2:18, 2:18, 0] = (2 * (idx // 16 - 8)).reshape(16, 16)
            mv[2:18, 2:18, 1] = (2 * (idx % 16 - 8)).reshape(16, 16)
        calls.append(1)
        return mv

    enc._motion_search = forced
    return enc.encode(bench._zoom_clip(mbs * 16, mbs * 16, 4, seed=11))


def dense_gop(data: bytes, gi: int, device):
    """Parse GOP ``gi``, pack its wire, copy it to ``device``, expand."""
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    g = parse_gop_compact(arr, groups[gi], seq, meta, BufferPool(), {})
    check(not g.dirty, f"GOP {gi} is dirty")
    spec = wire_spec(g.stacked)
    wire = torch.from_numpy(flatten_wire(g.stacked, spec)).to(device)
    dense = expand_compact_gop(unflatten_wire(wire, spec), seq.mb_height,
                               seq.mb_width)
    return meta, seq, g, wire, spec, dense


# ---------------------------------------------------------------------------
# Phase 3: kernel vs plain

def kernel_vs_plain(label: str, data: bytes, gi: int, device,
                    quirk_frames=()) -> int:
    """Every frame and plane of GOP ``gi`` through the kernel and the plain
    version on the same CUDA tensors (the kernel's output carries as the
    next frame's reference).  Returns the max |kernel - plain|."""
    meta, seq, g, _, _, dense = dense_gop(data, gi, device)
    consts = make_constants(seq, device)
    refs = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                     device)
    worst = 0
    for i in range(len(g.hdrs)):
        frame = frame_at(dense, i)
        for quirk in sorted({False, i in quirk_frames}):
            planes = []
            for ci, key in enumerate(frame_comp_keys(frame)):
                chroma = comp_is_chroma(ci)
                k = fused.fused_decode_plane(frame[key], refs[ci],
                                             frame["is_p"], consts, chroma,
                                             quirk)
                p = decode_frame_plane(frame[key], refs[ci], frame["is_p"],
                                       consts, chroma, quirk)
                sync(device)
                n_diff = int((k != p).sum())
                err = int((k.int() - p.int()).abs().max())
                emit("kernel_vs_plain", stream=label, gop=gi, frame=i,
                     plane=key, quirk=quirk, shape=list(k.shape),
                     is_p=int(frame["is_p"]), mismatching_pixels=n_diff,
                     max_abs_err=err)
                check(n_diff == 0,
                      f"{label} frame {i} plane {key} quirk={quirk}: "
                      f"{n_diff} pixels differ between kernel and plain")
                worst = max(worst, err)
                planes.append(k)
            if not quirk:
                decoded = tuple(planes)
        refs = decoded
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the slice

def collect(data: bytes, device) -> tuple[list, object]:
    got = {}
    res = transcode(data, lambda gi, outs: got.__setitem__(
        gi, [o.cpu() for o in outs]), device=device)
    frames = [tuple(s[i].numpy() for s in got[g]) for g in sorted(got)
              for i in range(got[g][0].shape[0])]
    return frames, res


def check_vs_oracle(label: str, data: bytes, device) -> float:
    frames, res = collect(data, device)
    oracle = decode_stream_oracle(data)
    check(len(frames) == len(oracle) == res.n_frames,
          f"{label}: {len(frames)} frames, oracle {len(oracle)}")
    worst, min_psnr = 0, float("inf")
    for f, o in zip(frames, oracle):
        check(len(f) == len(o.planes), f"{label}: plane count")
        for p, q in zip(f, o.planes):
            worst = max(worst, int(np.abs(p.astype(int)
                                          - q.astype(int)).max()))
            min_psnr = min(min_psnr, psnr(p, q))
    emit("oracle", stream=label, frames=len(frames), planes=len(frames[0]),
         max_abs_err_vs_oracle=worst, min_psnr_db=min_psnr)
    check(worst <= 1, f"{label}: {worst} LSB from the oracle")
    return min_psnr


# ---------------------------------------------------------------------------
# Phase 5: timing

def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def call_ms(fn, device) -> list[float]:
    """Per call with the host in the loop: CUDA events around one call,
    so the device's idle time while Python launches is included."""
    for _ in range(3):
        fn()
    sync(device)
    times = []
    for _ in range(N_TIMED):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def device_ms(fn, device, k: int) -> tuple[list[float], float, float]:
    """Device time per call, the host's launch cost hidden: a spin kernel
    (``torch.cuda._sleep``) holds the stream for about SLEEP_MS while
    ``k`` calls are enqueued behind it, so they run back to back.
    Returns the per-call times, the share of repetitions whose enqueueing
    ended before the spin did (1.0: every time is pure device time), and
    the median host time to enqueue the ``k`` calls."""
    for _ in range(3):
        fn()
    sync(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    cycles = 1_000_000
    for _ in range(2):                     # calibrate, then measure it
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        e1.synchronize()
        spin_ms = e0.elapsed_time(e1)
        cycles = int(cycles * SLEEP_MS / spin_ms)
    times, host, covered = [], [], 0
    for _ in range(N_TIMED):
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        e0.record()
        for _ in range(k):
            fn()
        e1.record()
        host.append((time.perf_counter() - t0) * 1e3)
        covered += host[-1] < 0.9 * spin_ms
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / k)
    return times, covered / N_TIMED, statistics.median(host)


def smoke(dev: torch.device) -> None:
    t_start = time.perf_counter()

    # ---- 1. the card --------------------------------------------------------
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    nvcc = run([build.nvcc_path(), "--version"]).splitlines()[-1]
    kind = torch.cuda.get_device_name(0)
    emit("device", card=card, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0])

    # ---- 2. build -----------------------------------------------------------
    built = build.load()
    emit("build", library=built.path, nvcc_seconds=built.seconds,
         ptxas=[ln.strip() for ln in built.log.splitlines()
                if "Used" in ln or "spill" in ln])

    # ---- 3. kernel vs plain -------------------------------------------------
    t0 = time.perf_counter()
    fix = bench.ensure_fixture()
    with open(fix, "rb") as f:
        data_1080 = f.read()
    emit("fixture", path=fix, bytes=len(data_1080),
         seconds=time.perf_counter() - t0)
    worst = kernel_vs_plain("1080p", data_1080, 0, dev, quirk_frames=(1,))
    hm = high_motion_stream()
    _, _, g, _, _, _ = dense_gop(hm, 1, dev)
    n_mv = len(np.unique(g.stacked["mb"]["mv"][1].reshape(-1, 2), axis=0))
    emit("high_motion", distinct_mvs=n_mv)
    check(n_mv >= 256, f"{n_mv} distinct vectors, expected >= 256")
    for gi in range(2):
        worst = max(worst, kernel_vs_plain("320x320-256mv", hm, gi, dev))

    # ---- 4. the slice -------------------------------------------------------
    fused.launches = 0
    cuda_frames, res = collect(data_1080, dev)
    launches = fused.launches
    meta, seq, _ = walk_stream(data_1080)
    n_planes = meta.n_components
    emit("transcode", device=str(dev), frames=res.n_frames, gops=res.n_gops,
         planes=n_planes, launches=launches,
         expected_launches=res.n_frames * n_planes)
    check(launches == res.n_frames * n_planes > 0,
          f"{launches} kernel launches for {res.n_frames} frames x "
          f"{n_planes} planes")
    cpu_frames, _ = collect(data_1080, "cpu")
    n_diff = 0
    for fc, fh in zip(cuda_frames, cpu_frames):
        check(fc[0].shape == (seq.coded_height, seq.coded_width),
              f"luma shape {fc[0].shape}")
        for a, b in zip(fc, fh):
            check(a.dtype == np.uint8, f"plane dtype {a.dtype}")
            n_diff += int((a != b).sum())
    emit("cuda_vs_cpu", frames=len(cuda_frames), mismatching_pixels=n_diff)
    check(n_diff == 0 and len(cuda_frames) == len(cpu_frames) == res.n_frames,
          f"CUDA and CPU transcode differ: {n_diff} pixels")
    cif = bench._zoom_clip(288, 352, 12, seed=7)
    check_vs_oracle("cif-352x288", JsvEncoder(352, 288, EncoderConfig(
        gop_size=6, quantizer_scale=6, me_range=8,
        half_pel_refine=True)).encode(cif), dev)
    check_vs_oracle("yuva-128x96", JsvEncoder(128, 96, EncoderConfig(
        gop_size=4, quantizer_scale=5, me_range=6,
        half_pel_refine=True)).encode(yuva_clip(8, 96, 128)), dev)

    # ---- 5. timing ----------------------------------------------------------
    meta, seq, g, wire, spec, dense = dense_gop(data_1080, 0, dev)
    consts = make_constants(seq, dev)
    refs = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                     dev)
    f0 = frame_at(dense, 0)
    refs = tuple(fused.fused_decode_plane(f0[k], refs[ci], f0["is_p"],
                                          consts, comp_is_chroma(ci))
                 for ci, k in enumerate(frame_comp_keys(f0)))
    f1 = frame_at(dense, 1)                 # a P frame
    check(int(f1["is_p"]) == 1, "frame 1 of GOP 0 is not a P frame")
    timing = {}
    for ci, key in ((0, "y"), (1, "cb")):
        chroma = comp_is_chroma(ci)
        kernel = lambda: fused.fused_decode_plane(  # noqa: E731
            f1[key], refs[ci], f1["is_p"], consts, chroma)
        plain = lambda: decode_frame_plane(  # noqa: E731
            f1[key], refs[ci], f1["is_p"], consts, chroma)
        # in turns: plain, kernel, kernel, plain
        p1, pc1, ph1 = device_ms(plain, dev, 1)
        k1, kc1, kh1 = device_ms(kernel, dev, 20)
        k2, kc2, kh2 = device_ms(kernel, dev, 20)
        p2, pc2, ph2 = device_ms(plain, dev, 1)
        kcall, pcall = call_ms(kernel, dev), call_ms(plain, dev)
        shape = list(refs[ci].shape)
        timing[key] = dict(ms=statistics.median(k1 + k2),
                           plain_ms=statistics.median(p1 + p2))
        px = shape[0] * shape[1]
        # bytes the kernel must move: levels 2 B + out 1 B per pixel, at
        # least one reference tap 1 B; the per-block sideband is 1/64th
        moved = px * 4 + (px // 64) * 8
        emit("kernel_time", card=card, plane=key, shape=shape,
             kernel_ms=timing[key]["ms"], plain_ms=timing[key]["plain_ms"],
             kernel_ms_runs=[statistics.median(k1), statistics.median(k2)],
             plain_ms_runs=[statistics.median(p1), statistics.median(p2)],
             host_ahead_share={"kernel": min(kc1, kc2),
                               "plain": min(pc1, pc2)},
             host_enqueue_ms={"kernel_x20": max(kh1, kh2),
                              "plain_x1": max(ph1, ph2)},
             speedup=timing[key]["plain_ms"] / timing[key]["ms"],
             kernel_call_ms=statistics.median(kcall),
             plain_call_ms=statistics.median(pcall),
             min_bytes=moved,
             achieved_gb_s=moved / (timing[key]["ms"] * 1e-3) / 1e9,
             reps=2 * N_TIMED, l2="warm (inputs resident, 50 MB L2)")

    n_f = len(g.hdrs)

    def gop():
        zr = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                       dev)
        return decode_gop_wire(wire, spec, zr, consts, seq.mb_height,
                               seq.mb_width)

    def expand():
        return expand_compact_gop(unflatten_wire(wire, spec), seq.mb_height,
                                  seq.mb_width)

    gop_dev, gop_cov, _ = device_ms(gop, dev, 2)
    exp_dev, exp_cov, _ = device_ms(expand, dev, 4)
    gop_call = call_ms(gop, dev)
    emit("device_gop_decode", card=card, frames=n_f,
         gop_ms=statistics.median(gop_call),
         frames_per_s=n_f / (statistics.median(gop_call) * 1e-3),
         device_busy_ms=statistics.median(gop_dev),
         expand_device_ms=statistics.median(exp_dev),
         host_ahead_share=min(gop_cov, exp_cov),
         device_idle_share=1 - statistics.median(gop_dev)
         / statistics.median(gop_call),
         reps=N_TIMED, what="unflatten + expand + GOP loop, resident wire")

    m = Metrics()
    wall = []
    for rep in range(N_TIMED + 1):
        mm = Metrics() if rep == 0 else m  # rep 0 is the warm-up
        sync(dev)
        t0 = time.perf_counter()
        r = transcode(data_1080, lambda gi, outs: [o.cpu() for o in outs],
                      device=dev, metrics=mm)
        sync(dev)
        if rep:
            wall.append(time.perf_counter() - t0)
    stages = {k: v / N_TIMED / r.n_gops for k, v in m.timers.totals.items()}
    emit("end_to_end", card=card, frames=r.n_frames, gops=r.n_gops,
         median_s=statistics.median(wall),
         frames_per_s=r.n_frames / statistics.median(wall),
         # device busy: the GOP decode's device time, once per GOP
         device_idle_share=1 - r.n_gops * statistics.median(gop_dev) * 1e-3
         / statistics.median(wall),
         reps=N_TIMED, stage_s_per_gop=stages,
         wire_bytes_per_run=m.gauges["wire_bytes"])

    check("jax" not in sys.modules, "JAX was imported")
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "fused_decode_plane", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": worst,
        "ms": timing["y"]["ms"], "plain_ms": timing["y"]["plain_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smoke(torch.device("cuda", 0))


if __name__ == "__main__":
    main()
