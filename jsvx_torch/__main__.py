"""jsvx_torch command line: info / decode / encode / bench / play / warm.

Usage:
  python -m jsvx_torch info CLIP.jsv
  python -m jsvx_torch decode CLIP.jsv OUT_DIR [--rgb]
      [--impl fused|two_kernel|oracle] [--device cuda]
  python -m jsvx_torch encode FRAMES.npy CLIP.jsv [--gop 12] [--q 8]
  python -m jsvx_torch bench CLIP.jsv [--trace DIR]
      [--impl fused|two_kernel] [--device cuda]
  python -m jsvx_torch play CLIP.jsv [--seconds 30] [--rate 1.0]
      [--start 0] [--audio X.wav] [--skip-hard] [--rgb] [--device cuda]
  python -m jsvx_torch warm [CLIP.jsv | --shape 1920x1088 [--gop 4]
      [--q 6]] [--device cuda]

The port of ``python -m jsvx``; each command prints jsvx's JSON plus
``device``.  ``info`` reads the container header and counts start codes,
and ``encode`` (an ``.npz`` of ``y``/``cb``/``cr`` stacks or an RGB
``.npy`` of (N, H, W, 3)) writes jsvx's bytes: both run on the host.
``decode`` sends every picture of the stream through
:class:`jsvx_torch.pipeline.stream.StreamDecoder` (``--impl oracle``: the
float64 oracle, on the host) and writes it to OUT_DIR as
``frame_NNNNN.npz`` (coded-size ``y``, ``cb``, ``cr`` planes) or, with
``--rgb``, as ``frame_NNNNN.ppm``.  ``bench`` runs
:func:`jsvx_torch.transcode` once, inside a ``torch.profiler`` trace with
``--trace``, which also holds the program's spans.  ``play`` runs
:class:`jsvx_torch.api.Player` on a wall clock.  ``warm`` builds the CUDA
kernels' library and the C++ parser (the port's counterpart of jsvx's
compile cache) and runs ``transcode`` twice.  ``decode``, ``bench``, ``play`` and ``warm`` run on the CUDA card
and fail when there is none; ``--device cpu`` is the only way to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def cmd_info(args) -> int:
    from .bitstream.bitio import BitReader
    from .bitstream.container import StartCodeIndex, parse_container_header
    from .coding import tables as T

    with open(args.stream, "rb") as f:
        data = f.read()
    meta = parse_container_header(BitReader(data))
    idx = StartCodeIndex.scan(data)
    codes = idx.entries[:, 1]
    info = {
        "bytes": len(data),
        "width": meta.width,
        "height": meta.height,
        "duration_s": meta.duration,
        "yuva": meta.yuva,
        "gop_key_map": meta.key_map.count if meta.key_map else 0,
        "sequences": int(np.count_nonzero(codes == T.START_SEQUENCE)),
        "gops": int(np.count_nonzero(codes == T.START_GOP)),
        "pictures": int(np.count_nonzero(codes == T.START_PICTURE)),
    }
    print(json.dumps(info, indent=2))
    return 0


def device_for(arg: str) -> str:
    """The device named on the command line; a CUDA device must exist."""
    import torch

    if torch.device(arg).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"python -m jsvx_torch: no CUDA device is "
                         f"available for --device {arg} (pass --device cpu "
                         f"to run on the CPU)")
    return arg


def cmd_decode(args) -> int:
    from .tools.refmath import ycbcr_to_rgb

    # the oracle is float64 numpy on the host: it needs no card
    device = "host" if args.impl == "oracle" else device_for(args.device)
    with open(args.stream, "rb") as f:
        data = f.read()
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    if args.impl == "oracle":
        from .tools.oracle import decode_stream_oracle

        frames = [f.planes for f in decode_stream_oracle(data)]
    else:
        from .pipeline.stream import StreamDecoder

        res = StreamDecoder(data, device=device).decode(impl=args.impl)
        frames = [tuple(p.cpu().numpy() for p in f) for f in res.frames]
    dt = time.perf_counter() - t0

    for i, planes in enumerate(frames):
        if args.rgb:
            _write_ppm(os.path.join(args.out_dir, f"frame_{i:05d}.ppm"),
                       ycbcr_to_rgb(*planes[:3]))
        else:
            np.savez(os.path.join(args.out_dir, f"frame_{i:05d}.npz"),
                     y=planes[0], cb=planes[1], cr=planes[2])
    print(json.dumps({"frames": len(frames), "seconds": round(dt, 3),
                      "fps": round(len(frames) / dt, 1), "device": device,
                      "impl": args.impl}))
    return 0


def cmd_encode(args) -> int:
    from .tools.encoder import EncoderConfig, JsvEncoder, rgb_to_ycbcr

    arr = np.load(args.frames)
    if isinstance(arr, np.lib.npyio.NpzFile):
        ys, cbs, crs = arr["y"], arr["cb"], arr["cr"]
        frames = [(ys[i], cbs[i], crs[i]) for i in range(ys.shape[0])]
    else:
        # (N, H, W, 3) RGB
        frames = [rgb_to_ycbcr(arr[i]) for i in range(arr.shape[0])]
    h, w = frames[0][0].shape
    data = JsvEncoder(w, h, EncoderConfig(
        gop_size=args.gop, quantizer_scale=args.q)).encode(frames)
    with open(args.out, "wb") as f:
        f.write(data)
    print(json.dumps({"frames": len(frames), "bytes": len(data),
                      "device": "host"}))
    return 0


def cmd_bench(args) -> int:
    """One ``transcode`` of the clip (inside a ``torch.profiler`` trace
    written to ``--trace DIR``, the program's spans merged in): its
    metrics, end-to-end frames/s."""
    from .pipeline.transcode import transcode
    from .runtime.profiler import device_trace

    device = device_for(args.device)
    with open(args.stream, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    with device_trace(args.trace, device):
        res = transcode(data, device=device, impl=args.impl)
    dt = time.perf_counter() - t0
    out = res.metrics.to_dict()
    out["fps_end_to_end"] = res.n_frames / dt
    if args.trace:
        out["trace_dir"] = args.trace
    out["device"] = device
    out["impl"] = args.impl
    print(json.dumps(out, indent=2))
    return 0


def warm_stream(w: int, h: int, gop: int, q: int) -> str:
    """jsvx's warm stream (two GOPs of a noisy moving sine pattern, the
    same encoder settings), cached under ``build/jsvx_torch/warm/`` and
    keyed by the encoder's source, as the fixture is."""
    import hashlib

    from .kernels.build import BUILD_ROOT
    from .tools import encoder
    from .tools.encoder import EncoderConfig, JsvEncoder

    with open(encoder.__file__, "rb") as f:
        tag = hashlib.sha256(f.read() + f"|{w}x{h}|g{gop}|q{q}".encode()
                             ).hexdigest()[:8]
    src = os.path.join(BUILD_ROOT, "warm", f"jsvx_warm_{tag}.jsv")
    if os.path.exists(src):
        return src
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(2 * gop):
        y = np.clip(120 + 60 * np.sin(2 * np.pi * (xx + 3 * t) / w)
                    + rng.normal(0, 5, (h, w)), 0, 255)
        cb = np.clip(128 + 24 * np.sin(2 * np.pi * xx[::2, ::2] / w), 0, 255)
        cr = np.clip(128 + 24 * np.cos(2 * np.pi * yy[::2, ::2] / h), 0, 255)
        frames.append(tuple(p.astype(np.uint8) for p in (y, cb, cr)))
    data = JsvEncoder(w, h, EncoderConfig(
        gop_size=gop, quantizer_scale=q, me_range=4,
        half_pel_refine=True)).encode(frames)
    os.makedirs(os.path.dirname(src), exist_ok=True)
    tmp = src + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, src)
    return src


def cmd_warm(args) -> int:
    """Build what a first decode would build (the CUDA kernels' library,
    on a card, and the C++ parser), then run ``transcode`` twice on the
    clip (or on jsvx's synthesised warm stream at ``--shape``): the first
    run's and the second run's wall times.  On a card the first run
    captures the stream's GOP programs (their count and capture seconds
    are reported) and the second replays them; a program lives only in
    its process, so this warms the builds on disk, not the programs of
    another process."""
    from .bitstream import native
    from .kernels import build
    from .pipeline.transcode import transcode

    device = device_for(args.device)
    if args.stream:
        src = args.stream
    elif args.shape:
        w, h = (int(x) for x in args.shape.lower().split("x"))
        src = warm_stream(w, h, args.gop, args.q)
    else:
        print("warm: need a stream path or --shape WxH", file=sys.stderr)
        return 2
    with open(src, "rb") as f:
        data = f.read()

    t0 = time.perf_counter()
    native.get_native_parser()
    # build_s: the compiler's time, about 0 when the build was on disk
    parser = {"path": native.library_path(),
              "build_s": time.perf_counter() - t0}
    kernels = None
    if device != "cpu":
        built = build.load()
        kernels = {"path": built.path, "build_s": built.seconds}

    def sink(gi, outs):
        int(outs[0][-1, 0, 0])          # one pixel to the host

    t0 = time.perf_counter()
    first = transcode(data, sink=sink, device=device).metrics
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = transcode(data, sink=sink, device=device)
    warm_s = time.perf_counter() - t0
    print(json.dumps({
        "stream": src,
        "cache_dir": build.BUILD_ROOT,
        "kernels": kernels,
        "parser": parser,
        "frames": res.n_frames,
        "compile_plus_first_decode_s": cold_s,
        "warm_decode_s": warm_s,
        "warm_fps": res.n_frames / warm_s,
        "programs": first.counters["gop_program.captures"],
        "capture_s": first.gauges.get("gop_program.capture_s", 0.0),
        "second_run_captures": res.metrics.counters["gop_program.captures"],
        "device": device,
        "note": ("the kernels' library and the parser are built once per "
                 "source tree under cache_dir (kernels: null on the CPU, "
                 "which runs the plain versions); the GOP programs (CUDA "
                 "graphs, one per wire layout) were captured in this "
                 "process and die with it, unlike jsvx's persistent "
                 "compile cache: a server captures its own on its first "
                 "GOP of each layout"),
    }))
    return 0


def cmd_play(args) -> int:
    """``python -m jsvx play`` on the port's Player: ``run_realtime``
    over a file source with the A/V clock and a headless frame sink.
    Prints a JSON report at exit: frames shown, display fps, late-frame
    skips, played ranges, the event counts and order, and the device."""
    from .api import Player, PlayerConfig, WallClockAudio

    device = device_for(args.device)
    cfg = PlayerConfig(skip_hard=args.skip_hard, emit_rgb=args.rgb)
    audio = None
    if args.audio:
        with open(args.audio, "rb") as f:
            audio = WallClockAudio(f.read())
    p = Player(config=cfg, audio_clock=audio, device=device)
    counts: dict[str, int] = {}
    order: list[str] = []
    for ev in ("loadstart", "progress", "loadedmetadata", "canplay",
               "canplaythrough", "playing", "waiting", "stalled",
               "unstalled", "seeking", "seeked", "timeupdate", "ended",
               "error", "bitratechange", "suspend"):
        def bump(*a, _e=ev):
            counts[_e] = counts.get(_e, 0) + 1
            if _e != "timeupdate" and (not order or order[-1] != _e):
                order.append(_e)
        p.on(ev, bump)
    shown: list[float] = []
    p.set_frame_sink(lambda f, t: shown.append(t))
    p.src = args.stream
    p.playback_rate = args.rate
    if args.start:
        p.current_time = args.start
    p.play()
    p.run_realtime()
    t0 = time.monotonic()
    try:
        while (time.monotonic() - t0 < args.seconds
               and not counts.get("ended") and p.error is None):
            time.sleep(0.02)
    finally:
        wall = time.monotonic() - t0
        p.stop_realtime()
        pr = p.played
        ranges = [(pr.start(i), pr.end(i)) for i in range(pr.length)]
        report = {
            "stream": args.stream,
            "wall_seconds": round(wall, 2),
            "playback_rate": args.rate,
            "frames_shown": len(shown),
            "display_fps": round(len(shown) / wall, 1) if wall else 0.0,
            "media_seconds_played": round(
                sum(b - a for a, b in ranges), 2),
            "played_ranges": [[round(a, 2), round(b, 2)]
                              for a, b in ranges],
            "late_skips": int(p.metrics.counters.get("late_skips", 0)),
            "current_time": round(p.current_time, 2),
            "ended": bool(counts.get("ended")),
            "error": str(p.error) if p.error else None,
            "events": counts,
            "event_order": order[:24],
            "device": str(p.device),
        }
        p.destroy()
        print(json.dumps(report))
    return 0 if report["error"] is None else 1


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.tobytes())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m jsvx_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("info")
    pi.add_argument("stream")
    pi.set_defaults(fn=cmd_info)

    pd = sub.add_parser("decode")
    pd.add_argument("stream")
    pd.add_argument("out_dir")
    pd.add_argument("--rgb", action="store_true")
    pd.add_argument("--impl", default="fused",
                    choices=["fused", "two_kernel", "oracle"])
    pd.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the "
                         "plain versions; --impl oracle runs on the host)")
    pd.set_defaults(fn=cmd_decode)

    pe = sub.add_parser("encode")
    pe.add_argument("frames")
    pe.add_argument("out")
    pe.add_argument("--gop", type=int, default=12)
    pe.add_argument("--q", type=int, default=8)
    pe.set_defaults(fn=cmd_encode)

    pb = sub.add_parser("bench")
    pb.add_argument("stream")
    pb.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace to "
                    "DIR/trace.json: the host ops, the card's kernels and "
                    "the program's spans (walk, parse, replay, ...)")
    pb.add_argument("--impl", default="fused",
                    choices=["fused", "two_kernel"])
    pb.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the "
                         "plain versions)")
    pb.set_defaults(fn=cmd_bench)

    pp = sub.add_parser("play")
    pp.add_argument("stream")
    pp.add_argument("--seconds", type=float, default=30.0,
                    help="max wall-clock run time")
    pp.add_argument("--rate", type=float, default=1.0,
                    help="playback rate (>1 = faster than realtime)")
    pp.add_argument("--start", type=float, default=0.0,
                    help="seek to this time (s) before playing")
    pp.add_argument("--audio", default=None, metavar="WAV",
                    help="companion WAV for the A/V clock")
    pp.add_argument("--skip-hard", action="store_true",
                    help="drop late frames aggressively")
    pp.add_argument("--rgb", action="store_true",
                    help="convert frames to RGB in the sink")
    pp.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the "
                         "plain versions)")
    pp.set_defaults(fn=cmd_play)

    pw = sub.add_parser("warm")
    pw.add_argument("stream", nargs="?", default=None,
                    help="representative stream to warm with")
    pw.add_argument("--shape", default=None, metavar="WxH",
                    help="synthesize a warm stream at this size")
    pw.add_argument("--gop", type=int, default=4)
    pw.add_argument("--q", type=int, default=6)
    pw.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu builds only the "
                         "parser and runs the plain versions)")
    pw.set_defaults(fn=cmd_warm)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
