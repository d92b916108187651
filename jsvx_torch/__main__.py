"""jsvx_torch command line: info / decode / play.

Usage:
  python -m jsvx_torch info CLIP.jsv
  python -m jsvx_torch decode CLIP.jsv OUT_DIR [--rgb]
      [--impl fused|two_kernel] [--device cuda]
  python -m jsvx_torch play CLIP.jsv [--seconds 30] [--rate 1.0]
      [--start 0] [--audio X.wav] [--skip-hard] [--rgb] [--device cuda]

The port of ``python -m jsvx``'s ``info``, ``decode`` and ``play``.
``info`` reads the container header and counts start codes (host only).
``decode`` sends every picture of the stream through
:class:`jsvx_torch.pipeline.stream.StreamDecoder` and writes it to OUT_DIR
as ``frame_NNNNN.npz`` (coded-size ``y``, ``cb``, ``cr`` planes) or, with
``--rgb``, as ``frame_NNNNN.ppm``.  ``play`` runs
:class:`jsvx_torch.api.Player` on a wall clock and prints a JSON report
(jsvx's, plus ``device``).  ``decode`` and ``play`` run on the CUDA card
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
    from .pipeline.stream import StreamDecoder
    from .tools.refmath import ycbcr_to_rgb

    device = device_for(args.device)
    with open(args.stream, "rb") as f:
        data = f.read()
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
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
                    choices=["fused", "two_kernel"])
    pd.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the "
                         "plain versions)")
    pd.set_defaults(fn=cmd_decode)

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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
