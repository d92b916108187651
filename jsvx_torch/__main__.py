"""jsvx_torch command line: decode.

Usage:
  python -m jsvx_torch decode CLIP.jsv OUT_DIR [--rgb]
      [--impl fused|two_kernel] [--device cuda]

The port of ``python -m jsvx decode``: every picture of the stream goes
through :class:`jsvx_torch.pipeline.stream.StreamDecoder` and is written
to OUT_DIR as ``frame_NNNNN.npz`` (coded-size ``y``, ``cb``, ``cr``
planes) or, with ``--rgb``, as ``frame_NNNNN.ppm``.  The device defaults
to the first CUDA card where there is one, else the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def cmd_decode(args) -> int:
    import torch

    from jsvx.tools.refmath import ycbcr_to_rgb

    from .pipeline.stream import StreamDecoder

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
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


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.tobytes())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m jsvx_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pd = sub.add_parser("decode")
    pd.add_argument("stream")
    pd.add_argument("out_dir")
    pd.add_argument("--rgb", action="store_true")
    pd.add_argument("--impl", default="fused",
                    choices=["fused", "two_kernel"])
    pd.add_argument("--device", default=None,
                    help="torch device (default: cuda if available, "
                         "else cpu)")
    pd.set_defaults(fn=cmd_decode)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
