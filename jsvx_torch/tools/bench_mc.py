"""Motion-compensation cost against the number of distinct vectors.

The port of ``jsvx/tools/bench_mc.py``, which asks how the MC kernel's
cost grows with the distinct-vector count K of a P plane (jsvx's kernel
reads a table of distinct vectors, one window per table row, and above
255 jsvx falls back to a per-pixel gather).  The port's kernel
(``csrc/mc.cu`` behind :func:`jsvx_torch.kernels.mc.predict_plane_mc`)
reads a vector per 8x8 block, so it has one route for any count: jsvx's
"gather fallback above 255" row has no counterpart, and K = 300 runs the
same kernel as K = 8.

One 1920x1088 luma P plane whose blocks carry K distinct vectors, K in
``KS``: (0, 0) and K - 1 others drawn without replacement within +-48
half-pel from ``np.random.default_rng(K)``, each on at least one block,
a random reference and ``rep_add`` = 0.  The kernel and its plain version
(:func:`jsvx_torch.kernels.decode.predict_plane`) are timed: on the card
their device time per call (:func:`time_ms`: the calls queued behind a
spin kernel, CUDA events around them), on the CPU the host clock (where
the wrapper itself runs the plain version); on the card the two planes
are compared bit for bit.

Run: ``python -m jsvx_torch.tools.bench_mc [--device cuda]
[--shape 1920x1088]`` (``--device cpu`` for the CPU; a card is required
otherwise).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..kernels.decode import predict_plane
from ..kernels.mc import predict_plane_mc

#: distinct-vector counts, jsvx's and the count past its table's cap
KS = (8, 32, 64, 128, 255, 300)
#: half-pel range of the drawn vectors
MV_RANGE = 48
#: ms of the spin that holds the stream while the host enqueues the calls
SPIN_MS = 50.0


def plane_inputs(h: int, w: int, k: int, device) -> tuple:
    """(ref uint8 (h, w), mv int16 (h/8, w/8, 2), rep_add uint8 (h/8,
    w/8)) on ``device``, the blocks carrying exactly ``k`` distinct
    vectors."""
    hb, wb = h // 8, w // 8
    if not 1 <= k <= hb * wb:
        raise ValueError(f"{k} distinct vectors for {hb * wb} blocks")
    rng = np.random.default_rng(k)
    side = 2 * MV_RANGE + 1
    zero = (side * side) // 2              # the code of (0, 0)
    codes = rng.choice(side * side - 1, size=k - 1, replace=False)
    codes = codes + (codes >= zero)
    table = np.zeros((k, 2), np.int16)
    table[1:, 0] = codes // side - MV_RANGE
    table[1:, 1] = codes % side - MV_RANGE
    idx = rng.permutation(np.arange(hb * wb) % k).reshape(hb, wb)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return (torch.from_numpy(ref).to(device),
            torch.from_numpy(np.ascontiguousarray(table[idx])).to(device),
            torch.zeros((hb, wb), dtype=torch.uint8, device=device))


def time_ms(fn, device, reps: int) -> tuple:
    """(ms of one call, whether the timing is free of the host).

    On a card: the device time per call, ``reps`` calls enqueued behind a
    spin kernel (``torch.cuda._sleep``, about SPIN_MS) so that they run
    back to back, CUDA events around them; the flag says whether the host
    finished enqueueing before the spin ended (else the host's launch
    cost leaks into the time).  On the CPU: the host clock per call, the
    median of ``reps`` (the flag is True)."""
    if device.type != "cuda":
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), True
    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    cycles = 1_000_000
    for _ in range(2):                     # calibrate the spin
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        e1.synchronize()
        spin_ms = e0.elapsed_time(e1)
        cycles = int(cycles * SPIN_MS / spin_ms)
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    e1.synchronize()
    return e0.elapsed_time(e1) / reps, host_ms < 0.9 * spin_ms


def rows(device, h: int = 1088, w: int = 1920, ks=KS,
         reps: int = 30) -> list:
    """One row per (function, K): ``ms_per_plane`` and, for the kernel's
    wrapper, the pixels that differ from the plain version."""
    device = torch.device(device)
    out = []
    for k in ks:
        ref, mv, rep = plane_inputs(h, w, k, device)
        distinct = len(np.unique(mv.cpu().numpy().reshape(-1, 2), axis=0))
        kernel = predict_plane_mc(ref, mv, rep, False)
        plain = predict_plane(ref, mv, rep, False).to(torch.int16)
        diff = int((kernel != plain).sum())
        ms, hidden = time_ms(lambda: predict_plane_mc(ref, mv, rep, False),
                             device, reps)
        out.append({"impl": "predict_plane_mc", "k": k,
                    "distinct": distinct, "ms_per_plane": ms,
                    "host_hidden": hidden, "mismatching_pixels": diff})
        ms, hidden = time_ms(lambda: predict_plane(ref, mv, rep, False),
                             device, reps)
        out.append({"impl": "predict_plane", "k": k, "distinct": distinct,
                    "ms_per_plane": ms, "host_hidden": hidden})
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m jsvx_torch.tools.bench_mc")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu times the plain "
                        "version twice)")
    p.add_argument("--shape", default="1920x1088", metavar="WxH",
                   help="plane size (at least 300 8x8 blocks)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"bench_mc: no CUDA device is available for "
                         f"--device {args.device} (pass --device cpu to "
                         f"run on the CPU)")
    w, h = (int(x) for x in args.shape.lower().split("x"))
    print(json.dumps({
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "plane": f"{w}x{h} luma",
        "rows": rows(device, h, w)}))


if __name__ == "__main__":
    main()
