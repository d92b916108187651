"""The comparison that decides ``correct``.

Each sampled output of the timed path is held to the plain reference's
decode of the same bytes (:func:`jsvbench.reference.oracle.decode_gop`):
planes for ``transcode``, display RGB (``refmath.ycbcr_to_rgb`` of the
reference's planes at the display crop) for the Player.  The numbers:

* ``missing_frames``: frames a unit should have delivered and did not;
* ``off_ppm``: of the worst sample, the samples (bytes) that differ from
  the reference, per million;
* ``max_abs_diff``: the largest difference of any sample (reported, not
  judged: the control does not read three times the program there).

A number is judged when the cell's workload file gives it a limit
(``checks``).
"""

from __future__ import annotations

import numpy as np

from .reference import refmath


def reference_rgb(planes: tuple, height: int, width: int) -> np.ndarray:
    """The display image of decoded planes: the crop, then colour."""
    y, cb, cr = planes[:3]
    hc, wc = -(-height // 2), -(-width // 2)
    return refmath.ycbcr_to_rgb(y[:height, :width], cb[:hc, :wc],
                                cr[:hc, :wc])


def reference_rgb_tf32(planes: tuple, height: int, width: int) -> np.ndarray:
    """:func:`reference_rgb` with its colour matrix product in TF32 (the
    control's colour)."""
    from .reference.oracle import tf32

    y, cb, cr = (np.asarray(p, np.float64) / 255.0 for p in planes[:3])
    hc, wc = -(-height // 2), -(-width // 2)
    y = y[:height, :width]
    up = [np.repeat(np.repeat(p[:hc, :wc], 2, 0), 2, 1)[:height, :width]
          for p in (cb, cr)]
    ycc = tf32(np.stack([y] + up, -1))
    rgb = (ycc @ tf32(refmath.YCBCR_TO_RGB.T)).astype(np.float64) \
        + refmath.YCBCR_OFFSET
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def want(output: str, frames_of, key: int, gop_size: int, display: tuple,
         rgb=reference_rgb) -> tuple:
    """What the reference says sample ``key`` should be: for ``planes``
    the (Y, Cb, Cr) stacks of GOP ``key``, for ``rgb`` the display image
    of frame ``key``; ``frames_of(g)`` gives GOP g's planes a picture."""
    if output == "planes":
        frames = frames_of(key)
        return tuple(np.stack([f[k] for f in frames]) for k in range(3))
    return (rgb(frames_of(key // gop_size)[key % gop_size], *display),)


def differences(got, want) -> tuple[int, int, int]:
    """(samples that differ, samples, the largest difference)."""
    off = total = worst = 0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.int16), np.asarray(w, np.int16)
        if g.shape != w.shape:              # every sample of it is off
            off, total, worst = off + w.size, total + w.size, 255
            continue
        d = np.abs(g - w)
        off += int((d > 0).sum())
        total += d.size
        worst = max(worst, int(d.max(initial=0)))
    return off, total, worst


def numbers(samples: list, want_of, missing: int) -> dict:
    """The compared numbers of ``samples`` (each a tuple of arrays, with
    its key): ``want_of(key)`` is the reference's tuple of arrays."""
    ppm, worst = 0.0, 0
    for key, got in samples:
        off, total, w = differences(got, want_of(key))
        ppm = max(ppm, 1e6 * off / max(total, 1))
        worst = max(worst, w)
    return dict(missing_frames=missing, off_ppm=ppm, max_abs_diff=worst)


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    out = {k: {"value": found[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out
