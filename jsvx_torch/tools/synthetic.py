"""Decode inputs of a plausible picture without a bitstream (numpy only).

The port's copy of ``__graft_entry__._synthetic_frame_inputs``: the same
random draws in the same order, so the same seed gives the same arrays.
It keeps the fields the port decodes (``levels``, ``lnz``, ``q``,
``intra``, ``mv``, ``rep_add`` per plane; ``is_p`` and ``f_code``) and
drops jsvx's distinct-vector table (``mv_idx``, ``mv_table``,
``mv_count``), which the port does not read.  :func:`synthetic_gop` stacks
such pictures into a GOP: the 1080p high-motion GOP whose derived halo
(f_code >= 6) reaches a four-band split's 272 rows, so the row-band decode
takes the all-gather (``tests/test_sharding.py``'s ``_1080p_gop``).
:func:`colour_triples` is the display colour's exhaustive input: every
(Y, Cb, Cr) triple once.
"""

from __future__ import annotations

import numpy as np


def synthetic_frame_inputs(mb_h: int, mb_w: int, is_p: bool, seed: int = 0,
                           max_mv: int = 12, mv_capacity: int = 16) -> dict:
    """One picture of ``mb_h`` x ``mb_w`` macroblocks (Y, Cb, Cr), as
    ``frame_to_device`` lays it out.  Motion is drawn from a small set of
    distinct vectors (as real streams do) of up to ``max_mv`` half-pels."""
    rng = np.random.default_rng(seed)
    n_mv = max(2, mv_capacity - 4)
    mv_table = np.zeros((mv_capacity, 2), np.int32)
    mv_table[1:n_mv] = rng.integers(-max_mv, max_mv + 1, (n_mv - 1, 2))
    mb_idx = (rng.integers(0, n_mv, (mb_h, mb_w)).astype(np.int32)
              * (1 if is_p else 0))
    mb_mv = mv_table[mb_idx]

    comps = {}
    for key, rep in (("y", 2), ("cb", 1), ("cr", 1)):
        bh, bw = mb_h * rep, mb_w * rep
        h, w = bh * 8, bw * 8
        levels = np.zeros((h, w), dtype=np.int16)
        # low-frequency coefficients in each block
        lv = rng.integers(-80, 81, (bh, bw, 3, 3)).astype(np.int16)
        levels.reshape(bh, 8, bw, 8).swapaxes(1, 2)[:, :, :3, :3] = lv
        lnz = rng.integers(1, 12, (bh, bw)).astype(np.uint8)
        if is_p:
            intra = (rng.random((bh, bw)) < 0.05).astype(np.uint8)
        else:
            intra = np.ones((bh, bw), dtype=np.uint8)

        def up(a):
            return np.repeat(np.repeat(a, rep, axis=0), rep, axis=1)

        comps[key] = dict(
            levels=levels,
            lnz=lnz,
            q=np.full((bh, bw), 8, dtype=np.uint8),
            intra=intra,
            mv=up(mb_mv).astype(np.int16),
            rep_add=(intra * (1 if is_p else 0)).astype(np.uint8),
        )
    comps["is_p"] = np.int32(1 if is_p else 0)
    f_code = 1
    while (16 << (f_code - 1)) - 1 < 2 * max_mv:   # mv units are half-pel
        f_code += 1
    comps["f_code"] = np.int32(f_code if is_p else 0)
    return comps


def synthetic_gop(n_frames: int = 2, mb_h: int = 68, mb_w: int = 120,
                  max_mv: int = 20, mv_capacity: int = 8,
                  seed: int = 40) -> dict:
    """An I picture then P pictures (``seed + i`` each), stacked on a
    leading frame axis; the defaults are a 1920x1088 GOP of two."""
    frames = [synthetic_frame_inputs(mb_h, mb_w, is_p=i > 0, seed=seed + i,
                                     max_mv=max_mv, mv_capacity=mv_capacity)
              for i in range(n_frames)]

    def stack(parts):
        return {k: stack([p[k] for p in parts]) if isinstance(v, dict)
                else np.stack([p[k] for p in parts])
                for k, v in parts[0].items()}

    return stack(frames)


#: :func:`colour_triples`'s plane shapes: 256**3 luma samples, a quarter
#: as many of each chroma plane
TRIPLES_LUMA = (512, 32768)
TRIPLES_CHROMA = (256, 16384)


def colour_triples() -> tuple:
    """(Y, Cb, Cr) uint8 planes of 512x32768 and 256x16384 holding every
    (Y, Cb, Cr) triple once under nearest 2x chroma upsampling: chroma
    sample i (row-major) has (Cb, Cr) = (i % 256, (i // 256) % 256), and
    the four luma samples it covers take the values 4 * (i // 65536) + 0,
    1 (top row), 2, 3 (bottom row).  A row band of 2k luma rows and the
    k chroma rows under it converts on its own."""
    i = np.arange(TRIPLES_CHROMA[0] * TRIPLES_CHROMA[1], dtype=np.int64)
    cb = (i & 255).astype(np.uint8).reshape(TRIPLES_CHROMA)
    cr = ((i >> 8) & 255).astype(np.uint8).reshape(TRIPLES_CHROMA)
    base = (4 * (i >> 16)).reshape(TRIPLES_CHROMA)
    y = np.empty(TRIPLES_LUMA, np.uint8)
    for dy in (0, 1):
        for dx in (0, 1):
            y[dy::2, dx::2] = base + 2 * dy + dx
    return y, cb, cr
