"""Device-side expansion of the compact coefficient wire format.

The port of ``jsvx/kernels/expand.py``, as torch ops on the wire's device
(the JAX package has no Pallas kernel here either).  The wire carries one
uint16 per coded coefficient, ``(spatial_pos:6 << 10) | (level + 512)``,
concatenated in (frame, macroblock-raster, block-within-MB) order and
padded to a bucket, plus uint8 per-block entry counts; per-macroblock
sideband is carried once per frame.  These functions rebuild exactly the
dense per-block grids the decode kernel consumes.
"""

from __future__ import annotations

import torch

from .decode import COMP_KEYS


def expand_levels(cpk: torch.Tensor, n_coef: torch.Tensor,
                  counts: torch.Tensor, mb_h: int, mb_w: int,
                  luma_like: bool) -> torch.Tensor:
    """Packed entries -> dense int16 coefficient plane stack (n, H, W).

    ``counts`` is (n_frames, n_blocks) uint8 with blocks in (mb*4 + b)
    order for luma-like components and mb order for chroma.  Entries at
    index >= ``n_coef`` (padding) go to a sacrificial slot.
    """
    device = cpk.device
    n, n_blocks = counts.shape
    rep = 2 if luma_like else 1
    hb, wb = mb_h * rep, mb_w * rep
    h, w = hb * 8, wb * 8
    n_ent = cpk.shape[0]

    # entry i's block = #{b : ends[b] <= i}: blocks are emitted in
    # increasing order, so one scatter-add of the block end positions and
    # a cumsum give the rank.  An end equal to n_ent (the last block ends
    # the buffer) is dropped into slot n_ent.
    ends = torch.cumsum(counts.reshape(-1).to(torch.int32), 0,
                        dtype=torch.int32).to(torch.int64)
    marks = torch.zeros((n_ent + 1,), dtype=torch.int32, device=device)
    marks.index_add_(0, ends.clamp(max=n_ent),
                     torch.ones_like(ends, dtype=torch.int32))
    blk = torch.cumsum(marks[:n_ent], 0, dtype=torch.int32)
    blk = blk.clamp(max=n * n_blocks - 1)
    i = torch.arange(n_ent, dtype=torch.int32, device=device)

    ent = cpk.to(torch.int32)
    zz = ent >> 10                         # spatial position in the block
    lvl = (ent & 1023) - 512

    frame = torch.div(blk, n_blocks, rounding_mode="floor")
    r = blk - frame * n_blocks
    if luma_like:
        mb = r >> 2
        b = r & 3
        by = torch.div(mb, mb_w, rounding_mode="floor") * 2 + (b >> 1)
        bx = (mb % mb_w) * 2 + (b & 1)
    else:
        by = torch.div(r, mb_w, rounding_mode="floor")
        bx = r % mb_w
    dest = (frame.to(torch.int64) * (h * w)
            + (by * 8 + (zz >> 3)).to(torch.int64) * w + bx * 8 + (zz & 7))
    dest = torch.where(i < n_coef, dest, n * h * w)

    plane = torch.zeros((n * h * w + 1,), dtype=torch.int16, device=device)
    plane[dest] = lvl.to(torch.int16)
    return plane[:-1].reshape(n, h, w)


def _up(a: torch.Tensor, rep: int, mb_h: int, mb_w: int) -> torch.Tensor:
    """Per-MB (n, mb_h, mb_w, ...) -> per-block grid (contiguous)."""
    if rep == 1:
        return a.contiguous()
    n, tail = a.shape[0], tuple(a.shape[3:])
    bc = a[:, :, None, :, None].expand((n, mb_h, rep, mb_w, rep) + tail)
    return bc.reshape((n, mb_h * rep, mb_w * rep) + tail)


def expand_compact_gop(stacked: dict, mb_h: int, mb_w: int) -> dict:
    """Compact wire dict -> the dense stacked-GOP dict the kernel eats.

    ``lnz`` is a constant full-scan mask: the expanded planes are exact
    (true zeros wherever nothing was coded).
    """
    mb = stacked["mb"]
    n = mb["q"].shape[0]
    out = {"is_p": stacked["is_p"], "f_code": stacked["f_code"]}
    for key in COMP_KEYS:
        if key not in stacked["coef"]:
            continue
        luma_like = key in ("y", "a")
        rep = 2 if luma_like else 1
        c = stacked["coef"][key]
        out[key] = dict(
            levels=expand_levels(c["cpk"], c["n"], c["counts"], mb_h, mb_w,
                                 luma_like),
            lnz=torch.full((n, mb_h * rep, mb_w * rep), 64,
                           dtype=torch.uint8, device=mb["q"].device),
            q=_up(mb["q"], rep, mb_h, mb_w),
            intra=_up(mb["intra"], rep, mb_h, mb_w),
            mv=_up(mb["mv"], rep, mb_h, mb_w),
            rep_add=_up(mb["rep_add"], rep, mb_h, mb_w),
        )
    return out
