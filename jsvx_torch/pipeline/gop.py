"""GOP-level recurrent decode.

A Python loop over the frames of a GOP with the reconstructed planes as
the carry (the JAX package's ``lax.scan`` in ``jsvx/pipeline/gop.py``): I
frames ignore the carry (their prediction term is zeroed), P frames
predict from it.  Each plane of each frame is one call of the fused
decode (the hand-written kernel on CUDA, its plain version on the CPU).
"""

from __future__ import annotations

import torch

from ..kernels.decode import DecodeConstants, frame_comp_keys
from ..kernels.expand import expand_compact_gop
from ..kernels.fused import decode_frame_planes_fused
from .wire import unflatten_wire


def zero_refs(coded_h: int, coded_w: int, n_comps: int, device) -> tuple:
    """All-zero reference planes (Y, Cb, Cr[, A]) for the start of a GOP."""
    shapes = [(coded_h, coded_w), (coded_h // 2, coded_w // 2),
              (coded_h // 2, coded_w // 2), (coded_h, coded_w)][:n_comps]
    return tuple(torch.zeros(s, dtype=torch.uint8, device=device)
                 for s in shapes)


def frame_at(dense: dict, i: int) -> dict:
    """Frame ``i`` of a stacked GOP, as the frame dict the decode takes."""
    frame = {k: {f: v[i] for f, v in dense[k].items()}
             for k in frame_comp_keys(dense)}
    frame["is_p"] = dense["is_p"][i]
    return frame


def decode_gop(dense: dict, refs: tuple, consts: DecodeConstants,
               quirk_oddify_zeros: bool = False) -> tuple:
    """Decode a stacked GOP; returns ((Y, Cb, Cr[, A]) stacks, final refs).

    ``dense`` holds per-frame stacks on a leading axis (the output of
    :func:`jsvx_torch.kernels.expand.expand_compact_gop`).  Each frame's
    planes are written straight into the output stacks, and the next
    frame predicts from those rows.
    """
    n_comps = len(frame_comp_keys(dense))
    n = dense["is_p"].shape[0]
    outs = tuple(torch.empty((n,) + tuple(r.shape), dtype=torch.uint8,
                             device=r.device) for r in refs[:n_comps])
    for i in range(n):
        refs = decode_frame_planes_fused(
            frame_at(dense, i), refs, consts, quirk_oddify_zeros,
            outs=tuple(o[i] for o in outs))
    return outs, refs


def decode_gop_wire(buf: torch.Tensor, spec: tuple, refs: tuple,
                    consts: DecodeConstants, mb_h: int, mb_w: int) -> tuple:
    """Decode a compact GOP shipped as one uint8 wire tensor: unpack,
    expand the coefficients, run the GOP loop."""
    dense = expand_compact_gop(unflatten_wire(buf, spec), mb_h, mb_w)
    return decode_gop(dense, refs, consts)
