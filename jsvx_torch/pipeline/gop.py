"""GOP-level recurrent decode.

A Python loop over the frames of a GOP with the reconstructed planes as
the carry (the JAX package's ``lax.scan`` in ``jsvx/pipeline/gop.py``): I
frames ignore the carry (their prediction term is zeroed), P frames
predict from it.  ``impl`` picks the per-frame decode:

* ``"fused"`` (the default): one launch of the fused decode kernel per
  picture (:mod:`jsvx_torch.kernels.fused`), jsvx's ``impl="fused"``;
* ``"two_kernel"``: one launch of the MC kernel then one of the
  reconstruction kernel per picture (:mod:`jsvx_torch.kernels.recon`),
  jsvx's ``impl="pallas"``, renamed because no Pallas runs here.

Both sum the IDCT in one order and dequantise by one rule, so they agree
bit for bit.  On the CPU both run their plain versions.
:func:`decode_gop_wire` and :func:`decode_gop_batch` are the bodies of
the GOP programs (:mod:`jsvx_torch.pipeline.program`), captured once per
wire layout on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.decode import DecodeConstants, frame_comp_keys
from ..kernels.expand import expand_compact_gop
from ..kernels.fused import decode_frame_planes_fused
from ..kernels.recon import decode_frame_planes_two_kernel
from .wire import unflatten_wire

#: per-frame decode of each ``impl``
FRAME_DECODERS = {"fused": decode_frame_planes_fused,
                  "two_kernel": decode_frame_planes_two_kernel}


def frame_decoder(impl: str):
    """The per-frame decode function of ``impl``."""
    try:
        return FRAME_DECODERS[impl]
    except KeyError:
        raise ValueError(f"impl must be one of {sorted(FRAME_DECODERS)}, "
                         f"got {impl!r}") from None


def stack_device_frames(frames: list[dict]) -> dict:
    """Per-frame dicts (from ``frame_to_device``, numpy) -> one dict of
    stacks on a leading frame axis."""
    first = frames[0]
    return {k: (stack_device_frames([f[k] for f in frames])
                if isinstance(v, dict)
                else np.stack([np.asarray(f[k]) for f in frames]))
            for k, v in first.items()}


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


def gop_at(batch: dict, g: int) -> dict:
    """GOP ``g`` of a batch whose leaves lead with the GOP axis."""
    return {k: gop_at(v, g) if isinstance(v, dict) else v[g]
            for k, v in batch.items()}


def decode_gop(dense: dict, refs: tuple, consts: DecodeConstants,
               quirk_oddify_zeros: bool = False,
               impl: str = "fused", outs: tuple | None = None) -> tuple:
    """Decode a stacked GOP; returns ((Y, Cb, Cr[, A]) stacks, final refs).

    ``dense`` holds per-frame stacks on a leading axis (the output of
    :func:`jsvx_torch.kernels.expand.expand_compact_gop`, or a stacked
    dense GOP).  Each frame's planes are written straight into the output
    stacks (``outs`` if given, else new ones), and the next frame
    predicts from those rows.
    """
    decode_frame = frame_decoder(impl)
    n_comps = len(frame_comp_keys(dense))
    n = dense["is_p"].shape[0]
    if outs is None:
        outs = tuple(torch.empty((n,) + tuple(r.shape), dtype=torch.uint8,
                                 device=r.device) for r in refs[:n_comps])
    for i in range(n):
        refs = decode_frame(frame_at(dense, i), refs, consts,
                            quirk_oddify_zeros,
                            outs=tuple(o[i] for o in outs))
    return outs, refs


def decode_gop_batch(batch: dict, refs: tuple, consts: DecodeConstants,
                     quirk_oddify_zeros: bool = False,
                     impl: str = "fused") -> tuple:
    """Decode G GOPs stacked on a leading axis (leaves ``(G, F, ...)``),
    each from ``refs``, one after the other; returns (G, F, H, W) stacks
    per plane (jsvx vmaps its GOP scan over the same axis)."""
    n_comps = len(frame_comp_keys(batch))
    g, n = batch["is_p"].shape[:2]
    outs = tuple(torch.empty((g, n) + tuple(r.shape), dtype=torch.uint8,
                             device=r.device) for r in refs[:n_comps])
    for i in range(g):
        decode_gop(gop_at(batch, i), refs, consts, quirk_oddify_zeros, impl,
                   outs=tuple(o[i] for o in outs))
    return outs


def decode_gop_wire(buf: torch.Tensor, spec: tuple, refs: tuple,
                    consts: DecodeConstants, mb_h: int, mb_w: int,
                    quirk_oddify_zeros: bool = False,
                    impl: str = "fused") -> tuple:
    """Decode a GOP shipped as one uint8 wire tensor.

    A compact wire (it holds ``coef``) has its coefficients expanded on
    the device first (on a card one launch of the expansion kernel, whose
    inputs are views of ``buf``); a dense wire (stacked
    ``frame_to_device`` dicts) goes straight to the GOP loop.  The oddify-zeros quirk needs the dense
    wire: it changes positions the compact wire does not carry.
    """
    stacked = unflatten_wire(buf, spec)
    if "coef" in stacked:
        if quirk_oddify_zeros:
            raise ValueError("the oddify-zeros quirk needs the dense wire")
        stacked = expand_compact_gop(stacked, mb_h, mb_w)
    return decode_gop(stacked, refs, consts, quirk_oddify_zeros, impl)
