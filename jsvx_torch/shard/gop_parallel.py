"""GOP-parallel decode: independent GOPs split across ranks.

The port of ``jsvx/shard/gop_parallel.py``.  GOPs are closed decode units
(I-led, per-slice predictor resets), so a batch of GOPs splits on its
leading axis with no communication inside a step.  Each rank decodes its
GOPs one after the other through the single-device GOP loop
(:func:`jsvx_torch.pipeline.gop.decode_gop`), where jsvx vmaps them; on a
card that is one launch of the fused decode kernel per picture.
"""

from __future__ import annotations

import torch

from ..kernels.decode import DecodeConstants, frame_comp_keys
from ..pipeline.gop import decode_gop, zero_refs
from .mesh import Mesh
from .slice_rows import cut_band, gop_at, stack_gops


def decode_gops_parallel(batch: dict, coded_h: int, coded_w: int,
                         consts: DecodeConstants, mesh: Mesh,
                         axis: str = "gop",
                         quirk_oddify_zeros: bool = False,
                         device="cuda") -> tuple:
    """Decode this rank's share of a batch of GOPs split over ``axis``.

    ``batch`` leaves lead with ``(n_gops, n_frames, ...)`` (numpy or
    tensors); ``n_gops`` must divide by the axis's size (pad a short batch
    with repeated GOPs and drop the extras).  Each of this rank's GOPs is
    decoded on ``device`` from zero reference planes by the fused kernel.
    Returns (stacked planes (GOPs, frames, H, W) per plane, final planes
    (GOPs, H, W) per plane, the GOPs' indices in the batch).
    """
    device = torch.device(device)
    n_comps = len(frame_comp_keys(batch))
    gops = mesh.shard_range(batch["is_p"].shape[0], axis)
    return (*stack_gops([decode_gop(
        cut_band(gop_at(batch, g), 0, 1, device),
        zero_refs(coded_h, coded_w, n_comps, device), consts,
        quirk_oddify_zeros, "fused") for g in gops]), gops)
