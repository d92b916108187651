"""Wrapper of the motion-compensation kernel (``csrc/mc.cu``).

The first kernel of the two-kernel route: the half-pel prediction plane
of one plane of one picture, int16, as the port of
``jsvx/kernels/pallas_mc.py`` (``predict_plane_mvset_pallas``).  It reads
per-block vectors, so it needs no distinct-vector table and has no cap on
the number of distinct vectors.

A tensor on the CPU goes to the plain version
(:func:`jsvx_torch.kernels.decode.predict_plane`, cast to int16).  A
tensor on a CUDA device launches the kernel or raises; there is no
fallback.  ``launches`` counts the kernel's launches, and nothing else.
"""

from __future__ import annotations

import torch

from .decode import predict_plane
from .fused import check_tensor

#: number of kernel launches in this process (reset it to 0 to count a run)
launches = 0


def predict_plane_mc(ref: torch.Tensor, mv_blk: torch.Tensor,
                     rep_add_blk: torch.Tensor, is_chroma: bool,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Half-pel prediction of a plane -> int16 (h, w) (``out`` if given).

    ``ref`` is the previous plane (uint8 (h, w)); ``mv_blk`` the per-block
    vector in luma half-pel units (int16 (h/8, w/8, 2)); ``rep_add_blk``
    uint8 (h/8, w/8), where set the prediction is 0.
    """
    global launches
    device = ref.device
    if device.type == "cpu":
        pred = predict_plane(ref, mv_blk, rep_add_blk, is_chroma)
        if out is None:
            return pred.to(torch.int16)
        out.copy_(pred)
        return out
    if device.type != "cuda":
        raise ValueError(f"no motion-compensation kernel for device "
                         f"{device}")

    h, w = ref.shape
    if h % 8 or w % 8:
        raise ValueError(f"plane {h}x{w} is not a multiple of 8")
    hb, wb = h // 8, w // 8
    check_tensor("ref", ref, torch.uint8, (h, w), device)
    check_tensor("mv", mv_blk, torch.int16, (hb, wb, 2), device)
    check_tensor("rep_add", rep_add_blk, torch.uint8, (hb, wb), device)
    if out is None:
        out = torch.empty((h, w), dtype=torch.int16, device=device)
    else:
        check_tensor("out", out, torch.int16, (h, w), device)

    from .build import load

    lib = load().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.jsvx_mc_plane(ref.data_ptr(), mv_blk.data_ptr(),
                           rep_add_blk.data_ptr(), out.data_ptr(), h, w,
                           int(is_chroma), device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"motion-compensation kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return out
