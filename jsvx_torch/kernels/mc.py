"""Wrapper of the motion-compensation kernel (``csrc/mc.cu``).

The first kernel of the two-kernel route: the int16 half-pel prediction
planes of every plane of one picture in one launch
(:func:`predict_picture_mc`; :func:`predict_plane_mc` is the one-plane case
of the same launch), as the port of ``jsvx/kernels/pallas_mc.py``
(``predict_plane_mvset_pallas``, one plane per call).  It reads per-block
vectors, so it needs no distinct-vector table and has no cap on the number
of distinct vectors.  The launch layout is the fused kernel's
(:func:`jsvx_torch.kernels.fused.launch_dims`).

A tensor on the CPU goes to the plain version
(:func:`jsvx_torch.kernels.decode.predict_plane`, cast to int16, plane by
plane).  A tensor on a CUDA device launches the kernel or raises; there is
no fallback.  ``launches`` counts the kernel's launches, one per picture,
and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import counters
from .decode import comp_is_chroma, frame_comp_keys, predict_plane
from .fused import check_aligned, check_plane_shape, check_tensor, launch_dims

#: number of kernel launches in this process (reset it to 0 to count a run)
launches = 0
counters.register("mc", __name__, "launches")


def check_mc_plane(ref: torch.Tensor, mv_blk: torch.Tensor,
                   rep_add_blk: torch.Tensor, out: torch.Tensor | None,
                   device) -> torch.Tensor:
    """Raise unless one plane's tensors are what the kernel takes: all on
    ``device``, contiguous, ``ref`` uint8 (h, w) with h and w multiples of
    8 and 8-byte aligned, ``mv_blk`` int16 (h/8, w/8, 2) 4-byte aligned,
    ``rep_add_blk`` uint8 (h/8, w/8), ``out`` int16 (h, w) 16-byte aligned.
    Returns ``out``, allocated when None."""
    if ref.dim() != 2:
        raise ValueError(f"ref has {ref.dim()} dimensions, expected 2")
    h, w = ref.shape
    check_plane_shape(h, w)
    check_tensor("ref", ref, torch.uint8, (h, w), device)
    check_tensor("mv", mv_blk, torch.int16, (h // 8, w // 8, 2), device)
    check_tensor("rep_add", rep_add_blk, torch.uint8, (h // 8, w // 8),
                 device)
    if out is None:
        out = torch.empty((h, w), dtype=torch.int16, device=device)
    else:
        check_tensor("out", out, torch.int16, (h, w), device)
    for name, t, align in (("ref", ref, 8), ("mv", mv_blk, 4),
                           ("out", out, 16)):
        check_aligned(name, t, align)
    return out


def _launch(planes: list) -> list:
    """One launch over ``planes``, each (ref, mv, rep_add, out or None,
    is_chroma), all on one CUDA device; returns the prediction planes."""
    global launches
    device = planes[0][0].device
    if device.type != "cuda":
        raise ValueError(f"no motion-compensation kernel for device "
                         f"{device}")
    outs, ptrs = [], []
    for ref, mv, rep, out, _ in planes:
        out = check_mc_plane(ref, mv, rep, out, device)
        outs.append(out)
        ptrs += [ref.data_ptr(), mv.data_ptr(), rep.data_ptr(),
                 out.data_ptr()]
    dims, total = launch_dims([(*ref.shape, chroma)
                               for ref, _, _, _, chroma in planes])

    from .build import load

    lib = load().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.jsvx_mc_picture(len(planes),
                             (ctypes.c_void_p * len(ptrs))(*ptrs), dims,
                             total, device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"motion-compensation kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return outs


def predict_plane_mc(ref: torch.Tensor, mv_blk: torch.Tensor,
                     rep_add_blk: torch.Tensor, is_chroma: bool,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Half-pel prediction of a plane -> int16 (h, w) (``out`` if given):
    the one-plane case of :func:`predict_picture_mc`.

    ``ref`` is the previous plane (uint8 (h, w)); ``mv_blk`` the per-block
    vector in luma half-pel units (int16 (h/8, w/8, 2)); ``rep_add_blk``
    uint8 (h/8, w/8), where set the prediction is 0.
    """
    if ref.device.type == "cpu":
        pred = predict_plane(ref, mv_blk, rep_add_blk, is_chroma)
        if out is None:
            return pred.to(torch.int16)
        out.copy_(pred)
        return out
    return _launch([(ref, mv_blk, rep_add_blk, out, is_chroma)])[0]


def predict_picture_mc(frame: dict, refs: tuple,
                       outs: tuple | None = None) -> tuple:
    """The int16 prediction of every plane of one picture from ``refs``
    (the previous planes; into ``outs`` if given): one kernel launch on a
    card, the plain version plane by plane on the CPU."""
    planes = [(refs[i], frame[k]["mv"], frame[k]["rep_add"],
               None if outs is None else outs[i], comp_is_chroma(i))
              for i, k in enumerate(frame_comp_keys(frame))]
    if refs[0].device.type == "cpu":
        return tuple(predict_plane_mc(ref, mv, rep, chroma, out=out)
                     for ref, mv, rep, out, chroma in planes)
    return tuple(_launch(planes))
