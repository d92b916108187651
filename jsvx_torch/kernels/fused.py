"""Wrapper of the fused decode kernel (``csrc/fused_decode.cu``).

One plane of one picture -> reconstructed uint8 plane, in one kernel: the
port of ``jsvx/kernels/pallas_fused.py`` (``fused_decode_plane`` and its
per-frame function ``decode_frame_planes_fused``).

A tensor on the CPU goes to the plain version
(:func:`jsvx_torch.kernels.decode.decode_frame_plane`).  A tensor on a CUDA
device launches the kernel or raises; there is no fallback.  ``launches``
counts the kernel's launches, and nothing else.
"""

from __future__ import annotations

import torch

from .decode import (DecodeConstants, comp_is_chroma, decode_frame_plane,
                     frame_comp_keys)

#: number of kernel launches in this process (reset it to 0 to count a run)
launches = 0


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what every kernel wrapper checks before a launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_is_p(is_p: torch.Tensor, device) -> None:
    if is_p.device != device or is_p.dtype != torch.int32 \
            or is_p.numel() != 1:
        raise ValueError("is_p must be one int32 element on the plane's "
                         "device")


def fused_decode_plane(comp_inputs: dict, ref: torch.Tensor,
                       is_p: torch.Tensor, consts: DecodeConstants,
                       is_chroma: bool, quirk_oddify_zeros: bool = False,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """One plane of one picture -> uint8 plane (``out`` if given).

    ``comp_inputs`` holds the per-block grids of the plane: ``levels``
    int16 (h, w); ``lnz``, ``q``, ``intra``, ``rep_add`` uint8 (h/8, w/8);
    ``mv`` int16 (h/8, w/8, 2).  ``ref`` is the previous plane (uint8
    (h, w)); ``is_p`` an int32 tensor of one element.
    """
    global launches
    device = ref.device
    if device.type == "cpu":
        plane = decode_frame_plane(comp_inputs, ref, is_p, consts,
                                   is_chroma, quirk_oddify_zeros)
        if out is None:
            return plane
        out.copy_(plane)
        return out
    if device.type != "cuda":
        raise ValueError(f"no fused decode kernel for device {device}")

    h, w = ref.shape
    hb, wb = h // 8, w // 8
    if h % 8 or w % 8:
        raise ValueError(f"plane {h}x{w} is not a multiple of 8")
    c = comp_inputs
    check_tensor("levels", c["levels"], torch.int16, (h, w), device)
    for key in ("lnz", "q", "intra", "rep_add"):
        check_tensor(key, c[key], torch.uint8, (hb, wb), device)
    check_tensor("mv", c["mv"], torch.int16, (hb, wb, 2), device)
    check_tensor("ref", ref, torch.uint8, (h, w), device)
    check_is_p(is_p, device)
    qtab, c_basis = consts.qtab, consts.c_basis
    check_tensor("qtab", qtab, torch.int32, (3, 64), device)
    check_tensor("c_basis", c_basis, torch.float32, (8, 8), device)
    if out is None:
        out = torch.empty((h, w), dtype=torch.uint8, device=device)
    else:
        check_tensor("out", out, torch.uint8, (h, w), device)

    from .build import load

    lib = load().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.jsvx_fused_decode_plane(
        c["levels"].data_ptr(), c["lnz"].data_ptr(), c["q"].data_ptr(),
        c["intra"].data_ptr(), c["mv"].data_ptr(), c["rep_add"].data_ptr(),
        ref.data_ptr(), is_p.data_ptr(), qtab.data_ptr(),
        c_basis.data_ptr(), out.data_ptr(), h, w, int(is_chroma),
        int(quirk_oddify_zeros), device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"fused decode kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return out


def decode_frame_planes_fused(frame: dict, refs: tuple,
                              consts: DecodeConstants,
                              quirk_oddify_zeros: bool = False,
                              outs: tuple | None = None) -> tuple:
    """All planes of one picture, one kernel launch per plane."""
    return tuple(
        fused_decode_plane(frame[k], refs[i], frame["is_p"], consts,
                           comp_is_chroma(i), quirk_oddify_zeros,
                           out=None if outs is None else outs[i])
        for i, k in enumerate(frame_comp_keys(frame)))
