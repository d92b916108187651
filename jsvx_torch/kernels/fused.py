"""Wrapper of the fused decode kernel (``csrc/fused_decode.cu``).

The planes of one picture -> reconstructed uint8 planes, in one kernel
launch: the port of ``jsvx/kernels/pallas_fused.py`` (its per-frame
``decode_frame_planes_fused``; ``fused_decode_plane`` is the one-plane
case of the same launch).

A tensor on the CPU goes to the plain version
(:func:`jsvx_torch.kernels.decode.decode_frame_plane`, per plane).  A
tensor on a CUDA device launches the kernel or raises; there is no
fallback.  ``launches`` counts the kernel's launches, one per picture, and
nothing else.

The launch layout (:func:`picture_layout`) is computed here and checked
by the kernel's entry point: a warp decodes four 8x8 blocks side by side
in one block row, a CTA four warps, and the planes' CTAs follow one
another, so a CTA finds its plane from the prefix of CTA counts
(:func:`plane_of_cta`).  The MC and reconstruction kernels of the
two-kernel route (:mod:`jsvx_torch.kernels.mc`,
:mod:`jsvx_torch.kernels.recon`) launch on the same layout
(``csrc/picture_layout.cuh``), through :func:`launch_dims`.
"""

from __future__ import annotations

import ctypes

import torch

from . import counters
from .decode import (DecodeConstants, comp_is_chroma, decode_frame_plane,
                     frame_comp_keys)

#: number of kernel launches in this process (reset it to 0 to count a run)
launches = 0
counters.register("fused", __name__, "launches")

#: the picture kernels' layout constants (``csrc/picture_layout.cuh``)
MAX_PLANES = 4
WARPS_PER_CTA = 4
BLOCKS_PER_WARP = 4


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


def check_aligned(name: str, t: torch.Tensor, align: int) -> None:
    """Raise unless ``t`` starts on an ``align``-byte boundary: what a
    kernel's vector loads and stores need."""
    if t.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned")


def check_plane_shape(h: int, w: int) -> None:
    if h % 8 or w % 8:
        raise ValueError(f"plane {h}x{w} is not a multiple of 8")


def plane_ctas(h: int, w: int) -> int:
    """CTAs of one (h, w) plane: a warp task per four blocks of a block
    row, four warp tasks per CTA."""
    groups = -(-(w // 8) // BLOCKS_PER_WARP)
    return -(-((h // 8) * groups) // WARPS_PER_CTA)


def picture_layout(shapes) -> tuple:
    """Plane shapes -> (first CTA of each plane, total CTAs)."""
    begins, total = [], 0
    for h, w in shapes:
        begins.append(total)
        total += plane_ctas(h, w)
    return tuple(begins), total


def plane_of_cta(begins, cta: int) -> int:
    """The plane a CTA decodes: the last plane whose first CTA is at or
    before it (the kernel's search)."""
    p = 0
    for i in range(1, len(begins)):
        if cta >= begins[i]:
            p = i
    return p


def cta_blocks(h: int, w: int, cta: int) -> list:
    """The (block row, block column) pairs CTA ``cta`` of an (h, w) plane
    decodes, counted from the plane's first CTA (the kernel's index
    math; lanes past the plane's edge decode nothing)."""
    hb, wb = h // 8, w // 8
    groups = -(-wb // BLOCKS_PER_WARP)
    out = []
    for warp in range(WARPS_PER_CTA):
        task = cta * WARPS_PER_CTA + warp
        by = task // groups
        for b in range(BLOCKS_PER_WARP):
            bx = (task - by * groups) * BLOCKS_PER_WARP + b
            if by < hb and bx < wb:
                out.append((by, bx))
    return out


def launch_dims(planes) -> tuple:
    """(h, w, is_chroma) of each plane of one launch -> the entry point's
    ``dims`` (h, w, is_chroma and first CTA per plane) and the total CTAs:
    the layout every picture kernel (fused, MC, reconstruction) takes."""
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"{len(planes)} planes; a picture kernel takes 1 "
                         f"to {MAX_PLANES}")
    begins, total = picture_layout([(h, w) for h, w, _ in planes])
    dims = []
    for (h, w, chroma), begin in zip(planes, begins):
        dims += [h, w, int(chroma), begin]
    return (ctypes.c_int * len(dims))(*dims), total


def _check_plane(c: dict, ref: torch.Tensor, out, device) -> torch.Tensor:
    h, w = ref.shape
    check_plane_shape(h, w)
    hb, wb = h // 8, w // 8
    check_tensor("levels", c["levels"], torch.int16, (h, w), device)
    for key in ("lnz", "q", "intra", "rep_add"):
        check_tensor(key, c[key], torch.uint8, (hb, wb), device)
    check_tensor("mv", c["mv"], torch.int16, (hb, wb, 2), device)
    check_tensor("ref", ref, torch.uint8, (h, w), device)
    if out is None:
        out = torch.empty((h, w), dtype=torch.uint8, device=device)
    else:
        check_tensor("out", out, torch.uint8, (h, w), device)
    for name, t, align in (("levels", c["levels"], 16), ("mv", c["mv"], 4),
                           ("ref", ref, 8), ("out", out, 8)):
        check_aligned(name, t, align)
    return out


def _launch_picture(planes: list, is_p: torch.Tensor,
                    consts: DecodeConstants, quirk: bool) -> list:
    """One launch over ``planes``, each (comp_inputs, ref, out or None,
    is_chroma), all on one CUDA device; returns the output planes."""
    global launches
    device = planes[0][1].device
    if device.type != "cuda":
        raise ValueError(f"no fused decode kernel for device {device}")
    dims, total = launch_dims([(*ref.shape, chroma)
                               for _, ref, _, chroma in planes])
    check_is_p(is_p, device)
    outs, ptrs = [], []
    for c, ref, out, chroma in planes:
        out = _check_plane(c, ref, out, device)
        outs.append(out)
        ptrs += [c["levels"].data_ptr(), c["lnz"].data_ptr(),
                 c["q"].data_ptr(), c["intra"].data_ptr(),
                 c["mv"].data_ptr(), c["rep_add"].data_ptr(),
                 ref.data_ptr(), out.data_ptr()]

    from .build import load

    lib = load().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.jsvx_fused_decode_picture(
        len(planes), (ctypes.c_void_p * len(ptrs))(*ptrs), dims, total,
        is_p.data_ptr(),
        (ctypes.c_int * 192)(*consts.qtab_host),
        (ctypes.c_float * 64)(*consts.c_basis_host),
        int(quirk), device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"fused decode kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return outs


def fused_decode_plane(comp_inputs: dict, ref: torch.Tensor,
                       is_p: torch.Tensor, consts: DecodeConstants,
                       is_chroma: bool, quirk_oddify_zeros: bool = False,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """One plane of one picture -> uint8 plane (``out`` if given): the
    one-plane case of :func:`decode_frame_planes_fused`.

    ``comp_inputs`` holds the per-block grids of the plane: ``levels``
    int16 (h, w); ``lnz``, ``q``, ``intra``, ``rep_add`` uint8 (h/8, w/8);
    ``mv`` int16 (h/8, w/8, 2).  ``ref`` is the previous plane (uint8
    (h, w)); ``is_p`` an int32 tensor of one element.
    """
    if ref.device.type == "cpu":
        plane = decode_frame_plane(comp_inputs, ref, is_p, consts,
                                   is_chroma, quirk_oddify_zeros)
        if out is None:
            return plane
        out.copy_(plane)
        return out
    return _launch_picture([(comp_inputs, ref, out, is_chroma)], is_p,
                           consts, quirk_oddify_zeros)[0]


def decode_frame_planes_fused(frame: dict, refs: tuple,
                              consts: DecodeConstants,
                              quirk_oddify_zeros: bool = False,
                              outs: tuple | None = None) -> tuple:
    """All planes of one picture: one kernel launch on a card, the plain
    version plane by plane on the CPU."""
    keys = frame_comp_keys(frame)
    if refs[0].device.type == "cpu":
        return tuple(
            fused_decode_plane(frame[k], refs[i], frame["is_p"], consts,
                               comp_is_chroma(i), quirk_oddify_zeros,
                               out=None if outs is None else outs[i])
            for i, k in enumerate(keys))
    return tuple(_launch_picture(
        [(frame[k], refs[i], None if outs is None else outs[i],
          comp_is_chroma(i)) for i, k in enumerate(keys)],
        frame["is_p"], consts, quirk_oddify_zeros))
