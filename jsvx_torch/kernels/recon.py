"""The two-kernel route: sideband expansion, reconstruction kernel wrapper
(``csrc/recon.cu``) and its per-frame driver.

The port of ``jsvx/kernels/pallas_decode.py`` (jsvx's ``impl="pallas"``).
Per plane: :func:`expand_sideband` turns the per-block grids into
per-pixel ``mult`` (q * M) and ``flags`` planes (torch ops), the MC kernel
(:mod:`jsvx_torch.kernels.mc`) computes the int16 prediction, and the
reconstruction kernel dequantises, runs the 8x8 IDCT, adds the
prediction, rounds and clamps.

:func:`recon_plane` is the reconstruction kernel's plain version.  It
follows the spec's mismatch control (``sign(d)``), where jsvx's
``_recon_kernel`` subtracts ``sign(level)``, and sums the IDCT in the
fused route's fixed order, so the two routes agree bit for bit.

A tensor on the CPU goes to the plain version.  A tensor on a CUDA device
launches the kernel or raises; there is no fallback.  ``launches`` counts
the reconstruction kernel's launches, and nothing else.
"""

from __future__ import annotations

import torch

from .decode import (DecodeConstants, comp_is_chroma, dequant_values,
                     frame_comp_keys, idct_plane)
from .fused import check_is_p, check_tensor
from .mc import predict_plane_mc

#: number of kernel launches in this process (reset it to 0 to count a run)
launches = 0


def expand_sideband(comp_inputs: dict, consts: DecodeConstants) -> tuple:
    """Per-block sideband -> per-pixel (mult int16, flags uint8) planes.

    ``mult`` = q * (intra or non-intra matrix value); ``flags`` bit0
    non-intra, bit1 inside the coded scan (scan position < lnz), bit2 the
    intra DC position.  Bit-equal to jsvx's ``expand_sideband``.
    """
    q = comp_inputs["q"]
    hb, wb = q.shape
    h, w = hb * 8, wb * 8

    def up(a):
        return a.to(torch.int32)[:, None, :, None]

    qtab = consts.qtab.to(q.device)
    mi = qtab[0].reshape(1, 8, 1, 8)
    mn = qtab[1].reshape(1, 8, 1, 8)
    scan = qtab[2].reshape(1, 8, 1, 8)
    intra = up(comp_inputs["intra"]) > 0
    mult = up(q) * torch.where(intra, mi, mn)
    flags = (torch.where(intra, 0, 1)
             + torch.where(scan < up(comp_inputs["lnz"]), 2, 0)
             + torch.where((scan == 0) & intra, 4, 0))
    return (mult.to(torch.int16).reshape(h, w),
            flags.to(torch.uint8).reshape(h, w))


def dequant_sideband(levels: torch.Tensor, mult: torch.Tensor,
                     flags: torch.Tensor, quirk: bool = False
                     ) -> torch.Tensor:
    """int16 levels + per-pixel sideband -> int32 dequantised plane: the
    same values as :func:`jsvx_torch.kernels.decode.dequant_plane` on the
    per-block grids the sideband was expanded from."""
    lv = levels.to(torch.int32)
    fl = flags.to(torch.int32)
    d = dequant_values(lv, mult.to(torch.int32), (fl & 1) != 0, quirk)
    d = torch.where((fl & 2) != 0, d, 0)
    return torch.where((fl & 4) != 0, 8 * lv, d)


def recon_plane(levels: torch.Tensor, mult: torch.Tensor,
                flags: torch.Tensor, pred: torch.Tensor, is_p: torch.Tensor,
                consts: DecodeConstants,
                quirk: bool = False) -> torch.Tensor:
    """Dequantise from ``mult``/``flags``, IDCT, add ``pred`` (zeroed for
    an I picture by ``is_p``), round, clamp -> uint8 plane."""
    d = dequant_sideband(levels, mult, flags, quirk)
    res = idct_plane(d.to(torch.float32), consts)
    p = pred.to(torch.int32) * is_p.to(torch.int32)
    out = torch.round(p.to(torch.float32) + res)
    return out.clamp(0.0, 255.0).to(torch.uint8)


def fused_recon_plane(levels: torch.Tensor, mult: torch.Tensor,
                      flags: torch.Tensor, pred: torch.Tensor,
                      is_p: torch.Tensor, consts: DecodeConstants,
                      quirk: bool = False,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """One plane -> uint8 (h, w) (``out`` if given).

    ``levels``, ``mult`` int16 (h, w); ``flags`` uint8 (h, w); ``pred``
    int16 (h, w), the MC kernel's output; ``is_p`` an int32 tensor of one
    element.
    """
    global launches
    device = levels.device
    if device.type == "cpu":
        plane = recon_plane(levels, mult, flags, pred, is_p, consts, quirk)
        if out is None:
            return plane
        out.copy_(plane)
        return out
    if device.type != "cuda":
        raise ValueError(f"no reconstruction kernel for device {device}")

    h, w = levels.shape
    if h % 8 or w % 8:
        raise ValueError(f"plane {h}x{w} is not a multiple of 8")
    check_tensor("levels", levels, torch.int16, (h, w), device)
    check_tensor("mult", mult, torch.int16, (h, w), device)
    check_tensor("flags", flags, torch.uint8, (h, w), device)
    check_tensor("pred", pred, torch.int16, (h, w), device)
    check_is_p(is_p, device)
    c_basis = consts.c_basis
    check_tensor("c_basis", c_basis, torch.float32, (8, 8), device)
    if out is None:
        out = torch.empty((h, w), dtype=torch.uint8, device=device)
    else:
        check_tensor("out", out, torch.uint8, (h, w), device)

    from .build import load

    lib = load().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.jsvx_recon_plane(
        levels.data_ptr(), mult.data_ptr(), flags.data_ptr(),
        pred.data_ptr(), is_p.data_ptr(), c_basis.data_ptr(),
        out.data_ptr(), h, w, int(quirk), device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"reconstruction kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return out


def decode_frame_plane_two_kernel(comp_inputs: dict, ref: torch.Tensor,
                                  is_p: torch.Tensor,
                                  consts: DecodeConstants, is_chroma: bool,
                                  quirk_oddify_zeros: bool = False,
                                  out: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """One plane of one picture through MC then reconstruction.

    Parser-emitted ``mult``/``flags`` are used when ``comp_inputs``
    carries them; otherwise they are expanded from the per-block grids.
    """
    if "mult" in comp_inputs:
        mult, flags = comp_inputs["mult"], comp_inputs["flags"]
    else:
        mult, flags = expand_sideband(comp_inputs, consts)
    pred = predict_plane_mc(ref, comp_inputs["mv"], comp_inputs["rep_add"],
                            is_chroma)
    return fused_recon_plane(comp_inputs["levels"], mult, flags, pred, is_p,
                             consts, quirk_oddify_zeros, out=out)


def decode_frame_planes_two_kernel(frame: dict, refs: tuple,
                                   consts: DecodeConstants,
                                   quirk_oddify_zeros: bool = False,
                                   outs: tuple | None = None) -> tuple:
    """All planes of one picture, two kernel launches per plane."""
    return tuple(
        decode_frame_plane_two_kernel(
            frame[k], refs[i], frame["is_p"], consts, comp_is_chroma(i),
            quirk_oddify_zeros, out=None if outs is None else outs[i])
        for i, k in enumerate(frame_comp_keys(frame)))
