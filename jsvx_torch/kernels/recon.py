"""The two-kernel route: sideband expansion, reconstruction kernel wrapper
(``csrc/recon.cu``) and the route's per-picture decode.

The port of ``jsvx/kernels/pallas_decode.py`` (jsvx's ``impl="pallas"``).
Per picture on a card: the MC kernel (:mod:`jsvx_torch.kernels.mc`)
computes the int16 prediction of every plane in one launch, then the
reconstruction kernel dequantises, runs the 8x8 IDCT, adds the
prediction, rounds and clamps every plane in one launch
(:func:`recon_picture`).

The reconstruction kernel reads the dequantisation sideband per block:
the ``lnz``/``q``/``intra`` grids, with the quant matrices and scan order
from the launch, as the fused kernel reads them.  jsvx's ``_recon_kernel``
takes per-pixel ``mult`` (q * M) and ``flags`` planes instead, which
:func:`expand_sideband` makes from the grids; here that expansion is
folded into the launch, so the route runs no torch op between its two
launches.  A frame that also carries the parser's per-pixel sideband
(``StreamParser(emit_sideband=True)``) decodes from its grids all the
same.  :func:`recon_plane` is the per-pixel plain version, jsvx's
interface; :func:`recon_plane_blocks`, :func:`recon_plane` on the
expanded planes, is the kernel's.

The plain versions follow the spec's mismatch control (``sign(d)``),
where jsvx's ``_recon_kernel`` subtracts ``sign(level)``, and sum the IDCT
in the fused route's fixed order, so the two routes agree bit for bit.

A tensor on the CPU goes to the plain version.  A tensor on a CUDA device
launches the kernel or raises; there is no fallback.  ``launches`` counts
the reconstruction kernel's launches, one per picture, and nothing else;
``expansions`` counts :func:`expand_sideband`'s calls.
"""

from __future__ import annotations

import ctypes

import torch

from . import counters
from .decode import (DecodeConstants, comp_is_chroma, dequant_values,
                     frame_comp_keys, idct_plane)
from .fused import (check_aligned, check_is_p, check_plane_shape,
                    check_tensor, launch_dims)
from .mc import predict_picture_mc

#: number of kernel launches in this process (reset it to 0 to count a run)
launches = 0
counters.register("recon", __name__, "launches")
#: number of :func:`expand_sideband` calls (reset it to 0 to count a run)
expansions = 0
counters.register("expansions", __name__, "expansions")


def expand_sideband(comp_inputs: dict, consts: DecodeConstants) -> tuple:
    """Per-block sideband -> per-pixel (mult int16, flags uint8) planes.

    ``mult`` = q * (intra or non-intra matrix value); ``flags`` bit0
    non-intra, bit1 inside the coded scan (scan position < lnz), bit2 the
    intra DC position.  Bit-equal to jsvx's ``expand_sideband``.
    """
    global expansions
    expansions += 1
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
    an I picture by ``is_p``), round, clamp -> uint8 plane: the per-pixel
    form's plain version."""
    d = dequant_sideband(levels, mult, flags, quirk)
    res = idct_plane(d.to(torch.float32), consts)
    p = pred.to(torch.int32) * is_p.to(torch.int32)
    out = torch.round(p.to(torch.float32) + res)
    return out.clamp(0.0, 255.0).to(torch.uint8)


def recon_plane_blocks(comp_inputs: dict, pred: torch.Tensor,
                       is_p: torch.Tensor, consts: DecodeConstants,
                       quirk: bool = False) -> torch.Tensor:
    """The per-block form's plain version: :func:`recon_plane` on the
    per-pixel planes :func:`expand_sideband` makes from the plane's
    ``lnz``/``q``/``intra`` grids."""
    return recon_plane(comp_inputs["levels"],
                       *expand_sideband(comp_inputs, consts), pred, is_p,
                       consts, quirk)


def check_recon_plane(c: dict, pred: torch.Tensor, out: torch.Tensor | None,
                      device) -> torch.Tensor:
    """Raise unless one plane's tensors are what the kernel takes: all on
    ``device``, contiguous, ``levels`` int16 (h, w) with h and w multiples
    of 8; ``lnz``, ``q``, ``intra`` uint8 (h/8, w/8); ``pred`` int16 (h,
    w); ``out`` uint8 (h, w); levels and pred 16-byte, out 8-byte aligned.
    Returns ``out``, allocated when None."""
    levels = c["levels"]
    if levels.dim() != 2:
        raise ValueError(f"levels has {levels.dim()} dimensions, expected 2")
    h, w = levels.shape
    check_plane_shape(h, w)
    check_tensor("levels", levels, torch.int16, (h, w), device)
    for key in ("lnz", "q", "intra"):
        check_tensor(key, c[key], torch.uint8, (h // 8, w // 8), device)
    check_tensor("pred", pred, torch.int16, (h, w), device)
    if out is None:
        out = torch.empty((h, w), dtype=torch.uint8, device=device)
    else:
        check_tensor("out", out, torch.uint8, (h, w), device)
    for name, t, align in (("levels", levels, 16), ("pred", pred, 16),
                           ("out", out, 8)):
        check_aligned(name, t, align)
    return out


def _launch(comps: list, preds: tuple, outs: tuple, is_p: torch.Tensor,
            consts: DecodeConstants, quirk: bool) -> list:
    """One launch over the planes ``comps`` (their predictions ``preds``,
    outputs ``outs``, each None or a tensor), all on one CUDA device;
    returns the reconstructed planes."""
    global launches
    device = comps[0]["levels"].device
    if device.type != "cuda":
        raise ValueError(f"no reconstruction kernel for device {device}")
    check_is_p(is_p, device)
    res, ptrs = [], []
    for c, pred, out in zip(comps, preds, outs, strict=True):
        out = check_recon_plane(c, pred, out, device)
        res.append(out)
        ptrs += [c["levels"].data_ptr(), c["lnz"].data_ptr(),
                 c["q"].data_ptr(), c["intra"].data_ptr(), pred.data_ptr(),
                 out.data_ptr()]
    dims, total = launch_dims([(*c["levels"].shape, comp_is_chroma(i))
                               for i, c in enumerate(comps)])

    from .build import load

    lib = load().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.jsvx_recon_picture(
        len(comps), (ctypes.c_void_p * len(ptrs))(*ptrs), dims, total,
        is_p.data_ptr(), (ctypes.c_int * 192)(*consts.qtab_host),
        (ctypes.c_float * 64)(*consts.c_basis_host), int(quirk),
        device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"reconstruction kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return res


def recon_picture(frame: dict, preds: tuple, is_p: torch.Tensor,
                  consts: DecodeConstants, quirk: bool = False,
                  outs: tuple | None = None) -> tuple:
    """Every plane of one picture from its predictions ``preds`` (int16,
    the MC kernel's output) -> uint8 planes (``outs`` if given).

    Each plane is read from its ``levels`` and per-block ``lnz``, ``q``
    and ``intra``.  One kernel launch on a card; the plain version plane
    by plane on the CPU.
    """
    comps = [frame[k] for k in frame_comp_keys(frame)]
    outs = (None,) * len(comps) if outs is None else tuple(outs)
    if comps[0]["levels"].device.type != "cpu":
        return tuple(_launch(comps, tuple(preds), outs, is_p, consts,
                             quirk))
    planes = []
    for c, pred, out in zip(comps, preds, outs, strict=True):
        plane = recon_plane_blocks(c, pred, is_p, consts, quirk)
        if out is not None:
            out.copy_(plane)
            plane = out
        planes.append(plane)
    return tuple(planes)


def decode_frame_planes_two_kernel(frame: dict, refs: tuple,
                                   consts: DecodeConstants,
                                   quirk_oddify_zeros: bool = False,
                                   outs: tuple | None = None) -> tuple:
    """All planes of one picture through MC then reconstruction: two
    kernel launches on a card, with no torch op between them (the
    per-block sideband goes into the reconstruction launch as it is);
    the plain versions plane by plane on the CPU."""
    preds = predict_picture_mc(frame, refs)
    return recon_picture(frame, preds, frame["is_p"], consts,
                         quirk_oddify_zeros, outs)
