"""Display-time colour conversion (BT.601 limited range).

The port of ``jsvx/kernels/color.py``: nearest 2x chroma upsample, crop,
then jsvx's matrix constants (``refmath.YCBCR_TO_RGB``/``YCBCR_OFFSET``)
in float32.  jsvx compiles this as one XLA program (``ycbcr_to_rgb_jit``,
no Pallas kernel), which its Player calls once per displayed frame.

On a card, :func:`ycbcr_to_rgb` is one launch of the colour kernel
(``csrc/color.cu``) per frame: a tensor on a CUDA device launches the
kernel or raises, with no fallback, and the kernel reads each plane
through its own row stride, so cropped views need no copy.  The launch's
geometry is decided here, by :func:`launch_plan` (a one-warp CTA a unit
of a luma row pair over a segment of the width, and which loads and
stores are vector ones), so that the CPU tests reach it.  A tensor on
the CPU goes to the plain version, torch ops
(:func:`ycbcr_to_rgb_plain`).  ``launches`` counts
the kernel's launches; ``plain_calls`` counts the plain version's calls,
wherever they run (none on a card's display path).

The plain version writes the 3x3 product as separate elementwise
multiplies and adds in one fixed order, every constant a float32 tensor
on the planes' device, so that the CPU and a CUDA card compute the same
bits: a matmul may run in TF32 on a card and sums in an order of its own,
and a division by a host scalar is a multiply by its reciprocal on a card
but a true division on the CPU.  The kernel is bit-equal to it: the same
operations in the same order, each rounded once, or exact shortcuts of
them (``csrc/color.cu``'s note).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import counters
from ..tools import refmath

_M = refmath.YCBCR_TO_RGB.astype(np.float32)          # (3, 3)
_OFF = refmath.YCBCR_OFFSET.astype(np.float32)        # (3,)
#: the kernel's constants: the matrix row-major, then the offsets
_COEFFS = np.ascontiguousarray(np.concatenate([_M.reshape(-1), _OFF]))

#: number of kernel launches in this process (reset it to 0 to count a run)
launches = 0
counters.register("color", __name__, "launches")
#: number of calls of the plain (torch) version in this process
plain_calls = 0
counters.register("color_plain", __name__, "plain_calls")

#: the kernel's alpha modes (``csrc/color.cu``: ``AlphaMode``)
NO_ALPHA, OPAQUE, ALPHA_PLANE = 0, 1, 2

#: threads a CTA, one warp (``csrc/color.cu``: ``kThreads``), 16 columns
#: each
THREADS = 32
#: the widest segment of a unit, in pixels (``kMaxSeg``)
MAX_SEG = 16 * THREADS
#: plan flags (``kVec*``): 16-byte loads of a plane (8-byte for the
#: chroma), 16-byte stores of the output rows
VEC_Y, VEC_CB, VEC_CR, VEC_A, VEC_OUT = 1, 2, 4, 8, 16


@dataclass(frozen=True)
class LaunchPlan:
    """What the colour kernel is told about a frame: its units, one CTA
    each, and which loads and stores are 16-byte ones.  A unit is a luma
    row pair (rows 2p and 2p + 1, the second absent past h) over one
    segment of the width (columns s seg_w .., at most seg_w of them) with
    the chroma row p under it; units are numbered pair-major, and CTA u
    takes unit u.  In a unit, lane l takes columns 16 l .. 16 l + 15 of
    the segment."""

    h: int
    w: int
    channels: int
    alpha_plane: bool
    seg_w: int              # a multiple of 32, at most MAX_SEG
    n_segs: int
    units: int              # ceil(h / 2) * n_segs
    vec: tuple              # y, cb, cr(, alpha): vector loads
    out_vec: bool           # 16-byte stores of the output rows
    threads: int = THREADS

    @property
    def flags(self) -> int:
        f = sum(bit for bit, v in zip((VEC_Y, VEC_CB, VEC_CR, VEC_A),
                                      self.vec) if v)
        return f | (VEC_OUT if self.out_vec else 0)

    @property
    def grid(self) -> int:
        """CTAs: one a unit."""
        return self.units

    def unit(self, u: int) -> tuple:
        """(first luma row, rows, first column, columns) of unit u."""
        p, s = divmod(u, self.n_segs)
        x0 = s * self.seg_w
        return 2 * p, min(2, self.h - 2 * p), x0, min(self.seg_w,
                                                      self.w - x0)

    def args(self) -> ctypes.Array:
        """The kernel's ``plan`` argument: seg_w, flags."""
        return (ctypes.c_int * 2)(self.seg_w, self.flags)


def _aligned16(offset: int, stride: int) -> bool:
    return (offset | stride) % 16 == 0


def launch_plan(h: int, w: int, channels: int, strides, offsets,
                out_offset: int = 0) -> LaunchPlan:
    """The colour kernel's launch for an (h, w) frame of ``channels`` (3
    or 4) output channels.  ``strides``: the row strides in bytes of Y,
    Cb, Cr and, for a frame with an alpha plane, of that plane;
    ``offsets``: the same planes' addresses (or their residues modulo
    16); ``out_offset``: the output's.

    The width is cut into the fewest equal segments of at most MAX_SEG
    pixels, each a multiple of 32 wide (so each segment start keeps its
    row's 16-byte alignment, luma and chroma): 480 at 1920 wide.
    The grid is one CTA a unit.  A plane is read in 16-byte loads (the
    chroma in 8-byte ones) where its base and row stride are multiples of
    16, the output rows are written in 16-byte stores where its base and
    its row length w * channels are; the kernel trusts these flags and
    does not check them again."""
    if h < 1 or w < 1 or channels not in (3, 4):
        raise ValueError(f"no colour plan for {h}x{w}x{channels}")
    if len(strides) != len(offsets) or len(strides) not in (3, 4):
        raise ValueError("strides and offsets of 3 or 4 planes")
    alpha_plane = len(strides) == 4
    if alpha_plane and channels != 4:
        raise ValueError("an alpha plane needs 4 channels")
    n_segs = -(-w // MAX_SEG)
    seg_w = -(-(-(-w // n_segs)) // 32) * 32
    n_segs = -(-w // seg_w)
    units = -(-h // 2) * n_segs
    return LaunchPlan(
        h=h, w=w, channels=channels, alpha_plane=alpha_plane, seg_w=seg_w,
        n_segs=n_segs, units=units,
        vec=tuple(_aligned16(o, s) for o, s in zip(offsets, strides)),
        out_vec=_aligned16(out_offset, w * channels))


@functools.cache
def _constants(device: torch.device) -> tuple:
    """The matrix, the offsets and 255 as float32 tensors on ``device``,
    made once per device: a copy from the host to a card waits for the
    work queued before it, so a conversion must not make one per call."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (_M, _OFF, 255.0))


def ycbcr_to_rgb_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                       alpha=False) -> torch.Tensor:
    """The plain version: (H, W) + 2x(H/2, W/2) uint8 planes -> (H, W,
    3|4) uint8 RGB(A) on the planes' device, torch ops.

    ``alpha`` may be ``True`` (an opaque 255 channel) or a decoded (H, W)
    uint8 alpha plane of a YUVA stream.  Each channel is ``((m0*y +
    m1*cb) + m2*cr) + off`` on the [0, 1]-scaled planes, then
    ``round(x*255)`` (half to even), clamped to [0, 255].
    """
    global plain_calls
    plain_calls += 1
    h, w = y.shape
    dev = y.device
    m, off, k255 = _constants(dev)

    def scaled(p: torch.Tensor) -> torch.Tensor:
        return p.to(torch.float32) / k255

    def up(p: torch.Tensor) -> torch.Tensor:
        hc, wc = p.shape
        return p[:, None, :, None].expand(hc, 2, wc, 2).reshape(
            2 * hc, 2 * wc)[:h, :w]

    ycc = (scaled(y), scaled(up(cb)), scaled(up(cr)))
    chans = []
    for r in range(3):
        acc = m[r, 0] * ycc[0]
        acc = acc + m[r, 1] * ycc[1]
        acc = acc + m[r, 2] * ycc[2]
        acc = acc + off[r]
        chans.append(torch.round(acc * k255).clamp(0.0, 255.0)
                     .to(torch.uint8))
    if alpha is True:
        chans.append(torch.full((h, w), 255, dtype=torch.uint8, device=dev))
    elif alpha is not False and alpha is not None:
        chans.append(alpha.to(torch.uint8)[:h, :w])
    return torch.stack(chans, dim=-1)


def _check(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
           a: torch.Tensor | None) -> None:
    """Raise ``ValueError`` unless the planes are 2-D on one device, the
    chroma covers (ceil(h/2), ceil(w/2)) and the alpha plane (h, w)."""
    planes = {"y": y, "cb": cb, "cr": cr}
    if a is not None:
        planes["alpha"] = a
    for name, p in planes.items():
        if p.dim() != 2:
            raise ValueError(f"{name} has {p.dim()} dimensions, expected 2")
        if p.device != y.device:
            raise ValueError(f"{name} is on {p.device}, y on {y.device}")
    h, w = y.shape
    for name, p, need in (("cb", cb, (-(-h // 2), -(-w // 2))),
                          ("cr", cr, (-(-h // 2), -(-w // 2))),
                          ("alpha", a, (h, w))):
        if p is not None and (p.shape[0] < need[0] or p.shape[1] < need[1]):
            raise ValueError(f"{name} {tuple(p.shape)} does not cover "
                             f"{need} for a {h}x{w} frame")


def _rows(p: torch.Tensor) -> torch.Tensor:
    """``p`` as the kernel reads it: unit column stride and rows that do
    not overlap (a copy only for a view that has neither)."""
    if p.stride(1) == 1 and p.stride(0) >= p.shape[1]:
        return p
    return p.contiguous()


def _launch(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
            a: torch.Tensor | None, mode: int) -> torch.Tensor:
    """One launch of the colour kernel on the planes' CUDA device, as
    :func:`launch_plan` lays it out: a contiguous (h, w, 3|4) uint8
    tensor."""
    global launches
    device = y.device
    if device.type != "cuda":
        raise ValueError(f"no colour kernel for device {device}")
    h, w = y.shape
    planes = [_rows(p) for p in (y, cb, cr)] + (
        [_rows(a)] if a is not None else [])
    out = torch.empty((h, w, 3 if mode == NO_ALPHA else 4),
                      dtype=torch.uint8, device=device)
    index = device.index or 0
    plan = launch_plan(h, w, out.shape[2], [p.stride(0) for p in planes],
                       [p.data_ptr() for p in planes], out.data_ptr())
    ptrs = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))
    strides = [p.stride(0) for p in planes] + [0] * (4 - len(planes))

    from .build import load

    lib = load().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.jsvx_colour_frame(
        (ctypes.c_void_p * 4)(*ptrs), (ctypes.c_longlong * 4)(*strides),
        h, w, mode, _COEFFS.ctypes.data, out.data_ptr(), plan.args(),
        index, stream)
    if rc != 0:
        raise RuntimeError(f"colour kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 alpha=False) -> torch.Tensor:
    """(H, W) + 2x(H/2, W/2) uint8 planes -> (H, W, 3|4) uint8 RGB(A) on
    the planes' device, contiguous: one launch of the colour kernel on a
    card, the plain version on the CPU; jsvx's ``ycbcr_to_rgb_jax``'s
    signature and results.

    ``alpha`` may be ``True`` (an opaque 255 channel) or a decoded alpha
    plane of a YUVA stream covering (H, W).  The chroma planes must cover
    (ceil(H/2), ceil(W/2)); any of the planes may be a strided view (a
    crop).  A plane of another dtype is cast to uint8 first
    (``.to(torch.uint8)``: jsvx's ``astype`` of the alpha plane; on
    samples 0-255 it agrees with jsvx's float cast of Y, Cb and Cr); an
    empty frame gives an empty image without a launch.  Raises
    ``ValueError`` for planes on different devices or that do not cover
    the frame.
    """
    y, cb, cr = (p if p.dtype == torch.uint8 else p.to(torch.uint8)
                 for p in (y, cb, cr))
    a = None
    if alpha is not False and alpha is not None and alpha is not True:
        a = alpha if alpha.dtype == torch.uint8 else alpha.to(torch.uint8)
    _check(y, cb, cr, a)
    h, w = y.shape
    mode = (NO_ALPHA if alpha is False or alpha is None
            else OPAQUE if alpha is True else ALPHA_PLANE)
    if h == 0 or w == 0:
        return torch.empty((h, w, 3 if mode == NO_ALPHA else 4),
                           dtype=torch.uint8, device=y.device)
    if y.device.type == "cpu":
        return ycbcr_to_rgb_plain(y, cb, cr,
                                  a if a is not None else mode == OPAQUE)
    return _launch(y, cb, cr, a, mode)
