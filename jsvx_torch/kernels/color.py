"""Display-time colour conversion (BT.601 limited range).

The port of ``jsvx/kernels/color.py``: nearest 2x chroma upsample, crop,
then jsvx's matrix constants (``refmath.YCBCR_TO_RGB``/``YCBCR_OFFSET``)
in float32.  jsvx runs this in XLA outside any Pallas kernel; here it is
torch ops on the planes' device.

The 3x3 product is written as separate elementwise multiplies and adds in
one fixed order, every constant a float32 tensor on the planes' device,
so that the CPU and a CUDA card compute the same bits: a matmul may run
in TF32 on a card and sums in an order of its own, and a division by a
host scalar is a multiply by its reciprocal on a card but a true division
on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tools import refmath

_M = refmath.YCBCR_TO_RGB.astype(np.float32)          # (3, 3)
_OFF = refmath.YCBCR_OFFSET.astype(np.float32)        # (3,)


@functools.cache
def _constants(device: torch.device) -> tuple:
    """The matrix, the offsets and 255 as float32 tensors on ``device``,
    made once per device: a copy from the host to a card waits for the
    work queued before it, so a conversion must not make one per call."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (_M, _OFF, 255.0))


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 alpha=False) -> torch.Tensor:
    """(H, W) + 2x(H/2, W/2) uint8 planes -> (H, W, 3|4) uint8 RGB(A) on
    the planes' device.

    ``alpha`` may be ``True`` (an opaque 255 channel) or a decoded (H, W)
    uint8 alpha plane of a YUVA stream.  Each channel is ``((m0*y +
    m1*cb) + m2*cr) + off`` on the [0, 1]-scaled planes, then
    ``round(x*255)`` (half to even), clamped to [0, 255].
    """
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
