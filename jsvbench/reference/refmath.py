"""Reference reconstruction math (float64, block granularity).

The single source of truth for what "reference reconstruction" means in this
framework: the float-exact formulation of the reference decoder's GPU math
(``decoders/shaders/mpeg1video.js``), shared by the fixture encoder's closed
decode loop, the float64 oracle, and the tests that pin the TPU kernels.

Scale conventions (derived from the integer shader path, which computes at
256x pixel scale with an AAN prescale of 32 and a final ``(x+128)/256``
descale — see SURVEY.md section 2.2):

* dequantised coefficients ``D`` feed a unitary-normalised 2-D IDCT
  ``f = C @ D @ C.T`` with ``C[x,u] = (c_u/2) cos((2x+1) u pi/16)``;
* an intra block's DC is ``8 * dc_value`` (DC quantiser step 8);
* intra pixels are ``clip(round(f), 0, 255)``;
* inter pixels are ``clip(round(prediction + f), 0, 255)`` with MPEG
  half-pel prediction rounding ``floor((a+b+1)/2)`` / ``floor((a+b+c+d+2)/4)``.
"""

from __future__ import annotations

import numpy as np


def idct_basis() -> np.ndarray:
    """C[x, u] such that spatial = C @ freq @ C.T (orthogonal)."""
    x = np.arange(8)[:, None]
    u = np.arange(8)[None, :]
    c = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    return 0.5 * c * np.cos((2 * x + 1) * u * np.pi / 16.0)


C_BASIS = idct_basis()


def fdct2(block: np.ndarray) -> np.ndarray:
    return C_BASIS.T @ block @ C_BASIS


def idct2(freq: np.ndarray) -> np.ndarray:
    return C_BASIS @ freq @ C_BASIS.T


def dequant_intra(levels: np.ndarray, q, matrix: np.ndarray,
                  quirk_oddify_zeros: bool = False) -> np.ndarray:
    """Intra dequant: d = floor(2*lvl*q*M/16); mismatch control (evens are
    pulled one step toward zero).

    ``quirk_oddify_zeros=True`` reproduces the reference shader's behaviour
    of applying mismatch control to zero coefficients inside the coded scan
    range as well (COL_INT_3 in decoders/shaders/mpeg1video.js applies the
    even-value correction unconditionally, turning 0 into +1); the default
    is the ISO 11172-2 behaviour where zero stays zero.
    """
    lv = np.asarray(levels, dtype=np.float64)
    d = np.floor(2.0 * lv * q * matrix / 16.0)
    even = np.mod(d, 2.0) == 0
    if quirk_oddify_zeros:
        d = np.where(even, d - np.where(d > 0, 1.0, -1.0), d)
    else:
        d = np.where(even & (lv != 0), d - np.sign(d), d)
    return np.clip(d, -2048, 2047)


def dequant_inter(levels: np.ndarray, q, matrix: np.ndarray,
                  quirk_oddify_zeros: bool = False) -> np.ndarray:
    """Non-intra dequant: d = floor((2*lvl + sign(lvl))*q*M/16) + mismatch.

    With ``quirk_oddify_zeros`` the sign pre-add treats 0 as +1 like the
    reference shader does for in-range zero coefficients.
    """
    lv = np.asarray(levels, dtype=np.float64)
    if quirk_oddify_zeros:
        pre = 2.0 * lv + np.where(lv < 0, -1.0, 1.0)
    else:
        pre = 2.0 * lv + np.sign(lv)
    d = np.floor(pre * q * matrix / 16.0)
    even = np.mod(d, 2.0) == 0
    if quirk_oddify_zeros:
        d = np.where(even, d - np.where(d > 0, 1.0, -1.0), d)
    else:
        d = np.where(even & (lv != 0), d - np.sign(d), d)
    return np.clip(d, -2048, 2047)


# ---------------------------------------------------------------------------
# Motion compensation (edge-clamped, MPEG rounding)

def shift_plane(p: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Edge-clamped full-pel shift: out[y, x] = p[y+dy, x+dx]."""
    h, w = p.shape
    ys = np.clip(np.arange(h) + dy, 0, h - 1)
    xs = np.clip(np.arange(w) + dx, 0, w - 1)
    return p[np.ix_(ys, xs)]


def gather_window(p: np.ndarray, y0: int, x0: int,
                  hh: int, ww: int) -> np.ndarray:
    h, w = p.shape
    ys = np.clip(np.arange(y0, y0 + hh), 0, h - 1)
    xs = np.clip(np.arange(x0, x0 + ww), 0, w - 1)
    return p[np.ix_(ys, xs)]


def avg_taps(g: np.ndarray, oy: int, ox: int, size: int) -> np.ndarray:
    a = g[0:size, 0:size]
    if not oy and not ox:
        return a
    if ox and not oy:
        return np.floor((a + g[0:size, 1:size + 1] + 1) / 2.0)
    if oy and not ox:
        return np.floor((a + g[1:size + 1, 0:size] + 1) / 2.0)
    return np.floor((a + g[0:size, 1:size + 1] + g[1:size + 1, 0:size]
                     + g[1:size + 1, 1:size + 1] + 2) / 4.0)


def luma_mv_parts(vy: int, vx: int) -> tuple[int, int, int, int]:
    """(full_y, full_x, odd_y, odd_x): arithmetic-shift halving (shader
    INTER_1, mv_coef = 1)."""
    return vy >> 1, vx >> 1, vy & 1, vx & 1


def chroma_mv_parts(vy: int, vx: int) -> tuple[int, int, int, int]:
    """Chroma halves the luma MV with trunc-toward-zero first (shader
    INTER_1, mv_coef = 0.5), then splits full/half-pel with floor."""
    cy = int(np.trunc(vy / 2.0))
    cx = int(np.trunc(vx / 2.0))
    return cy >> 1, cx >> 1, cy & 1, cx & 1


def mc_luma_block(ref: np.ndarray, row: int, col: int, mv) -> np.ndarray:
    vy, vx = int(mv[0]), int(mv[1])
    fy, fx, oy, ox = luma_mv_parts(vy, vx)
    g = gather_window(ref, row * 16 + fy, col * 16 + fx, 17, 17).astype(
        np.float64)
    return avg_taps(g, oy, ox, 16)


def mc_chroma_block(ref: np.ndarray, row: int, col: int, mv) -> np.ndarray:
    fy, fx, oy, ox = chroma_mv_parts(int(mv[0]), int(mv[1]))
    g = gather_window(ref, row * 8 + fy, col * 8 + fx, 9, 9).astype(
        np.float64)
    return avg_taps(g, oy, ox, 8)


# ---------------------------------------------------------------------------
# Colour conversion (BT.601 limited range; player/parts/end.js:87-92)

YCBCR_TO_RGB = np.array([
    [1.16438, 0.00000, 1.59603],
    [1.16438, -0.39176, -0.81297],
    [1.16438, 2.01723, 0.00000],
])
YCBCR_OFFSET = np.array([-0.87079, 0.52959, -1.08139])


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Planes (chroma half-res, nearest-upsampled) -> uint8 RGB (H, W, 3)."""
    yf = y.astype(np.float64) / 255.0
    cbu = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1)[:y.shape[0],
                                                         :y.shape[1]]
    cru = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1)[:y.shape[0],
                                                         :y.shape[1]]
    cbf = cbu.astype(np.float64) / 255.0
    crf = cru.astype(np.float64) / 255.0
    ycc = np.stack([yf, cbf, crf], axis=-1)
    rgb = ycc @ YCBCR_TO_RGB.T + YCBCR_OFFSET
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
