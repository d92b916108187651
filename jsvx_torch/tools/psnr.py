"""PSNR / quality metrics for decode verification."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def frames_psnr(frames_a, frames_b) -> float:
    """Mean PSNR over frame sequences of (Y, Cb, Cr) plane tuples."""
    vals = []
    for fa, fb in zip(frames_a, frames_b, strict=True):
        for pa, pb in zip(fa, fb):
            vals.append(psnr(pa, pb))
    finite = [v for v in vals if np.isfinite(v)]
    return float(np.mean(finite)) if finite else float("inf")
