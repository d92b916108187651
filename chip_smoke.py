"""The port's on-card check, and the work arithmetic its kernels are held to.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:
it runs the ``cuda``-marked tests of the port (:data:`CUDA_TESTS`) with
``pytest -m cuda --noconftest`` (``tests/conftest.py`` imports JAX, which
that machine lacks) and exits with pytest's code.  Those tests build the
kernels with ``nvcc`` at first use and hold every kernel to its plain
PyTorch version and every path on the card to the same call on the CPU.

The rest of the file is what one picture, GOP or frame of each kernel
must move and compute, and the least time an H100 could take for it:
``jsvbench/work.py`` holds a frozen copy, and
``jsvbench/tests/test_jsvbench_work.py`` holds that copy to this one.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from jsvx_torch.kernels.decode import comp_is_chroma, frame_comp_keys

#: the port's test files that hold ``cuda``-marked tests
CUDA_TESTS = tuple(f"tests/test_torch_{name}.py" for name in (
    "fused", "two_kernel", "expand", "color", "api", "corrupt_streams",
    "gop_program", "group_program", "shard", "sequence_matrices",
    "graft_entry"))
#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s outside
#: the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: f32 operations per pixel of the IDCT (two passes of 8 multiplies and 7
#: adds) and the prediction add
FLOP_PER_CODED_PIXEL = 31
#: f32 operations per pixel of the colour conversion: per channel three
#: multiplies and three adds, the multiply by 255, the rounding and two
#: clamps (the scaling, one division per sample, is counted apart)
COLOUR_FLOP_PER_PIXEL = 30


def tap_footprint(c: dict, h: int, w: int, chroma: bool) -> int:
    """Distinct reference bytes the half-pel taps of a plane's predicted
    blocks read (each tap clamped to the plane): the union of the blocks'
    windows, counted with a 2-D difference array."""
    mv = c["mv"].cpu().numpy().astype(np.int64)
    pred = c["rep_add"].cpu().numpy() == 0
    mvy, mvx = mv[..., 0], mv[..., 1]
    if chroma:                               # truncation toward zero
        mvy, mvx = np.fix(mvy / 2).astype(np.int64), \
            np.fix(mvx / 2).astype(np.int64)
    by, bx = np.nonzero(pred)
    if by.size == 0:
        return 0
    vy, vx = mvy[by, bx], mvx[by, bx]
    y0 = np.clip(by * 8 + (vy >> 1), 0, h - 1)
    y1 = np.clip(by * 8 + 7 + (vy >> 1) + (vy & 1), 0, h - 1)
    x0 = np.clip(bx * 8 + (vx >> 1), 0, w - 1)
    x1 = np.clip(bx * 8 + 7 + (vx >> 1) + (vx & 1), 0, w - 1)
    diff = np.zeros((h + 1, w + 1), np.int32)
    np.add.at(diff, (y0, x0), 1)
    np.add.at(diff, (y0, x1 + 1), -1)
    np.add.at(diff, (y1 + 1, x0), -1)
    np.add.at(diff, (y1 + 1, x1 + 1), 1)
    return int((diff.cumsum(0).cumsum(1)[:h, :w] > 0).sum())


def picture_work(frame: dict) -> dict:
    """What one picture's fused decode must move and compute, from this
    picture's data: output 1 B and levels 2 B per pixel, 8 B of sideband
    per block (lnz, q, intra, rep_add, two int16 vector components), and
    the reference bytes the taps read; levels only for coded blocks (lnz
    > 0 or intra) in ``bytes``, for every block in ``bytes_all_levels``;
    31 f32 operations per pixel of a coded block."""
    is_p = int(frame["is_p"]) != 0
    out = dict(bytes=0, bytes_all_levels=0, flop=0, pixels=0)
    for ci, key in enumerate(frame_comp_keys(frame)):
        c = frame[key]
        h, w = c["levels"].shape
        coded = int(((c["lnz"] > 0) | (c["intra"] > 0)).sum()) * 64
        ref = tap_footprint(c, h, w, comp_is_chroma(ci)) if is_p else 0
        fixed = h * w + (h // 8) * (w // 8) * 8 + ref
        out["bytes"] += fixed + 2 * coded
        out["bytes_all_levels"] += fixed + 2 * h * w
        out["flop"] += FLOP_PER_CODED_PIXEL * coded
        out["pixels"] += h * w
    return out


def bound(work_bytes: int, flop: int) -> tuple[float, str]:
    """The least time (ms) the card could take, and what sets it."""
    t_bytes = work_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def two_kernel_work(frame: dict) -> dict:
    """What one picture's MC and reconstruction launches must move, from
    this picture's data.  MC: 2 B out per pixel, the reference bytes the
    taps of predicted blocks read (their union) and 5 B per block (vector,
    rep_add).  Reconstruction: 1 B out per pixel, 2 B of levels per pixel
    of a coded block (lnz > 0 or intra), 2 B of prediction per pixel of a
    P picture, 3 B per block (lnz, q, intra); 31 f32 operations per pixel
    of a coded block."""
    is_p = int(frame["is_p"]) != 0
    out = dict(mc=0, recon=0, flop=0)
    for ci, key in enumerate(frame_comp_keys(frame)):
        c = frame[key]
        h, w = c["levels"].shape
        px, blocks = h * w, (h // 8) * (w // 8)
        coded = int(((c["lnz"] > 0) | (c["intra"] > 0)).sum()) * 64
        pred = 2 * px if is_p else 0
        out["mc"] += (2 * px + tap_footprint(c, h, w, comp_is_chroma(ci))
                      + 5 * blocks)
        out["recon"] += px + 2 * coded + pred + 3 * blocks
        out["flop"] += FLOP_PER_CODED_PIXEL * coded
    return out


def expand_work(tree: dict, mb_h: int, mb_w: int) -> int:
    """The bytes one GOP's expansion must move, from this wire: read, each
    entry below n once (2 B), n (4 B) and the counts (1 B a block) of each
    component, and the per-MB sideband once (3 B and a 4 B vector per MB
    and frame) when a luma-like component repeats it; written, 2 B of
    levels per pixel, 1 B of lnz per block, and per block of a luma-like
    component 7 B of grids (q, intra, rep_add, vector)."""
    n = int(tree["is_p"].shape[0])
    total, luma_seen = 0, False
    for key, c in tree["coef"].items():
        luma = key in ("y", "a")
        blocks = n * mb_h * mb_w * (4 if luma else 1)
        entries = max(0, min(int(c["n"].cpu()), c["cpk"].shape[0]))
        total += 2 * entries + 4 + blocks + 2 * 64 * blocks + blocks
        if luma:
            total += 7 * blocks
            luma_seen = True
    return total + (7 * n * mb_h * mb_w if luma_seen else 0)


def colour_work(h: int, w: int) -> tuple[int, int]:
    """What one (h, w) frame's RGB conversion must move and compute: luma
    and the chroma (ceil(h/2) x ceil(w/2) each) read once, the 3-channel
    image written once; COLOUR_FLOP_PER_PIXEL operations a pixel and one
    division a sample read (the scaling)."""
    chroma = 2 * (-(-h // 2)) * (-(-w // 2))
    return 4 * h * w + chroma, COLOUR_FLOP_PER_PIXEL * h * w + h * w + chroma


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.exit(subprocess.run([sys.executable, "-m", "pytest", *CUDA_TESTS,
                             "-m", "cuda", "--noconftest", "-q",
                             "-p", "no:cacheprovider"]).returncode)


if __name__ == "__main__":
    main()
