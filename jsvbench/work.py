"""The yardstick: each kernel's work and bound, and the profiler window.

The arithmetic is a frozen copy of ``chip_smoke.py``'s ``picture_work``,
``two_kernel_work``, ``expand_work``, ``colour_work`` and ``bound``,
taken here from the reference parser's products (``FrameTensors``) of the
stream's own bytes, never from what the program made: the work of these
inputs, whatever implements them.  The peaks are one H100 SXM's (NVIDIA's
data sheet): 3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the
tensor cores, at the full 700 W; a run prints its card's power limit
beside them.

:class:`Window` is the traced window: ``torch.profiler`` with CPU and
CUDA activity over the measured window, reduced to each kernel's summed
device time and count, the union of the device's busy intervals (kernels,
copies and fills), and the harness's own host spans.
"""

from __future__ import annotations

import contextlib

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: f32 operations per pixel of the IDCT (two passes of 8 multiplies and 7
#: adds) and the prediction add
FLOP_PER_CODED_PIXEL = 31
#: f32 operations per pixel of the colour conversion: per channel three
#: multiplies and three adds, the multiply by 255, the rounding and two
#: clamps (the scaling, one division per sample, is counted apart)
COLOUR_FLOP_PER_PIXEL = 30


def bound(work_bytes: int, flop: int) -> tuple[float, str]:
    """The least time (ms) the card could take, and what sets it."""
    t_bytes = work_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# Per-block views of a parsed picture

def _per_block(arr: np.ndarray, comp: int) -> np.ndarray:
    """A per-macroblock array at the block grid of component ``comp``:
    luma and alpha have 2x2 blocks a macroblock, chroma one."""
    if comp in (0, 3):
        return np.repeat(np.repeat(arr, 2, axis=0), 2, axis=1)
    return arr


def _blocks(ft, comp: int) -> dict:
    return dict(levels=ft.levels[comp], lnz=ft.lnz[comp],
                intra=_per_block(ft.mb_intra, comp),
                mv=_per_block(ft.mb_mv, comp),
                rep_add=_per_block(ft.mb_rep_add, comp))


def tap_footprint(c: dict, h: int, w: int, chroma: bool) -> int:
    """Distinct reference bytes the half-pel taps of a plane's predicted
    blocks read (each tap clamped to the plane): the union of the blocks'
    windows, counted with a 2-D difference array."""
    mv = np.asarray(c["mv"]).astype(np.int64)
    pred = np.asarray(c["rep_add"]) == 0
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


def _coded(c: dict) -> int:
    return int(((np.asarray(c["lnz"]) > 0)
                | (np.asarray(c["intra"]) > 0)).sum()) * 64


def picture_work(ft) -> dict:
    """What one picture's fused decode must move and compute, from this
    picture's data: output 1 B and levels 2 B per pixel, 8 B of sideband
    per block (lnz, q, intra, rep_add, two int16 vector components), and
    the reference bytes the taps read; levels only for coded blocks (lnz
    > 0 or intra) in ``bytes``, for every block in ``bytes_all_levels``;
    31 f32 operations per pixel of a coded block."""
    is_p = not ft.is_intra_picture
    out = dict(bytes=0, bytes_all_levels=0, flop=0, pixels=0)
    for ci in range(ft.n_comps):
        c = _blocks(ft, ci)
        h, w = c["levels"].shape
        coded = _coded(c)
        ref = tap_footprint(c, h, w, ci in (1, 2)) if is_p else 0
        fixed = h * w + (h // 8) * (w // 8) * 8 + ref
        out["bytes"] += fixed + 2 * coded
        out["bytes_all_levels"] += fixed + 2 * h * w
        out["flop"] += FLOP_PER_CODED_PIXEL * coded
        out["pixels"] += h * w
    return out


def two_kernel_work(ft) -> dict:
    """What one picture's MC and reconstruction launches must move, from
    this picture's data.  MC: 2 B out per pixel, the reference bytes the
    taps of predicted blocks read (their union) and 5 B per block (vector,
    rep_add).  Reconstruction: 1 B out per pixel, 2 B of levels per pixel
    of a coded block (lnz > 0 or intra), 2 B of prediction per pixel of a
    P picture, 3 B per block (lnz, q, intra); 31 f32 operations per pixel
    of a coded block."""
    is_p = not ft.is_intra_picture
    out = dict(mc=0, recon=0, flop=0)
    for ci in range(ft.n_comps):
        c = _blocks(ft, ci)
        h, w = c["levels"].shape
        px, blocks = h * w, (h // 8) * (w // 8)
        coded = _coded(c)
        pred = 2 * px if is_p else 0
        out["mc"] += 2 * px + tap_footprint(c, h, w, ci in (1, 2)) + 5 * blocks
        out["recon"] += px + 2 * coded + pred + 3 * blocks
        out["flop"] += FLOP_PER_CODED_PIXEL * coded
    return out


def coded_entries(ft, comp: int) -> int:
    """The compact wire's entries of one picture's component: one per
    coded coefficient as the stream codes it, an intra block's DC
    included."""
    c = _blocks(ft, comp)
    lv = np.asarray(c["levels"])
    h, w = lv.shape
    blk = lv.reshape(h // 8, 8, w // 8, 8)
    nz = (blk != 0).sum((1, 3))
    dc_nz = blk[:, 0, :, 0] != 0
    intra = np.asarray(c["intra"]) > 0
    # an intra block's DC is an entry whatever its value
    return int(nz.sum() + (intra & ~dc_nz).sum())


def expand_work(fts: list, mb_h: int, mb_w: int) -> int:
    """The bytes one GOP's expansion must move, from its pictures: read,
    each entry once (2 B), n (4 B) and the counts (1 B a block) of each
    component, and the per-MB sideband once (3 B and a 4 B vector per MB
    and frame) when a luma-like component repeats it; written, 2 B of
    levels per pixel, 1 B of lnz per block, and per block of a luma-like
    component 7 B of grids (q, intra, rep_add, vector)."""
    n = len(fts)
    total, luma_seen = 0, False
    for comp in range(fts[0].n_comps):
        luma = comp in (0, 3)
        blocks = n * mb_h * mb_w * (4 if luma else 1)
        entries = sum(coded_entries(ft, comp) for ft in fts)
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


def gop_bounds(fts: list, mb_h: int, mb_w: int, display: tuple) -> dict:
    """The bounds (s) of one GOP's work: the fused kernel's pictures, the
    expansion, and the colour of one displayed frame."""
    fused = sum(bound(w["bytes"], w["flop"])[0]
                for w in map(picture_work, fts)) / 1e3
    expand = bound(expand_work(fts, mb_h, mb_w), 0)[0] / 1e3
    colour = bound(*colour_work(*display))[0] / 1e3
    return dict(fused_s_per_gop=fused, expand_s_per_gop=expand,
                colour_s_per_frame=colour, pictures_per_gop=len(fts))


# ---------------------------------------------------------------------------
# The profiler window

SPAN_PREFIX = "jsvbench."


def merge(intervals: list) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Window:
    """The measured window, traced when ``enabled``: on exit ``kernels``
    maps each kernel's name to [seconds, launches], ``busy`` is the union
    of the device's intervals, ``spans`` the harness's host spans (name,
    start, end; ns), and ``start``/``end`` the window's ends (ns, the
    profiler's clock)."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled, self.cuda = enabled, cuda
        self.kernels: dict = {}
        self.device_intervals: list = []
        self.spans: list = []
        self.start = self.end = None

    def span(self, name: str):
        """A host span of the harness (a no-op when not tracing)."""
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def run(self):
        if not self.enabled:
            yield self
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(SPAN_PREFIX + "window"):
                yield self
                if self.cuda:           # the window's last kernels traced
                    torch.cuda.synchronize()
        self._read(prof)

    def _read(self, prof) -> None:
        events = prof.profiler.kineto_results.events()
        for e in events:
            name = e.name()
            start, end = e.start_ns(), e.end_ns()
            if name.startswith(SPAN_PREFIX) and \
                    str(e.device_type()).endswith("CUDA"):
                continue            # a host span's shadow on the device
            if str(e.device_type()).endswith("CUDA"):
                self.device_intervals.append((start, end))
                if not name.startswith(("Memcpy", "Memset")):
                    k = self.kernels.setdefault(name, [0.0, 0])
                    k[0] += (end - start) / 1e9
                    k[1] += 1
            elif name.startswith(SPAN_PREFIX):
                if name == SPAN_PREFIX + "window":
                    self.start, self.end = start, end
                else:
                    self.spans.append((name[len(SPAN_PREFIX):], start, end))

    # -- readings -------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy(self) -> list:
        """The device's busy intervals inside the window, merged."""
        return [(max(s, self.start), min(e, self.end))
                for s, e in merge(self.device_intervals)
                if e > self.start and s < self.end]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernel(self, fragment: str) -> tuple[float, int]:
        """(seconds, launches) summed over the kernels whose name holds
        ``fragment``."""
        t = n = 0
        for name, (s, k) in self.kernels.items():
            if fragment in name:
                t += s
                n += k
        return t, n

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each labelled by the innermost harness span around its
        middle."""
        ops = sorted(([n, s] for n, (s, _) in self.kernels.items()),
                     key=lambda x: -x[1])[:top]
        busy = self.busy()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = (s + e) // 2
            inside = [(b - a, n) for n, a, b in self.spans if a <= mid <= b]
            label = min(inside)[1] if inside else "outside spans"
            out.append([label, (e - s) / 1e9])
        return dict(device_ops=ops, idle_gaps=out)
