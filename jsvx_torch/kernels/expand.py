"""Device-side expansion of the compact coefficient wire format.

The port of ``jsvx/kernels/expand.py``, which jsvx compiles into its GOP
program (``decode_gop_scan_wire``; it has no Pallas kernel).  The wire
carries one uint16 per coded coefficient, ``(spatial_pos:6 << 10) |
(level + 512)``, concatenated in (frame, macroblock-raster,
block-within-MB) order and padded to a bucket, plus uint8 per-block entry
counts; per-macroblock sideband is carried once per frame.  These
functions rebuild exactly the dense per-block grids the decode kernels
consume.

On a card, :func:`expand_compact_gop` is one launch of the expansion
kernel (``csrc/expand.cu``) for every component and frame of the GOP, and
:func:`expand_levels` is the one-component case of the same launch: a
tensor on a CUDA device launches the kernel or raises, with no fallback,
and the wrapper passes only data pointers (torch has few uint16 ops on
CUDA).  A tensor on the CPU goes to the plain version, torch ops
(:func:`expand_compact_gop_plain`, :func:`expand_levels_plain`).
``launches`` counts the kernel's launches, one per GOP; ``plain_calls``
counts the plain version's expansions of a component, wherever they run
(none on a card's decode path).

The launch layout (:func:`expand_layout`): a CTA expands a tile of
``TILE_BLOCKS`` consecutive blocks of one component in wire order, a
thread per block (:func:`thread_blocks`), and the components' CTAs follow
one another.
"""

from __future__ import annotations

import ctypes

import torch

from . import counters
from .decode import COMP_KEYS
from .fused import check_aligned, check_tensor

#: number of kernel launches in this process (reset it to 0 to count a run)
launches = 0
counters.register("expand", __name__, "launches")
#: number of plain (torch) expansions of a component in this process
plain_calls = 0
counters.register("expand_plain", __name__, "plain_calls")

#: blocks per CTA of the expansion kernel, a thread each
#: (``csrc/expand.cu``: ``kTileBlocks``)
TILE_BLOCKS = 256
MAX_COMPS = 4


def comp_blocks(mb_h: int, mb_w: int, luma_like: bool) -> int:
    """8x8 blocks of one component in one frame."""
    return mb_h * mb_w * (4 if luma_like else 1)


def expand_layout(totals) -> tuple:
    """Each component's block count (all frames) -> (first CTA of each
    component, total CTAs): a CTA per tile of TILE_BLOCKS blocks."""
    begins, total = [], 0
    for n in totals:
        begins.append(total)
        total += -(-n // TILE_BLOCKS)
    return tuple(begins), total


def thread_blocks(luma_like: bool) -> list:
    """The block of its tile, counted in wire order, that each thread of a
    CTA expands (the kernel's index math).  Chroma: thread t, block t.
    Luma-like: a tile holds 64 whole MBs; threads 0-127 take their top
    blocks and 128-255 the bottom ones, left to right, so neighbouring
    threads write neighbouring blocks of one block row."""
    if not luma_like:
        return list(range(TILE_BLOCKS))
    half = TILE_BLOCKS // 2
    return [((t % half) >> 1) * 4 + (t // half) * 2 + (t & 1)
            for t in range(TILE_BLOCKS)]


# ---------------------------------------------------------------------------
# The plain version (torch ops)

def expand_levels_plain(cpk: torch.Tensor, n_coef: torch.Tensor,
                        counts: torch.Tensor, mb_h: int, mb_w: int,
                        luma_like: bool) -> torch.Tensor:
    """Packed entries -> dense int16 coefficient plane stack (n, H, W).

    ``counts`` is (n_frames, n_blocks) uint8 with blocks in (mb*4 + b)
    order for luma-like components and mb order for chroma.  Entries at
    index >= ``n_coef`` (padding) go to a sacrificial slot.
    """
    global plain_calls
    plain_calls += 1
    device = cpk.device
    n, n_blocks = counts.shape
    rep = 2 if luma_like else 1
    hb, wb = mb_h * rep, mb_w * rep
    h, w = hb * 8, wb * 8
    n_ent = cpk.shape[0]

    # entry i's block = #{b : ends[b] <= i}: blocks are emitted in
    # increasing order, so one scatter-add of the block end positions and
    # a cumsum give the rank.  An end equal to n_ent (the last block ends
    # the buffer) is dropped into slot n_ent.
    ends = torch.cumsum(counts.reshape(-1).to(torch.int32), 0,
                        dtype=torch.int32).to(torch.int64)
    marks = torch.zeros((n_ent + 1,), dtype=torch.int32, device=device)
    marks.index_add_(0, ends.clamp(max=n_ent),
                     torch.ones_like(ends, dtype=torch.int32))
    blk = torch.cumsum(marks[:n_ent], 0, dtype=torch.int32)
    blk = blk.clamp(max=n * n_blocks - 1)
    i = torch.arange(n_ent, dtype=torch.int32, device=device)

    ent = cpk.to(torch.int32)
    zz = ent >> 10                         # spatial position in the block
    lvl = (ent & 1023) - 512

    frame = torch.div(blk, n_blocks, rounding_mode="floor")
    r = blk - frame * n_blocks
    if luma_like:
        mb = r >> 2
        b = r & 3
        by = torch.div(mb, mb_w, rounding_mode="floor") * 2 + (b >> 1)
        bx = (mb % mb_w) * 2 + (b & 1)
    else:
        by = torch.div(r, mb_w, rounding_mode="floor")
        bx = r % mb_w
    dest = (frame.to(torch.int64) * (h * w)
            + (by * 8 + (zz >> 3)).to(torch.int64) * w + bx * 8 + (zz & 7))
    dest = torch.where(i < n_coef, dest, n * h * w)

    plane = torch.zeros((n * h * w + 1,), dtype=torch.int16, device=device)
    plane[dest] = lvl.to(torch.int16)
    return plane[:-1].reshape(n, h, w)


def _up(a: torch.Tensor, rep: int, mb_h: int, mb_w: int) -> torch.Tensor:
    """Per-MB (n, mb_h, mb_w, ...) -> per-block grid (contiguous)."""
    if rep == 1:
        return a.contiguous()
    n, tail = a.shape[0], tuple(a.shape[3:])
    bc = a[:, :, None, :, None].expand((n, mb_h, rep, mb_w, rep) + tail)
    return bc.reshape((n, mb_h * rep, mb_w * rep) + tail)


def expand_compact_gop_plain(stacked: dict, mb_h: int, mb_w: int) -> dict:
    """Compact wire dict -> the dense stacked-GOP dict the kernels eat.

    ``lnz`` is a constant full-scan mask: the expanded planes are exact
    (true zeros wherever nothing was coded).
    """
    mb = stacked["mb"]
    n = mb["q"].shape[0]
    out = {"is_p": stacked["is_p"], "f_code": stacked["f_code"]}
    for key in COMP_KEYS:
        if key not in stacked["coef"]:
            continue
        luma_like = key in ("y", "a")
        rep = 2 if luma_like else 1
        c = stacked["coef"][key]
        out[key] = dict(
            levels=expand_levels_plain(c["cpk"], c["n"], c["counts"], mb_h,
                                       mb_w, luma_like),
            lnz=torch.full((n, mb_h * rep, mb_w * rep), 64,
                           dtype=torch.uint8, device=mb["q"].device),
            q=_up(mb["q"], rep, mb_h, mb_w),
            intra=_up(mb["intra"], rep, mb_h, mb_w),
            mv=_up(mb["mv"], rep, mb_h, mb_w),
            rep_add=_up(mb["rep_add"], rep, mb_h, mb_w),
        )
    return out


# ---------------------------------------------------------------------------
# The kernel's wrapper

def _check_comp(c: dict, n: int, mb_h: int, mb_w: int, luma_like: bool,
                device) -> None:
    """Raise unless one component's wire leaves are what the kernel takes:
    ``cpk`` uint16 (bucket,), ``n`` one int32, ``counts`` uint8 (n,
    blocks) 16-byte aligned, all contiguous on ``device``."""
    cpk, n_coef = c["cpk"], c["n"]
    if cpk.dim() != 1:
        raise ValueError(f"cpk has {cpk.dim()} dimensions, expected 1")
    check_tensor("cpk", cpk, torch.uint16, cpk.shape, device)
    check_tensor("n", n_coef, torch.int32, n_coef.shape, device)
    if n_coef.numel() != 1:
        raise ValueError(f"n has {n_coef.numel()} elements, expected 1")
    check_tensor("counts", c["counts"], torch.uint8,
                 (n, comp_blocks(mb_h, mb_w, luma_like)), device)
    check_aligned("counts", c["counts"], 16)


def _check_mb(mb: dict, n: int, mb_h: int, mb_w: int, device) -> None:
    for key in ("q", "intra", "rep_add"):
        check_tensor(key, mb[key], torch.uint8, (n, mb_h, mb_w), device)
    check_tensor("mv", mb["mv"], torch.int16, (n, mb_h, mb_w, 2), device)
    check_aligned("mv", mb["mv"], 4)


def _launch(comps: list, mb: dict | None, n: int, mb_h: int, mb_w: int,
            device) -> list:
    """One launch over ``comps``, each (wire leaves, luma_like, whether to
    write the block grids), all on one CUDA device; ``mb`` is the GOP's
    per-MB sideband (needed when a component writes its grids).  Returns
    per component its outputs: ``levels``, and with the grids ``lnz``,
    plus ``q``, ``intra``, ``mv``, ``rep_add`` for a luma-like one.  The
    inputs are checked (and the outputs allocated) before the device: a
    ``meta`` tensor shows what would be rejected."""
    global launches
    if not 1 <= len(comps) <= MAX_COMPS:
        raise ValueError(f"{len(comps)} components; the expansion kernel "
                         f"takes 1 to {MAX_COMPS}")
    if mb is not None:
        _check_mb(mb, n, mb_h, mb_w, device)
    begins, total = expand_layout(
        [n * comp_blocks(mb_h, mb_w, luma) for _, luma, _ in comps])
    outs, ptrs, dims = [], [], []
    for (c, luma, grids), begin in zip(comps, begins):
        _check_comp(c, n, mb_h, mb_w, luma, device)
        rep = 2 if luma else 1
        hb, wb = mb_h * rep, mb_w * rep
        o = {"levels": torch.empty((n, hb * 8, wb * 8), dtype=torch.int16,
                                   device=device)}
        check_aligned("levels", o["levels"], 16)
        if grids:
            o["lnz"] = torch.empty((n, hb, wb), dtype=torch.uint8,
                                   device=device)
            if luma:
                for key in ("q", "intra", "rep_add"):
                    o[key] = torch.empty((n, hb, wb), dtype=torch.uint8,
                                         device=device)
                o["mv"] = torch.empty((n, hb, wb, 2), dtype=torch.int16,
                                      device=device)
        grid_ptrs = ([o[k].data_ptr() for k in ("q", "intra", "rep_add",
                                                "mv")]
                     if grids and luma else [None] * 4)
        ptrs += [c["cpk"].data_ptr() or None, c["n"].data_ptr(),
                 c["counts"].data_ptr(), o["levels"].data_ptr(),
                 o["lnz"].data_ptr() if grids else None, *grid_ptrs]
        dims += [n, mb_h, mb_w, int(luma), c["cpk"].shape[0], begin]
        outs.append(o)
    if device.type != "cuda":
        raise ValueError(f"no expansion kernel for device {device}")
    if total == 0:                         # no frames: nothing to launch
        return outs
    mb_ptrs = ([mb[k].data_ptr() for k in ("q", "intra", "rep_add", "mv")]
               if mb is not None else [None] * 4)

    from .build import load

    lib = load().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.jsvx_expand_gop(
        len(comps), (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(dims))(*dims), total,
        (ctypes.c_void_p * 4)(*mb_ptrs), device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"expansion kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return outs


def expand_levels(cpk: torch.Tensor, n_coef: torch.Tensor,
                  counts: torch.Tensor, mb_h: int, mb_w: int,
                  luma_like: bool) -> torch.Tensor:
    """Packed entries -> dense int16 coefficient plane stack (n, H, W):
    the one-component case of :func:`expand_compact_gop`'s launch on a
    card, the plain version on the CPU.

    ``counts`` is (n_frames, n_blocks) uint8 with blocks in (mb*4 + b)
    order for luma-like components and mb order for chroma.  Entries at
    index >= ``n_coef`` (padding) are dropped.
    """
    if cpk.device.type == "cpu":
        return expand_levels_plain(cpk, n_coef, counts, mb_h, mb_w,
                                   luma_like)
    c = {"cpk": cpk, "n": n_coef, "counts": counts}
    return _launch([(c, luma_like, False)], None, counts.shape[0], mb_h,
                   mb_w, cpk.device)[0]["levels"]


def expand_compact_gop(stacked: dict, mb_h: int, mb_w: int) -> dict:
    """Compact wire dict -> the dense stacked-GOP dict the kernels eat: one
    kernel launch for every component on a card, the plain version on the
    CPU.  The same keys, dtypes and shapes either way; chroma's grids are
    the wire's own per-MB tensors (a chroma block is a macroblock).
    """
    mb = stacked["mb"]
    device = mb["q"].device
    if device.type == "cpu":
        return expand_compact_gop_plain(stacked, mb_h, mb_w)
    keys = [k for k in COMP_KEYS if k in stacked["coef"]]
    luma = [k in ("y", "a") for k in keys]
    comps = _launch([(stacked["coef"][k], lm, True)
                     for k, lm in zip(keys, luma)], mb, mb["q"].shape[0],
                    mb_h, mb_w, device)
    out = {"is_p": stacked["is_p"], "f_code": stacked["f_code"]}
    for key, lm, o in zip(keys, luma, comps):
        grids = o if lm else mb
        out[key] = dict(levels=o["levels"], lnz=o["lnz"], q=grids["q"],
                        intra=grids["intra"], mv=grids["mv"],
                        rep_add=grids["rep_add"])
    return out
