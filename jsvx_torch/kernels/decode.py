"""Plain PyTorch decode of one plane: the numerical spec of the port.

The same steps as :mod:`jsvx.kernels.decode` (integer dequantisation ->
8x8 IDCT -> half-pel motion compensation by per-pixel gather -> residual
add + clamp), written with torch ops on an explicit device.  On a CUDA
device the hand-written kernel (:mod:`jsvx_torch.kernels.fused`) computes
the same function; these functions are what it is held against.

One deliberate difference from the JAX spec: :func:`idct_plane` sums the
eight products of each 1-D pass in one fixed order (u = 0..7), as the
CUDA kernel does, with separate rounded multiplies and adds.  That makes
the kernel and this version bit-equal on the card; against the JAX
``einsum`` (whose summation order XLA chooses) the f32 IDCT differs in its
last bits, which after rounding flips a rare exact-.5 tie by one level.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..coding import tables as T
from ..tools import refmath

#: Component key per plane index; [3] is the YUVA alpha plane (full
#: resolution, luma-like block grid, motion vectors NOT halved).
COMP_KEYS = ("y", "cb", "cr", "a")


def frame_comp_keys(frame: dict) -> tuple:
    """The component keys present in a frame dict."""
    return tuple(k for k in COMP_KEYS if k in frame)


def comp_is_chroma(comp: int) -> bool:
    return comp in (1, 2)


@dataclass(frozen=True)
class DecodeConstants:
    """Per-sequence constants on one device.

    ``c_basis`` is the f32 IDCT basis (spatial = C @ F @ C.T); the quant
    matrices are kept as 64-tuples in spatial order, as in the JAX package.
    """

    c_basis: torch.Tensor        # f32 (8, 8)
    intra_q_key: tuple           # 64 ints, spatial order
    non_intra_q_key: tuple

    @property
    def device(self) -> torch.device:
        return self.c_basis.device

    @property
    def quant_key(self) -> tuple:
        """The intra then the non-intra matrix, 128 ints (:func:`quant_key`
        of the sequence these constants were made for)."""
        return self.intra_q_key + self.non_intra_q_key

    @property
    def qtab_host(self) -> tuple:
        """192 ints: intra matrix, non-intra matrix, scan position of each
        spatial position."""
        return (self.intra_q_key + self.non_intra_q_key
                + tuple(int(x) for x in T.ZIG_ZAG_INVERSE))

    @functools.cached_property
    def qtab(self) -> torch.Tensor:
        """:attr:`qtab_host` as int32 (3, 64) on the device.  Built once per
        constants object."""
        return torch.tensor(self.qtab_host, dtype=torch.int32,
                            device=self.device).reshape(3, 64)

    @functools.cached_property
    def c_basis_host(self) -> tuple:
        """The basis as 64 Python floats, row-major (each exactly the f32
        value); one copy from the device per constants object."""
        return tuple(self.c_basis.cpu().reshape(-1).tolist())


def quant_key(seq) -> tuple:
    """The intra then the non-intra quant matrix of sequence header
    ``seq`` (None: the defaults), 128 ints in spatial order."""
    intra_q = (seq.intra_q if seq is not None
               else T.DEFAULT_INTRA_QUANT_MATRIX)
    non_intra_q = (seq.non_intra_q if seq is not None
                   else T.DEFAULT_NON_INTRA_QUANT_MATRIX)
    return tuple(int(x) for m in (intra_q, non_intra_q)
                 for x in np.asarray(m).reshape(-1))


def make_constants(seq, device) -> DecodeConstants:
    key = quant_key(seq)
    return DecodeConstants(
        c_basis=torch.tensor(refmath.C_BASIS.astype(np.float32),
                             device=device),
        intra_q_key=key[:64], non_intra_q_key=key[64:])


def constants_per_seq(seqs: list, device) -> list:
    """The constants of each sequence header of ``seqs``: one
    :class:`DecodeConstants` per distinct pair of matrices, the same
    object wherever the matrices repeat (a stream whose headers all
    carry the same matrices gets one)."""
    made: dict = {}
    out = []
    for seq in seqs:
        key = quant_key(seq)
        if key not in made:
            made[key] = make_constants(seq, device)
        out.append(made[key])
    return out


def _up8(a: torch.Tensor) -> torch.Tensor:
    """Per-block (hb, wb, ...) -> per-pixel (8*hb, 8*wb, ...)."""
    return a.repeat_interleave(8, dim=0).repeat_interleave(8, dim=1)


# ---------------------------------------------------------------------------
# Host packing of one parsed picture

def _mb_to_blocks(a: np.ndarray, comp: int) -> np.ndarray:
    """Per-MB (mb_h, mb_w, ...) -> per-block grid of plane ``comp`` (each
    luma-like MB covers 2x2 blocks)."""
    if comp_is_chroma(comp):
        return a
    return np.repeat(np.repeat(a, 2, axis=0), 2, axis=1)


def frame_to_device(ft, dtype_levels=np.int16) -> dict:
    """FrameTensors -> dict of numpy arrays the decode consumes.

    The numpy copy of ``jsvx/kernels/decode.py::frame_to_device`` with
    ``mv_capacity=0``: the port's motion compensation reads per-block
    vectors, so no distinct-vector table is built.  Per-MB sideband is
    expanded to the per-block grid of each plane; the parser-emitted
    per-pixel ``mult``/``flags`` are carried when present.
    """
    out = dict(is_p=np.int32(0 if ft.is_intra_picture else 1),
               f_code=np.int32(ft.f_code))
    for comp in range(len(ft.levels)):
        c = dict(
            levels=ft.levels[comp].astype(dtype_levels, copy=False),
            lnz=ft.lnz[comp],
            q=_mb_to_blocks(ft.mb_quant, comp),
            intra=_mb_to_blocks(ft.mb_intra, comp),
            mv=_mb_to_blocks(ft.mb_mv, comp).astype(np.int16, copy=False),
            rep_add=_mb_to_blocks(ft.mb_rep_add, comp),
        )
        if ft.mult is not None:
            c["mult"] = ft.mult[comp]
            c["flags"] = ft.flags[comp]
        out[COMP_KEYS[comp]] = c
    return out


# ---------------------------------------------------------------------------
# Dequantisation (integer, reference semantics)

def dequant_values(lv: torch.Tensor, mult: torch.Tensor,
                   nonintra: torch.Tensor,
                   quirk_oddify_zeros: bool = False) -> torch.Tensor:
    """The integer core shared by both routes (and, in CUDA,
    ``csrc/block_math.cuh::dequant_coef``): int32 levels, ``mult`` = q * M
    and a non-intra mask, broadcast together -> clamped int32 values.

    x2 (+sign for non-intra), x mult, /16 with floor, mismatch control
    (an even result moves one step toward zero by ``sign(d)``, ISO 11172-2
    and ``jsvx/tools/refmath.py``), clamp to [-2048, 2047].  The caller
    applies the coded-scan mask and the intra DC override.
    """
    sign = torch.sign(lv)
    pre_sign = torch.where(lv < 0, -1, 1) if quirk_oddify_zeros else sign
    pre = torch.where(nonintra, 2 * lv + pre_sign, 2 * lv)
    d = (pre * mult) >> 4                  # floor(x / 16), negatives too
    even = (d & 1) == 0
    if quirk_oddify_zeros:
        d = torch.where(even, d - torch.where(d > 0, 1, -1), d)
    else:
        d = torch.where(even & (lv != 0), d - torch.sign(d), d)
    return d.clamp(-2048, 2047)


def dequant_plane(levels: torch.Tensor, q_blk: torch.Tensor,
                  intra_blk: torch.Tensor, lnz_blk: torch.Tensor,
                  consts: DecodeConstants,
                  quirk_oddify_zeros: bool = False) -> torch.Tensor:
    """int16 level plane -> f32 dequantised coefficient plane.

    :func:`dequant_values` with the per-block quantiser and matrix, then
    zero outside the coded scan range and intra DC = 8*level.
    """
    h, w = levels.shape
    hb, wb = h // 8, w // 8
    lv = levels.to(torch.int32).reshape(hb, 8, wb, 8)
    q = q_blk.to(torch.int32).reshape(hb, 1, wb, 1)
    intra = intra_blk.reshape(hb, 1, wb, 1) > 0
    lnz = lnz_blk.to(torch.int32).reshape(hb, 1, wb, 1)
    qtab = consts.qtab.to(levels.device)
    mi = qtab[0].reshape(1, 8, 1, 8)
    mn = qtab[1].reshape(1, 8, 1, 8)
    scan = qtab[2].reshape(1, 8, 1, 8)

    d = dequant_values(lv, q * torch.where(intra, mi, mn), ~intra,
                       quirk_oddify_zeros)
    d = torch.where(scan < lnz, d, 0)
    is_dc = scan == 0                      # spatial (0, 0): scan index 0
    d = torch.where(is_dc & intra, 8 * lv, d)
    return d.reshape(h, w).to(torch.float32)


# ---------------------------------------------------------------------------
# IDCT: two 1-D passes, each an explicit 8-term sum in fixed order

def idct_plane(d: torch.Tensor, consts: DecodeConstants) -> torch.Tensor:
    """Blockwise 8x8 IDCT of a coefficient plane: C @ F @ C.T per block.

    Each output of each pass is ``c[x,0]*f[0] + c[x,1]*f[1] + ... +
    c[x,7]*f[7]`` summed left to right, every product and partial sum
    rounded to f32 (separate multiplies and adds: never a fused
    multiply-add), the order the CUDA kernel uses.
    """
    h, w = d.shape
    c = consts.c_basis.to(d.device)
    f = d.reshape(h // 8, 8, w)            # column pass over each block's u
    cols = c[:, 0].reshape(1, 8, 1) * f[:, 0:1, :]
    for u in range(1, 8):
        cols = cols + c[:, u].reshape(1, 8, 1) * f[:, u:u + 1, :]
    g = cols.reshape(h, w // 8, 8)         # row pass over each block's v
    rows = c[:, 0].reshape(1, 1, 8) * g[:, :, 0:1]
    for v in range(1, 8):
        rows = rows + c[:, v].reshape(1, 1, 8) * g[:, :, v:v + 1]
    return rows.reshape(h, w)


# ---------------------------------------------------------------------------
# Motion compensation (per-pixel gather, MPEG half-pel rounding)

def predict_plane(ref: torch.Tensor, mv_blk: torch.Tensor,
                  rep_add_blk: torch.Tensor,
                  is_chroma: bool) -> torch.Tensor:
    """Edge-clamped half-pel prediction of a plane (int32).

    ``ref`` is the previous reconstructed plane (uint8).  ``mv_blk`` is the
    per-8x8-block motion vector in luma half-pel units; chroma planes halve
    it with truncation toward zero first.  Zero where ``rep_add`` is set
    (intra macroblocks of a P picture).
    """
    h, w = ref.shape
    mv = _up8(mv_blk.to(torch.int32))
    mvy, mvx = mv[..., 0], mv[..., 1]
    if is_chroma:
        mvy = torch.div(mvy, 2, rounding_mode="trunc")
        mvx = torch.div(mvx, 2, rounding_mode="trunc")
    fy, oy = mvy >> 1, mvy & 1
    fx, ox = mvx >> 1, mvx & 1

    yy = torch.arange(h, dtype=torch.int32, device=ref.device)[:, None] + fy
    xx = torch.arange(w, dtype=torch.int32, device=ref.device)[None, :] + fx
    flat = ref.to(torch.int32).reshape(-1)

    def at(dy, dx):
        iy = (yy + dy).clamp(0, h - 1)
        ix = (xx + dx).clamp(0, w - 1)
        return flat[(iy * w + ix).to(torch.int64)]

    a = at(0, 0)
    b = at(0, 1)
    c = at(1, 0)
    d = at(1, 1)
    pred = torch.where(
        (oy == 0) & (ox == 0), a,
        torch.where((oy == 0) & (ox == 1), (a + b + 1) >> 1,
                    torch.where((oy == 1) & (ox == 0), (a + c + 1) >> 1,
                                (a + b + c + d + 2) >> 2)))
    return torch.where(_up8(rep_add_blk) > 0, 0, pred)


# ---------------------------------------------------------------------------
# Full frame step

def decode_frame_plane(comp_inputs: dict, ref: torch.Tensor,
                       is_p: torch.Tensor, consts: DecodeConstants,
                       is_chroma: bool,
                       quirk_oddify_zeros: bool = False) -> torch.Tensor:
    """One plane of one picture -> reconstructed uint8 plane.

    Uniform over I/P: ``is_p`` (0-d int32 tensor) zeroes the prediction of
    an I picture, so a GOP loop can carry the reference planes.
    """
    d = dequant_plane(comp_inputs["levels"], comp_inputs["q"],
                      comp_inputs["intra"], comp_inputs["lnz"], consts,
                      quirk_oddify_zeros)
    res = idct_plane(d, consts)
    pred = predict_plane(ref, comp_inputs["mv"], comp_inputs["rep_add"],
                         is_chroma)
    pred = pred * is_p.to(torch.int32)
    out = torch.round(pred.to(torch.float32) + res)
    return out.clamp(0.0, 255.0).to(torch.uint8)


def decode_frame_planes(frame: dict, refs: tuple, consts: DecodeConstants,
                        quirk_oddify_zeros: bool = False) -> tuple:
    """All planes of one picture; ``refs`` = (Y, Cb, Cr[, A]) uint8."""
    return tuple(
        decode_frame_plane(frame[k], refs[i], frame["is_p"], consts,
                           comp_is_chroma(i), quirk_oddify_zeros)
        for i, k in enumerate(frame_comp_keys(frame)))
