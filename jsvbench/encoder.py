"""The benchmark's JSV encoder: every block of a picture at once, in numpy.

A frozen copy of the port's fixture encoder (``jsvx_torch/tools/encoder.py``)
in its syntax and its decisions, rewritten so that a 1080p picture takes
well under a second:

* I and P pictures, forward motion, half-pel, one slice per macroblock
  row, a sequence header before every GOP, the GOP key map;
* motion is given by the caller (the clip's own zoom-pan field) and
  refined here over the 3x3 half-pel neighbourhood by the prediction's
  SAD, all macroblocks at once;
* the intra/inter decision, skipped macroblocks, DC and motion-vector
  prediction, run/level coding and escapes are the fixture encoder's;
* the transform, quantisation, the closed-loop reconstruction (the
  float64 oracle's math, so the reference decodes exactly this) and the
  VLC emission run over whole pictures: each code is one entry of a
  symbol array, and the bits are packed at the end.

:func:`encode_gop` returns one GOP's picture payloads and the pictures'
reconstructions; :func:`assemble` writes the container, the key map and
the sequence and GOP headers around GOPs of payloads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .reference import refmath
from .reference import tables as T
from .reference.bitio import BitWriter
from .reference.oracle import idct_plane, predict_plane
from .reference.vlc import compiled_tables

_RL_MAX_LEVEL = 255
_ESCAPE_CODE = 0b000001
_BIT_LENGTH = np.array([v.bit_length() for v in range(256)], np.int64)


#: the fixture encoder's intra decision: a macroblock goes intra when its
#: mean absolute residual passes this and 1.1 x its own mean deviation
INTRA_SAD_THRESHOLD = 18.0


@dataclass(frozen=True)
class EncodeParams:
    quantizer_scale: int
    rate_code: int = 4                 # 29.97 Hz
    f_code: int = 3


# ---------------------------------------------------------------------------
# Block layout

def to_blocks(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Planes -> (mb_h, mb_w, 6, 8, 8): luma TL, TR, BL, BR, then Cb, Cr."""
    mb_h, mb_w = y.shape[0] // 16, y.shape[1] // 16
    lum = y.reshape(mb_h, 2, 8, mb_w, 2, 8).transpose(0, 3, 1, 4, 2, 5)
    lum = lum.reshape(mb_h, mb_w, 4, 8, 8)
    ch = [p.reshape(mb_h, 8, mb_w, 8).transpose(0, 2, 1, 3)[:, :, None]
          for p in (cb, cr)]
    return np.concatenate([lum] + ch, axis=2)


def from_blocks(b: np.ndarray) -> tuple:
    """The inverse of :func:`to_blocks`."""
    mb_h, mb_w = b.shape[:2]
    y = b[:, :, :4].reshape(mb_h, mb_w, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5)
    y = y.reshape(mb_h * 16, mb_w * 16)
    ch = [b[:, :, k].transpose(0, 2, 1, 3).reshape(mb_h * 8, mb_w * 8)
          for k in (4, 5)]
    return y, ch[0], ch[1]


def fdct(b: np.ndarray) -> np.ndarray:
    c = refmath.C_BASIS
    return np.matmul(np.matmul(c.T, b), c)


# ---------------------------------------------------------------------------
# VLC tables as arrays

class _Codes:
    def __init__(self):
        v = compiled_tables()
        self.addr = v["mb_addr_inc"].encode
        self.type_i = v["mb_type_i"].encode
        self.type_p = v["mb_type_p"].encode
        self.cbp = v["cbp"].encode
        self.motion = v["motion"].encode
        self.dc = [v["dc_size_lum"].encode, v["dc_size_chrom"].encode]
        # run/level -> (code with its sign bit slot, length); 0 = escape
        self.rl_code = np.zeros((64, 256), np.uint64)
        self.rl_len = np.zeros((64, 256), np.int64)
        for key, (code, n) in v["dct_coeff"].encode.items():
            if key == T.DCT_COEFF_ESCAPE:
                continue
            self.rl_code[key >> 8, key & 0xFF] = code << 1
            self.rl_len[key >> 8, key & 0xFF] = n + 1
        self.rl_code[0, 1], self.rl_len[0, 1] = 0b110, 3   # '11' s
        lut = lambda enc, lo, hi: (
            np.array([enc[i][0] if i in enc else 0 for i in range(lo, hi)],
                     np.uint64),
            np.array([enc[i][1] if i in enc else 0 for i in range(lo, hi)],
                     np.int64))
        self.addr_code, self.addr_len = lut(self.addr, 0, 36)
        self.cbp_code, self.cbp_len = lut(self.cbp, 0, 64)
        self.mv_code, self.mv_len = lut(self.motion, -16, 17)
        self.dc_code = [lut(t, 0, 9) for t in self.dc]


_CODES = None


def codes() -> _Codes:
    global _CODES
    if _CODES is None:
        _CODES = _Codes()
    return _CODES


def pack_bits(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """Concatenate codes MSB first; the total must be whole bytes."""
    keep = nbits > 0
    values, nbits = values[keep].astype(np.uint64), nbits[keep]
    total = int(nbits.sum())
    if total % 8:
        raise ValueError("symbols do not end on a byte boundary")
    sym = np.repeat(np.arange(len(nbits)), nbits)
    start = np.cumsum(nbits) - nbits
    shift = (nbits[sym] - 1 - (np.arange(total) - start[sym])).astype(
        np.uint64)
    bits = ((values[sym] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits).tobytes()


# ---------------------------------------------------------------------------
# Pictures

@dataclass
class _Picture:
    """Per macroblock: ``kind`` 0 skipped, 1 inter not coded, 2 inter
    coded, 3 intra; the vectors, the zig-zagged levels of the six blocks,
    their coded flags and the intra DC values."""

    kind: np.ndarray             # (mb_h, mb_w)
    mv: np.ndarray               # (mb_h, mb_w, 2) (vy, vx) half-pel
    zz: np.ndarray               # (mb_h, mb_w, 6, 64) int64, scan order
    coded: np.ndarray            # (mb_h, mb_w, 6) bool
    dc: np.ndarray               # (mb_h, mb_w, 6) int64 (intra only)
    q_rows: np.ndarray           # (mb_h,) each slice's quantiser


def _quantise(freq: np.ndarray, q: int, matrix: np.ndarray) -> np.ndarray:
    lv = np.round(8.0 * freq / (q * matrix))
    return np.clip(lv, -_RL_MAX_LEVEL, _RL_MAX_LEVEL).astype(np.int64)


def _dequant_planes(levels_blocks, intra_mb, dc, q, iq, nq):
    """Dequantised coefficient planes, the oracle's rule: intra blocks
    ``dequant_intra`` with the DC 8 * dc, the others ``dequant_inter``."""
    lv = levels_blocks.astype(np.float64)
    di = refmath.dequant_intra(lv, q, iq)
    di[..., 0, 0] = 8.0 * dc
    dn = refmath.dequant_inter(lv, q, nq)
    return np.where(intra_mb[:, :, None, None, None], di, dn)


def _clip_mv(mv: np.ndarray, f_code: int, hh: int, ww: int) -> np.ndarray:
    """The fixture encoder's limits: the f_code range, then every
    half-pel window inside the picture."""
    mb_h, mb_w = mv.shape[:2]
    half = (16 << (f_code - 1)) - 1
    mv = np.clip(mv, -half - 1, half)
    row = np.arange(mb_h)[:, None]
    col = np.arange(mb_w)[None, :]
    vy = np.clip(mv[..., 0], -32 * row, 2 * (hh - 16 * row - 18))
    vx = np.clip(mv[..., 1], -32 * col, 2 * (ww - 16 * col - 18))
    return np.stack([vy, vx], -1)


def refine_motion(y: np.ndarray, ref_y: np.ndarray, mv: np.ndarray,
                  f_code: int) -> np.ndarray:
    """``mv`` and its four half-pel neighbours searched by the luma
    prediction's SAD, every macroblock at once."""
    hh, ww = y.shape
    mb_h, mb_w = mv.shape[:2]
    cur = y.reshape(mb_h, 16, mb_w, 16)
    everywhere = np.ones((mb_h, mb_w), bool)
    best_sad = np.full((mb_h, mb_w), np.inf)
    best = mv
    for step in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
        cand = _clip_mv(mv + np.array(step), f_code, hh, ww)
        pred = predict_plane(ref_y, cand, everywhere, 16)
        sad = np.abs(cur - pred.reshape(mb_h, 16, mb_w, 16)).sum((1, 3))
        better = sad < best_sad
        best_sad = np.where(better, sad, best_sad)
        best = np.where(better[..., None], cand, best)
    return best


def row_quantisers(q: float, mb_h: int) -> np.ndarray:
    """Whole quantisers for the slices (macroblock rows) of a picture
    whose mean is ``q``: the rows take floor(q) or floor(q) + 1, spread
    over the picture."""
    offsets = (np.arange(mb_h) * 0.6180339887498949) % 1.0
    return np.clip(np.floor(q + offsets), 1, 31).astype(np.int64)


def encode_picture(planes: tuple, ref: tuple | None, mv: np.ndarray | None,
                   p: EncodeParams, iq: np.ndarray, nq: np.ndarray,
                   q_rows: np.ndarray):
    """One picture: (its decisions, its reconstruction).  ``ref`` None
    makes an I picture; otherwise ``mv`` is the motion field to refine.
    ``q_rows`` is each slice's quantiser."""
    y, cb, cr = (x.astype(np.float64) for x in planes)
    mb_h, mb_w = y.shape[0] // 16, y.shape[1] // 16
    q = q_rows.astype(np.float64)[:, None, None, None, None]
    src = to_blocks(y, cb, cr)
    intra_mb = np.ones((mb_h, mb_w), bool)
    preds = [np.zeros_like(x) for x in (y, cb, cr)]
    if ref is not None:
        mv = refine_motion(y, ref[0], _clip_mv(mv, p.f_code, *y.shape),
                           p.f_code)
        everywhere = np.ones((mb_h, mb_w), bool)
        preds = [predict_plane(r, mv, everywhere, 16 if i == 0 else 8)
                 for i, r in enumerate(ref)]
        ymb = y.reshape(mb_h, 16, mb_w, 16)
        res_y = ymb - preds[0].reshape(mb_h, 16, mb_w, 16)
        intra_cost = np.abs(ymb - ymb.mean((1, 3), keepdims=True)).mean((1, 3))
        inter_cost = np.abs(res_y).mean((1, 3))
        intra_mb = inter_cost > np.maximum(INTRA_SAD_THRESHOLD,
                                           intra_cost * 1.1)
    else:
        mv = np.zeros((mb_h, mb_w, 2), np.int64)

    # intra: DC apart, AC by the intra matrix
    f_src = fdct(src)
    lv_i = _quantise(f_src, q, iq)
    lv_i[..., 0, 0] = 0
    dc = np.clip(np.round(f_src[..., 0, 0] / 8.0), 0, 255).astype(np.int64)
    # inter: the residual by the non-intra matrix
    pred_b = to_blocks(*preds)
    lv_n = _quantise(fdct(src - pred_b), q, nq)
    lv_n[intra_mb] = 0
    levels = np.where(intra_mb[:, :, None, None, None], lv_i, lv_n)
    dc = np.where(intra_mb[:, :, None], dc, 0)
    coded = np.where(intra_mb[:, :, None], True, (lv_n != 0).any((3, 4)))

    col = np.arange(mb_w)[None, :]
    kind = np.where(intra_mb, 3, np.where(coded.any(2), 2, 1))
    if ref is not None:
        skip = ((kind == 1) & (mv == 0).all(2) & (col != 0)
                & (col != mb_w - 1))
        kind = np.where(skip, 0, kind)
    mv = np.where((kind == 3)[..., None] | (kind == 0)[..., None], 0, mv)

    # the closed loop: what the float64 oracle decodes from this picture
    deq = _dequant_planes(levels, intra_mb, dc, q, iq, nq)
    res = [idct_plane(d) for d in from_blocks(deq)]
    if ref is None:
        recon = tuple(np.clip(np.round(r), 0, 255) for r in res)
    else:
        # the same vectors (a skipped macroblock's is 0 already), with
        # intra macroblocks predicting 0
        keep = [np.repeat(np.repeat(~intra_mb, k, 0), k, 1) for k in
                (16, 8, 8)]
        recon = tuple(np.clip(np.round(np.where(m, pr, 0.0) + r), 0, 255)
                      for pr, r, m in zip(preds, res, keep))
    zz = levels.reshape(mb_h, mb_w, 6, 64)[..., T.ZIG_ZAG]
    return _Picture(kind=kind, mv=mv, zz=zz, coded=coded, dc=dc,
                    q_rows=q_rows), recon


def _dc_symbols(pic: _Picture, c: _Codes):
    """(value, bits) of each intra block's DC: size code then the
    difference, predicted along the slice and reset to 128 after a
    macroblock that is not intra (and at each slice's start)."""
    intra = pic.kind == 3
    prev_intra = np.zeros_like(intra)
    prev_intra[:, 1:] = intra[:, :-1]
    dc = pic.dc
    pred = np.empty_like(dc)
    last_y = np.full(intra.shape, 128, np.int64)
    last_y[:, 1:] = dc[:, :-1, 3]
    pred[..., 0] = np.where(prev_intra, last_y, 128)
    pred[..., 1:4] = dc[..., 0:3]
    for k in (4, 5):
        last = np.full(intra.shape, 128, np.int64)
        last[:, 1:] = dc[:, :-1, k]
        pred[..., k] = np.where(prev_intra, last, 128)
    diff = dc - pred
    size = _BIT_LENGTH[np.abs(diff)]
    extra = np.where(diff > 0, diff, diff + (1 << size) - 1)
    chroma = np.zeros(diff.shape, bool)
    chroma[..., 4:] = True
    code = np.where(chroma, c.dc_code[1][0][size], c.dc_code[0][0][size])
    clen = np.where(chroma, c.dc_code[1][1][size], c.dc_code[0][1][size])
    value = (code << size.astype(np.uint64)) | extra.astype(np.uint64)
    return value, clen + size


def _mv_symbols(pic: _Picture, f_code: int, c: _Codes):
    """(value, bits) of each macroblock's two motion codes (x, then y),
    predicted from the previous macroblock when it was inter and coded
    in this slice, else from 0."""
    moving = (pic.kind == 1) | (pic.kind == 2)
    prev = np.zeros_like(moving)
    prev[:, 1:] = moving[:, :-1]
    pred = np.zeros_like(pic.mv)
    pred[:, 1:] = pic.mv[:, :-1]
    pred = np.where(prev[..., None], pred, 0)
    r_size = f_code - 1
    big = 1 << r_size
    d = pic.mv - pred
    d = np.where(d > (big << 4) - 1, d - (big << 5), d)
    d = np.where(d < -(big << 4), d + (big << 5), d)
    out_v, out_n = [], []
    for axis in (1, 0):
        da = d[..., axis]
        mag = np.abs(da)
        if big == 1:
            principal = da
            residual = rbits = np.zeros_like(da)
        else:
            moved = da != 0
            principal = np.where(moved, np.sign(da) * (((mag - 1) >> r_size)
                                                       + 1), 0)
            residual = np.where(moved, (mag - 1) & (big - 1), 0)
            rbits = np.where(moved, r_size, 0)
        out_v.append((c.mv_code[principal + 16] << rbits.astype(np.uint64))
                     | residual.astype(np.uint64))
        out_n.append(c.mv_len[principal + 16] + rbits)
    return out_v, out_n


def picture_bytes(pic: _Picture, temporal_ref: int, is_p: bool,
                  p: EncodeParams) -> bytes:
    """The picture's header and slices, as the fixture encoder writes
    them."""
    c = codes()
    mb_h, mb_w = pic.kind.shape
    n_mb = mb_h * mb_w
    col = np.tile(np.arange(mb_w), mb_h)
    kind = pic.kind.reshape(-1)
    # -- per macroblock: 8 header slots
    hv = np.zeros((n_mb, 8), np.uint64)
    hn = np.zeros((n_mb, 8), np.int64)
    first = col == 0
    slice_hdr = ((np.uint64(0x000001) << np.uint64(8))
                 | (np.repeat(np.arange(mb_h), mb_w) + T.START_SLICE_FIRST
                    ).astype(np.uint64))
    hv[first, 0] = ((slice_hdr[first] << np.uint64(6))
                    | (pic.q_rows.astype(np.uint64) << np.uint64(1)))
    hn[first, 0] = 38
    sent = kind != 0
    # address increment: columns since the previous macroblock sent
    idx = np.where(sent, col, -1).reshape(mb_h, mb_w)
    last = np.maximum.accumulate(np.where(idx >= 0, idx, -1), axis=1)
    prev_sent = np.full((mb_h, mb_w), -1)
    prev_sent[:, 1:] = last[:, :-1]
    inc = (col.reshape(mb_h, mb_w) - prev_sent).reshape(-1)
    n_esc = (inc - 1) // 33
    rest = inc - 33 * n_esc
    esc_code, esc_len = c.addr[T.MB_ADDRESS_INCREMENT_ESCAPE]
    esc_bits = np.zeros(n_mb, np.uint64)
    for k in range(int(n_esc.max(initial=0))):
        more = n_esc > k
        esc_bits[more] = (esc_bits[more] << np.uint64(esc_len)) | np.uint64(
            esc_code)
    hv[sent, 1] = ((esc_bits << c.addr_len[rest].astype(np.uint64))
                   | c.addr_code[rest])[sent]
    hn[sent, 1] = (esc_len * n_esc + c.addr_len[rest])[sent]
    # macroblock type
    if is_p:
        tcode = {3: 0x01, 2: 0x0A, 1: 0x08}
        table = c.type_p
    else:
        tcode, table = {3: 0x01}, c.type_i
    for k, t in tcode.items():
        sel = kind == k
        hv[sel, 2], hn[sel, 2] = table[t]
    # motion
    if is_p:
        mvv, mvn = _mv_symbols(pic, p.f_code, c)
        moving = (kind == 1) | (kind == 2)
        for j in range(2):
            hv[moving, 3 + j] = mvv[j].reshape(-1)[moving]
            hn[moving, 3 + j] = mvn[j].reshape(-1)[moving]
        inter_coded = kind == 2
        cbp = (pic.coded.reshape(n_mb, 6)
               * (1 << np.arange(5, -1, -1))).sum(1)
        hv[inter_coded, 5] = c.cbp_code[cbp[inter_coded]]
        hn[inter_coded, 5] = c.cbp_len[cbp[inter_coded]]
    # -- blocks: DC (intra), run/levels, end of block
    coded = pic.coded.reshape(n_mb * 6) & np.repeat(sent, 6)
    intra_blk = np.repeat(kind == 3, 6)
    dcv, dcn = _dc_symbols(pic, c)
    zz = pic.zz.reshape(n_mb * 6, 64)
    nzmask = (zz != 0) & coded[:, None]
    nzmask[:, 0] &= ~intra_blk
    blk, pos = np.nonzero(nzmask)
    lv = zz[blk, pos]
    start = np.where(intra_blk[blk], 1, 0)
    new_blk = np.ones(len(blk), bool)
    new_blk[1:] = blk[1:] != blk[:-1]
    prev_pos = np.empty_like(pos)
    prev_pos[0:1] = 0
    prev_pos[1:] = pos[:-1]
    run = np.where(new_blk, pos - start, pos - prev_pos - 1)
    mag = np.abs(lv)
    sign = (lv < 0).astype(np.uint64)
    av = c.rl_code[run, mag] | sign
    an = c.rl_len[run, mag]
    firstc = new_blk & ~intra_blk[blk] & (run == 0) & (mag == 1)
    av = np.where(firstc, np.uint64(0b10) | sign, av)
    an = np.where(firstc, 2, an)
    esc = an == 0
    lvl_bits = np.where((lv > 0) & (lv < 128), lv,
                        np.where(lv >= 128, lv,
                                 np.where(lv > -128, lv + 256,
                                          (128 << 8) | ((lv + 256) & 0xFF))))
    lvl_len = np.where((lv > -128) & (lv < 128), 8, 16)
    ev = ((np.uint64(_ESCAPE_CODE) << np.uint64(6)) | run.astype(np.uint64))
    ev = (ev << lvl_len.astype(np.uint64)) | lvl_bits.astype(np.uint64)
    av = np.where(esc, ev, av)
    an = np.where(esc, 12 + lvl_len, an)
    # -- order: per macroblock its header slots, then per block DC, the
    # run/levels by scan position, the end of block; a slice ends on a
    # byte boundary
    mb_of_blk = np.arange(n_mb * 6) // 6
    b_in_mb = np.arange(n_mb * 6) % 6
    sub = 1000
    keys = [np.arange(n_mb)[:, None] * sub + np.arange(8)[None, :]]
    vals, lens = [hv], [hn]
    dci = np.nonzero(coded & intra_blk)[0]
    keys.append(mb_of_blk[dci] * sub + 8 + b_in_mb[dci] * 66)
    vals.append(dcv.reshape(-1)[dci])
    lens.append(dcn.reshape(-1)[dci])
    keys.append(mb_of_blk[blk] * sub + 8 + b_in_mb[blk] * 66 + 1 + pos)
    vals.append(av)
    lens.append(an)
    cb = np.nonzero(coded)[0]
    keys.append(mb_of_blk[cb] * sub + 8 + b_in_mb[cb] * 66 + 65)
    vals.append(np.full(len(cb), 0b10, np.uint64))
    lens.append(np.full(len(cb), 2, np.int64))
    key = np.concatenate([k.reshape(-1) for k in keys])
    val = np.concatenate([v.reshape(-1) for v in vals]).astype(np.uint64)
    ln = np.concatenate([n.reshape(-1) for n in lens]).astype(np.int64)
    row_bits = np.bincount(key // sub // mb_w, weights=ln, minlength=mb_h)
    pad = (-row_bits.astype(np.int64)) % 8
    key = np.concatenate([key, (np.arange(mb_h) * mb_w + mb_w - 1) * sub
                          + 999])
    val = np.concatenate([val, np.zeros(mb_h, np.uint64)])
    ln = np.concatenate([ln, pad])
    order = np.argsort(key, kind="stable")
    body = pack_bits(val[order], ln[order])

    w = BitWriter()
    w.put_start_code(T.START_PICTURE)
    w.put_bits(temporal_ref & 0x3FF, 10)
    w.put_bits(T.PICTURE_TYPE_P if is_p else T.PICTURE_TYPE_I, 3)
    w.put_bits(0xFFFF, 16)                  # vbv_delay
    if is_p:
        w.put_bits(0, 1)                    # full_pel: half-pel vectors
        w.put_bits(p.f_code, 3)
    w.byte_align()
    return w.getvalue() + body


def encode_gop(frames: list, motion: list, p: EncodeParams,
               target_bytes: float | None = None) -> tuple:
    """One GOP, an I picture then P pictures: (the pictures' bytes, their
    reconstructions, each picture's quantiser).  ``motion[i]`` is picture
    i's (mb_h, mb_w, 2) field (half-pel, into picture i-1), unused for
    picture 0.  With ``target_bytes`` (a mean per picture) the P pictures
    keep to the GOP's budget, as a constant-rate encoder does: each P
    picture's quantiser follows the last one's size against the budget
    left for each picture still to code."""
    iq = T.DEFAULT_INTRA_QUANT_MATRIX.reshape(8, 8).astype(np.float64)
    nq = T.DEFAULT_NON_INTRA_QUANT_MATRIX.reshape(8, 8).astype(np.float64)
    payloads, recons, qs, ref = [], [], [], None
    q = float(p.quantizer_scale)
    mb_h = frames[0][0].shape[0] // 16
    for i, planes in enumerate(frames):
        if target_bytes is not None and i > 1:
            left = target_bytes * len(frames) - sum(map(len, payloads))
            want = max(left / (len(frames) - i), 1.0)
            q = float(np.clip(q * (len(payloads[-1]) / want) ** 0.8, 1, 31))
        q_rows = row_quantisers(q, mb_h)
        pic, ref = encode_picture(planes, ref, motion[i] if i else None, p,
                                  iq, nq, q_rows)
        payloads.append(picture_bytes(pic, i, i > 0, p))
        recons.append(tuple(x.astype(np.uint8) for x in ref))
        qs.append(float(q_rows.mean()))
    return payloads, recons, qs


# ---------------------------------------------------------------------------
# Container

def pack_timecode(frame_index: int, rate: float) -> int:
    fps = int(round(rate))
    total_sec, frame = divmod(frame_index, max(fps, 1))
    minute, second = divmod(total_sec, 60)
    hour, minute = divmod(minute, 60)
    return (((hour & 0x1F) << 26) | ((minute & 0x3F) << 20) | (1 << 19)
            | ((second & 0x3F) << 13) | ((frame & 0x3F) << 7))


def gop_header(width: int, height: int, p: EncodeParams, frame0: int,
               max_pic: int) -> bytes:
    """A sequence header (default matrices) and a GOP header."""
    rate = float(T.PICTURE_RATE[p.rate_code])
    w = BitWriter()
    w.put_start_code(T.START_SEQUENCE)
    w.put_bits(width, 12)
    w.put_bits(height, 12)
    w.put_bits(1, 4)                        # aspect: square
    w.put_bits(p.rate_code, 4)
    w.put_bits(3000, 18)                    # bit_rate (units of 400 bit/s)
    w.put_bits(1, 1)                        # marker
    w.put_bits(min((1 << 10) - 1, max_pic // 16384 + 1), 10)
    w.put_bits(0, 1)                        # constrained
    w.put_bits(0, 1)                        # default intra matrix
    w.put_bits(0, 1)                        # default non-intra matrix
    w.put_start_code(T.START_GOP)
    w.put_bits((pack_timecode(frame0, rate) >> 7) & 0x1FFFFFF, 25)
    w.byte_align()
    return w.getvalue()


def assemble(width: int, height: int, p: EncodeParams, gops: list) -> bytes:
    """The container header with its GOP key map, then each GOP (a list
    of picture payloads) after its own sequence and GOP headers."""
    rate = float(T.PICTURE_RATE[p.rate_code])
    frame0 = np.cumsum([0] + [len(g) for g in gops])
    max_pic = max(len(x) for g in gops for x in g)
    bodies = [gop_header(width, height, p, int(frame0[i]), max_pic)
              + b"".join(g) for i, g in enumerate(gops)]
    head = BitWriter()
    head.put_bits(0x4A56, 16)
    head.put_bits(width, 16)
    head.put_bits(height, 16)
    d100 = int(round(int(frame0[-1]) / rate * 100))
    if 0 < d100 < (1 << 16):
        head.put_bits(d100, 16)
    else:
        head.put_bits(0, 16)
        head.put_bits(0, 1)
        head.put_bits(d100, 23)
    head.put_bits(0x000001C4, 32)           # START_MAP
    head.put_bits(len(bodies), 32)
    off = head.bit_length // 8 + 8 * len(bodies)
    for i, body in enumerate(bodies):
        head.put_bits(off, 32)
        head.put_bits(pack_timecode(int(frame0[i]), rate), 32)
        off += len(body)
    head.byte_align()
    return head.getvalue() + b"".join(bodies)
