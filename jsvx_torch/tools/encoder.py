"""JSV fixture encoder.

The reference repository ships no decodable stream (``videos/leon.jsv`` is a
stripped blob in the reference repository), so verifiable
test fixtures must be produced here.  This encoder emits the JSV container +
MPEG-1-subset elementary stream the reference decoder understands
(``decoders/jsv.js:237-280,491-561,583-676``):

* I and P pictures only, forward motion, half-pel precision;
* one slice per macroblock row;
* a sequence header before every GOP (required by the reference's seek
  loop, ``decoders/jsv.js:1631-1640``);
* optional GOP key map for seeking.

It is a *fixture generator*: correctness of emitted syntax matters,
rate-distortion quality does not.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..coding import tables as T
from ..coding.vlc import compiled_tables
from ..bitstream.bitio import BitWriter
from . import refmath
from .refmath import (
    C_BASIS as _C,
    fdct2,
    mc_chroma_block as _mc_chroma,
    mc_luma_block as _mc_luma,
    shift_plane as _shift_plane,
)

_RL_MAX_LEVEL = 255


@dataclass
class EncoderConfig:
    gop_size: int = 12
    quantizer_scale: int = 8
    rate_code: int = 5                 # 30 fps (tables.PICTURE_RATE)
    f_code: int = 3                    # motion range +/-(16<<(f_code-1))-1 half-pel
    full_pel: bool = False
    me_range: int = 7                  # full-pel search radius for P pictures
    half_pel_refine: bool = True
    intra_sad_threshold: float = 18.0  # mean abs residual above which MB -> intra
    use_skips: bool = True             # emit skipped-macroblock runs
    key_map: bool = True
    custom_intra_q: np.ndarray | None = None
    custom_non_intra_q: np.ndarray | None = None
    magic: int = 0x4A56                # 16 reserved header bits ("JV")


def blocks_of(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (H//8, W//8, 8, 8) view-by-copy."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def rgb_to_ycbcr(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BT.601 limited-range RGB -> (Y, Cb, Cr), chroma box-downsampled 2x."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    cb = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    cr = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    cb = cb.reshape(cb.shape[0] // 2, 2, cb.shape[1] // 2, 2).mean(axis=(1, 3))
    cr = cr.reshape(cr.shape[0] // 2, 2, cr.shape[1] // 2, 2).mean(axis=(1, 3))
    to8 = lambda p: np.clip(np.round(p), 0, 255).astype(np.uint8)
    return to8(y), to8(cb), to8(cr)


def pad_to_coded(plane: np.ndarray, mult: int = 16) -> np.ndarray:
    h, w = plane.shape
    ch = -(-h // mult) * mult
    cw = -(-w // mult) * mult
    if (ch, cw) == (h, w):
        return plane
    return np.pad(plane, ((0, ch - h), (0, cw - w)), mode="edge")


class _DCState:
    def __init__(self):
        self.reset()

    def reset(self):
        self.y = self.cb = self.cr = self.a = 128


class JsvEncoder:
    """Encodes YCbCr 4:2:0 frames into a JSV byte stream.

    Frames with a 4th plane (Y, Cb, Cr, A) switch the stream to YUVA
    mode: the container's alpha flag is set (``decoders/jsv.js:256-259``)
    and every macroblock carries 4 extra alpha blocks (always coded for
    intra MBs; gated by 4 alpha-cbp bits after the cbp VLC otherwise —
    see :class:`jsvx_torch.bitstream.parser.StreamParser`).  An alpha residual
    in a macroblock whose YCbCr cbp is zero is dropped (the cbp VLC has
    no zero codeword to hang the alpha pattern on); acceptable for a
    lossy fixture encoder.
    """

    def __init__(self, width: int, height: int,
                 config: EncoderConfig | None = None):
        self.cfg = config or EncoderConfig()
        self.width = width
        self.height = height
        self.yuva = False
        self.mb_w = (width + 15) >> 4
        self.mb_h = (height + 15) >> 4
        v = compiled_tables()
        self._t_addr = v["mb_addr_inc"]
        self._t_type_i = v["mb_type_i"]
        self._t_type_p = v["mb_type_p"]
        self._t_cbp = v["cbp"]
        self._t_motion = v["motion"]
        self._t_dc_lum = v["dc_size_lum"]
        self._t_dc_chrom = v["dc_size_chrom"]
        self._rl_encode = {  # (run, |level|) -> (code,len) with table quirks
            (k >> 8, k & 0xFF): c for k, c in v["dct_coeff"].encode.items()
            if k != T.DCT_COEFF_ESCAPE
        }
        iq = (self.cfg.custom_intra_q if self.cfg.custom_intra_q is not None
              else T.DEFAULT_INTRA_QUANT_MATRIX)
        nq = (self.cfg.custom_non_intra_q
              if self.cfg.custom_non_intra_q is not None
              else T.DEFAULT_NON_INTRA_QUANT_MATRIX)
        self.intra_q = iq.reshape(8, 8).astype(np.float64)
        self.non_intra_q = nq.reshape(8, 8).astype(np.float64)
        # decoded-reference reconstruction state (float64 oracle semantics)
        self._ref: list[np.ndarray] | None = None

    # ------------------------------------------------------------------

    def encode(self, frames: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
               picture_rate: float | None = None) -> bytes:
        cfg = self.cfg
        rate = float(T.PICTURE_RATE[cfg.rate_code])
        n = len(frames)
        duration = n / rate
        self.yuva = len(frames[0]) == 4

        # Encode GOPs to byte strings first (container offsets need sizes).
        gop_payloads = []
        gop_frame0 = []
        for g0 in range(0, n, cfg.gop_size):
            gop_frames = frames[g0:g0 + cfg.gop_size]
            gop_payloads.append(self._encode_gop(gop_frames, g0, rate))
            gop_frame0.append(g0)

        # Container header.
        head = BitWriter()
        head.put_bits(cfg.magic, 16)
        head.put_bits(self.width, 16)
        head.put_bits(self.height, 16)
        d100 = int(round(duration * 100))
        if 0 < d100 < (1 << 16) and not self.yuva:
            head.put_bits(d100, 16)
        else:
            # extended form: zero short-duration field, then yuva flag
            head.put_bits(0, 16)
            head.put_bits(1 if self.yuva else 0, 1)
            head.put_bits(d100, 23)
        if cfg.key_map:
            head.put_bits(0x000001C4, 32)  # START_MAP
            head.put_bits(len(gop_payloads), 32)
            header_size = head.bit_length // 8 + 8 * len(gop_payloads)
            off = header_size
            for gi, payload in enumerate(gop_payloads):
                head.put_bits(off, 32)
                head.put_bits(self._pack_timecode(gop_frame0[gi], rate), 32)
                off += len(payload)
        head.byte_align()
        out = bytearray(head.getvalue())
        for payload in gop_payloads:
            out.extend(payload)
        return bytes(out)

    # ------------------------------------------------------------------

    def _pack_timecode(self, frame_index: int, rate: float) -> int:
        fps = int(round(rate))
        total_sec, frame = divmod(frame_index, max(fps, 1))
        minute, second = divmod(total_sec, 60)
        hour, minute = divmod(minute, 60)
        tc = 0
        tc |= (hour & 0x1F) << 26
        tc |= (minute & 0x3F) << 20
        tc |= 1 << 19                       # marker
        tc |= (second & 0x3F) << 13
        tc |= (frame & 0x3F) << 7
        return tc

    def _encode_gop(self, frames, frame0: int, rate: float) -> bytes:
        cfg = self.cfg
        pictures = []
        self._ref = None
        for i, f in enumerate(frames):
            is_intra = i == 0
            pictures.append(self._encode_picture(f, i, is_intra))
        max_pic = max(len(p) for p in pictures)

        w = BitWriter()
        # Sequence header (decoders/jsv.js:491-561 field order).
        w.put_start_code(T.START_SEQUENCE)
        w.put_bits(self.width, 12)
        w.put_bits(self.height, 12)
        w.put_bits(1, 4)                    # aspect: square
        w.put_bits(cfg.rate_code, 4)
        w.put_bits(min((1 << 18) - 1, 3000), 18)   # bit_rate (units of 400bps)
        w.put_bits(1, 1)                    # marker
        w.put_bits(min((1 << 10) - 1, max_pic // 16384 + 1), 10)
        w.put_bits(0, 1)                    # constrained
        if cfg.custom_intra_q is not None:
            w.put_bits(1, 1)
            for i in range(64):
                w.put_bits(int(cfg.custom_intra_q[T.ZIG_ZAG[i]]), 8)
        else:
            w.put_bits(0, 1)
        if cfg.custom_non_intra_q is not None:
            w.put_bits(1, 1)
            for i in range(64):
                w.put_bits(int(cfg.custom_non_intra_q[T.ZIG_ZAG[i]]), 8)
        else:
            w.put_bits(0, 1)
        # GOP header.
        w.put_start_code(T.START_GOP)
        tc = self._pack_timecode(frame0, rate)
        w.put_bits((tc >> 7) & 0x1FFFFFF, 25)
        w.byte_align()
        out = bytearray(w.getvalue())
        for p in pictures:
            out.extend(p)
        return bytes(out)

    # ------------------------------------------------------------------
    # Picture encoding

    def _encode_picture(self, frame, temporal_ref: int,
                        is_intra: bool) -> bytes:
        cfg = self.cfg
        y, cb, cr, *rest = (
            pad_to_coded(p, 16 if i in (0, 3) else 8).astype(np.float64)
            for i, p in enumerate(frame))
        a = rest[0] if rest else None
        w = BitWriter()
        w.put_start_code(T.START_PICTURE)
        w.put_bits(temporal_ref & 0x3FF, 10)
        w.put_bits(T.PICTURE_TYPE_I if is_intra else T.PICTURE_TYPE_P, 3)
        w.put_bits(0xFFFF, 16)              # vbv_delay
        if not is_intra:
            w.put_bits(1 if cfg.full_pel else 0, 1)
            w.put_bits(cfg.f_code, 3)

        if is_intra:
            recon = self._encode_intra_picture(w, y, cb, cr, a)
        else:
            recon = self._encode_p_picture(w, y, cb, cr, a)
        self._ref = recon
        w.byte_align()
        return w.getvalue()

    def _encode_intra_picture(self, w: BitWriter, y, cb, cr, a=None):
        q = self.cfg.quantizer_scale
        recon = [np.zeros_like(y), np.zeros_like(cb), np.zeros_like(cr)]
        if a is not None:
            recon.append(np.zeros_like(a))
        for row in range(self.mb_h):
            self._begin_slice(w, row, q)
            dc = _DCState()
            for col in range(self.mb_w):
                w.put_code(self._t_addr, 1)
                w.put_code(self._t_type_i, 0x01)
                self._encode_mb_blocks_intra(w, y, cb, cr, row, col, q, dc,
                                             recon, a)
        return recon

    def _encode_p_picture(self, w: BitWriter, y, cb, cr, a=None):
        cfg = self.cfg
        q = cfg.quantizer_scale
        ref = self._ref
        assert ref is not None, "P picture without a reference frame"
        recon = [r.copy() for r in ref]
        mvs = self._motion_search(y, ref[0])
        half_range = (16 << (cfg.f_code - 1)) - 1

        for row in range(self.mb_h):
            self._begin_slice(w, row, q)
            dc = _DCState()
            mv_pred = np.zeros(2, dtype=np.int64)   # (vy, vx) half-pel
            pending_skip = 0

            def flush(pending: int) -> int:
                # Mirrors decoder state effects of increment > 1
                # (jsv.js:754-765): skip runs reset DC and MV predictors.
                self._flush_skips(w, pending)
                if pending > 0:
                    dc.reset()
                    mv_pred[:] = 0
                return 0

            for col in range(self.mb_w):
                mv = np.clip(mvs[row, col], -half_range - 1, half_range)
                # MPEG-1 forbids references outside the picture; keep the
                # half-pel interpolation window (17x17) fully in bounds.
                hh, ww = y.shape
                mv = np.clip(
                    mv,
                    [-32 * row, -32 * col],
                    [2 * (hh - 16 * row - 18), 2 * (ww - 16 * col - 18)])
                mv_t = (int(mv[0]), int(mv[1]))
                ymb = y[row * 16:row * 16 + 16, col * 16:col * 16 + 16]
                pred_y = _mc_luma(ref[0], row, col, mv_t)
                res_y = blocks_of(ymb - pred_y)
                intra_cost = np.abs(ymb - ymb.mean()).mean()
                inter_cost = np.abs(res_y).mean()
                use_intra = inter_cost > max(cfg.intra_sad_threshold,
                                             intra_cost * 1.1)

                if use_intra:
                    pending_skip = flush(pending_skip)
                    w.put_code(self._t_type_p, 0x01)
                    self._encode_mb_blocks_intra(w, y, cb, cr, row, col, q,
                                                 dc, recon, a)
                    mv_pred[:] = 0          # intra MBs reset MV predictors
                    continue

                # Quantise residuals for all 6 blocks.
                pred_cb = _mc_chroma(ref[1], row, col, mv_t)
                pred_cr = _mc_chroma(ref[2], row, col, mv_t)
                res_cb = (cb[row * 8:row * 8 + 8, col * 8:col * 8 + 8]
                          - pred_cb)
                res_cr = (cr[row * 8:row * 8 + 8, col * 8:col * 8 + 8]
                          - pred_cr)
                blocks = [res_y[0, 0], res_y[0, 1], res_y[1, 0], res_y[1, 1],
                          res_cb, res_cr]
                levels = [self._quant_inter(fdct2(b), q) for b in blocks]
                cbp = 0
                for bi, lv in enumerate(levels):
                    if np.any(lv):
                        cbp |= 0x20 >> bi

                acbp = 0
                levels_a = None
                if a is not None:
                    amb = a[row * 16:row * 16 + 16, col * 16:col * 16 + 16]
                    pred_a = _mc_luma(ref[3], row, col, mv_t)
                    res_a = blocks_of(amb - pred_a)
                    levels_a = [self._quant_inter(
                        fdct2(res_a[ai >> 1, ai & 1]), q) for ai in range(4)]
                    if cbp:                 # alpha pattern rides the cbp VLC
                        for ai, lv in enumerate(levels_a):
                            if np.any(lv):
                                acbp |= 0x8 >> ai
                    coded_a = [levels_a[ai] if acbp & (0x8 >> ai)
                               else np.zeros((8, 8)) for ai in range(4)]
                else:
                    coded_a = None

                can_skip = (cfg.use_skips and cbp == 0 and mv_t == (0, 0)
                            and col != 0 and col != self.mb_w - 1)
                if can_skip:
                    pending_skip += 1
                    self._reconstruct_inter(recon, row, col, mv_t,
                                            [np.zeros((8, 8))] * 6, q,
                                            [np.zeros((8, 8))] * 4
                                            if a is not None else None)
                    continue

                pending_skip = flush(pending_skip)
                mb_type = 0x0A if cbp else 0x08
                w.put_code(self._t_type_p, mb_type)
                self._encode_motion(w, mv_t, mv_pred)
                if cbp:
                    w.put_code(self._t_cbp, cbp)
                    if a is not None:
                        w.put_bits(acbp, 4)
                    for bi, lv in enumerate(levels):
                        if cbp & (0x20 >> bi):
                            self._encode_block_rl(w, lv, first_is_dc=True)
                    for ai in range(4):
                        if acbp & (0x8 >> ai):
                            self._encode_block_rl(w, levels_a[ai],
                                                  first_is_dc=True)
                dc.reset()                  # non-intra MBs reset DC predictors
                self._reconstruct_inter(recon, row, col, mv_t, levels, q,
                                        coded_a)
        return recon

    # ------------------------------------------------------------------
    # Macroblock helpers

    def _begin_slice(self, w: BitWriter, row: int, q: int) -> None:
        w.put_start_code(T.START_SLICE_FIRST + row)
        w.put_bits(q, 5)
        w.put_bits(0, 1)                    # no extra information

    def _flush_skips(self, w: BitWriter, n_skipped: int) -> None:
        increment = n_skipped + 1
        while increment > 33:
            w.put_code(self._t_addr, T.MB_ADDRESS_INCREMENT_ESCAPE)
            increment -= 33
        w.put_code(self._t_addr, increment)

    def _encode_motion(self, w: BitWriter, mv, mv_pred) -> None:
        f_code = self.cfg.f_code
        r_size = f_code - 1
        F = 1 << r_size
        # Reference order: horizontal then vertical (jsv.js:835-886);
        # mv is stored (vy, vx), so axis 1 (x) goes first.
        for axis in (1, 0):
            d = int(mv[axis]) - int(mv_pred[axis])
            lo, hi = -(F << 4), (F << 4) - 1
            if d > hi:
                d -= F << 5
            elif d < lo:
                d += F << 5
            if d == 0 or F == 1:
                w.put_code(self._t_motion, d)
            else:
                mag = abs(d)
                principal = ((mag - 1) >> r_size) + 1
                residual = (mag - 1) & (F - 1)
                w.put_code(self._t_motion, principal if d > 0 else -principal)
                w.put_bits(residual, r_size)
            mv_pred[axis] = mv[axis]

    def _encode_mb_blocks_intra(self, w: BitWriter, y, cb, cr, row, col,
                                q: int, dc: _DCState, recon,
                                a=None) -> None:
        ys = y[row * 16:row * 16 + 16, col * 16:col * 16 + 16]
        yb = blocks_of(ys)
        order = [(0, yb[0, 0]), (1, yb[0, 1]), (2, yb[1, 0]), (3, yb[1, 1]),
                 (4, cb[row * 8:row * 8 + 8, col * 8:col * 8 + 8]),
                 (5, cr[row * 8:row * 8 + 8, col * 8:col * 8 + 8])]
        if a is not None:                  # YUVA: 4 alpha blocks 6..9
            ab = blocks_of(a[row * 16:row * 16 + 16,
                             col * 16:col * 16 + 16])
            order += [(6, ab[0, 0]), (7, ab[0, 1]),
                      (8, ab[1, 0]), (9, ab[1, 1])]
        for bi, block in order:
            d = fdct2(block)
            lv = self._quant_intra(d, q)
            dc_val = int(np.clip(np.round(d[0, 0] / 8.0), 0, 255))
            self._encode_dc(w, bi, dc_val, dc)
            self._encode_block_rl(w, lv, first_is_dc=False)
            # reconstruct (float oracle semantics) for P reference
            deq = refmath.dequant_intra(lv, q, self.intra_q)
            deq[0, 0] = 8.0 * dc_val
            pix = np.clip(np.round(_C @ deq @ _C.T), 0, 255)
            if bi < 4 or bi >= 6:
                comp = 0 if bi < 4 else 3
                b = bi if bi < 4 else bi - 6
                r0 = row * 16 + (8 if b & 2 else 0)
                c0 = col * 16 + (8 if b & 1 else 0)
                recon[comp][r0:r0 + 8, c0:c0 + 8] = pix
            else:
                comp = 1 if bi == 4 else 2
                recon[comp][row * 8:row * 8 + 8, col * 8:col * 8 + 8] = pix

    def _encode_dc(self, w: BitWriter, block: int, dc_val: int,
                   dc: _DCState) -> None:
        if block < 4:
            pred, table = dc.y, self._t_dc_lum
        elif block >= 6:                   # alpha: own pred, lum table
            pred, table = dc.a, self._t_dc_lum
        elif block == 4:
            pred, table = dc.cb, self._t_dc_chrom
        else:
            pred, table = dc.cr, self._t_dc_chrom
        diff = dc_val - pred
        size = int(abs(diff)).bit_length()
        w.put_code(table, size)
        if size > 0:
            v = diff if diff > 0 else diff + (1 << size) - 1
            w.put_bits(v, size)
        if block < 4:
            dc.y = dc_val
        elif block >= 6:
            dc.a = dc_val
        elif block == 4:
            dc.cb = dc_val
        else:
            dc.cr = dc_val

    def _quant_intra(self, d: np.ndarray, q: int) -> np.ndarray:
        lv = np.round(8.0 * d / (q * self.intra_q))
        lv[0, 0] = 0                        # DC coded separately
        return np.clip(lv, -_RL_MAX_LEVEL, _RL_MAX_LEVEL).astype(np.int32)

    def _quant_inter(self, d: np.ndarray, q: int) -> np.ndarray:
        lv = np.round(8.0 * d / (q * self.non_intra_q))
        return np.clip(lv, -_RL_MAX_LEVEL, _RL_MAX_LEVEL).astype(np.int32)

    def _encode_block_rl(self, w: BitWriter, levels: np.ndarray,
                         first_is_dc: bool) -> None:
        """Zig-zag run/level coding.  ``first_is_dc=True`` for non-intra
        blocks whose scan starts at position 0."""
        flat = np.asarray(levels).reshape(64)[T.ZIG_ZAG]
        start = 0 if first_is_dc else 1
        run = 0
        # Only a non-intra block's very first coefficient uses the short
        # dc_coeff_first form of the '1' code (jsv.js:1405 n==0 case).
        first = first_is_dc
        for i in range(start, 64):
            lv = int(flat[i])
            if lv == 0:
                run += 1
                continue
            self._emit_run_level(w, run, lv, first)
            first = False
            run = 0
        w.put_bits(0b10, 2)                 # end_of_block

    def _emit_run_level(self, w: BitWriter, run: int, level: int,
                        first: bool) -> None:
        mag = abs(level)
        key = (run, mag)
        if key == (0, 1):
            w.put_bits(0b1 if first else 0b11, 1 if first else 2)
            w.put_bits(1 if level < 0 else 0, 1)
        elif key in self._rl_encode and mag <= 0xFF:
            code, nbits = self._rl_encode[key]
            w.put_bits(code, nbits)
            w.put_bits(1 if level < 0 else 0, 1)
        else:
            # escape: 6-bit run + 8/16-bit level (jsv.js:1409-1421)
            code, nbits = compiled_tables()["dct_coeff"].encode[
                T.DCT_COEFF_ESCAPE]
            w.put_bits(code, nbits)
            w.put_bits(run, 6)
            if 0 < level < 128:
                w.put_bits(level, 8)
            elif 128 <= level <= 255:
                w.put_bits(0, 8)
                w.put_bits(level, 8)
            elif -128 < level < 0:
                w.put_bits(level + 256, 8)
            elif -255 <= level <= -128:
                w.put_bits(128, 8)
                w.put_bits((level + 256) & 0xFF, 8)
            else:
                raise ValueError(f"level {level} out of escape range")

    # ------------------------------------------------------------------
    # Motion estimation / reconstruction

    def _motion_search(self, y: np.ndarray, ref_y: np.ndarray) -> np.ndarray:
        """Full-pel exhaustive SAD search + optional half-pel refine.
        Returns int64[mb_h, mb_w, 2] (vy, vx) in half-pel units."""
        cfg = self.cfg
        R = cfg.me_range
        h, w = y.shape
        best_sad = np.full((self.mb_h, self.mb_w), np.inf)
        best_mv = np.zeros((self.mb_h, self.mb_w, 2), dtype=np.int64)
        yb = y.reshape(self.mb_h, 16, self.mb_w, 16)
        for dy in range(-R, R + 1):
            for dx in range(-R, R + 1):
                shifted = _shift_plane(ref_y, dy, dx)
                sad = np.abs(
                    yb - shifted.reshape(self.mb_h, 16, self.mb_w, 16)
                ).sum(axis=(1, 3))
                better = sad < best_sad
                best_sad = np.where(better, sad, best_sad)
                best_mv[better] = (2 * dy, 2 * dx)
        if cfg.half_pel_refine:
            for r in range(self.mb_h):
                for c in range(self.mb_w):
                    vy, vx = best_mv[r, c]
                    best = np.inf
                    pick = (vy, vx)
                    for hy in (vy - 1, vy, vy + 1):
                        for hx in (vx - 1, vx, vx + 1):
                            pred = _mc_luma(ref_y, r, c, (hy, hx))
                            sad = np.abs(
                                y[r * 16:r * 16 + 16, c * 16:c * 16 + 16]
                                - pred).sum()
                            if sad < best:
                                best, pick = sad, (hy, hx)
                    best_mv[r, c] = pick
        return best_mv

    def _reconstruct_inter(self, recon, row, col, mv, levels, q,
                           levels_a=None) -> None:
        pred_y = _mc_luma(self._ref[0], row, col, mv)
        pred_cb = _mc_chroma(self._ref[1], row, col, mv)
        pred_cr = _mc_chroma(self._ref[2], row, col, mv)
        res = [
            refmath.idct2(refmath.dequant_inter(levels[i], q,
                                                self.non_intra_q))
            for i in range(6)
        ]
        ymb = np.zeros((16, 16))
        ymb[0:8, 0:8] = res[0]
        ymb[0:8, 8:16] = res[1]
        ymb[8:16, 0:8] = res[2]
        ymb[8:16, 8:16] = res[3]
        recon[0][row * 16:row * 16 + 16, col * 16:col * 16 + 16] = np.clip(
            np.round(pred_y + ymb), 0, 255)
        recon[1][row * 8:row * 8 + 8, col * 8:col * 8 + 8] = np.clip(
            np.round(pred_cb + res[4]), 0, 255)
        recon[2][row * 8:row * 8 + 8, col * 8:col * 8 + 8] = np.clip(
            np.round(pred_cr + res[5]), 0, 255)
        if levels_a is not None:
            pred_a = _mc_luma(self._ref[3], row, col, mv)
            amb = np.zeros((16, 16))
            for ai in range(4):
                r0, c0 = 8 * (ai >> 1), 8 * (ai & 1)
                amb[r0:r0 + 8, c0:c0 + 8] = refmath.idct2(
                    refmath.dequant_inter(levels_a[ai], q,
                                          self.non_intra_q))
            recon[3][row * 16:row * 16 + 16, col * 16:col * 16 + 16] = (
                np.clip(np.round(pred_a + amb), 0, 255))


def encode_frames(frames, width: int | None = None, height: int | None = None,
                  config: EncoderConfig | None = None) -> bytes:
    """Convenience wrapper: YCbCr frame list -> JSV bytes."""
    if not frames:
        raise ValueError("encode_frames: no frames given")
    y0 = frames[0][0]
    h, w = y0.shape
    enc = JsvEncoder(width or w, height or h, config)
    return enc.encode(frames)
