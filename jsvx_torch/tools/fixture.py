"""The 1080p bench fixture and its test pattern, for the port's checks.

The port's copy of ``bench.py``'s ``_zoom_clip`` and ``ensure_fixture``:
a zooming, half-pel-panning band-limited texture with sensor noise,
encoded at 1920x1088, GOP 4, q=6 with half-pel motion search.  The
encoded stream is cached under ``build/jsvx_torch/fixtures/`` at the root
of the checkout (``build/`` is git-ignored), keyed by a hash of the
port's encoder and the clip parameters, so a changed encoder can never
serve a stale stream.

:func:`switch_stream` is a rendition switch: GOPs of two encodes of one
clip with different quant matrices, spliced into one stream, each GOP
with its own sequence header (:func:`splice_gops`).
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np

from ..bitstream.container import find_start_codes
from ..coding import tables as T
from . import encoder as _encoder

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(os.path.dirname(_PKG), "build", "jsvx_torch",
                         "fixtures")


def zoom_clip(h: int, w: int, n: int, seed: int = 3) -> list:
    """Zooming + half-pel-translating band-limited pattern.

    A zoom makes the motion field vary across the frame (many distinct
    vectors) and a 1.5 px/frame pan lands on half-pel positions, so the
    4-tap interpolation path carries load.  Returns ``n`` (Y, Cb, Cr)
    uint8 frames of ``h`` x ``w`` (chroma halved).
    """
    rng = np.random.default_rng(seed)
    cy, cx = h / 2, w / 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    # rich 1/f texture: low components steer the motion search, high
    # components lose energy under half-pel interpolation (real residual
    # load), per-frame sensor noise keeps the coefficient planes dense
    n_comp = 40
    freq = rng.uniform(0.02, 1.4, (n_comp, 2))
    ph = rng.uniform(0, 2 * np.pi, n_comp)
    mag = np.linalg.norm(freq, axis=1)
    amp = 9.0 / np.sqrt(mag / mag.min())

    def tex(u, v):
        out = np.full(u.shape, 120.0)
        for (kyy, kxx), p, a in zip(freq, ph, amp):
            out += a * np.sin(kyy * u + kxx * v + p)
        return out

    zoom_rate = 3.0 / (w / 2)            # ~3 px at the side midpoints
    frames = []
    for t in range(n):
        s = 1.0 / (1.0 + zoom_rate * t)  # sample source = inverse zoom
        u = (yy - cy) * s + cy + 1.5 * t
        v = (xx - cx) * s + cx + 1.5 * t
        y = np.clip(tex(u, v) + rng.normal(0, 4, u.shape), 0, 255)
        cb = np.clip(128 + 24 * np.sin(0.05 * v[::2, ::2])
                     + rng.normal(0, 2, (h // 2, w // 2)), 0, 255)
        cr = np.clip(128 + 24 * np.cos(0.05 * u[::2, ::2])
                     + rng.normal(0, 2, (h // 2, w // 2)), 0, 255)
        frames.append(tuple(p.astype(np.uint8) for p in (y, cb, cr)))
    return frames


def fixture_path() -> str:
    """Path of the cached 1080p fixture, versioned by the encoder source
    and the clip parameters."""
    with open(_encoder.__file__, "rb") as f:
        tag = hashlib.sha256(
            f.read() + b"|1088x1920x8|gop4|q6|me8|halfpel|zoomclip-v1"
        ).hexdigest()[:10]
    return os.path.join(CACHE_DIR, f"jsvx_torch_1080p_{tag}.jsv")


def ensure_fixture() -> str:
    """Encode the 1080p fixture if it is not cached; return its path."""
    fix = fixture_path()
    if not os.path.exists(fix):
        h, w = 1088, 1920
        data = _encoder.JsvEncoder(w, h, _encoder.EncoderConfig(
            gop_size=4, quantizer_scale=6, me_range=8,
            half_pel_refine=True)).encode(zoom_clip(h, w, 8))
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = fix + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, fix)
    return fix


def _gop_payloads(data: bytes) -> tuple:
    """(the container header's bytes, each GOP's bytes from its sequence
    header on): the encoder writes a sequence header before every GOP."""
    codes = find_start_codes(data)
    starts = [int(o) for o, c in codes if c == T.START_SEQUENCE]
    ends = starts[1:] + [len(data)]
    return data[:starts[0]], [data[a:b] for a, b in zip(starts, ends)]


def splice_gops(streams: list, picks: list) -> bytes:
    """GOP ``g`` of ``streams[picks[g]]`` for each ``g``: encodes of one
    clip at one size, so their GOPs line up.  The container header is
    ``streams[0]``'s, its GOP key map (when it has one) pointed at the
    spliced GOPs."""
    parts = [_gop_payloads(s) for s in streams]
    head = parts[0][0]
    gops = [parts[p][1][g] for g, p in enumerate(picks)]
    if len(head) > 8:                    # a key map: 16 bytes, then 8 a GOP
        n = struct.unpack(">I", head[12:16])[0]
        if n != len(gops):
            raise ValueError(f"the key map holds {n} GOPs, not {len(gops)}")
        entries, off = [], len(head)
        for g, gop in enumerate(gops):
            tc = struct.unpack(">I", head[20 + 8 * g:24 + 8 * g])[0]
            entries.append(struct.pack(">II", off, tc))
            off += len(gop)
        head = head[:16] + b"".join(entries)
    return head + b"".join(gops)


#: the second rendition of :func:`switch_stream`: the intra matrix times 3
#: and a flat non-intra matrix of 40
SWITCH_INTRA_Q = (np.asarray(T.DEFAULT_INTRA_QUANT_MATRIX, np.int32)
                  * 3).astype(np.uint8)
SWITCH_NON_INTRA_Q = np.full(64, 40, np.uint8)


def switch_clip() -> list:
    """The clip of :func:`switch_stream`: 6 frames of 64x48."""
    return zoom_clip(48, 64, 6, seed=11)


def switch_stream(key_map: bool = False) -> bytes:
    """A rendition switch at GOP 1: :func:`switch_clip` encoded twice at
    GOP 3 and q 4, once with the default quant matrices and once with
    :data:`SWITCH_INTRA_Q` and :data:`SWITCH_NON_INTRA_Q`; GOP 0 comes
    from the first encode and GOP 1 from the second, each after its own
    sequence header (with the container's GOP key map, or without)."""
    clip = switch_clip()
    h, w = clip[0][0].shape
    cfg = dict(gop_size=3, quantizer_scale=4, key_map=key_map)
    streams = [_encoder.JsvEncoder(w, h, _encoder.EncoderConfig(
        **cfg, **extra)).encode(clip) for extra in (
        {}, {"custom_intra_q": SWITCH_INTRA_Q,
             "custom_non_intra_q": SWITCH_NON_INTRA_Q})]
    return splice_gops(streams, [0, 1])
