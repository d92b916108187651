"""The seeded stream generator and its per-seed cache.

The content is a seeded copy of the port's zoom-pan clip
(``jsvx_torch/tools/fixture.py::zoom_clip``): a band-limited 1/f texture
of 40 sinusoids, zoomed and panned, with sensor noise.  The seed sets the
texture, the pan and the zoom rate; the configuration sets the size, the
noise and the quantiser.  A row's texture depends on its row and a
column's on its column, so each frame is two matrix products, and the
motion of each macroblock is the clip's own zoom-pan field at its centre
(refined by :mod:`jsvbench.encoder`).

A seed's clip is coded as the configuration's ``distinct_gops`` GOPs, GOP
j the clip's frames from ``j * gop_size`` on, and a stream of ``gops``
GOPs repeats them in turn (A, B, A, B, ...), each after its own sequence
and GOP headers (the GOP timecodes count on), with the container's GOP
key map: neighbouring GOPs carry different pictures, so a GOP handed the
one before it decodes wrong.  Each GOP's pictures are cached per
(configuration, seed, GOP, generator hash) under
``build/jsvbench/streams/`` in the checkout, and so is the reference's
decode of each.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

from . import encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(ROOT, "build", "jsvbench", "streams")
_HERE = os.path.dirname(os.path.abspath(__file__))
#: the sources whose bytes make a stream or its reference: a change to any
#: of them makes new cache entries
_SOURCES = ("streams.py", "encoder.py", "reference/tables.py",
            "reference/vlc.py", "reference/bitio.py",
            "reference/container.py", "reference/parser.py",
            "reference/refmath.py", "reference/oracle.py")


def generator_hash() -> str:
    h = hashlib.sha256()
    for rel in _SOURCES:
        with open(os.path.join(_HERE, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read())
    return h.hexdigest()[:12]


#: the texture's 40 wave vectors (rad/px) and amplitudes, the same for
#: every seed: the fixture's band (each component uniform in 0.02-1.4)
#: and its 1/sqrt(f) amplitudes, drawn once
_RNG0 = np.random.default_rng(20251017)
_FREQ = _RNG0.uniform(0.02, 1.4, (40, 2))
_MAG = np.linalg.norm(_FREQ, axis=1)
_AMP = 9.0 / np.sqrt(_MAG / _MAG.min())


def seed_key(seed: int) -> int:
    """The seed as numpy's generators take it (not negative)."""
    return seed % 2 ** 64


def clip_params(seed: int) -> dict:
    """What the seed sets: the texture's orientation and phases, the
    pan's direction (1.5 px a frame, as the fixture's) and the zoom rate
    (2.5-3.5 px a frame at the side midpoints; the fixture's is 3).  The
    spectrum and the noise stay, so every seed's stream costs about the
    same to code and to decode."""
    rng = np.random.default_rng(seed_key(seed))
    theta = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]])
    phi = rng.uniform(0, 2 * np.pi)
    return dict(freq=_FREQ @ rot.T,
                phase=rng.uniform(0, 2 * np.pi, 40), amp=_AMP,
                pan=1.5 * np.array([np.sin(phi), np.cos(phi)]),
                zoom_px=float(rng.uniform(2.5, 3.5)))


def _coords(h: int, w: int, t: int, cp: dict) -> tuple:
    """The texture coordinates (u of each row, v of each column) of
    frame ``t``, and the frame's scale."""
    s = 1.0 / (1.0 + cp["zoom_px"] / (w / 2) * t)
    u = (np.arange(h) - h / 2) * s + h / 2 + cp["pan"][0] * t
    v = (np.arange(w) - w / 2) * s + w / 2 + cp["pan"][1] * t
    return u, v, s


def clip(h: int, w: int, n: int, seed: int, noise: float,
         t0: int = 0) -> tuple:
    """``n`` (Y, Cb, Cr) uint8 frames of ``h`` x ``w`` (chroma halved),
    the clip's frames from ``t0`` on, and per frame the (h/16, w/16, 2)
    half-pel motion field into the frame before it (zeros for frame
    ``t0``).  The noise of a frame range has its own generator, so a
    range is the same whichever ranges were made before it."""
    cp = clip_params(seed)
    rng = np.random.default_rng([seed_key(seed), t0])
    ky, kx = cp["freq"][:, 0], cp["freq"][:, 1]
    frames, motion = [], []
    mb_h, mb_w = -(-h // 16), -(-w // 16)
    for t in range(t0, t0 + n):
        u, v, s = _coords(h, w, t, cp)
        a = cp["amp"] * np.sin(np.outer(u, ky))
        b = cp["amp"] * np.cos(np.outer(u, ky))
        y = (120.0 + a @ np.cos(np.outer(kx, v) + cp["phase"][:, None])
             + b @ np.sin(np.outer(kx, v) + cp["phase"][:, None]))
        y = np.clip(y + noise * rng.standard_normal((h, w), np.float32), 0, 255)
        cb = np.clip(128 + 24 * np.sin(0.05 * v[None, ::2])
                     + noise / 2 * rng.standard_normal((h // 2, w // 2), np.float32), 0, 255)
        cr = np.clip(128 + 24 * np.cos(0.05 * u[::2, None])
                     + noise / 2 * rng.standard_normal((h // 2, w // 2), np.float32), 0, 255)
        frames.append(tuple(p.astype(np.uint8) for p in (y, cb, cr)))
        field = np.zeros((mb_h, mb_w, 2), np.int64)
        if t > t0:
            s_prev = _coords(h, w, t - 1, cp)[2]
            for axis, (size, k) in enumerate(((h, mb_h), (w, mb_w))):
                c = np.arange(k) * 16 + 7.5
                src = (size / 2 + ((c - size / 2) * s + cp["pan"][axis])
                       / s_prev)
                d = np.round(2 * (src - c)).astype(np.int64)
                field[..., axis] = d[:, None] if axis == 0 else d[None, :]
        motion.append(field)
    return frames, motion


def pad_to_coded(plane: np.ndarray, mult: int) -> np.ndarray:
    h, w = plane.shape
    return np.pad(plane, ((0, -h % mult), (0, -w % mult)), mode="edge")


def params_of(config: dict) -> encoder.EncodeParams:
    g = config["generator"]
    return encoder.EncodeParams(quantizer_scale=int(g["quantizer_scale"]),
                                rate_code=int(config["rate_code"]),
                                f_code=int(g["f_code"]))


def encode_gop(config: dict, seed: int, j: int = 0) -> list:
    """The picture payloads of GOP ``j`` of ``seed``'s clip."""
    h, w = int(config["height"]), int(config["width"])
    n = int(config["gop_size"])
    frames, motion = clip(h, w, n, seed, float(config["generator"]["noise"]),
                          t0=j * n)
    frames = [tuple(pad_to_coded(p, 16 if i == 0 else 8)
                    for i, p in enumerate(f)) for f in frames]
    mb_h, mb_w = frames[0][0].shape[0] // 16, frames[0][0].shape[1] // 16
    motion = [m[:mb_h, :mb_w] if m.shape[:2] == (mb_h, mb_w)
              else np.pad(m, ((0, mb_h - m.shape[0]), (0, mb_w - m.shape[1]),
                              (0, 0)), mode="edge") for m in motion]
    payloads, _, _ = encoder.encode_gop(
        frames, motion, params_of(config),
        target_bytes=float(config["bytes_per_picture"]))
    return payloads


class Streams:
    """One configuration's streams, cached per seed in ``cache_dir``."""

    def __init__(self, name: str, config: dict, cache_dir: str = CACHE_DIR):
        self.name, self.config, self.cache_dir = name, config, cache_dir
        self.tag = generator_hash()

    def _path(self, seed: int, what: str) -> str:
        return os.path.join(self.cache_dir,
                            f"{self.name}-{seed}-{self.tag}.{what}")

    def gop(self, seed: int, j: int = 0) -> tuple:
        """(GOP ``j``'s picture payloads, seconds spent encoding them: 0
        when they came from the cache)."""
        path = self._path(seed, f"g{j}.gop.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                blob, sizes = z["blob"], z["sizes"]
            ends = np.cumsum(sizes)
            return [blob[e - n:e].tobytes()
                    for e, n in zip(ends, sizes)], 0.0
        t0 = time.perf_counter()
        payloads = encode_gop(self.config, seed, j)
        spent = time.perf_counter() - t0
        _atomic_save(path, blob=np.frombuffer(b"".join(payloads), np.uint8),
                     sizes=np.array([len(p) for p in payloads]))
        return payloads, spent

    def stream(self, seed: int, gops: int) -> tuple:
        """(the stream of ``gops`` GOPs, the seed's distinct GOPs in turn,
        seconds spent encoding)."""
        c = self.config
        made = [self.gop(seed, j) for j in range(int(c["distinct_gops"]))]
        data = encoder.assemble(int(c["width"]), int(c["height"]),
                                params_of(c),
                                [made[i % len(made)][0] for i in range(gops)])
        return data, sum(spent for _, spent in made)

    def reference(self, seed: int, gop_bytes: bytes, decode) -> tuple:
        """((the reference's planes of the GOP, its work bounds), seconds
        spent decoding: 0 when they came from the cache).
        ``decode(gop_bytes)`` gives (a list of per-picture plane tuples, a
        dict of numbers)."""
        key = hashlib.sha256(gop_bytes).hexdigest()[:12]
        path = self._path(seed, f"{key}.ref.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                n = int(z["n"])
                planes = [tuple(z[f"p{i}_{k}"] for k in range(3))
                          for i in range(n)]
                return (planes, json.loads(str(z["bounds"]))), 0.0
        t0 = time.perf_counter()
        planes, bounds = decode(gop_bytes)
        spent = time.perf_counter() - t0
        arrays = {f"p{i}_{k}": p for i, f in enumerate(planes)
                  for k, p in enumerate(f)}
        _atomic_save(path, n=np.array(len(planes)),
                     bounds=np.array(json.dumps(bounds)), **arrays)
        return (planes, bounds), spent


def _atomic_save(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
