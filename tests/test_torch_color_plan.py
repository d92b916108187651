"""The colour kernel's launch plan and arithmetic, on the CPU.

``csrc/color.cu`` runs only on a card; what it is told and what it
computes are held here.  :func:`jsvx_torch.kernels.color.launch_plan`
decides the launch (a one-warp CTA for each unit of a luma row pair
and a segment of the width, 16 columns a lane, and which loads and
stores are vector ones); the tests check that the plan's units and
lanes cover every output byte exactly once, and every luma, chroma and
alpha sample the frame needs exactly once, at the Player's sizes (1920x1080 and
1920x1088, CIF, 128x96, 64x48, the 48x64 stream with a 24-byte chroma
stride), widths 1-17 at odd heights, crop views with a stride above the
width, wide frames in segments, C = 3 and 4; that vector loads and
stores are chosen only where the plane's base and row stride, or the
output's base and row length, are multiples of 16, so that every such
access starts on a boundary of its size; and that the kernel's exact
shortcuts (``v / 255`` by a reciprocal and two fmas; ``clamp(rint(x *
255), 0, 255)`` by a saturating add and an add of 1.5 * 2^23) give the
plain version's bytes.  A numpy walk of the plan's schedule, doing the
kernel's per-pixel arithmetic in float32, equals ``ycbcr_to_rgb_plain``
byte for byte on every (Y, Cb, Cr) triple, and on seeded frames also
jsvx's ``ycbcr_to_rgb_jax`` (jsvx sums the 3x3 product in XLA's order,
which on some triples rounds a tie the other way, as
``tests/test_torch_color.py`` states; on these frames no byte differs).
"""

import os
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from jsvx_torch.kernels import color
from jsvx_torch.kernels.color import (MAX_SEG, THREADS, launch_plan,
                                      ycbcr_to_rgb_plain)
from jsvx_torch.tools.synthetic import TRIPLES_LUMA, colour_triples

try:                                     # the card's machine has no JAX
    import jax.numpy as jnp

    from jsvx.kernels.color import ycbcr_to_rgb_jax
except ImportError:
    jnp = None

SOURCE = os.path.join(os.path.dirname(color.__file__), "..", "csrc",
                      "color.cu")
F32 = np.float32
#: RN(1 / 255), the kernel's ``kRecip255``
RECIP = F32(1) / F32(255)
MAGIC = F32(12582912.0)                 # 1.5 * 2^23


def _rn32(x: Fraction) -> np.float32:
    """x rounded once to the nearest float32, ties to even."""
    f = F32(float(x))                    # within an ulp; fix it exactly
    cands = (np.nextafter(f, F32(-np.inf)), f, np.nextafter(f, F32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.uint32)) & 1))


def _fma(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _kernel_scale_table() -> np.ndarray:
    """s(v) for every byte as the kernel computes it: q = RN(v r), then
    fma(fma(-q, 255, v), r, q), in exact rational arithmetic."""
    out = np.empty(256, F32)
    for v in range(256):
        fv = F32(v)
        q = F32(fv * RECIP)
        out[v] = _fma(_fma(-q, F32(255), fv), RECIP, q)
    return out


SCALE = _kernel_scale_table()


def test_reciprocal_and_two_fmas_divide_every_byte_exactly():
    """The kernel's s(v) equals the plain version's true division v / 255
    (a float32 tensor divided by a 0-dim tensor, as ``_constants`` makes
    it) for all 256 bytes, and its constant is RN(1/255)."""
    v = torch.arange(256, dtype=torch.float32)
    plain = (v / torch.tensor(255.0, dtype=torch.float32)).numpy()
    assert np.array_equal(SCALE, plain)
    assert np.array_equal(SCALE, np.arange(256, dtype=F32) / F32(255))
    with open(SOURCE) as f:
        lit = re.search(r"kRecip255 = (0x[0-9a-fA-F.]+p[-+]?\d+)f;",
                        f.read()).group(1)
    assert F32(float.fromhex(lit)) == RECIP
    assert float.fromhex(lit) == float(RECIP)


def _kernel_byte(acc: np.ndarray, off: np.float32) -> np.ndarray:
    """The kernel's last steps of a channel: the saturating offset add,
    x 255, the add of 1.5 * 2^23; the sum's low byte."""
    sat = np.clip(acc + off, F32(0), F32(1))
    t = sat * F32(255) + MAGIC
    return (t.view(np.uint32) & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("off", [F32(0), *color._OFF])
def test_saturating_add_and_magic_rint_equal_clamp_of_round(off):
    """rint(sat(acc + off) * 255) by the add of 1.5 * 2^23 equals the
    plain version's clamp(round(RN(acc + off) * 255), 0, 255) (round half
    to even) on random sums across and past [0, 1], on every sum whose
    product with 255 is a tie k + 0.5 or a neighbour of one, and at the
    ends."""
    rng = np.random.default_rng(17)
    acc = rng.uniform(-1.5, 2.5, 1 << 20).astype(F32) - off
    k = np.arange(-3, 259, dtype=np.float64)
    ties = ((k + 0.5) / 255).astype(F32)
    near = np.concatenate([ties, np.nextafter(ties, F32(-9)),
                           np.nextafter(ties, F32(9)),
                           (k / 255).astype(F32)])
    acc = np.concatenate([acc, near - off, F32([0, 1, -0.0]) - off])
    want = torch.round(torch.from_numpy(acc + off) * F32(255)).clamp(
        0.0, 255.0).to(torch.uint8).numpy()
    assert np.array_equal(_kernel_byte(acc, off), want)


# ---------------------------------------------------------------------------
# The plan: coverage and alignment

#: (h, w, channels, strides, offsets, out offset)
FRAMES = {
    "1080p-crop": (1080, 1920, 3, (1920, 960, 960), (0, 0, 0), 0),
    "1080p-crop-yuva": (1080, 1920, 4, (1920, 960, 960, 1920),
                        (0, 0, 0, 0), 0),
    "1088p": (1088, 1920, 3, (1920, 960, 960), (0, 0, 0), 0),
    "1088p-opaque": (1088, 1920, 4, (1920, 960, 960), (0, 0, 0), 0),
    "cif": (288, 352, 3, (352, 176, 176), (0, 0, 0), 0),
    "128x96-yuva": (96, 128, 4, (128, 64, 64, 128), (0, 0, 0, 0), 0),
    "64x48": (48, 64, 3, (64, 32, 32), (0, 0, 0), 0),
    "48x64-stride24": (64, 48, 3, (48, 24, 24), (0, 0, 0), 0),
    "48x64-stride24-yuva": (64, 48, 4, (48, 24, 24, 48), (0, 0, 0, 0), 0),
    "crop-45x61-of-48x64": (45, 61, 3, (64, 32, 32), (0, 0, 0), 0),
    "crop-45x61-yuva": (45, 61, 4, (64, 32, 32, 64), (0, 0, 0, 0), 0),
    "view-off-1": (45, 61, 3, (70, 35, 35), (71, 36, 3), 0),
    "crop-1077x1917": (1077, 1917, 4, (1920, 960, 960, 1920),
                       (0, 0, 0, 0), 0),
    "wide-4100": (5, 4100, 3, (4100, 2050, 2050), (0, 0, 0), 0),
    "wide-4096-yuva": (3, 4096, 4, (4096, 2048, 2048, 4096),
                       (0, 0, 0, 0), 0),
}
for _w in range(1, 18):
    for _h in (1, 3, 7):
        for _c in (3, 4):
            _cw = -(-_w // 2)
            FRAMES[f"{_h}x{_w}x{_c}"] = (
                _h, _w, _c, (_w, _cw, _cw) + ((_w,) if _c == 4 else ()),
                (0,) * (4 if _c == 4 else 3), 0)


def lanes(plan, n: int) -> list:
    """(lane, first column, columns) of each thread of the kernel with
    columns in a unit of n columns: lane l takes 16 from 16 l, fewer at
    the unit's end."""
    return [(ln, 16 * ln, min(16, n - 16 * ln))
            for ln in range(plan.threads) if 16 * ln < n]


def _plan(name):
    h, w, c, strides, offsets, out_off = FRAMES[name]
    return launch_plan(h, w, c, strides, offsets, out_off)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_plan_covers_every_byte_once(name):
    """Every output byte is written by exactly one (unit, row) of the
    plan, and every luma, chroma and alpha sample the frame needs is
    loaded by exactly one; the grid is one CTA a unit; in every unit the
    lanes' columns cover it exactly once."""
    h, w, c, strides, offsets, _ = FRAMES[name]
    plan = _plan(name)
    assert plan.threads == THREADS and plan.channels == c
    assert plan.seg_w % 32 == 0 and 32 <= plan.seg_w <= MAX_SEG
    assert plan.n_segs == -(-w // plan.seg_w)
    assert plan.units == -(-h // 2) * plan.n_segs
    assert plan.grid == plan.units
    assert plan.alpha_plane == (len(strides) == 4)
    out = np.zeros(h * w * c, np.uint8)
    luma = np.zeros((h, w), np.uint8)
    chroma = np.zeros((-(-h // 2), -(-w // 2)), np.uint8)
    for u in range(plan.grid):
        row0, rows, x0, n = plan.unit(u)
        assert row0 % 2 == 0 and rows in (1, 2) and x0 % 32 == 0
        assert 1 <= n <= plan.seg_w and (rows == 2 or row0 == h - 1)
        chroma[row0 // 2, x0 // 2:x0 // 2 + (n + 1) // 2] += 1
        for dr in range(rows):
            luma[row0 + dr, x0:x0 + n] += 1
            start = ((row0 + dr) * w + x0) * c
            out[start:start + n * c] += 1
    assert (out == 1).all() and (luma == 1).all() and (chroma == 1).all()
    for n in {plan.unit(u)[3] for u in range(plan.units)}:
        cols = np.zeros(n, np.uint8)
        for _, x, k in lanes(plan, n):
            assert 1 <= k <= 16
            cols[x:x + k] += 1
        assert (cols == 1).all()


@pytest.mark.parametrize("off", [0, 1, 4, 8, 16, 24, 4096])
@pytest.mark.parametrize("stride_pad", [0, 3, 8, 16])
@pytest.mark.parametrize("c", [3, 4])
def test_vector_paths_only_where_aligned(c, stride_pad, off):
    """A plane takes vector loads exactly when its base and row stride
    are multiples of 16, the output 16-byte stores when its base and w *
    channels are; then every load a lane makes whole (its 16 luma or alpha
    bytes, its 8 chroma bytes) starts on a boundary of its size, and every
    unit's output run starts on a 16-byte boundary."""
    for h, w in ((7, 61), (45, 64), (1080, 1920), (4, 4100), (3, 48)):
        cw = -(-w // 2)
        strides = [w + stride_pad, cw + stride_pad, cw + stride_pad]
        offsets = [off, off + 32, 2 * off]
        if c == 4:
            strides.append(w + 2 * stride_pad)
            offsets.append(off + 16)
        plan = launch_plan(h, w, c, strides, offsets, out_offset=off)
        for vec, s, o in zip(plan.vec, strides, offsets):
            assert vec == ((s | o) % 16 == 0)
        assert plan.out_vec == ((off | (w * c)) % 16 == 0)
        want_flags = sum(1 << i for i, v in enumerate(plan.vec) if v) | (
            16 if plan.out_vec else 0)
        assert plan.flags == want_flags
        for u in {0, plan.n_segs - 1, plan.units - 1}:
            row0, rows, x0, n = plan.unit(u)
            for dr in range(rows):
                row = row0 + dr
                for _, x, k in lanes(plan, n):
                    col = x0 + x
                    starts = [(offsets[0] + row * strides[0] + col, 16),
                              (offsets[1] + row // 2 * strides[1] + col // 2,
                               8),
                              (offsets[2] + row // 2 * strides[2] + col // 2,
                               8)]
                    if c == 4:
                        starts.append((offsets[3] + row * strides[3] + col,
                                       16))
                    for vec, (start, size) in zip(plan.vec, starts):
                        assert not vec or k < 16 or start % size == 0
                run = off + (row * w + x0) * c
                assert not plan.out_vec or run % 16 == 0


def test_plan_args_and_refusals():
    """The kernel is told the segment width and the flags: the 1920x1080
    crop is 2160 CTAs, 540 row pairs of four 480-wide segments, every
    access a vector one; 4096 wide with alpha, eight 512-wide segments,
    all five vector; 4100 wide, nine 480-wide segments, every access bytes
    (no stride is a multiple of 16); a frame the kernel has no layout for
    raises."""
    plan = _plan("1080p-crop")
    assert (plan.grid, plan.n_segs) == (2160, 4)
    assert tuple(plan.args()) == (480, 23)
    assert tuple(_plan("wide-4096-yuva").args()) == (512, 31)
    assert tuple(_plan("wide-4100").args()) == (480, 0)
    for args in ((0, 5, 3, (5, 3, 3), (0, 0, 0)),
                 (5, 5, 2, (5, 3, 3), (0, 0, 0)),
                 (5, 5, 3, (5, 3, 3, 5), (0, 0, 0, 0)),
                 (5, 5, 4, (5, 3), (0, 0))):
        with pytest.raises(ValueError):
            launch_plan(*args)


# ---------------------------------------------------------------------------
# The plan's schedule walked in numpy, with the kernel's arithmetic

def walk(plan, y, cb, cr, alpha=None) -> np.ndarray:
    """What the colour kernel writes under ``plan``: each unit (a CTA
    each); per unit the chroma row once (its products m[r][1] s(cb) and
    m[r][2] s(cr) once per sample), then each luma row: s(y) from the
    kernel's scale, ((m[r][0] s(y) + pcb) + pcr), the saturating offset
    add, x 255, the add of 1.5 * 2^23 and its low byte; 255 or the alpha
    plane as the fourth channel.  float32 throughout, one rounding per
    operation, as the kernel's ``_rn`` intrinsics."""
    h, w, c = plan.h, plan.w, plan.channels
    m, off = color._M, color._OFF
    out = np.zeros(h * w * c, np.uint8)
    for u in range(plan.grid):
        row0, rows, x0, n = plan.unit(u)
        cx, cn = x0 // 2, (n + 1) // 2
        cols = np.arange(n) // 2
        pcb = m[:, 1:2] * SCALE[cb[row0 // 2, cx:cx + cn]][None]
        pcr = m[:, 2:3] * SCALE[cr[row0 // 2, cx:cx + cn]][None]
        for dr in range(rows):
            ys = SCALE[y[row0 + dr, x0:x0 + n]][None]
            acc = m[:, 0:1] * ys
            acc = acc + pcb[:, cols]
            acc = acc + pcr[:, cols]
            px = np.stack([_kernel_byte(acc[r], off[r])
                           for r in range(3)], axis=-1)
            if c == 4:
                a = (np.full(n, 255, np.uint8) if alpha is None
                     else alpha[row0 + dr, x0:x0 + n])
                px = np.concatenate([px, a[:, None]], axis=-1)
            start = ((row0 + dr) * w + x0) * c
            out[start:start + n * c] = px.reshape(-1)
    return out.reshape(h, w, c)


def _walk_frames():
    rng = np.random.default_rng(23)

    def planes(h, w, ph=None, pw=None):
        ph, pw = ph or h, pw or w
        return (rng.integers(0, 256, (ph, pw)).astype(np.uint8),
                rng.integers(0, 256, (-(-ph // 2), -(-pw // 2))).astype(
                    np.uint8),
                rng.integers(0, 256, (-(-ph // 2), -(-pw // 2))).astype(
                    np.uint8),
                rng.integers(0, 256, (ph, pw)).astype(np.uint8))

    y, cb, cr, a = planes(1080, 1920, 1088)
    yield "1080p-crop", (y[:1080], cb[:540], cr[:540], False)
    y, cb, cr, a = planes(45, 61, 48, 64)
    yield "45x61-crop-yuva", (y[:45, :61], cb[:23, :31], cr[:23, :31],
                              a[:45, :61])
    y, cb, cr, a = planes(64, 48)
    yield "48x64-stride24-opaque", (y, cb, cr, True)
    y, cb, cr, a = planes(7, 4100)
    yield "wide-4100-yuva", (y, cb, cr, a)
    y, cb, cr, a = planes(3, 13, 5, 20)
    yield "3x13-view-off", (y[1:4, 2:15], cb[1:3, 1:8], cr[:2, 2:9], True)


@pytest.mark.parametrize("name,frame", list(_walk_frames()),
                         ids=[n for n, _ in _walk_frames()])
def test_walk_equals_plain_and_jsvx(name, frame):
    """The numpy walk of the plan == the plain version and == jsvx's
    ``ycbcr_to_rgb_jax``, byte for byte, on these seeded frames."""
    y, cb, cr, alpha = frame
    a = None if isinstance(alpha, bool) else alpha
    c = 3 if alpha is False else 4
    planes = [y, cb, cr] + ([a] if a is not None else [])
    plan = launch_plan(*y.shape, c, [p.strides[0] for p in planes],
                       [p.__array_interface__["data"][0] for p in planes])
    got = walk(plan, y, cb, cr, a)
    ta = alpha if a is None else torch.from_numpy(np.ascontiguousarray(a))
    want = ycbcr_to_rgb_plain(*(torch.from_numpy(np.ascontiguousarray(p))
                                for p in (y, cb, cr)), ta).numpy()
    assert got.shape == want.shape == (*y.shape, c)
    assert np.array_equal(got, want)
    if jnp is None:
        pytest.skip("jsvx's ycbcr_to_rgb_jax needs JAX, which is missing")
    ja = alpha if a is None else jnp.asarray(a)
    jsvx = np.asarray(ycbcr_to_rgb_jax(*(jnp.asarray(p) for p in (y, cb, cr)),
                                       ja))
    assert np.array_equal(got, jsvx)


def test_walk_equals_plain_on_every_triple():
    """Every (Y, Cb, Cr) triple (``colour_triples``, 512x32768: sixty-four
    512-wide segments) through the walk of its plan == the plain version
    byte for byte: the kernel's shortcuts hold on every input a channel
    sees."""
    y, cb, cr = colour_triples()
    plan = launch_plan(*y.shape, 3, (y.shape[1], cb.shape[1], cb.shape[1]),
                       (0, 0, 0))
    assert plan.n_segs == 64
    got = walk(plan, y, cb, cr)
    for r0 in range(0, TRIPLES_LUMA[0], 64):
        band = [torch.from_numpy(p) for p in (
            y[r0:r0 + 64], cb[r0 // 2:r0 // 2 + 32], cr[r0 // 2:r0 // 2 + 32])]
        assert np.array_equal(got[r0:r0 + 64],
                              ycbcr_to_rgb_plain(*band).numpy()), r0

