"""The port's display colour (jsvx_torch.kernels.color) vs jsvx.

The same uint8 planes go through jsvx's ``ycbcr_to_rgb_jax`` (XLA on the
CPU), the float64 ``refmath.ycbcr_to_rgb`` and the port's
``ycbcr_to_rgb``.  Tolerance: <= 1 LSB, with at least 99.9 % of the
values equal to jsvx's (jsvx forms the 3x3 product with a matmul whose
summation order XLA chooses; the port sums each channel in one fixed
order, so a value within an f32 ulp of a .5 tie may round the other
way).  On every one of the 256**3 (Y, Cb, Cr) triples
(``tools/synthetic.colour_triples``) the plain version may differ from
jsvx on at most 0.01 % of the values, by at most 1, and from ``refmath``
by at most 1.  Planes: random, and decoded frames of 48x64 and 96x112
streams made by ``JsvEncoder``; whole, and cropped to a size that is not
a multiple of 16; strided crop views; the Player's ``_to_rgb`` on streams
of an odd display size against jsvx's.

On the CPU ``ycbcr_to_rgb`` is its plain version; the colour kernel
(``csrc/color.cu``, CUDA C++ for sm_90a) runs only on a card, in the
``cuda``-marked test (0 differing bytes from the plain version and from
the CPU, also on frames of the streams of ``tests/torch_card.py``); its
launch plan and a numpy walk of it
are tested on the CPU in ``tests/test_torch_color_plan.py``:
``python -m pytest tests/test_torch_color.py -m cuda --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

try:                                     # the card's machine has no JAX
    import jax.numpy as jnp

    from jsvx.api import Player as JsvxPlayer
    from jsvx.api import PlayerConfig as JsvxPlayerConfig
    from jsvx.kernels.color import ycbcr_to_rgb_jax, ycbcr_to_rgb_jit
    from jsvx.tools.encoder import EncoderConfig, JsvEncoder
    from jsvx.tools.refmath import ycbcr_to_rgb as ref_rgb
except ImportError:
    jnp = None

from jsvx_torch.api import Player, PlayerConfig
from jsvx_torch.kernels import color, counters
from jsvx_torch.kernels.color import ycbcr_to_rgb, ycbcr_to_rgb_plain
from jsvx_torch.pipeline.stream import StreamDecoder
from jsvx_torch.pipeline.packed_parse import walk_stream
from jsvx_torch.tools.synthetic import TRIPLES_LUMA, colour_triples

import torch_card

torch.set_num_threads(1)

#: luma rows of a band of the exhaustive set (8 bands)
BAND = 64


def _decoded(clip, seed):
    h, w = clip[0][0].shape
    data = JsvEncoder(w, h, EncoderConfig(gop_size=3, quantizer_scale=4)) \
        .encode(clip[:4])
    frames = StreamDecoder(data, device="cpu").decode().frames
    return tuple(p.numpy() for p in frames[seed % len(frames)])


@pytest.fixture(scope="module")
def planes(tiny_clip, small_clip):
    rng = np.random.default_rng(31)
    random = (rng.integers(0, 256, (48, 64)).astype(np.uint8),
              rng.integers(0, 256, (24, 32)).astype(np.uint8),
              rng.integers(0, 256, (24, 32)).astype(np.uint8))
    return {"random": random, "tiny_clip": _decoded(tiny_clip, 2),
            "small_clip": _decoded(small_clip, 3)}


def _crop(p, crop):
    y, cb, cr = p
    if not crop:
        return y, cb, cr
    h, w = y.shape[0] - 3, y.shape[1] - 5       # odd, not multiples of 16
    return y[:h, :w], cb[:(h + 1) // 2, :(w + 1) // 2], \
        cr[:(h + 1) // 2, :(w + 1) // 2]


@pytest.mark.parametrize("crop", [False, True])
@pytest.mark.parametrize("alpha", ["none", "opaque", "plane"])
@pytest.mark.parametrize("source", ["random", "tiny_clip", "small_clip"])
def test_port_vs_jsvx_and_refmath(planes, source, alpha, crop):
    y, cb, cr = _crop(planes[source], crop)
    h, w = y.shape
    a = {"none": False, "opaque": True,
         "plane": np.random.default_rng(h * w).integers(
             0, 256, (h + 3, w + 5)).astype(np.uint8)}[alpha]
    ja = a if isinstance(a, bool) else jnp.asarray(a)
    ta = a if isinstance(a, bool) else torch.from_numpy(a)
    want = np.asarray(ycbcr_to_rgb_jax(jnp.asarray(y), jnp.asarray(cb),
                                       jnp.asarray(cr), ja))
    got = ycbcr_to_rgb(torch.from_numpy(y), torch.from_numpy(cb),
                       torch.from_numpy(cr), ta)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    n_ch = 3 if alpha == "none" else 4
    assert tuple(got.shape) == want.shape == (h, w, n_ch)
    got = got.numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"{source} alpha={alpha} crop={crop}: "
          f"{int((diff > 0).sum())} of {diff.size} values differ")
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    ref = ref_rgb(y, cb, cr)
    assert np.abs(got[..., :3].astype(int) - ref.astype(int)).max() <= 1
    if alpha == "opaque":
        assert (got[..., 3] == 255).all()
    elif alpha == "plane":
        assert np.array_equal(got[..., 3], a[:h, :w])


def test_extremes_clamp():
    """Saturated inputs clamp to [0, 255] as jsvx does."""
    for v in (0, 16, 235, 255):
        y = np.full((16, 16), v, np.uint8)
        c = np.full((8, 8), 255 - v, np.uint8)
        got = ycbcr_to_rgb(*(torch.from_numpy(p) for p in (y, c, c)))
        want = np.asarray(ycbcr_to_rgb_jax(jnp.asarray(y), jnp.asarray(c),
                                           jnp.asarray(c)))
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_every_triple_vs_jsvx_and_refmath():
    """All 256**3 triples, in 8 row bands of 64 luma rows (each band holds
    the chroma rows under it): the plain version against jsvx's compiled
    ``ycbcr_to_rgb_jit`` and against ``refmath``."""
    y, cb, cr = colour_triples()
    n_jsvx = n_ref = worst_jsvx = worst_ref = 0
    for r0 in range(0, TRIPLES_LUMA[0], BAND):
        band = (y[r0:r0 + BAND], cb[r0 // 2:(r0 + BAND) // 2],
                cr[r0 // 2:(r0 + BAND) // 2])
        got = ycbcr_to_rgb_plain(*(torch.from_numpy(p) for p in band)) \
            .numpy().astype(np.int16)
        for want, key in ((np.asarray(ycbcr_to_rgb_jit(*(
                jnp.asarray(p) for p in band))), "jsvx"),
                          (ref_rgb(*band), "ref")):
            diff = np.abs(got - want.astype(np.int16))
            if key == "jsvx":
                n_jsvx += int((diff > 0).sum())
                worst_jsvx = max(worst_jsvx, int(diff.max()))
            else:
                n_ref += int((diff > 0).sum())
                worst_ref = max(worst_ref, int(diff.max()))
    total = y.size * 3
    print(f"every triple: {n_jsvx} of {total} values differ from jsvx "
          f"(max {worst_jsvx}), {n_ref} from refmath (max {worst_ref})")
    assert worst_jsvx <= 1 and n_jsvx <= 1e-4 * total
    assert worst_ref <= 1


# ---------------------------------------------------------------------------
# The dispatcher on the CPU: its plain version, checked inputs, crop views

def _frame(h=48, w=64, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
                 for s in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                           ((h + 1) // 2, (w + 1) // 2), (h, w)))


ALPHAS = ("none", "opaque", "plane")


def _alpha(mode, a):
    return {"none": False, "opaque": True, "plane": a}[mode]


@pytest.mark.parametrize("alpha", ALPHAS)
def test_dispatch_on_the_cpu_is_the_plain_version(alpha):
    y, cb, cr, a = _frame(45, 61)
    before = counters.snapshot()
    got = ycbcr_to_rgb(y, cb, cr, _alpha(alpha, a))
    moved = {n: k - before[n] for n, k in counters.snapshot().items()}
    assert moved["color_plain"] == 1 and moved["color"] == 0
    assert got.is_contiguous() and got.dtype == torch.uint8
    assert torch.equal(got, ycbcr_to_rgb_plain(y, cb, cr, _alpha(alpha, a)))


@pytest.mark.parametrize("case", ["cb_rows", "cr_cols", "alpha_rows",
                                  "alpha_cols", "device", "alpha_device",
                                  "dims"])
def test_shape_and_device_checks_raise(case):
    y, cb, cr, a = _frame(45, 61)
    alpha = False
    if case == "cb_rows":
        cb = cb[:22]
    elif case == "cr_cols":
        cr = cr[:, :30]
    elif case == "alpha_rows":
        alpha = a[:44]
    elif case == "alpha_cols":
        alpha = a[:, :60]
    elif case == "device":
        cr = cr.to("meta")
    elif case == "alpha_device":
        alpha = a.to("meta")
    else:
        cb = cb[None]
    before = counters.snapshot()
    with pytest.raises(ValueError):
        ycbcr_to_rgb(y, cb, cr, alpha)
    assert counters.snapshot() == before


def test_kernel_route_refuses_a_device_without_it():
    """A tensor that is neither on the CPU nor on a card reaches the
    kernel's wrapper, which raises: no quiet plain version."""
    y, cb, cr, _ = (p.to("meta") for p in _frame())
    with pytest.raises(ValueError, match="no colour kernel"):
        ycbcr_to_rgb(y, cb, cr)


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.float32])
def test_non_uint8_alpha_is_cast_as_jsvx_casts_it(dtype):
    y, cb, cr, _ = _frame(45, 61)
    rng = np.random.default_rng(7)
    if dtype.is_floating_point:                 # truncated toward 0
        a = rng.uniform(0, 256, (45, 61)).astype(np.float32)
    else:                                       # wrapped modulo 256
        a = rng.integers(0, 600, (45, 61)).astype(
            np.int16 if dtype == torch.int16 else np.int32)
    got = ycbcr_to_rgb(y, cb, cr, torch.from_numpy(a))
    want = np.asarray(ycbcr_to_rgb_jax(*(jnp.asarray(p.numpy())
                                         for p in (y, cb, cr)),
                                       jnp.asarray(a)))
    assert np.array_equal(got[..., 3].numpy(), want[..., 3])
    assert np.array_equal(got[..., 3].numpy(),
                          torch.from_numpy(a).to(torch.uint8).numpy())


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("shape", [(0, 61), (45, 0)])
def test_empty_frame(shape, alpha):
    y, cb, cr, a = _frame(45, 61)
    h, w = shape
    before = counters.snapshot()
    got = ycbcr_to_rgb(y[:h, :w], cb, cr, _alpha(alpha, a))
    assert counters.snapshot() == before
    want = ycbcr_to_rgb_jax(*(jnp.asarray(p.numpy()[:h, :w] if p is y
                                          else p.numpy())
                              for p in (y, cb, cr)),
                            _alpha(alpha, jnp.asarray(a.numpy())))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (
        h, w, 3 if alpha == "none" else 4)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("crop", [(45, 61), (47, 63), (1, 1), (48, 5)])
def test_crop_views_equal_the_full_frame_cropped(crop, alpha):
    """Strided views of a crop convert to exactly the full frame's
    conversion cropped, and within the tolerance of jsvx's."""
    y, cb, cr, a = _frame(48, 64)
    a = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (50, 70)).astype(np.uint8))
    h, w = crop
    hc, wc = -(-h // 2), -(-w // 2)
    got = ycbcr_to_rgb(y[:h, :w], cb[:hc, :wc], cr[:hc, :wc],
                       _alpha(alpha, a[:h, :w]))
    full = ycbcr_to_rgb(y, cb, cr, _alpha(alpha, a))
    assert got.is_contiguous() and torch.equal(got, full[:h, :w])
    want = np.asarray(ycbcr_to_rgb_jax(
        *(jnp.asarray(p.numpy()) for p in (y, cb, cr)),
        _alpha(alpha, jnp.asarray(a.numpy()))))[:h, :w]
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


# ---------------------------------------------------------------------------
# The Player: its _to_rgb against jsvx's on the same frames

def _odd_stream(yuva):
    """Three 45x61 frames (coded 48x64), with an alpha plane for YUVA."""
    from conftest import synthetic_frames, synthetic_frames_yuva

    frames = (synthetic_frames_yuva(3, 48, 64, seed=8) if yuva
              else synthetic_frames(3, 48, 64, seed=3))
    clip = [tuple(p[:(45 + s - 1) // s, :(61 + s - 1) // s]
                  for p, s in zip(f, (1, 2, 2, 1))) for f in frames]
    return JsvEncoder(61, 45, EncoderConfig(gop_size=3, quantizer_scale=4)) \
        .encode(clip)


def _play(player, data):
    """Drive ``player`` (RGB output) to ``ended``: (its RGB frames, the
    displayed frames)."""
    rgb, shown = [], []
    player.set_frame_sink(lambda f, t: rgb.append(f))
    player.on("frameout", lambda f, t: shown.append(f))
    player.src = data
    player.play()
    t = 0.0
    while not player.ended and t < 5.0:
        t += 1 / 30.0
        player.tick(t)
    assert player.ended
    return rgb, shown


@pytest.mark.parametrize("yuva", [False, True], ids=["yuv", "yuva"])
def test_player_rgb_equals_jsvx_player(yuva):
    """A stream of display size 45x61 (coded 48x64): each frame the sink
    receives is contiguous, of display size, and within 1 LSB of jsvx's
    Player ``_to_rgb`` on the same frame."""
    data = _odd_stream(yuva)
    rgb, shown = _play(Player(PlayerConfig(emit_rgb=True), device="cpu"),
                       data)
    ref = JsvxPlayer(JsvxPlayerConfig(emit_rgb=True), backend="oracle")
    _play(ref, data)
    assert (ref.video_height, ref.video_width) == (45, 61)
    assert len(rgb) == len(shown) == 3
    for got, frame in zip(rgb, shown):
        assert got.is_contiguous() and tuple(got.shape) == (
            45, 61, 4 if yuva else 3)
        planes = [p.numpy() for p in frame.planes]
        assert planes[0].shape == (48, 64)
        want = np.asarray(ref._to_rgb(types.SimpleNamespace(planes=planes)))
        diff = np.abs(got.numpy().astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        if yuva:
            assert np.array_equal(got[..., 3].numpy(), planes[3][:45, :61])


# ---------------------------------------------------------------------------
# The card

def _random_cases(dev):
    y, cb, cr = (torch.from_numpy(p).to(dev) for p in colour_triples())
    a = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, TRIPLES_LUMA).astype(np.uint8)).to(dev)
    cases = [(y, cb, cr, m) for m in (False, True, a)]
    fy, fcb, fcr, fa = (p.to(dev) for p in _frame(48, 64))
    for h, w in ((45, 61), (47, 63), (1, 1), (48, 5), (48, 64)):
        hc, wc = -(-h // 2), -(-w // 2)
        for m in (False, True, fa[:h, :w]):
            cases.append((fy[:h, :w], fcb[:hc, :wc], fcr[:hc, :wc], m))
    for w in range(1, 18):
        for h in (1, 3, 7):
            ty, tcb, tcr, ta = (p.to(dev) for p in _frame(h, w, seed=w))
            cases += [(ty, tcb, tcr, m) for m in (False, True, ta)]
    # byte paths: bases off by 1 and 3, a 24-byte chroma stride
    by, bcb, bcr, ba = (p.to(dev) for p in _frame(50, 70, seed=9))
    cases.append((by[1:46, 3:64], bcb[1:24, 1:32], bcr[:23, 3:34],
                  ba[1:46, 3:64]))
    sy, scb, scr, sa = (p.to(dev) for p in _frame(64, 48, seed=4))
    cases += [(sy, scb, scr, m) for m in (False, sa)]
    wy, wcb, wcr, wa = (p.to(dev) for p in _frame(6, 4100, seed=6))
    cases += [(wy, wcb, wcr, m) for m in (False, True, wa)]
    hy, hcb, hcr, _ = (p.to(dev) for p in _frame(1088, 1920, seed=2))
    cases.append((hy[:1080], hcb[:540], hcr[:540], False))
    return cases


def _stream_cases(label, dev):
    """Every frame of a stream of ``tests/torch_card.py`` decoded on the
    card, at its display crop (views, as the Player's ``_to_rgb`` passes
    them) without alpha, opaque and with its alpha plane where it has
    one, a 1080-row frame also at 1920x1080; odd crops of its first
    frame."""
    data = torch_card.stream(label)
    meta = walk_stream(data)[0]
    frames = StreamDecoder(data, device=dev).decode().frames

    def crop(f, h, w):
        hc, wc = -(-h // 2), -(-w // 2)
        return (f[0][:h, :w], f[1][:hc, :wc], f[2][:hc, :wc],
                *(a[:h, :w] for a in f[3:]))

    cases = []
    for f in frames:
        v = crop(f, meta.height, meta.width)
        cases += [(*v[:3], m) for m in (False, True, *v[3:])]
        if f[0].shape[0] > 1080:
            cases.append((*crop(f, 1080, 1920)[:3], False))
    f = frames[0]
    for h, w in ((f[0].shape[0] - 1, f[0].shape[1] - 3), (1, 1), (37, 5)):
        v = crop(f, h, w)
        cases.append((*v[:3], v[3] if len(v) > 3 else True))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["random", "1080p", "yuva-128x96",
                                    "cif-352x288"])
def test_kernel_matches_plain_on_the_card(source):
    """The colour kernel == its plain version on the card and == the CPU,
    0 differing bytes: every triple (three alpha modes), crop views of a
    random frame, widths 1-17 at odd heights, planes whose base or stride
    is not a multiple of 16 (the byte path), a 4100-wide frame (nine
    segments) and the 1920x1080 crop of a 1920x1088 frame; and the
    decoded frames of the card's streams; one launch per call."""
    dev = torch_card.card()
    cases = (_random_cases(dev) if source == "random"
             else _stream_cases(source, dev))
    for y_, cb_, cr_, m in cases:
        before = color.launches
        got = ycbcr_to_rgb(y_, cb_, cr_, m)
        torch.cuda.synchronize()
        assert color.launches == before + 1
        want = ycbcr_to_rgb_plain(y_, cb_, cr_, m)
        cpu = ycbcr_to_rgb(*(p.cpu() for p in (y_, cb_, cr_)),
                           m if isinstance(m, bool) else m.cpu())
        label = (tuple(y_.shape), m is True)
        assert got.is_contiguous() and torch.equal(got, want), label
        assert torch.equal(got.cpu(), cpu), label
