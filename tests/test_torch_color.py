"""The port's display colour (jsvx_torch.kernels.color) vs jsvx.

The same uint8 planes go through jsvx's ``ycbcr_to_rgb_jax`` (XLA on the
CPU), the float64 ``refmath.ycbcr_to_rgb`` and the port's
``ycbcr_to_rgb``.  Tolerance: <= 1 LSB, with at least 99.9 % of the
values equal to jsvx's (jsvx forms the 3x3 product with a matmul whose
summation order XLA chooses; the port sums each channel in one fixed
order, so a value within an f32 ulp of a .5 tie may round the other
way).  Planes: random, and decoded frames of 48x64 and 96x112 streams
made by ``JsvEncoder``; whole, and cropped to a size that is not a
multiple of 16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jsvx.kernels.color import ycbcr_to_rgb_jax
from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.refmath import ycbcr_to_rgb as ref_rgb
from jsvx_torch.kernels.color import ycbcr_to_rgb
from jsvx_torch.pipeline.stream import StreamDecoder

torch.set_num_threads(1)


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
