"""The port's dense stream decoder (jsvx_torch.pipeline.stream) and its CLI
vs jsvx ``JaxStreamDecoder``.

Both routes of the port (``impl="fused"`` and ``"two_kernel"``), GOP by
GOP and picture by picture, run on the CPU (their plain versions) against
``JaxStreamDecoder(data).decode(impl="xla")``, which jsvx's
``test_pallas_recon_interpret_matches_xla`` pins bit-equal to its Pallas
route.  Tolerance: <= 1 LSB, on at most 0.1 % of the stream's pixels (an
f32 IDCT rounding tie that the two packages sum in different orders; the
count is printed), and <= 1 LSB of the float64 oracle.
"""

import os

import numpy as np
import pytest
import torch

from jsvx.pipeline.stream import JaxStreamDecoder
from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.oracle import decode_stream_oracle
from jsvx.tools.refmath import ycbcr_to_rgb
from jsvx_torch.__main__ import main as cli_main
from jsvx_torch.pipeline.stream import StreamDecoder

from test_high_motion import high_motion_stream  # noqa: F401 (fixture)

torch.set_num_threads(1)

IMPLS = ("fused", "two_kernel")


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**kw)).encode(clip)


@pytest.fixture(scope="module")
def stream(small_clip):
    return _encode(small_clip, gop_size=4, quantizer_scale=4, me_range=6,
                   half_pel_refine=True)


def _port(data, **kw):
    quirk = kw.pop("quirk", False)
    res = StreamDecoder(data, quirk, device="cpu").decode(**kw)
    return [tuple(p.numpy() for p in f) for f in res.frames]


def _jsvx(data, quirk=False):
    res = JaxStreamDecoder(data, quirk).decode(impl="xla")
    return [tuple(np.asarray(p) for p in f) for f in res.frames]


def _vs_jsvx_and_oracle(port, data, label, quirk=False):
    ref = _jsvx(data, quirk)
    oracle = None if quirk else decode_stream_oracle(data)
    assert len(port) == len(ref) > 0
    n_diff = n_pix = 0
    for fi, (fp, fr) in enumerate(zip(port, ref)):
        assert len(fp) == len(fr)
        for ci, (p, r) in enumerate(zip(fp, fr)):
            assert p.dtype == np.uint8 and p.shape == r.shape
            diff = np.abs(p.astype(int) - r.astype(int))
            assert diff.max() <= 1
            n_diff += int((diff > 0).sum())
            n_pix += diff.size
            if oracle is not None:
                o = oracle[fi].planes[ci]
                assert np.abs(p.astype(int) - o.astype(int)).max() <= 1
    print(f"{label}: {n_diff} of {n_pix} pixels differ from jsvx")
    assert n_diff <= 1e-3 * n_pix


@pytest.mark.parametrize("use_gop_scan", [True, False])
@pytest.mark.parametrize("impl", IMPLS)
def test_stream_decoder_vs_jsvx_and_oracle(stream, impl, use_gop_scan):
    _vs_jsvx_and_oracle(_port(stream, impl=impl, use_gop_scan=use_gop_scan),
                        stream, f"{impl} gop_scan={use_gop_scan}")


def test_both_routes_and_modes_bit_equal(stream):
    runs = [_port(stream, impl=impl, use_gop_scan=scan)
            for impl in IMPLS for scan in (True, False)]
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for fa, fb in zip(runs[0], other):
            for a, b in zip(fa, fb):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("impl", IMPLS)
def test_stream_decoder_yuva(tiny_clip_yuva, impl):
    data = _encode(tiny_clip_yuva, gop_size=3, quantizer_scale=4,
                   me_range=4)
    port = _port(data, impl=impl)
    assert len(port[0]) == 4
    _vs_jsvx_and_oracle(port, data, f"yuva {impl}")


@pytest.mark.parametrize("impl", IMPLS)
def test_stream_decoder_high_motion(high_motion_stream, impl):  # noqa: F811
    """A P frame with 256 distinct vectors, above jsvx's 255-entry table:
    the port's MC reads per-block vectors and has no cap."""
    fts = StreamDecoder(high_motion_stream, device="cpu").parse_all()
    assert max(len(np.unique(ft.mb_mv.reshape(-1, 2), axis=0))
               for ft in fts) >= 256
    _vs_jsvx_and_oracle(_port(high_motion_stream, impl=impl),
                        high_motion_stream, f"high-motion {impl}")


def test_stream_decoder_quirk(tiny_clip):
    data = _encode(tiny_clip, gop_size=3, quantizer_scale=4, me_range=4)
    port = _port(data, impl="two_kernel", quirk=True)
    _vs_jsvx_and_oracle(port, data, "quirk", quirk=True)
    plain = _port(data, impl="two_kernel")
    assert any(not np.array_equal(a, b) for fa, fb in zip(port, plain)
               for a, b in zip(fa, fb))


def test_stream_result_and_stages(stream):
    res = StreamDecoder(stream, device="cpu").decode(impl="two_kernel")
    assert len(res.frames) == 10 == res.metrics.counters["frames"]
    assert res.picture_types == [1, 2, 2, 2] * 2 + [1, 2]
    assert (res.width, res.height) == (112, 96)
    assert res.frames[0][0].device.type == "cpu"
    stages = res.metrics.to_dict()["stages"]
    assert {"parse", "pack", "h2d", "device_decode"} <= stages.keys()
    assert stages["device_decode"]["count"] == 3        # one per GOP
    with pytest.raises(ValueError, match="impl must be one of"):
        StreamDecoder(stream, device="cpu").decode(impl="pallas")


def test_cli_decode_writes_stream_decoder_frames(stream, tmp_path, capsys):
    clip = tmp_path / "clip.jsv"
    clip.write_bytes(stream)
    out = tmp_path / "out"
    assert cli_main(["decode", str(clip), str(out), "--impl", "two_kernel",
                     "--device", "cpu"]) == 0
    assert '"frames": 10' in capsys.readouterr().out
    want = _port(stream, impl="fused")
    names = sorted(os.listdir(out))
    assert names == [f"frame_{i:05d}.npz" for i in range(10)]
    for name, planes in zip(names, want):
        got = np.load(out / name)
        for key, p in zip(("y", "cb", "cr"), planes):
            assert np.array_equal(got[key], p)


def test_cli_decode_rgb(stream, tmp_path, capsys):
    clip = tmp_path / "clip.jsv"
    clip.write_bytes(stream)
    out = tmp_path / "rgb"
    assert cli_main(["decode", str(clip), str(out), "--rgb",
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    y, cb, cr = _port(stream, impl="fused")[3]
    raw = (out / "frame_00003.ppm").read_bytes()
    header = b"P6\n%d %d\n255\n" % (y.shape[1], y.shape[0])
    assert raw.startswith(header)
    rgb = np.frombuffer(raw[len(header):], np.uint8).reshape(
        y.shape + (3,))
    assert np.array_equal(rgb, ycbcr_to_rgb(y, cb, cr))
