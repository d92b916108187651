"""The port's streaming Decoder and Player (jsvx_torch.api) vs jsvx's.

On the CPU the port's Decoder runs the fused kernel's plain version.  It
is held:

* to jsvx ``Decoder(backend="jax")`` on the same stream: the same frames
  and picture types, planes <= 1 LSB on at most 0.1 % of the pixels (the
  IDCT summation order, see ``tests/test_torch_stream.py``);
* bit for bit to the port's ``StreamDecoder``, and its GOP batch to its
  picture-at-a-time path;
* within 1 LSB of the float64 oracle for the quirk, YUVA and 256-vector
  streams.

The port's Player must give the events and ready states of jsvx's Player
on the same stream, RGB(A) within 1 LSB of ``refmath``, and must ignore
the late completion of a cancelled range request (jsvx does not: ADVICE
r5, pinned below with a strict ``xfail``).

The ``cuda``-marked test runs on a card:
``python -m pytest tests/test_torch_api.py -m cuda --noconftest``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jsvx.api import Decoder as JsvxDecoder
from jsvx.api import Player as JsvxPlayer
from jsvx.api import PlayerConfig, ReadyState
from jsvx.runtime.source import ByteSource
from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.oracle import decode_stream_oracle
from jsvx.tools.refmath import ycbcr_to_rgb as ref_rgb
from jsvx_torch.api import Decoder, Player
from jsvx_torch.runtime.source import ByteSource as PortByteSource
from jsvx_torch.kernels.color import ycbcr_to_rgb_plain
from jsvx_torch.pipeline.packed_parse import walk_stream
from jsvx_torch.pipeline.stream import StreamDecoder

import torch_card

try:                  # the card's machine has no JAX, which conftest needs
    from test_high_motion import high_motion_stream  # noqa: F401 (fixture)
except ImportError:
    pass

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENTS = ("loadstart", "durationchange", "loadedmetadata", "loadeddata",
          "progress", "canplay", "canplaythrough", "play", "playing",
          "pause", "timeupdate", "waiting", "stalled", "unstalled",
          "seeking", "seeked", "ended", "error", "resize", "suspend",
          "frameout")


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**kw)).encode(clip)


@pytest.fixture(scope="module")
def stream():
    from conftest import synthetic_frames

    return _encode(synthetic_frames(12, 48, 64, seed=5), gop_size=4,
                   quantizer_scale=4)


def _decode(data, cls=Decoder, scan=True, quirk=False, **kw):
    if cls is Decoder:
        kw.setdefault("device", "cpu")
    d = cls(PlayerConfig(use_gop_scan=scan, quirk_oddify_zeros=quirk), **kw)
    d.feed(0, data, total=len(data))
    frames = list(d.iter_frames())
    assert d.ended
    return d, frames


def _np(frame):
    return tuple(np.asarray(p) for p in frame.planes)


def _within_1lsb(port, ref, max_share=1e-3):
    assert len(port) == len(ref) > 0
    n_diff = n_pix = 0
    for fp, fr in zip(port, ref):
        assert len(fp) == len(fr)
        for p, r in zip(fp, fr):
            assert p.dtype == np.uint8 and p.shape == r.shape
            diff = np.abs(p.astype(int) - r.astype(int))
            assert diff.max() <= 1
            n_diff += int((diff > 0).sum())
            n_pix += diff.size
    assert n_diff <= max_share * n_pix, (n_diff, n_pix)


def _bit_equal(a, b):
    assert len(a) == len(b) > 0
    for fa, fb in zip(a, b):
        assert len(fa) == len(fb)
        for pa, pb in zip(fa, fb):
            assert np.array_equal(pa, pb)


# ---------------------------------------------------------------------------
# Decoder


@pytest.mark.parametrize("scan", [True, False])
def test_decoder_vs_jsvx(stream, scan):
    _, port = _decode(stream, scan=scan)
    _, ref = _decode(stream, JsvxDecoder, scan=scan, backend="jax")
    assert [f.picture_type for f in port] == [f.picture_type for f in ref]
    assert [f.ts_ms for f in port] == [f.ts_ms for f in ref]
    assert all(p.dtype == torch.uint8 and p.device.type == "cpu"
               for f in port for p in f.planes)
    _within_1lsb([_np(f) for f in port], [_np(f) for f in ref])


def test_decoder_vs_stream_decoder_and_batch_vs_picture(stream):
    d_batch, batch = _decode(stream, scan=True)
    d_one, single = _decode(stream, scan=False)
    want = [tuple(p.numpy() for p in f)
            for f in StreamDecoder(stream, device="cpu").decode().frames]
    _bit_equal([_np(f) for f in batch], want)
    _bit_equal([_np(f) for f in single], want)
    assert [f.picture_type for f in batch] == [f.picture_type
                                               for f in single]
    # the batch engaged: one parse, pack, copy and decode per GOP; the
    # picture path copies and decodes each picture
    stages = d_batch.metrics.to_dict()["stages"]
    assert stages["device_decode"]["count"] == 3 == stages["parse"]["count"]
    stages = d_one.metrics.to_dict()["stages"]
    assert stages["device_decode"]["count"] == 12 and "parse" not in stages
    assert d_batch.metrics.counters["frames"] == 12


def test_decoder_seek_then_tail(stream):
    """Seek drops the batch queue and the carried reference; the frames
    after it equal the tail of the straight decode."""
    _, single = _decode(stream, scan=False)
    d = Decoder(PlayerConfig(use_gop_scan=True), device="cpu")
    d.feed(0, stream, total=len(stream))
    first = d.decode_frame()
    assert first is not None and d._pending and d._refs is not None
    assert d.seek(250.0)
    assert not d._pending and d._refs is None
    got = list(d.iter_frames())
    assert got and got[0].is_intra and len(got) < len(single)
    _bit_equal([_np(f) for f in got],
               [_np(f) for f in single[len(single) - len(got):]])


def test_decoder_partial_buffer_falls_back(stream):
    """A partly buffered GOP decodes picture by picture; the batch resumes
    once the bytes arrive, and the output equals the straight decode."""
    _, single = _decode(stream, scan=False)
    d = Decoder(PlayerConfig(use_gop_scan=True), device="cpu")
    half = len(stream) // 2
    d.feed(0, stream[:half], total=len(stream))
    got = list(d.iter_frames())
    assert 0 < len(got) < 12 and not d.ended
    n_dec = d.metrics.to_dict()["stages"]["device_decode"]["count"]
    d.feed(half, stream[half:], total=len(stream))
    got += list(d.iter_frames())
    assert len(got) == 12 and d.ended
    assert d.metrics.to_dict()["stages"]["device_decode"]["count"] > n_dec
    _bit_equal([_np(f) for f in got], [_np(f) for f in single])


def test_decoder_progressive_feed(stream):
    """Fed in 400-byte chunks (stalls between them), the frames equal the
    whole-buffer decode."""
    _, want = _decode(stream, scan=False)
    d = Decoder(PlayerConfig(), device="cpu")
    stalls = []
    d.on("stalled", stalls.append)
    got, pos = [], 0
    while len(got) < 12:
        frame = d.decode_frame()
        if frame is not None:
            got.append(frame)
            continue
        assert pos < len(stream)
        d.feed(pos, stream[pos:pos + 400], len(stream))
        pos += 400
    assert stalls and d.decode_frame() is None and d.ended
    _bit_equal([_np(f) for f in got], [_np(f) for f in want])


@pytest.fixture(scope="module")
def long_stream():
    """Three GOPs of noisy 176x144 video at quantiser 1: 358 KB, more than
    one 300,000 B chunk and many times the encoder's backward limit
    (bit_rate 3000: 11,250 B)."""
    from conftest import synthetic_frames

    rng = np.random.default_rng(0)
    clip = [(np.clip(y.astype(int) + rng.integers(-30, 30, y.shape), 0,
                     255).astype(np.uint8), cb, cr)
            for y, cb, cr in synthetic_frames(12, 144, 176, seed=3)]
    data = _encode(clip, gop_size=4, quantizer_scale=1)
    _, frames = _decode(data, scan=False, backend="oracle")
    return data, [_np(f) for f in frames]


@pytest.mark.parametrize("chunk", [300_000, 4099, 997])
@pytest.mark.parametrize("scan", [True, False])
def test_decoder_scans_each_byte_once(long_stream, scan, chunk):
    """Fed in chunks and drained between them, the Decoder gives the
    oracle backend's frames, trims its buffer to the stream's backward
    limit, hands the start-code scanner each byte once (plus 3 a side a
    chunk) and copies out at most twice the stream."""
    data, want = long_stream
    d = Decoder(PlayerConfig(use_gop_scan=scan), device="cpu")
    got, pos, chunks = [], 0, 0
    while True:
        frame = d.decode_frame()
        if frame is not None:
            got.append(_np(frame))
            continue
        if d.ended:
            break
        assert pos < len(data)
        d.feed(pos, data[pos:pos + chunk], len(data))
        pos, chunks = pos + chunk, chunks + 1
    _within_1lsb(got, want)
    assert d.buffer.bytes_backward_limit == 11_250
    assert d.buffer.byte_ranges()[0][0] >= len(data) - 11_250 - 4
    c = d.metrics.counters
    assert len(data) <= c["scanned_bytes"] <= len(data) + 6 * chunks
    assert len(data) // 2 < c["copied_bytes"] <= 2 * len(data)
    if scan:
        assert d.metrics.to_dict()["stages"]["parse"]["count"] > 0


@pytest.mark.parametrize("scan", [True, False])
def test_decoder_quirk(tiny_clip, scan):
    data = _encode(tiny_clip, gop_size=3, quantizer_scale=4, me_range=4)
    _, port = _decode(data, scan=scan, quirk=True)
    _, ref = _decode(data, JsvxDecoder, scan=scan, quirk=True,
                     backend="jax")
    _within_1lsb([_np(f) for f in port], [_np(f) for f in ref])
    _, plain = _decode(data, scan=scan)
    assert any(not np.array_equal(a, b) for fa, fb in zip(port, plain)
               for a, b in zip(_np(fa), _np(fb)))


@pytest.mark.parametrize("scan", [True, False])
def test_decoder_yuva(tiny_clip_yuva, scan):
    data = _encode(tiny_clip_yuva, gop_size=3, quantizer_scale=4,
                   me_range=4)
    _, port = _decode(data, scan=scan)
    assert all(len(f.planes) == 4 for f in port)
    oracle = [f.planes for f in decode_stream_oracle(data)]
    _within_1lsb([_np(f) for f in port], oracle, max_share=1.0)


def test_decoder_high_motion(high_motion_stream):  # noqa: F811
    """256 distinct vectors in one P frame: the port's batch has no
    vector-table capacity and decodes it through the same kernel."""
    _, port = _decode(high_motion_stream)
    oracle = [f.planes for f in decode_stream_oracle(high_motion_stream)]
    _within_1lsb([_np(f) for f in port], oracle, max_share=1.0)


def test_decoder_oracle_backend_is_jsvx(stream):
    _, port = _decode(stream, backend="oracle")
    _, ref = _decode(stream, JsvxDecoder, backend="oracle")
    _bit_equal([_np(f) for f in port], [_np(f) for f in ref])


def test_backend_is_checked():
    with pytest.raises(ValueError, match="backend must be one of"):
        Decoder(backend="jax", device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        Player(backend="jax", device="cpu")


def test_top_level_exports():
    """The port's API is its own classes, not jsvx's or subclasses of
    them, with jsvx's names and states."""
    import jsvx_torch
    import jsvx_torch.api as api
    from jsvx.api.player import WallClockAudio

    assert jsvx_torch.Player is api.Player and jsvx_torch.Decoder is \
        api.Decoder
    assert jsvx_torch.PlayerConfig is api.PlayerConfig
    for name in ("Player", "Decoder", "PlayerConfig", "WallClockAudio",
                 "ReadyState", "NetworkState", "MediaError", "DecodedFrame"):
        cls = getattr(api, name)
        assert cls.__module__.startswith("jsvx_torch.api."), name
    assert not issubclass(api.Player, JsvxPlayer)
    assert not issubclass(api.Decoder, JsvxDecoder)
    assert api.WallClockAudio is not WallClockAudio
    assert {s.name: int(s) for s in api.ReadyState} == \
        {s.name: int(s) for s in ReadyState}


# ---------------------------------------------------------------------------
# Player


def _record(p):
    log = []
    for name in EVENTS:
        p.on(name, lambda *a, n=name: log.append((n, int(p.ready_state))))
    return log


def _play_to_end(p, max_s=3.0):
    t = 0.0
    while not p.ended and t < max_s:
        t += 1 / 30.0
        p.tick(t)
    assert p.ended


def test_player_events_and_states_equal_jsvx(stream):
    logs, shown = [], []
    for p in (Player(device="cpu"), JsvxPlayer(backend="oracle")):
        log, got = _record(p), []
        p.set_frame_sink(lambda f, t: got.append((t, _np(f))))
        p.src = stream
        p.play()
        _play_to_end(p)
        logs.append(log)
        shown.append(got)
    assert logs[0] == logs[1]
    assert logs[0][0] == ("loadstart", 0) and logs[0][-1][0] == "ended"
    assert ("canplaythrough", int(ReadyState.HAVE_ENOUGH_DATA)) in logs[0]
    assert [t for t, _ in shown[0]] == [t for t, _ in shown[1]]
    assert len(shown[0]) == 12
    _within_1lsb([f for _, f in shown[0]], [f for _, f in shown[1]],
                 max_share=1.0)


def test_player_seek_equals_decoder_tail(stream):
    _, single = _decode(stream, scan=False)
    p = Player(device="cpu")
    got = []
    p.set_frame_sink(lambda f, t: got.append(_np(f)))
    p.src = stream
    p.current_time = 0.25
    assert not p.seeking
    p.play()
    _play_to_end(p)
    assert 0 < len(got) < 12
    _bit_equal(got, [_np(f) for f in single[12 - len(got):]])


def test_player_background_decode(stream):
    """Decode on the background thread, display on this one: every frame
    shows, equal to the straight decode."""
    import time

    _, single = _decode(stream, scan=False)
    p = Player(device="cpu")
    got = []
    p.set_frame_sink(lambda f, t: got.append(_np(f)))
    p.src = stream
    p.start_background_decode()
    try:
        p.play()
        t, deadline = 0.0, time.monotonic() + 30
        while not p.ended and time.monotonic() < deadline:
            t += 1 / 30.0
            p.tick(t)
            time.sleep(0.002)
    finally:
        p.stop_background_decode()
    assert p.ended and p._decode_thread is None
    _bit_equal(got, [_np(f) for f in single])


def _rgb_frames(data, n=1):
    p = Player(PlayerConfig(emit_rgb=True), device="cpu")
    p.src = data
    got, raw = [], []
    p.set_frame_sink(lambda rgb, t: got.append(rgb))
    p.on("frameout", lambda f, t: raw.append(f))
    p.play()
    t = 0.0
    while len(got) < n and t < 1.0:
        t += 1 / 30.0
        p.tick(t)
    return got, raw


def test_player_emit_rgb(stream):
    got, raw = _rgb_frames(stream, n=4)
    for rgb, frame in zip(got, raw):
        assert isinstance(rgb, torch.Tensor) and rgb.dtype == torch.uint8
        assert tuple(rgb.shape) == (48, 64, 3)
        y, cb, cr = _np(frame)
        want = ref_rgb(y, cb, cr)[:48, :64]
        diff = np.abs(rgb.numpy().astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99


def test_player_emit_rgb_yuva():
    from conftest import synthetic_frames_yuva

    data = _encode(synthetic_frames_yuva(4, 48, 64, seed=8), gop_size=4,
                   quantizer_scale=4)
    got, raw = _rgb_frames(data)
    rgba = got[0]
    assert tuple(rgba.shape) == (48, 64, 4) and rgba.dtype == torch.uint8
    assert np.array_equal(rgba[..., 3].numpy(), _np(raw[0])[3][:48, :64])


def test_player_emit_rgb_crops_to_the_container(small_clip):
    """A 90x100 picture is coded as 96x112: the RGB frame is cropped."""
    clip = [tuple(p[:90 // s, :100 // s] for p, s in zip(f, (1, 2, 2)))
            for f in small_clip[:3]]
    data = _encode(clip, gop_size=3, quantizer_scale=4)
    got, raw = _rgb_frames(data)
    assert tuple(got[0].shape) == (90, 100, 3)
    assert _np(raw[0])[0].shape == (96, 112)


class _HeldSource(PortByteSource, ByteSource):
    """An asynchronous source that holds every callback until the test
    calls it, and records requests and cancels (a source of either
    package)."""

    def __init__(self, data):
        self.data = bytes(data)
        self.requests = []
        self.cancelled = []

    def total_length(self):
        return len(self.data)

    def request(self, start, end, on_data, on_error=None, on_complete=None,
                chunk_size=300000):
        req = dict(start=start, end=end, on_data=on_data,
                   on_complete=on_complete, handle=object())
        self.requests.append(req)
        return req["handle"]

    def cancel(self, handle):
        self.cancelled.append(handle)


def _cancel_a_then_complete_it(p, data):
    """Request A is cancelled and B started; then A's completion, queued
    before the cancel, arrives."""
    src = _HeldSource(data)
    p.src = src
    assert len(src.requests) == 1
    a = src.requests[0]
    p._request_range(0)
    assert len(src.requests) == 2 and src.cancelled == [a["handle"]]
    b = p._pending_request
    assert b is not None and b.handle is src.requests[1]["handle"]
    a["on_complete"]()
    return src, b


def test_stale_completion_keeps_the_newer_request(stream):
    p = Player(device="cpu")
    src, b = _cancel_a_then_complete_it(p, stream)
    assert p._pending_request is b
    assert len(src.requests) == 2, "a duplicate range was requested"
    # B goes on: it delivers the stream, completes, and the clip plays
    rb = src.requests[1]
    rb["on_data"](0, stream, len(stream))
    rb["on_complete"]()
    assert p._pending_request is None and len(src.requests) == 2
    shown = []
    p.set_frame_sink(lambda f, t: shown.append(t))
    p.play()
    _play_to_end(p)
    assert len(shown) == 12


@pytest.mark.xfail(strict=True, reason="ADVICE r5 (jsvx/api/player.py:"
                   "514-516): jsvx's Player lets a cancelled request's late "
                   "completion clear the newer request's slot and request "
                   "the range again; the port's Player repairs it")
def test_stale_completion_in_jsvx_player(stream):
    p = JsvxPlayer(backend="oracle")
    src, b = _cancel_a_then_complete_it(p, stream)
    assert p._pending_request is b
    assert len(src.requests) == 2, "a duplicate range was requested"


# ---------------------------------------------------------------------------
# Command line


def test_cli_play_and_info(stream, tmp_path, capsys):
    from jsvx.__main__ import main as jsvx_main
    from jsvx_torch.__main__ import main as cli_main

    clip = tmp_path / "clip.jsv"
    clip.write_bytes(stream)
    args = ["play", str(clip), "--rate", "8", "--rgb", "--seconds", "30"]
    assert cli_main(args + ["--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port["ended"] is True and port["frames_shown"] == 12
    assert port["device"] == "cpu" and port["error"] is None
    assert jsvx_main(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(port) == set(ref) | {"device"}
    # the file source delivers on its own thread, so the order between
    # playing, waiting and the first chunk's events depends on timing
    assert port["event_order"][0] == "loadstart"
    assert port["event_order"][-1] == ref["event_order"][-1] == "ended"
    assert cli_main(["info", str(clip)]) == 0
    info = capsys.readouterr().out
    assert jsvx_main(["info", str(clip)]) == 0
    assert info == capsys.readouterr().out
    assert json.loads(info)["pictures"] == 12


# ---------------------------------------------------------------------------
# The card


def _card_stream(label):
    """A 128x96 stream of 8 frames at GOP 4 or 2 (``128x96-gop4``), or a
    stream of ``tests/torch_card.py``."""
    if label.startswith("128x96"):
        from jsvx_torch.tools.fixture import zoom_clip

        return JsvEncoder(128, 96, EncoderConfig(
            gop_size=int(label[-1]), quantizer_scale=5, me_range=6,
            half_pel_refine=True)).encode(zoom_clip(96, 128, 8, seed=5))
    return torch_card.stream(label)


def _decoder_frames(data, device, scan, quirk=False, seek_gop=None):
    """Every frame through the port's Decoder, as numpy; with
    ``seek_gop``, those after a seek to that key-map GOP's time, made once
    the first frame is out."""
    d = Decoder(PlayerConfig(use_gop_scan=scan, quirk_oddify_zeros=quirk),
                device=device)
    d.feed(0, data, total=len(data))
    if seek_gop is not None:
        assert d.decode_frame() is not None
        t = d.meta.key_map.time_of(seek_gop, d.sequence.picture_rate)
        assert d.seek(t * 1e3)
    frames = list(d.iter_frames())
    assert d.ended
    assert all(p.device.type == torch.device(device).type
               for f in frames for p in f.planes)
    return torch_card.as_numpy(f.planes for f in frames)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["128x96-gop4", "1080p",
                                   "320x320-256mv", "yuva-128x96"])
def test_decoder_on_the_card_equals_the_cpu(label, tmp_path):
    """The Decoder on the card (GOP batch and picture by picture, after a
    seek to GOP 1, with the quirk) == the Decoder on the CPU, the fused
    kernel once a picture; the Player with RGB == the CPU's Player
    (events, RGB), its RGB the plain colour of the coded frame cropped to
    the display size and within 1 LSB of ``refmath``, the colour kernel
    once a frame shown; ``python -m jsvx_torch play`` on the card plays
    the stream to its end."""
    dev = torch_card.card()
    data = _card_stream(label)
    quirked = _decoder_frames(data, "cpu", True, quirk=True)
    cpu = _decoder_frames(data, "cpu", True)
    for scan in (True, False):
        for quirk, want in ((False, cpu), (True, quirked)):
            got, n = torch_card.counted(
                lambda: _decoder_frames(data, dev, scan, quirk))
            # a GOP batch without the quirk ships the compact wire
            compact = torch_card.compact_gops(data) if scan and not quirk \
                else 0
            assert n == torch_card.want_counts(fused=len(want),
                                               expand=compact), scan
            torch_card.assert_frames_equal(got, want)
        tail = _decoder_frames(data, dev, scan, seek_gop=1)
        assert 0 < len(tail) < len(cpu)
        torch_card.assert_frames_equal(tail, cpu[len(cpu) - len(tail):])

    (ev, rgb, planes, p), n = torch_card.counted(
        lambda: torch_card.play_rgb(data, dev))
    ev_cpu, rgb_cpu, _, _ = torch_card.play_rgb(data, "cpu")
    assert ev == ev_cpu and ev[0][0] == "loadstart" and ev[-1][0] == "ended"
    assert n == torch_card.want_counts(fused=len(rgb), color=len(rgb),
                                       expand=torch_card.compact_batches(p))
    torch_card.assert_frames_equal([(x,) for x in rgb],
                                   [(x,) for x in rgb_cpu])
    meta = walk_stream(data)[0]
    for x, f in zip(rgb, planes, strict=True):
        assert x.shape == (meta.height, meta.width, len(f))
        t = [torch.from_numpy(q).to(dev) for q in f]
        plain = ycbcr_to_rgb_plain(*t[:3], t[3] if len(t) > 3 else False)
        assert np.array_equal(x, plain[:meta.height, :meta.width].cpu())
        want = ref_rgb(*f[:3])[:meta.height, :meta.width]
        assert np.abs(x[..., :3].astype(int) - want.astype(int)).max() <= 1
        if len(f) == 4:
            assert np.array_equal(x[..., 3], f[3][:meta.height, :meta.width])

    clip = tmp_path / "clip.jsv"
    clip.write_bytes(data)
    proc = subprocess.run(
        [sys.executable, "-m", "jsvx_torch", "play", str(clip), "--rgb",
         "--rate", "8", "--device", str(dev)], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ended"] is True and report["frames_shown"] == len(cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["1080p-8-gops", "yuva-128x96"])
def test_player_compact_batches_on_the_card_equal_the_dense(monkeypatch,
                                                            label):
    """The Player with RGB on the card: the GOP batches its Decoder ships
    on the compact wire (one expansion launch each) give the RGB frames
    of the dense wire bit for bit; after one playback, a second playback
    of the stream captures no program (the Decoder's entry buckets are
    sticky, so its keys recur)."""
    from jsvx_torch.pipeline import program

    dev = torch_card.card()
    data = torch_card.stream(label)
    program.CACHE.clear()
    _, warm, _, _ = torch_card.play_rgb(data, dev)
    (_, rgb, _, p), n = torch_card.counted(
        lambda: torch_card.play_rgb(data, dev))
    c = p.decoder.metrics.counters
    assert c.get("gop_program.captures", 0) == 0
    assert c["gop_program.replays"] > 0
    batches = torch_card.compact_batches(p)
    assert batches > 0 and c.get("decoder.gop_batches.dense", 0) == 0
    assert n == torch_card.want_counts(fused=len(rgb), color=len(rgb),
                                       expand=batches)
    with monkeypatch.context() as mp:
        mp.setattr(Decoder, "_compact_route", lambda self: False)
        _, dense, _, pd = torch_card.play_rgb(data, dev)
    assert pd.decoder.metrics.counters["decoder.gop_batches.dense"] == \
        batches and torch_card.compact_batches(pd) == 0
    for got in (rgb, warm):
        torch_card.assert_frames_equal([(x,) for x in got],
                                       [(x,) for x in dense])


@pytest.mark.cuda
@pytest.mark.parametrize("label,quirk", [
    ("128x96-gop2", False), ("1080p", False), ("1080p", True),
    ("1080p-8-gops", False), ("48x64-dirty", False), ("cif-352x288", False),
    ("yuva-128x96", False)])
def test_pipelined_transcode_on_the_card_equals_the_cpu(label, quirk):
    """``transcode`` on a card, each route from a cold program cache under
    CUDA's sync debug mode: every pooled buffer pinned; no sync after GOP
    0's dispatch outside the waits meant for it (``wire_wait``,
    ``device_wait``), captures of later GOPs included; each picture
    through its route's kernels once and each GOP on the compact wire
    through the expansion kernel once; the planes the sink kept, read
    after the run, equal to the CPU's, and within 1 LSB of the float64
    oracle (but at 1080p, whose oracle the CPU tests hold the CPU to)."""
    dev = torch_card.card()
    from jsvx_torch.pipeline import program
    from jsvx_torch.pipeline.packed_parse import BufferPool
    from jsvx_torch.pipeline.transcode import transcode
    from jsvx_torch.tools import decode_stream_oracle

    pool = BufferPool(pin=True)
    buf = pool.acquire((4096,), np.uint8)
    assert pool.host_tensor(buf).is_pinned()
    assert torch.from_numpy(buf).is_pinned()
    data = _card_stream(label)
    n_compact = 0 if quirk else torch_card.compact_gops(data)
    oracle = (None if label.startswith("1080p") else
              [f.planes for f in decode_stream_oracle(data, quirk)])
    for impl in ("fused", "two_kernel"):
        kept = {}
        transcode(data, lambda gi, outs: kept.__setitem__(gi, outs),
                  device="cpu", impl=impl, quirk_oddify_zeros=quirk)
        cpu = [tuple(s[i].numpy() for s in kept[g]) for g in sorted(kept)
               for i in range(kept[g][0].shape[0])]
        program.CACHE.clear()
        w = torch_card.watched_transcode(data, dev, impl, quirk)
        n_f = w["res"].n_frames
        routes = dict(fused=n_f) if impl == "fused" else dict(mc=n_f,
                                                              recon=n_f)
        assert w["launches"] == torch_card.want_counts(**routes,
                                                       expand=n_compact)
        assert w["pins"] and all(w["pins"])
        assert not w["after_gop0_outside_waits"], w["spans"]
        assert w["distinct_planes"] and w["gops"] == sorted(kept)
        torch_card.assert_frames_equal(w["frames"], cpu)
        for f, o in zip(w["frames"], oracle or (), strict=bool(oracle)):
            for p, q in zip(f, o, strict=True):
                assert np.abs(p.astype(int) - q.astype(int)).max() <= 1
