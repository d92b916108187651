"""Corrupt and truncated streams through the port, on the CPU.

Each case of jsvx's ``tests/test_corrupt_streams.py`` on ``jsvx_torch``:
the streaming Decoder either produces frames, stalls awaiting bytes, ends
or raises a clean ``ValueError``, with both parser back ends; the Player
never crashes or hangs.  Where jsvx's test only asks that, the port is
also held to jsvx on the same damaged input: the same outcome (error or
not), the same stalls, and planes within 1 LSB on at most 0.1 % of
pixels (the port's tolerance against jsvx's f32 IDCT).  ``transcode`` goes
through the same truncations and bit flips, against jsvx's.  On a card
(``cuda``-marked), the damaged 1080p fixture reaches the CPU's outcome
with the CPU's planes.
"""

import numpy as np
import pytest
import torch

from jsvx.api import Decoder as JDecoder
from jsvx.api import Player as JPlayer
from jsvx.api import PlayerConfig as JConfig
from jsvx_torch.api import Decoder, Player, PlayerConfig
from jsvx_torch.pipeline.transcode import transcode
from jsvx_torch.tools.encoder import EncoderConfig, JsvEncoder

import torch_card

try:                                     # the card's machine has no JAX
    from jsvx.pipeline.transcode import transcode as j_transcode

    from conftest import synthetic_frames
except ImportError:
    j_transcode = None

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def good_stream():
    clip = synthetic_frames(6, 48, 64, seed=9)
    return JsvEncoder(64, 48, EncoderConfig(
        gop_size=3, quantizer_scale=4)).encode(clip), len(clip)


def _np(p):
    return p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def _drain(dec, data, total=None):
    """Feed everything, decode until stall or end; returns (the frames'
    planes as numpy, the stall positions, the error's type or None)."""
    stalls = []
    dec.on("stalled", stalls.append)
    frames = []
    try:
        dec.feed(0, data, total=total if total is not None else len(data))
        for _ in range(100):
            f = dec.decode_frame()
            if f is None:
                break
            frames.append(tuple(_np(p) for p in f.planes))
    except ValueError as e:                  # a clean parse error is fine
        return frames, stalls, type(e)
    return frames, stalls, None


def _close(port: list, ref: list) -> None:
    """Same frame count; each plane within 1 LSB, <= 0.1 % of pixels off."""
    assert len(port) == len(ref)
    n_diff = n_pix = 0
    for fp, fr in zip(port, ref):
        assert len(fp) == len(fr)
        for p, r in zip(fp, fr):
            assert p.shape == r.shape and p.dtype == np.uint8
            diff = np.abs(p.astype(int) - r.astype(int))
            assert diff.max() <= 1
            n_diff += int((diff > 0).sum())
            n_pix += diff.size
    assert n_diff <= 1e-3 * max(n_pix, 1)


def _both(data, use_native, total=None):
    """The port's Decoder and jsvx's on the same input: their outcomes
    (equal), and the port's frames, stalls and error."""
    port = _drain(Decoder(PlayerConfig(use_native_parser=use_native),
                          backend="torch", device="cpu"), data, total)
    ref = _drain(JDecoder(JConfig(use_native_parser=use_native),
                          backend="jax"), data, total)
    assert port[1] == ref[1] and port[2] == ref[2]
    _close(port[0], ref[0])
    return port


@pytest.mark.parametrize("use_native", [False, True])
def test_truncated_stream_stalls_not_crashes(good_stream, use_native):
    data, n = good_stream
    for cut in (len(data) // 3, len(data) // 2, len(data) - 5):
        # the truncated prefix with the TRUE total: the decoder must stall
        # awaiting the missing tail, never crash
        frames, stalls, err = _both(data[:cut], use_native, total=len(data))
        assert err is None
        assert len(frames) < n
        assert stalls


@pytest.mark.parametrize("use_native", [False, True])
def test_truncated_final_stream_ends(good_stream, use_native):
    """When the truncated prefix IS the whole stream (total == cut), the
    decoder terminates (ended, stall at the end, or a clean error)."""
    data, n = good_stream
    frames, _, _ = _both(data[:int(len(data) * 0.7)], use_native)
    assert len(frames) <= n


@pytest.mark.parametrize("use_native", [False, True])
def test_bit_flips_never_crash(good_stream, use_native):
    """Randomly corrupted payload bytes: every decode finishes (frames,
    stall, end, or a clean error), the same way as jsvx's."""
    data, n = good_stream
    rng = np.random.default_rng(42)
    for _ in range(12):
        buf = bytearray(data)
        for _ in range(4):
            pos = int(rng.integers(60, len(buf)))   # keep container header
            buf[pos] ^= 1 << int(rng.integers(0, 8))
        frames, _, _ = _both(bytes(buf), use_native)
        assert len(frames) <= n + 2


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_garbage_source_reports_error_or_nothing(backend):
    """A source that is not JSV at all must not loop or crash."""
    p = Player(PlayerConfig(), backend=backend, device="cpu")
    junk = bytes(np.random.default_rng(1).integers(0, 256, 4096,
                                                   dtype=np.uint8))
    p.src = junk
    for i in range(30):
        p.tick(i / 30.0)
    # no frames were produced and no exception escaped
    assert p.current_time == 0.0


def _play_corrupt(player, data):
    buf = bytearray(data)
    mid = len(buf) // 2
    for i in range(mid, min(mid + 40, len(buf))):
        buf[i] ^= 0x55
    shown = []
    player.set_frame_sink(lambda f, t: shown.append(t))
    player.src = bytes(buf)
    player.play()
    t = 0.0
    for _ in range(90):
        t += 1 / 30.0
        try:
            player.tick(t)
        except ValueError:
            break                            # clean decode error is fine
    return shown


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_player_survives_corrupt_midstream(good_stream, backend):
    """Some prefix decodes; the Player neither hangs nor crashes.  The
    oracle backend shows the frames jsvx's oracle Player shows."""
    data, n = good_stream
    shown = _play_corrupt(Player(PlayerConfig(), backend=backend,
                                 device="cpu"), data)
    assert len(shown) <= n
    if backend == "oracle":
        assert shown == _play_corrupt(JPlayer(JConfig(), backend="oracle"),
                                      data)


def _transcode_outcome(run, data):
    got = {}
    try:
        run(data, lambda gi, outs: got.__setitem__(
            gi, [_np(o).copy() for o in outs]))
        err = None
    except ValueError as e:
        err = type(e)
    frames = [tuple(s[i] for s in got[g]) for g in sorted(got)
              for i in range(got[g][0].shape[0])]
    return sorted(got), frames, err


@pytest.mark.parametrize("impl", ["fused", "two_kernel"])
def test_transcode_damaged_streams_match_jsvx(good_stream, impl):
    """Truncated and bit-flipped streams through ``transcode``: the same
    GOPs delivered and the same outcome as jsvx's, the planes within the
    tolerance."""
    data, _ = good_stream
    for bad in torch_card.damaged(data):
        gops, frames, err = _transcode_outcome(
            lambda d, s: transcode(d, s, device="cpu", impl=impl), bad)
        ref = _transcode_outcome(lambda d, s: j_transcode(d, s, impl="xla"),
                                 bad)
        assert (gops, err) == (ref[0], ref[2])
        _close(frames, ref[1])


@pytest.mark.cuda
def test_damaged_fixture_on_the_card_equals_the_cpu():
    """The 1080p fixture truncated (declared whole, so the Decoder
    stalls, and as it is, so it ends) and bit-flipped: on the card the
    Decoder and ``transcode`` (both routes) reach the CPU's outcome
    (stalls, GOPs delivered, error) with the CPU's planes."""
    dev = torch_card.card()
    data = torch_card.stream("1080p")
    damaged = torch_card.damaged(data)
    for bad, total in ([(b, len(b)) for b in damaged]
                       + [(b, len(data)) for b in damaged[:3]]):
        got, want = (_drain(Decoder(PlayerConfig(), device=d), bad, total)
                     for d in (dev, "cpu"))
        assert got[1:] == want[1:], total
        torch_card.assert_frames_equal(got[0], want[0])
        for impl in ("fused", "two_kernel"):
            got, want = (_transcode_outcome(
                lambda x, s: transcode(x, s, device=d, impl=impl), bad)
                for d in (dev, "cpu"))
            assert (got[0], got[2]) == (want[0], want[2]), impl
            torch_card.assert_frames_equal(got[1], want[1])
