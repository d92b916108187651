"""Streams and helpers of the port's ``cuda``-marked tests.

This module imports ``jsvx_torch`` only (the card's machine has no JAX);
pytest does not collect it.  The streams are encoded by the port's
encoder on the 1080p fixture's pattern (``tools/fixture.zoom_clip``),
once per process (:func:`stream`):

* ``1080p``: the fixture (``ensure_fixture``), 2 GOPs of 4 pictures;
* ``1080p-8-gops``: the fixture's GOPs repeated to 8;
* ``1080p-varied``: 12 GOPs of 1 to 4 pictures, each the first pictures
  of one of the fixture's GOPs;
* ``320x320-256mv``: 20x20 macroblocks, GOP 2; its second P picture
  carries 256 distinct motion vectors;
* ``48x64-dirty``: a first picture that carries its first slice twice
  (overlapping slices), so only the dense wire can carry GOP 0;
* ``cif-352x288``: 12 CIF frames, GOP 6;
* ``yuva-128x96``: 8 four-plane frames, GOP 4.
"""

from __future__ import annotations

import contextlib
import functools
import warnings

import numpy as np
import pytest
import torch

from jsvx_torch.api import Player, PlayerConfig
from jsvx_torch.bitstream.bitio import BitReader
from jsvx_torch.bitstream.container import parse_container_header
from jsvx_torch.coding.tables import START_PICTURE, START_SEQUENCE
from jsvx_torch.kernels import counters
from jsvx_torch.kernels.decode import decode_frame_planes, make_constants
from jsvx_torch.kernels.expand import expand_compact_gop_plain
from jsvx_torch.pipeline import packed_parse, program
from jsvx_torch.pipeline.gop import frame_at, zero_refs
from jsvx_torch.pipeline.packed_parse import (BufferPool, parse_gop_compact,
                                              parse_gop_packed, walk_stream)
from jsvx_torch.pipeline.transcode import transcode
from jsvx_torch.pipeline.wire import flatten_wire, unflatten_wire, wire_spec
from jsvx_torch.runtime.profiler import Metrics, StageTimer
from jsvx_torch.tools import EncoderConfig, JsvEncoder
from jsvx_torch.tools.fixture import ensure_fixture, zoom_clip

#: the kernels' encoded inputs: name -> (stream, GOP, pictures decoded
#: also with the oddify-zeros quirk)
GOPS = {"1080p-gop0": ("1080p", 0, (1,)),
        "320x320-256mv-gop0": ("320x320-256mv", 0, ()),
        "320x320-256mv-gop1": ("320x320-256mv", 1, ()),
        "48x64-dirty-gop0": ("48x64-dirty", 0, ()),
        "cif-352x288-gop0": ("cif-352x288", 0, ()),
        "yuva-128x96-gop0": ("yuva-128x96", 0, (1,))}
#: the Player's events
PLAYER_EVENTS = ("loadstart", "durationchange", "loadedmetadata",
                 "loadeddata", "progress", "canplay", "canplaythrough",
                 "play", "playing", "waiting", "stalled", "seeking",
                 "seeked", "ended", "error", "resize", "suspend", "frameout")
#: the stages in which ``transcode``'s host waits on purpose
WAIT_STAGES = ("wire_wait", "device_wait")


def card() -> torch.device:
    """The card the test runs on; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def yuva_clip(n: int, h: int, w: int) -> list:
    """The fixture's zooming pattern plus a moving alpha plane."""
    yy, xx = np.mgrid[0:h, 0:w]
    return [(y, cb, cr, np.clip(128 + 80 * np.sin(2 * np.pi * (xx + 5 * t)
                                                  / w) + 40 * (yy > 4 * t),
                                0, 255).astype(np.uint8))
            for t, (y, cb, cr) in enumerate(zoom_clip(h, w, n, seed=5))]


def _high_motion() -> bytes:
    mbs = 20
    enc = JsvEncoder(mbs * 16, mbs * 16, EncoderConfig(
        gop_size=2, quantizer_scale=8, f_code=3, intra_sad_threshold=1e9))
    calls = []

    def forced(y, ref_y):
        mv = np.zeros((mbs, mbs, 2), np.int64)
        if not calls:
            mv[2:18, 2:18] = (2, 2)
        else:
            idx = np.arange(256)
            mv[2:18, 2:18, 0] = (2 * (idx // 16 - 8)).reshape(16, 16)
            mv[2:18, 2:18, 1] = (2 * (idx % 16 - 8)).reshape(16, 16)
        calls.append(1)
        return mv

    enc._motion_search = forced
    data = enc.encode(zoom_clip(mbs * 16, mbs * 16, 4, seed=11))
    mv = wires(data, "cpu")[1][1]["mb"]["mv"][1].numpy()
    assert len(np.unique(mv.reshape(-1, 2), axis=0)) >= 256
    return data


def _dirty() -> bytes:
    raw = JsvEncoder(64, 48, EncoderConfig(gop_size=3, quantizer_scale=4)) \
        .encode(zoom_clip(48, 64, 3, seed=13))
    s0 = raw.find(b"\x00\x00\x01\x01", raw.find(b"\x00\x00\x01\x00"))
    nxt = s0 + 4
    while True:                          # the start code after the slice
        n = raw.find(b"\x00\x00\x01", nxt)
        if 0x01 <= raw[n + 3] <= 0xAF or raw[n + 3] in (0x00, 0xB8):
            break
        nxt = n + 4
    data = raw[:n] + raw[s0:n] + raw[n:]
    assert not wires(data, "cpu")[0][0]
    return data


def _fixture() -> bytes:
    with open(ensure_fixture(), "rb") as f:
        return f.read()


def _long() -> bytes:
    data = stream("1080p")
    body = data[parse_container_header(BitReader(data)).header_bytes:]
    return data + body * 3           # each GOP opens with a sequence header


def _varied() -> bytes:
    """GOP i is the first k pictures of the fixture's GOP g, for (g, k)
    below: a P picture predicts from earlier pictures only."""
    data = stream("1080p")
    n_head = parse_container_header(BitReader(data)).header_bytes
    seq_code = b"\x00\x00\x01" + bytes([START_SEQUENCE])
    pic_code = b"\x00\x00\x01" + bytes([START_PICTURE])
    gops = [seq_code + g for g in data[n_head:].split(seq_code)[1:]]
    out = [data[:n_head]]
    for g, k in ((0, 4), (1, 1), (0, 2), (1, 3), (0, 1), (1, 4), (0, 3),
                 (1, 2), (0, 4), (1, 4), (0, 2), (1, 1)):
        pos = -1
        for _ in range(k + 1):           # the (k+1)-th picture's start code
            pos = gops[g].find(pic_code, pos + 1)
        out.append(gops[g] if pos < 0 else gops[g][:pos])
    return b"".join(out)


def damaged(data: bytes) -> list:
    """``data`` truncated at a half, at 0.7 and 5 bytes short of its end,
    and six copies with 4 bits flipped each past the container header."""
    rng = np.random.default_rng(7)
    out = [data[:len(data) // 2], data[:int(len(data) * 0.7)],
           data[:len(data) - 5]]
    for _ in range(6):
        buf = bytearray(data)
        for _ in range(4):
            pos = int(rng.integers(60, len(buf)))
            buf[pos] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(buf))
    return out


_MAKERS = {
    "1080p": _fixture, "1080p-8-gops": _long, "1080p-varied": _varied,
    "320x320-256mv": _high_motion, "48x64-dirty": _dirty,
    "cif-352x288": lambda: JsvEncoder(352, 288, EncoderConfig(
        gop_size=6, quantizer_scale=6, me_range=8, half_pel_refine=True))
    .encode(zoom_clip(288, 352, 12, seed=7)),
    "yuva-128x96": lambda: JsvEncoder(128, 96, EncoderConfig(
        gop_size=4, quantizer_scale=5, me_range=6, half_pel_refine=True))
    .encode(yuva_clip(8, 96, 128)),
}


@functools.cache
def stream(label: str) -> bytes:
    """The bytes of stream ``label`` (one of those above)."""
    return _MAKERS[label]()


def wires(data: bytes, device) -> list:
    """Each GOP of ``data`` as the decode takes it: (whether on the
    compact wire, the wire unflattened on ``device``): the compact wire
    where it carries the GOP, the dense wire where not."""
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    out = []
    for group in groups:
        g = parse_gop_compact(arr, group, seq, meta, BufferPool(), {})
        compact = not g.dirty
        if not compact:
            g = parse_gop_packed(arr, group, seq, meta)
        spec = wire_spec(g.stacked)
        out.append((compact, unflatten_wire(torch.from_numpy(
            flatten_wire(g.stacked, spec)).to(device), spec)))
    return out


def compact_gops(data: bytes) -> int:
    """The GOPs of ``data`` on the compact wire: the expansion launches of
    a ``transcode`` of it."""
    return sum(compact for compact, _ in wires(data, "cpu"))


def compact_batches(player) -> int:
    """The GOP batches that ``player``'s Decoder shipped on the compact
    wire: the expansion launches of its playback."""
    return player.decoder.metrics.counters.get(
        "decoder.gop_batches.compact", 0)


def dense_gops(data: bytes, device) -> tuple:
    """(meta, seq, each GOP of ``data`` on ``device`` as the kernels take
    it: its wire, expanded by the plain version where compact)."""
    meta, seq, _ = walk_stream(data)
    return meta, seq, [
        expand_compact_gop_plain(t, seq.mb_height, seq.mb_width)
        if "coef" in t else t for _, t in wires(data, device)]


def pictures(name: str, device):
    """Every picture of the GOP ``GOPS[name]`` on ``device`` as the
    kernels take it: (picture, frame, reference planes, constants,
    quirk), each picture the entry lists also with the quirk; the
    references carried by the plain decode."""
    label, gi, quirk_pictures = GOPS[name]
    meta, seq, gops = dense_gops(stream(label), device)
    dense = gops[gi]
    consts = make_constants(seq, device)
    refs = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                     device)
    for i in range(int(dense["is_p"].shape[0])):
        frame = frame_at(dense, i)
        for quirk in sorted({False, i in quirk_pictures}):
            yield i, frame, refs, consts, quirk
        refs = decode_frame_planes(frame, refs, consts)


def eager_run(self, copied, metrics) -> tuple:
    """``GopProgram.run`` without its graph: the body (the eager loop on
    the static wire) on every call, no capture, no replay."""
    if copied is not None:
        torch.cuda.current_stream(self.device).wait_event(copied)
    outs = self.body()
    self.consumed = program._record(self.device)
    self.loaded = False
    return outs, self.consumed


def want_counts(**launches) -> dict:
    """Every count of the kernels' counter registry as a run on the card
    must leave it: each kernel's launches as given, and never a torch
    sideband expansion, a plain coefficient expansion or a plain colour
    conversion."""
    return {**dict.fromkeys(counters.snapshot(), 0), **launches}


def recording_keys(monkeypatch) -> list:
    """The key of every GOP program a call asks for, from now on."""
    keys, real_get = [], program.ProgramSet.get

    def get(self, key, build):
        keys.append(key)
        return real_get(self, key, build)

    monkeypatch.setattr(program.ProgramSet, "get", get)
    return keys


def counted(run):
    """``run()`` with the counter registry set to 0 just before it:
    (its result, the counts just after)."""
    counters.reset()
    out = run()
    return out, counters.snapshot()


def as_numpy(frames) -> list:
    return [tuple(p.cpu().numpy() for p in f) for f in frames]


def assert_frames_equal(got: list, want: list) -> None:
    assert len(got) == len(want), (len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(b), i
        for p, q in zip(a, b):
            assert p.dtype == q.dtype == np.uint8 and p.shape == q.shape, i
            assert np.array_equal(p, q), i


def play_rgb(data: bytes, device, quirk: bool = False) -> tuple:
    """The Player with RGB output, driven by a virtual 30 Hz clock to
    ``ended``: (its events with the ready state at each, the RGB frames
    its sink got and the decoded planes of each frame shown, as numpy;
    the Player)."""
    p = Player(PlayerConfig(emit_rgb=True, quirk_oddify_zeros=quirk),
               device=device)
    events, rgb, planes = [], [], []
    for name in PLAYER_EVENTS:
        p.on(name, lambda *a, n=name: events.append((n, int(p.ready_state))))

    def sink(frame, t):
        assert frame.is_contiguous()
        rgb.append(frame.cpu().numpy())

    p.set_frame_sink(sink)
    p.on("frameout", lambda f, t: planes.append(
        tuple(q.cpu().numpy() for q in f.planes)))
    p.src = data
    p.play()
    t = 0.0
    while not p.ended and t < 60.0:
        t += 1 / 30.0
        p.tick(t)
    assert p.ended
    return events, rgb, planes, p


class StageWatch(StageTimer):
    """A stage timer that notes which of the warnings in ``caught`` each
    stage raised: ``spans`` holds (stage, first warning, past the last),
    ``gop0_end`` the count of warnings when GOP 0's dispatch ended."""

    def __init__(self, caught: list):
        super().__init__()
        self.caught = caught
        self.spans: list = []
        self.gop0_end = None

    @contextlib.contextmanager
    def stage(self, name: str, **attrs):
        n0 = len(self.caught)
        with super().stage(name, **attrs) as s:
            yield s
        self.spans.append((name, n0, len(self.caught)))
        if name == "device_dispatch" and self.gop0_end is None:
            self.gop0_end = len(self.caught)


@contextlib.contextmanager
def pinned_buffers(record: list):
    """Record, for every buffer a ``BufferPool`` hands out, whether it is
    page-locked."""
    real = packed_parse.BufferPool.acquire

    def acquire(self, shape, dtype):
        arr = real(self, shape, dtype)
        record.append(bool(torch.from_numpy(arr).is_pinned()))
        return arr

    packed_parse.BufferPool.acquire = acquire
    try:
        yield
    finally:
        packed_parse.BufferPool.acquire = real


def watched_transcode(data: bytes, dev, impl: str = "fused",
                      quirk: bool = False) -> dict:
    """One ``transcode`` with CUDA's sync debug mode on ("warn") on a
    card, each warning placed in its stage; a sink that keeps each GOP's
    planes as given; the launches counted; the pooled buffers' pinning
    recorded.  ``frames`` are read after the run."""
    kept, pins = {}, []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        timer = StageWatch(caught)
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with pinned_buffers(pins):
                res, n = counted(lambda: transcode(
                    data, lambda gi, outs: kept.__setitem__(gi, outs),
                    device=dev, impl=impl, quirk_oddify_zeros=quirk,
                    metrics=Metrics(timers=timer)))
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    in_waits = {i for name, a, b in timer.spans if name in WAIT_STAGES
                for i in range(a, b)}
    after = set(range(timer.gop0_end or 0, len(caught))) - in_waits
    ptrs = [o.data_ptr() for outs in kept.values() for o in outs]
    return dict(res=res, launches=n, pins=pins, gops=sorted(kept),
                frames=[tuple(s[i].cpu().numpy() for s in kept[g])
                        for g in sorted(kept)
                        for i in range(kept[g][0].shape[0])],
                after_gop0_outside_waits=[str(caught[i].message)
                                          for i in sorted(after)],
                distinct_planes=len(set(ptrs)) == len(ptrs),
                spans=timer.spans)
