"""The Decoder's GOP batch on the compact wire against the dense wire.

A fully buffered key-map GOP that the Decoder decodes as one batch goes to
the device as the compact wire (the coded coefficients, expanded on the
device by the GOP program) unless the oddify-zeros quirk is on or the
GOP's compact parse is ``dirty`` (blocks out of order), which take the
dense wire.  On the CPU (the kernels' plain versions) the two routes give
the same frames bit for bit: planes, picture types, timestamps and the
reference planes carried to the next decode; the counters
``decoder.gop_batches.compact`` and ``.dense`` say which route each batch
took, and the ``parse`` stage's ``wire`` attribute says it too.  The
dense route is forced by patching :meth:`Decoder._compact_route`.
"""

import contextlib

import numpy as np
import pytest
import torch

import jsvx_torch.api.decoder as decoder_mod
from jsvx_torch.api import Decoder, PlayerConfig
from jsvx_torch.pipeline.stream import StreamDecoder
from jsvx_torch.runtime.profiler import Metrics, StageTimer
from jsvx_torch.tools import EncoderConfig, JsvEncoder
from jsvx_torch.tools import fixture
from jsvx_torch.tools.fixture import zoom_clip

import torch_card

torch.set_num_threads(1)

COMPACT = "decoder.gop_batches.compact"
DENSE = "decoder.gop_batches.dense"


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**kw)).encode(clip)


@pytest.fixture(scope="module", params=["yuv", "yuva", "switch"])
def stream(request):
    """(label, bytes, key-map GOPs): 10 frames at GOP 4, the same with an
    alpha plane, and the rendition switch (a sequence header with other
    quant matrices at GOP 1)."""
    if request.param == "switch":
        return "switch", fixture.switch_stream(key_map=True), 2
    clip = (torch_card.yuva_clip(10, 48, 64) if request.param == "yuva"
            else zoom_clip(48, 64, 10, seed=3))
    return request.param, _encode(clip, gop_size=4, quantizer_scale=5,
                                  me_range=4, half_pel_refine=True), 3


class _Wires(StageTimer):
    """A stage timer that keeps the ``wire`` of each ``parse`` stage."""

    def __init__(self):
        super().__init__()
        self.wires = []

    @contextlib.contextmanager
    def stage(self, name, **attrs):
        with super().stage(name, **attrs) as s:
            inner = s
            seen = dict(attrs)

            class _Set:
                def set(self, **more):
                    seen.update(more)
                    inner.set(**more)

            yield _Set()
        if name == "parse":
            self.wires.append(seen.get("wire"))


@contextlib.contextmanager
def _dense_route():
    """The Decoder's GOP batches forced onto the dense wire."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Decoder, "_compact_route", lambda self: False)
        yield


def _decoder(data, quirk=False, scan=True):
    """A Decoder (on the CPU, its stages timed by :class:`_Wires`) fed
    ``data`` -> (it, its frames)."""
    d = Decoder(PlayerConfig(use_gop_scan=scan, quirk_oddify_zeros=quirk),
                device="cpu")
    d.metrics = Metrics(timers=_Wires())
    d.buffer.metrics = d.metrics
    d.feed(0, data, total=len(data))
    return d, list(d.iter_frames())


def _planes(frames):
    return [tuple(p.numpy() for p in f.planes) for f in frames]


def _same_frames(a, b):
    assert len(a) == len(b) > 0
    assert [f.picture_type for f in a] == [f.picture_type for f in b]
    assert [f.ts_ms for f in a] == [f.ts_ms for f in b]
    torch_card.assert_frames_equal(_planes(a), _planes(b))


def test_compact_batches_equal_the_dense_route(stream):
    label, data, gops = stream
    d, got = _decoder(data)
    with _dense_route():
        dd, want = _decoder(data)
    assert d.ended and dd.ended
    _same_frames(got, want)
    assert len(got) == (6 if label == "switch" else 10)
    assert all(len(f.planes) == (4 if label == "yuva" else 3) for f in got)
    torch_card.assert_frames_equal(
        _planes(got), [tuple(p.numpy() for p in f) for f in
                       StreamDecoder(data, device="cpu").decode().frames])
    assert d.metrics.counters[COMPACT] == gops and DENSE not in \
        d.metrics.counters
    assert dd.metrics.counters[DENSE] == gops and COMPACT not in \
        dd.metrics.counters
    assert d.metrics.timers.wires == ["compact"] * gops
    assert dd.metrics.timers.wires == ["dense"] * gops
    # the same stages, the compact wire through the same ones
    assert d.metrics.timers.counts == dd.metrics.timers.counts
    assert d.metrics.counters["frames"] == len(got)


def test_the_carried_references_decode_the_next_picture_alike(stream):
    """After GOP 0's batch the reference planes each route carries are
    equal, and a P picture decoded picture by picture from them too."""
    _, data, _ = stream
    fts = StreamDecoder(data, device="cpu").parse_all()
    p_picture = fts[1]
    assert not p_picture.is_intra_picture
    out = []
    for route in (contextlib.nullcontext, _dense_route):
        with route():
            d = Decoder(PlayerConfig(), device="cpu")
            d.feed(0, data, total=len(data))
            assert d.decode_frame() is not None
            refs = tuple(r.clone() for r in d._refs)
            planes, = d._decode([p_picture], use_gop_scan=False)
        out.append((refs, tuple(p.numpy() for p in planes)))
    torch_card.assert_frames_equal([tuple(r.numpy() for r in out[0][0])],
                                   [tuple(r.numpy() for r in out[1][0])])
    torch_card.assert_frames_equal([out[0][1]], [out[1][1]])


def test_the_quirk_takes_the_dense_route(stream):
    """With the oddify-zeros quirk every batch is dense, and decodes as the
    dense stream decoder does (what the batch gave before the compact
    route)."""
    _, data, gops = stream
    d, got = _decoder(data, quirk=True)
    assert d.metrics.counters[DENSE] == gops and COMPACT not in \
        d.metrics.counters
    assert d.metrics.timers.wires == ["dense"] * gops
    want = StreamDecoder(data, quirk_oddify_zeros=True,
                         device="cpu").decode().frames
    torch_card.assert_frames_equal(
        _planes(got), [tuple(p.numpy() for p in f) for f in want])
    _, plain = _decoder(data)
    assert any(not np.array_equal(a, b) for fa, fb in
               zip(_planes(got), _planes(plain)) for a, b in zip(fa, fb))


def test_a_dirty_gop_is_parsed_again_dense():
    """A GOP whose slices overlap cannot go on the compact wire: its batch
    is parsed again into dense pictures and decodes as the dense route."""
    data = torch_card.stream("48x64-dirty")
    d, got = _decoder(data)
    with _dense_route():
        _, want = _decoder(data)
    _same_frames(got, want)
    assert d.metrics.counters[DENSE] == 1 and COMPACT not in \
        d.metrics.counters
    assert d.metrics.timers.wires == ["dense"]


def test_a_parse_reported_dirty_falls_back_to_dense(stream, monkeypatch):
    """Every GOP's compact parse reported ``dirty``: each batch is parsed
    again dense, its pooled buffers go back, and the frames are the dense
    route's."""
    _, data, gops = stream
    real = decoder_mod.parse_gop_compact
    released = []

    def dirty(*a, **k):
        g = real(*a, **k)
        g.dirty = True
        released.extend(id(b) for b in g.pooled)
        return g

    monkeypatch.setattr(decoder_mod, "parse_gop_compact", dirty)
    d, got = _decoder(data)
    monkeypatch.undo()
    with _dense_route():
        _, want = _decoder(data)
    _same_frames(got, want)
    assert d.metrics.counters[DENSE] == gops and COMPACT not in \
        d.metrics.counters
    assert d.metrics.timers.wires == ["dense"] * gops
    free = {id(b) for bufs in d._pool._free.values() for b in bufs}
    assert released and set(released) <= free


@pytest.fixture(scope="module")
def noisy():
    """Two GOPs of 4 noisy 64x80 pictures at quantiser 1: each GOP takes
    several times the stream's picture gate (``vbv_buffer_bytes``)."""
    rng = np.random.default_rng(0)
    clip = [(np.clip(y.astype(int) + rng.integers(-30, 30, y.shape), 0,
                     255).astype(np.uint8), cb, cr)
            for y, cb, cr in zoom_clip(64, 80, 8, seed=3)]
    return _encode(clip, gop_size=4, quantizer_scale=1)


def _fed_in_chunks(data, chunk):
    """A Decoder fed ``chunk`` bytes at a time, drained between chunks ->
    (it, its frames)."""
    d = Decoder(PlayerConfig(), device="cpu")
    got, pos = [], 0
    while True:
        frame = d.decode_frame()
        if frame is not None:
            got.append(frame)
        elif d.ended:
            return d, got
        else:
            d.feed(pos, data[pos:pos + chunk], len(data))
            pos += chunk


def test_a_partly_buffered_gop_decodes_picture_by_picture(noisy):
    """Fed in chunks, a GOP not yet fully buffered decodes picture by
    picture as before, and what is left of it once it is buffered goes
    as one compact batch; the frames are the dense route's."""
    d, got = _fed_in_chunks(noisy, len(noisy) // 9)
    with _dense_route():
        dd, want = _fed_in_chunks(noisy, len(noisy) // 9)
    _same_frames(got, want)
    assert len(got) == 8
    c, stages = d.metrics.counters, d.metrics.to_dict()["stages"]
    assert DENSE not in c and 0 < c[COMPACT] == stages["parse"]["count"]
    # the pictures outside the batches each decoded on their own
    assert c[COMPACT] < stages["device_decode"]["count"] < 8
    assert dd.metrics.counters[DENSE] == c[COMPACT]
    assert dd.metrics.timers.counts == d.metrics.timers.counts


def test_the_picture_path_keeps_the_dense_wire(stream):
    _, data, _ = stream
    d, got = _decoder(data, scan=False)
    assert COMPACT not in d.metrics.counters and DENSE not in \
        d.metrics.counters
    with _dense_route():
        _, want = _decoder(data)
    _same_frames(got, want)


def test_the_entry_buckets_stick_to_the_decoder(stream):
    """The compact wire's entry buckets are the Decoder's and only grow,
    so a stream's batches ask for few program keys; a second Decoder on
    the stream asks for the same keys."""
    _, data, gops = stream
    keys = []
    real = decoder_mod.decode_compact_group

    def spy(gop, *a, **k):
        keys.append(tuple(gop.stacked["coef"][c]["cpk"].shape
                          for c in sorted(gop.stacked["coef"])))
        return real(gop, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decoder_mod, "decode_compact_group", spy)
        d, _ = _decoder(data)
        first = list(keys)
        keys.clear()
        _decoder(data)
    assert len(first) == gops and keys == first
    assert len(set(first)) <= 2
    for a, b in zip(first, first[1:]):
        assert all(x <= y for x, y in zip(a, b))
    assert first[-1] == tuple((d._buckets[c],) for c in sorted(d._buckets))
