"""Each GOP decodes with its own sequence header's quant matrices.

The stream is a rendition switch (``jsvx_torch.tools.fixture.
switch_stream``): a 64x48 clip of 6 frames encoded twice at GOP 3 and q 4,
once with the default matrices and once with the intra matrix times 3 and
a flat non-intra matrix of 40; GOP 0 comes from the first encode, GOP 1
from the second, each after its own sequence header (with and without the
container's GOP key map, which the Decoder's GOP batch and seek need).

Every device entry point of the port, on the CPU (the kernels' plain
versions), is held per GOP within 1 LSB of the port's float64 oracle
Decoder, which decodes each picture with the current sequence header:
``transcode`` (both routes, compact and quirk wires), ``StreamDecoder``
(GOP scan and picture by picture, both routes), the Decoder (GOP batch
and picture by picture, and after a seek across the switch) and the
Player's RGB (within 1 LSB of ``refmath`` on the oracle's planes).  Before
the repair each missed one GOP by thousands of pixels: jsvx still does,
and its entry points are pinned here as strict ``xfail``s.  A stream
whose headers all carry one pair of matrices still builds one constants
set and one program key.

The ``cuda``-marked tests run the same entry points, and the Decoder's
seek into GOP 1, on a card against the CPU and the oracle, with the
kernels and the program captures counted: ``python -m pytest
tests/test_torch_sequence_matrices.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from jsvx_torch.api import Decoder, Player, PlayerConfig
from jsvx_torch.kernels.decode import constants_per_seq, quant_key
from jsvx_torch.pipeline import program as program_mod
from jsvx_torch.pipeline import stream as stream_mod
from jsvx_torch.pipeline import transcode as transcode_mod
from jsvx_torch.pipeline.packed_parse import walk_stream, walk_stream_seqs
from jsvx_torch.pipeline.program import ProgramCache, ProgramSet
from jsvx_torch.pipeline.stream import StreamDecoder
from jsvx_torch.pipeline.transcode import transcode
from jsvx_torch.runtime.profiler import Metrics
from jsvx_torch.tools import fixture
from jsvx_torch.tools.encoder import EncoderConfig, JsvEncoder
from jsvx_torch.tools.refmath import ycbcr_to_rgb as ref_rgb

import torch_card

try:                                     # the card's machine has no JAX
    import jax

    from jsvx.api import Decoder as JsvxDecoder
    from jsvx.api import PlayerConfig as JsvxPlayerConfig
    from jsvx.pipeline.stream import JaxStreamDecoder
    from jsvx.pipeline.transcode import transcode as j_transcode
except ImportError:
    jax = None

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs jax")
GOP = 3
IMPLS = ("fused", "two_kernel")


@pytest.fixture(scope="module")
def streams():
    """key_map -> the spliced stream."""
    return {km: fixture.switch_stream(km) for km in (False, True)}


def _oracle(data, quirk=False):
    d = Decoder(PlayerConfig(use_gop_scan=False, quirk_oddify_zeros=quirk),
                backend="oracle", device="cpu")
    d.feed(0, data, total=len(data))
    return [tuple(np.asarray(p) for p in f.planes) for f in d.iter_frames()]


@pytest.fixture(scope="module")
def oracle(streams):
    return {km: _oracle(data) for km, data in streams.items()}


def _np(frames):
    return [tuple(np.asarray(p) for p in f) for f in frames]


def _per_gop(got, want):
    """(differing pixels, largest difference) of each GOP."""
    assert len(got) == len(want) == 6
    out = []
    for g in range(0, len(want), GOP):
        n = mx = 0
        for fa, fb in zip(got[g:g + GOP], want[g:g + GOP], strict=True):
            for a, b in zip(fa, fb, strict=True):
                assert a.shape == b.shape and a.dtype == np.uint8
                d = np.abs(a.astype(int) - b.astype(int))
                n += int((d > 0).sum())
                mx = max(mx, int(d.max()))
        out.append((n, mx))
    return out


def _within_1lsb(got, want):
    per = _per_gop(got, want)
    assert all(mx <= 1 for _, mx in per), per


def _host(p):
    """A plane of either package (a torch tensor on any device, or a JAX
    array) as numpy."""
    return p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def _transcode(data, impl="fused", quirk=False, fn=transcode, **kw):
    got = {}

    def sink(gi, outs):
        got[gi] = [tuple(_host(p[i]) for p in outs)
                   for i in range(outs[0].shape[0])]

    fn(data, sink, impl=impl, quirk_oddify_zeros=quirk, **kw)
    return [f for gi in sorted(got) for f in got[gi]]


def _decoder(data, scan, cls=Decoder, config=PlayerConfig, **kw):
    d = cls(config(use_gop_scan=scan), **kw)
    d.feed(0, data, total=len(data))
    return d, list(d.iter_frames())


# ---------------------------------------------------------------------------
# The stream


def test_the_stream_switches_matrices_at_gop_1(streams):
    for data in streams.values():
        meta, seqs, groups = walk_stream_seqs(data)
        assert [len(g) for g in groups] == [GOP, GOP]
        assert quant_key(seqs[0]) == quant_key(None)
        assert quant_key(seqs[1]) == tuple(
            int(x) for m in (fixture.SWITCH_INTRA_Q,
                             fixture.SWITCH_NON_INTRA_Q)
            for x in m.reshape(-1))
        # walk_stream (jsvx's copy) gives the last header only
        assert quant_key(walk_stream(data)[1]) == quant_key(seqs[1])


def test_the_oracle_is_the_yardstick(streams, oracle):
    """The oracle's GOP 1 equals its decode of the second encode alone,
    and its GOP 0 that of the first: the switch changes nothing else."""
    clip = fixture.switch_clip()
    for km in (False, True):
        for g, extra in ((0, {}), (1, {
                "custom_intra_q": fixture.SWITCH_INTRA_Q,
                "custom_non_intra_q": fixture.SWITCH_NON_INTRA_Q})):
            alone = _oracle(JsvEncoder(64, 48, EncoderConfig(
                gop_size=GOP, quantizer_scale=4, key_map=km,
                **extra)).encode(clip))
            sl = slice(g * GOP, (g + 1) * GOP)
            for a, b in zip(oracle[km][sl], alone[sl], strict=True):
                assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_key_map_points_at_the_spliced_gops(streams):
    from jsvx_torch.bitstream.bitio import BitReader
    from jsvx_torch.bitstream.container import parse_container_header

    data = streams[True]
    meta = parse_container_header(BitReader(data))
    for off in meta.key_map.offsets:
        assert data[off:off + 4] == b"\x00\x00\x01\xc3"
    assert parse_container_header(BitReader(streams[False])).key_map is None


# ---------------------------------------------------------------------------
# The port's entry points


@pytest.mark.parametrize("quirk", [False, True], ids=["compact", "quirk"])
@pytest.mark.parametrize("impl", IMPLS)
def test_transcode_per_gop_matrices(streams, oracle, impl, quirk):
    for km in (False, True):
        want = _oracle(streams[km], quirk) if quirk else oracle[km]
        _within_1lsb(_transcode(streams[km], impl, quirk, device="cpu"),
                     want)


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "picture"])
@pytest.mark.parametrize("impl", IMPLS)
def test_stream_decoder_per_gop_matrices(streams, oracle, impl, scan):
    res = StreamDecoder(streams[False], device="cpu").decode(
        use_gop_scan=scan, impl=impl)
    _within_1lsb(_np(res.frames), oracle[False])


@pytest.mark.parametrize("km,scan", [(False, False), (True, False),
                                     (True, True)],
                         ids=["picture", "picture-key-map", "gop-batch"])
def test_decoder_per_gop_matrices(streams, oracle, km, scan):
    d, frames = _decoder(streams[km], scan, device="cpu")
    assert d.ended
    stages = d.metrics.to_dict()["stages"]
    # the GOP batch engaged where the key map allows it: once per GOP
    assert stages.get("parse", {}).get("count", 0) == (2 if scan else 0)
    _within_1lsb(_np(f.planes for f in frames), oracle[km])


@pytest.mark.parametrize("scan", [True, False], ids=["gop-batch", "picture"])
@pytest.mark.parametrize("direction", ["forward", "back"])
def test_decoder_seek_across_the_switch(streams, oracle, scan, direction):
    """A seek into the other rendition's GOP rebuilds the constants."""
    data = streams[True]
    d = Decoder(PlayerConfig(use_gop_scan=scan), device="cpu")
    d.feed(0, data, total=len(data))
    first = d.decode_frame()
    assert first is not None
    if direction == "forward":
        target, want = 150.0, oracle[True][GOP:]
    else:
        list(d.iter_frames())            # to the end: GOP 1 decoded last
        target, want = 0.0, oracle[True]
    before = d._consts
    assert d.seek(target)
    got = _np(f.planes for f in d.iter_frames())
    assert d.ended and len(got) == len(want)
    # the frames before the seek's GOP are the oracle's: whole GOPs again
    _within_1lsb(oracle[True][:6 - len(got)] + got, oracle[True])
    assert d._consts is not before


def test_player_rgb_per_gop_matrices(streams, oracle):
    p = Player(PlayerConfig(emit_rgb=True), device="cpu")
    p.src = streams[False]
    got = []
    p.set_frame_sink(lambda rgb, t: got.append(rgb.numpy()))
    p.play()
    t = 0.0
    while not p.ended and t < 3.0:
        t += 1 / 30.0
        p.tick(t)
    assert p.ended and len(got) == 6
    for g in range(2):
        worst = 0
        for rgb, planes in zip(got[g * GOP:(g + 1) * GOP],
                               oracle[False][g * GOP:(g + 1) * GOP]):
            want = ref_rgb(*planes)[:48, :64]
            assert rgb.shape == want.shape == (48, 64, 3)
            worst = max(worst, int(np.abs(rgb.astype(int)
                                          - want.astype(int)).max()))
        assert worst <= 1, (g, worst)


# ---------------------------------------------------------------------------
# One pair of matrices: one constants set, one program


@pytest.fixture
def cache(monkeypatch):
    c = ProgramCache()
    for mod in (stream_mod, transcode_mod):
        monkeypatch.setattr(mod, "CACHE", c)
    return c


@pytest.fixture
def asked(monkeypatch):
    keys = []
    real = ProgramSet.get

    def get(self, key, build):
        keys.append(key)
        return real(self, key, build)

    monkeypatch.setattr(ProgramSet, "get", get)
    return keys


def test_one_header_pair_builds_one_constants_set_and_program(cache, asked):
    clip = fixture.zoom_clip(48, 64, 9, 11)
    data = JsvEncoder(64, 48, EncoderConfig(
        gop_size=GOP, quantizer_scale=4)).encode(clip)
    meta, seqs, groups = walk_stream_seqs(data)
    assert len(groups) == 3 and len({id(s) for s in seqs}) == 3
    consts = constants_per_seq(seqs, "cpu")
    assert all(c is consts[0] for c in consts)
    _transcode(data, device="cpu")
    assert len(asked) == 3 and len(set(asked)) == 1
    assert len(cache.programs()) == 1
    del asked[:]
    StreamDecoder(data, device="cpu").decode()
    assert len(asked) == 3 and len(set(asked)) == 1


def test_a_switch_gets_a_program_per_matrices(streams, cache, asked):
    _transcode(streams[False], device="cpu")
    assert len(asked) == 2 and asked[0].spec == asked[1].spec
    assert asked[0].quant != asked[1].quant
    assert len(cache.programs()) == 2
    del asked[:]
    StreamDecoder(streams[False], device="cpu").decode(use_gop_scan=False)
    assert len(asked) == 6 and len(set(asked)) == 2


def test_a_p_picture_after_a_switch_keeps_its_reference(streams, oracle):
    """A nonconforming stream with a sequence header between P pictures:
    the stream decoder splits the group there and carries the reference
    planes across the split."""
    data = streams[False]
    from jsvx_torch.bitstream.container import find_start_codes
    from jsvx_torch.coding import tables as T

    codes = [(int(o), int(c)) for o, c in find_start_codes(data)]
    seq1 = [o for o, c in codes if c == T.START_SEQUENCE][1]
    gop1 = [o for o, c in codes if c == T.START_GOP and o > seq1][0]
    header = data[seq1:gop1]
    pics = [o for o, c in codes if c == T.START_PICTURE and o < seq1]
    # GOP 0 with GOP 1's sequence header before its last P picture
    spliced = data[:pics[2]] + header + data[pics[2]:]
    for scan in (True, False):
        got = _np(StreamDecoder(spliced, device="cpu").decode(
            use_gop_scan=scan).frames)
        want = _np(StreamDecoder(data, device="cpu").decode().frames)
        for a, b in zip(got[:2], want[:2]):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        # picture 2 predicts from picture 1's planes and dequantises with
        # the other matrices, as the oracle does
        assert not np.array_equal(got[2][0], want[2][0])
        _within_1lsb(got, _oracle(spliced))


# ---------------------------------------------------------------------------
# jsvx: one set of matrices per call or per Decoder (open there)

C1 = ("ROADMAP C1: jsvx builds one DecodeConstants per call or per Decoder, "
      "so a GOP after a sequence header with other matrices decodes with "
      "the wrong ones; the port repairs it, jsvx stays as it is")


@needs_jax
@pytest.mark.xfail(strict=True, raises=AssertionError, reason=C1)
def test_jsvx_transcode_per_gop_matrices(streams, oracle):
    _within_1lsb(_transcode(streams[False], "xla", fn=j_transcode),
                 oracle[False])


@needs_jax
@pytest.mark.xfail(strict=True, raises=AssertionError, reason=C1)
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "picture"])
def test_jsvx_stream_decoder_per_gop_matrices(streams, oracle, scan):
    res = JaxStreamDecoder(streams[False]).decode(use_gop_scan=scan,
                                                  impl="xla")
    _within_1lsb(_np(res.frames), oracle[False])


@needs_jax
@pytest.mark.xfail(strict=True, raises=AssertionError, reason=C1)
@pytest.mark.parametrize("km,scan", [(False, False), (True, True)],
                         ids=["picture", "gop-batch"])
def test_jsvx_decoder_per_gop_matrices(streams, oracle, km, scan):
    _, frames = _decoder(streams[km], scan, JsvxDecoder, JsvxPlayerConfig,
                         backend="jax")
    _within_1lsb(_np(f.planes for f in frames), oracle[km])


# ---------------------------------------------------------------------------
# On a card


#: the device entry points of the card's test: (path, impl, quirk)
CARD_PATHS = ([("transcode", i, q) for i in IMPLS for q in (False, True)]
              + [(p, i, False) for p in ("stream_scan", "stream_picture")
                 for i in IMPLS]
              + [(p, "fused", False) for p in ("decoder_gop_batch",
                                               "decoder_picture",
                                               "player_rgb")])


def _card_path(path, impl, quirk, data, device, m):
    """``data`` through ``path`` on ``device``, counted in ``m``: its
    frames as numpy (the Player's: each shown frame's planes and RGB)."""
    if path == "transcode":
        return _transcode(data, impl, quirk, device=device, metrics=m)
    if path.startswith("stream"):
        res = StreamDecoder(data, device=device).decode(
            use_gop_scan=path == "stream_scan", impl=impl, metrics=m)
        return [tuple(_host(p) for p in f) for f in res.frames]
    if path == "player_rgb":
        _, rgb, planes, p = torch_card.play_rgb(data, device)
        d, frames = p.decoder, [f + (x,) for f, x in zip(planes, rgb,
                                                          strict=True)]
    else:
        d, out = _decoder(data, path == "decoder_gop_batch", device=device)
        frames = [tuple(_host(p) for p in f.planes) for f in out]
    for k, v in d.metrics.counters.items():
        m.count(k, v)
    return frames


@pytest.mark.cuda
@pytest.mark.parametrize("path,impl,quirk", CARD_PATHS,
                         ids=["-".join(map(str, p)) for p in CARD_PATHS])
def test_per_gop_matrices_on_the_card_equal_the_cpu(monkeypatch, path, impl,
                                                    quirk):
    """The switch stream, with and without the key map, through each
    device entry point on the card from a cold program cache: per GOP
    within 1 LSB of the float64 oracle and bit-equal to the same call on
    the CPU (the Player's RGB within 1 LSB of ``refmath`` on the oracle's
    planes); each picture through its route's kernels once; captures =
    the distinct (layout, matrices) keys asked for, with both sets of
    matrices among them."""
    dev = torch_card.card()
    keys = torch_card.recording_keys(monkeypatch)
    launches = dict(fused=6) if impl == "fused" else dict(mc=6, recon=6)
    if path == "transcode":
        launches["expand"] = 0 if quirk else 2
    if path == "player_rgb":
        launches["color"] = 6
    for km in (False, True):
        data = fixture.switch_stream(km)
        want = _oracle(data, quirk)
        program_mod.CACHE.clear()
        keys.clear()
        m = Metrics()
        card, n = torch_card.counted(
            lambda: _card_path(path, impl, quirk, data, dev, m))
        asked = set(keys)
        cpu = _card_path(path, impl, quirk, data, "cpu", Metrics())
        _within_1lsb([f[:3] for f in card], want)
        assert _per_gop(card, cpu) == [(0, 0), (0, 0)], km
        # the Decoder's GOP batches (key map only) expand on the card
        batches = m.counters.get("decoder.gop_batches.compact", 0)
        if path == "decoder_gop_batch":
            assert batches == (2 if km else 0), km
        expand = dict(expand=batches) if path in ("decoder_gop_batch",
                                                  "player_rgb") else {}
        assert n == torch_card.want_counts(**launches, **expand), km
        assert m.counters.get("gop_program.captures", 0) == len(asked) > 0
        assert len({k.quant for k in asked}) == 2
        if path == "player_rgb":
            for f, o in zip(card, want, strict=True):
                x = f[-1]
                ref = ref_rgb(*o)[:x.shape[0], :x.shape[1]]
                assert np.abs(x.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("scan", [True, False], ids=["gop-batch", "picture"])
def test_decoder_seek_into_gop_1_on_the_card_equals_the_cpu(streams, oracle,
                                                             scan):
    """Once the first picture is out, a seek into GOP 1 (the other
    matrices) on the card: GOP 1 within 1 LSB of the oracle and bit-equal
    to the CPU, the fused kernel once a picture decoded."""
    dev = torch_card.card()

    def seek(device):
        d = Decoder(PlayerConfig(use_gop_scan=scan), device=device)
        d.feed(0, streams[True], total=len(streams[True]))
        assert d.decode_frame() is not None
        assert d.seek(150.0)
        return [tuple(_host(p) for p in f.planes) for f in d.iter_frames()]

    got, n = torch_card.counted(lambda: seek(dev))
    cpu = seek("cpu")
    assert n == torch_card.want_counts(fused=GOP + (GOP if scan else 1),
                                       expand=2 if scan else 0)
    _within_1lsb(oracle[True][:GOP] + got, oracle[True])
    assert _per_gop(oracle[True][:GOP] + got,
                    oracle[True][:GOP] + cpu)[1] == (0, 0)
