"""The GOP programs on the other GOP paths: ``decode_group`` (behind
``StreamDecoder``, the Decoder's GOP batch and its picture-at-a-time
decode) and ``decode_gops_parallel``.

* the key: ``refs_in`` and ``gops`` change it, ``transcode``'s keys stay
  as they were, and every picture of a stream has one one-picture key;
* ``StreamDecoder`` and the Decoder through their programs on the CPU
  (the programs' real route: static wire, reference slots, keys, cache),
  against jsvx's ``StreamDecoder.decode(impl="xla")`` and jsvx's
  ``Decoder(backend="jax")`` (its plain route) on the same bytes: <= 1
  LSB on at most 0.1 % of the pixels (an IDCT rounding tie flipped by
  jsvx's summation order, ROADMAP C); bit-equal to the port's eager loop
  (the code these paths ran before the programs, kept here as the
  reference) and the two ``impl``s bit-equal;
* the reference planes are inputs: one program decodes consecutive P
  pictures from the planes it is given;
* the order: each copy into a program's static wire and reference slots
  waits for that program's previous "consumed" event (events faked to
  log, as in ``tests/test_torch_gop_program.py``);
* a program that raises propagates, leaves no program checked out and no
  eager decode runs in its place;
* ``decode_gops_parallel`` through its program against the eager per-GOP
  loop and jsvx's ``decode_gops_parallel`` on a CPU mesh;
* on a card (``cuda``-marked): replay == eager == CPU, captures and
  replays counted, on a small stream and the streams of
  ``tests/torch_card.py``, the Player with RGB among the paths:
  ``python -m pytest tests/test_torch_group_program.py -m cuda
  --noconftest``.
"""

import numpy as np
import pytest
import torch

try:                                     # the card's machine has no JAX
    import jax

    from jsvx.api import Decoder as JDecoder
    from jsvx.api import PlayerConfig as JConfig
    from jsvx.kernels.decode import frame_to_device as j_frame_to_device
    from jsvx.kernels.decode import make_constants as j_make_constants
    from jsvx.pipeline.gop import stack_device_frames as j_stack
    from jsvx.pipeline.stream import JaxStreamDecoder
    from jsvx.shard import build_mesh as j_build_mesh
    from jsvx.shard import decode_gops_parallel as j_gops_parallel
except ImportError:
    jax = None

import jsvx_torch.pipeline.gop as gop_mod
import jsvx_torch.pipeline.stream as stream_mod
import jsvx_torch.pipeline.transcode as ttr
import jsvx_torch.shard.gop_parallel as gp_mod
from jsvx_torch.api import Decoder, PlayerConfig
from jsvx_torch.kernels.decode import frame_to_device, make_constants
from jsvx_torch.pipeline import program
from jsvx_torch.pipeline.gop import (decode_gop, frame_at, frame_decoder,
                                     stack_device_frames, zero_refs)
from jsvx_torch.pipeline.packed_parse import BufferPool, walk_stream
from jsvx_torch.pipeline.program import (GopProgram, ProgramCache,
                                         ProgramSet, program_key)
from jsvx_torch.pipeline.stream import StreamDecoder, decode_group
from jsvx_torch.pipeline.transcode import pack
from jsvx_torch.pipeline.wire import unflatten_wire
from jsvx_torch.runtime.profiler import Metrics
from jsvx_torch.shard import build_mesh, decode_gops_parallel
from jsvx_torch.shard.slice_rows import cut_band, gop_at, stack_gops
from jsvx_torch.tools import EncoderConfig, JsvEncoder
from jsvx_torch.tools.fixture import zoom_clip

import torch_card

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(jax is None, reason="needs jax")
IMPLS = ("fused", "two_kernel")


def _yuva_clip(n, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return [(y, cb, cr, np.clip(128 + 80 * np.sin(2 * np.pi * (xx + 5 * t)
                                                  / w) + 40 * (yy > 4 * t),
                                0, 255).astype(np.uint8))
            for t, (y, cb, cr) in enumerate(zoom_clip(h, w, n, seed=5))]


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**kw)).encode(clip)


@pytest.fixture(scope="module", params=["yuv", "yuva"])
def stream(request):
    clip = (_yuva_clip(10, 48, 64) if request.param == "yuva"
            else zoom_clip(48, 64, 10, seed=3))
    return _encode(clip, gop_size=4, quantizer_scale=5, me_range=4,
                   half_pel_refine=True)


@pytest.fixture(scope="module")
def yuv():
    return _encode(zoom_clip(48, 64, 10, seed=3), gop_size=4,
                   quantizer_scale=5, me_range=4, half_pel_refine=True)


@pytest.fixture
def cache(monkeypatch):
    """A fresh program cache for the paths under test."""
    c = ProgramCache()
    for mod in (stream_mod, gp_mod, ttr):
        monkeypatch.setattr(mod, "CACHE", c)
    return c


@pytest.fixture
def asked(monkeypatch):
    """Every key a ``ProgramSet`` is asked for."""
    keys = []
    real = ProgramSet.get

    def get(self, key, build):
        keys.append(key)
        return real(self, key, build)

    monkeypatch.setattr(ProgramSet, "get", get)
    return keys


def _np(frames):
    return [tuple(np.asarray(p) for p in f) for f in frames]


def _port_stream(data, scan=True, impl="fused", quirk=False):
    res = StreamDecoder(data, quirk, device="cpu").decode(
        use_gop_scan=scan, impl=impl)
    return _np(res.frames)


def _eager_group(fts, refs, consts, scan, impl, quirk):
    """``decode_group`` as it ran before the programs: one wire for the
    group, then the GOP loop or the per-frame decode on it."""
    spec, buf = pack(stack_device_frames([frame_to_device(ft) for ft in fts]),
                     BufferPool())
    stacked = unflatten_wire(torch.from_numpy(buf).clone(), spec)
    if scan:
        outs, refs = decode_gop(stacked, refs, consts, quirk, impl)
        return [tuple(p[i] for p in outs) for i in range(len(fts))], refs
    frames = []
    for i in range(len(fts)):
        refs = frame_decoder(impl)(frame_at(stacked, i), refs, consts, quirk)
        frames.append(refs)
    return frames, refs


def _split(fts, scan):
    if not scan:
        return [[ft] for ft in fts]
    groups = []
    for ft in fts:
        if ft.is_intra_picture or not groups:
            groups.append([])
        groups[-1].append(ft)
    return groups


def _eager_stream(data, scan=True, impl="fused", quirk=False):
    d = StreamDecoder(data, quirk, device="cpu")
    fts = d.parse_all()
    seq = d.parser.seq
    consts = make_constants(seq, "cpu")
    refs = zero_refs(seq.coded_height, seq.coded_width, d.meta.n_components,
                     "cpu")
    frames = []
    for group in _split(fts, scan):
        outs, refs = _eager_group(group, refs, consts, scan, impl, quirk)
        frames.extend(outs)
    return _np(frames)


def _port_decoder(data, scan, quirk=False):
    d = Decoder(PlayerConfig(use_gop_scan=scan, quirk_oddify_zeros=quirk),
                device="cpu")
    d.feed(0, data, total=len(data))
    frames = list(d.iter_frames())
    assert d.ended
    return frames


def _close(port, ref):
    assert len(port) == len(ref) > 0
    n_diff = n_pix = 0
    for fp, fr in zip(port, ref):
        assert len(fp) == len(fr)
        for p, r in zip(fp, fr):
            r = np.asarray(r)
            assert p.dtype == np.uint8 and p.shape == r.shape
            diff = np.abs(p.astype(int) - r.astype(int))
            assert diff.max() <= 1
            n_diff += int((diff > 0).sum())
            n_pix += diff.size
    assert n_diff <= 1e-3 * n_pix, (n_diff, n_pix)


def _equal(a, b):
    assert len(a) == len(b) > 0
    for fa, fb in zip(a, b):
        assert len(fa) == len(fb)
        for pa, pb in zip(fa, fb):
            assert np.array_equal(np.asarray(pa), np.asarray(pb))


# ---------------------------------------------------------------------------
# The keys


def test_refs_in_changes_the_key_and_transcode_keys_stay(yuv, cache, asked):
    ttr.transcode(yuv, device="cpu", quirk_oddify_zeros=True)
    dense = list(asked)
    asked.clear()
    StreamDecoder(yuv, True, device="cpu").decode()
    grouped = list(asked)
    assert dense and grouped
    for t, g in zip(dense, grouped):
        # the same dense layout: the keys differ in refs_in only
        assert not t.refs_in and t.gops == 0 and g.refs_in
        assert t != g and t == g._replace(refs_in=False)
        assert t == program_key(t.spec, t.mb_h, t.mb_w, t.n_comps, t.impl,
                                t.quirk, make_constants(None, "cpu"), "cpu")
    assert tuple(dense[0]._fields[:8]) == (
        "spec", "mb_h", "mb_w", "n_comps", "impl", "quirk", "quant",
        "device")
    base = dense[0]
    consts = make_constants(None, "cpu")
    args = (base.spec, base.mb_h, base.mb_w, base.n_comps, base.impl,
            base.quirk, consts, "cpu")
    assert program_key(*args, gops=2) != program_key(*args)
    assert program_key(*args, gops=2) != program_key(*args, gops=1)


@pytest.mark.parametrize("path", ["stream_decoder", "decoder"])
def test_one_picture_key_recurs(stream, cache, asked, path):
    if path == "stream_decoder":
        n = len(StreamDecoder(stream, device="cpu").decode(
            use_gop_scan=False).frames)
    else:
        n = len(_port_decoder(stream, scan=False))
    assert len(asked) == n == 10
    assert len(set(asked)) == 1 and asked[0].refs_in
    progs = cache.programs()
    assert len(progs) == 1 and progs[0].slots is not None
    assert not cache._busy


# ---------------------------------------------------------------------------
# StreamDecoder and the Decoder through their programs


@needs_jax
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "picture"])
@pytest.mark.parametrize("impl", IMPLS)
def test_stream_decoder_on_programs(stream, cache, asked, scan, impl):
    got = _port_stream(stream, scan, impl)
    assert len(asked) == (3 if scan else 10) and all(k.refs_in
                                                     for k in asked)
    ref = JaxStreamDecoder(stream).decode(use_gop_scan=scan, impl="xla")
    _close(got, _np(ref.frames))
    _equal(got, _eager_stream(stream, scan, impl))
    _equal(got, _port_stream(stream, scan, IMPLS[impl == "fused"]))


@needs_jax
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "picture"])
def test_stream_decoder_quirk_on_programs(yuv, cache, asked, scan):
    got = {impl: _port_stream(yuv, scan, impl, quirk=True) for impl in IMPLS}
    assert all(k.quirk for k in asked)
    ref = JaxStreamDecoder(yuv, True).decode(use_gop_scan=scan, impl="xla")
    _close(got["fused"], _np(ref.frames))
    _equal(got["fused"], got["two_kernel"])
    _equal(got["fused"], _eager_stream(yuv, scan, "fused", quirk=True))
    plain = _port_stream(yuv, scan)
    assert any(not np.array_equal(a, b) for fa, fb in zip(got["fused"],
                                                         plain)
               for a, b in zip(fa, fb))


def test_decode_group_of_pictures_one_at_a_time(yuv, cache, asked):
    """``use_gop_scan=False`` on a whole group: one one-picture program
    run per picture, each from the planes before it."""
    d = StreamDecoder(yuv, device="cpu")
    fts = d.parse_all()[:4]
    seq = d.parser.seq
    consts = make_constants(seq, "cpu")
    refs = zero_refs(seq.coded_height, seq.coded_width, 3, "cpu")
    m = Metrics()
    frames, last = decode_group(fts, refs, consts, torch.device("cpu"),
                                use_gop_scan=False, metrics=m)
    want, want_last = _eager_group(fts, refs, consts, False, "fused", False)
    _equal(_np(frames), _np(want))
    _equal(_np([last]), _np([want_last]))
    assert len(asked) == 4 and len(set(asked)) == 1
    assert m.counters["frames"] == 4
    assert m.to_dict()["stages"]["device_decode"]["count"] == 4
    assert not cache._busy and not any(p.loaded for p in cache.programs())


@needs_jax
@pytest.mark.parametrize("scan", [True, False], ids=["gop_batch", "picture"])
def test_decoder_on_programs(stream, cache, asked, scan):
    port = _port_decoder(stream, scan)
    assert asked and all(k.refs_in for k in asked)
    assert not cache._busy          # checked back in after every group
    jd = JDecoder(JConfig(use_gop_scan=scan), backend="jax")
    jd.feed(0, stream, total=len(stream))
    ref = list(jd.iter_frames())
    assert [f.picture_type for f in port] == [f.picture_type for f in ref]
    got = _np(f.planes for f in port)
    _close(got, _np(f.planes for f in ref))
    _equal(got, _eager_stream(stream, scan))


# ---------------------------------------------------------------------------
# The reference planes are inputs


def test_one_program_decodes_from_the_refs_it_is_given(yuv):
    d = StreamDecoder(yuv, device="cpu")
    fts = d.parse_all()[:4]
    assert [ft.is_intra_picture for ft in fts] == [True] + [False] * 3
    seq = d.parser.seq
    consts = make_constants(seq, "cpu")
    decode = frame_decoder("fused")
    prog = None

    def run(buf, refs):
        prog.fill(torch.from_numpy(buf), refs)
        return tuple(o[0] for o in prog.run(None, Metrics())[0])

    refs = zero_refs(seq.coded_height, seq.coded_width, 3, "cpu")
    for ft in fts:
        spec, buf = pack(stack_device_frames([frame_to_device(ft)]),
                         BufferPool())
        key = program_key(spec, seq.mb_height, seq.mb_width, 3, "fused",
                          False, consts, "cpu", refs_in=True)
        prog = prog or GopProgram(key, consts)
        assert prog.key == key                 # one program, every picture
        frame = frame_at(unflatten_wire(torch.from_numpy(buf), spec), 0)
        got, want = run(buf, refs), decode(frame, refs, consts)
        _equal(_np([got]), _np([want]))
        prev, refs = refs, got
    # the last P picture from other planes: another result, the eager one
    rng = np.random.default_rng(11)
    other = tuple(torch.from_numpy(rng.integers(0, 256, r.shape,
                                                dtype=np.uint8))
                  for r in prev)
    moved = run(buf, other)
    assert any(not torch.equal(a, b) for a, b in zip(moved, refs))
    _equal(_np([moved]), _np([decode(frame, other, consts)]))
    _equal(_np([run(buf, prev)]), _np([refs]))
    with pytest.raises(ValueError, match="static buffer"):
        prog.fill(torch.from_numpy(buf), tuple(r[:16] for r in prev))
    prog.loaded = False
    with pytest.raises(ValueError, match="reference planes for"):
        prog.fill(torch.from_numpy(buf), prev[:2])


# ---------------------------------------------------------------------------
# The order of the copies


class _Event:
    def __init__(self, label):
        self.label = label


def _logged(monkeypatch):
    """Copies into programs and program runs logged, each run's
    "consumed" event a labelled fake; returns the log."""
    log = []
    real_copy, real_run = program.copy_in, GopProgram.run
    names: dict = {}

    def copy_in(pairs, after):
        log.append(("copy", frozenset(id(d) for d, _ in pairs),
                    after.label if after else None))
        real_copy(pairs, None)

    def run(self, copied, metrics):
        name = names.setdefault(id(self), f"P{len(names)}")
        n = sum(e[0] == "run" and e[1] == name for e in log)
        log.append(("run", name, frozenset(
            id(t) for t in (self.wire,) + tuple(self.slots or ())),
            f"consumed {name}.{n}"))
        outs, done = real_run(self, copied, metrics)
        assert done is None
        self.consumed = _Event(f"consumed {name}.{n}")
        return outs, self.consumed

    monkeypatch.setattr(program, "copy_in", copy_in)
    monkeypatch.setattr(GopProgram, "run", run)
    return log


def _check_order(log, n_runs):
    """Each run follows one copy into exactly that program's wire and
    slots, made after that program's previous run's event."""
    last: dict = {}
    runs = 0
    for prev, entry in zip(log, log[1:]):
        if entry[0] != "run":
            continue
        _, name, targets, consumed = entry
        assert prev[0] == "copy" and prev[1] == targets, log
        assert prev[2] == last.get(name), log
        last[name] = consumed
        runs += 1
    assert runs == n_runs and sum(e[0] == "copy" for e in log) == n_runs


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "picture"])
def test_copies_wait_for_the_program_consumed(yuv, cache, monkeypatch,
                                              scan):
    """``StreamDecoder``, then the Decoder on the programs it left: the
    Decoder's first copy into a kept program waits for the event of the
    stream decoder's last run of it."""
    log = _logged(monkeypatch)
    got = _np(StreamDecoder(yuv, device="cpu").decode(
        use_gop_scan=scan).frames)
    port = _port_decoder(yuv, scan)
    _check_order(log, 2 * (3 if scan else 10))
    assert sum(e[0] == "run" for e in log) == len({e[1] for e in log
                                                   if e[0] == "run"}) + \
        sum(e[0] == "copy" and e[2] is not None for e in log)
    _equal(_np(f.planes for f in port), got)
    monkeypatch.undo()
    _equal(got, _eager_stream(yuv, scan))


# ---------------------------------------------------------------------------
# Failure


def test_a_failing_program_raises_and_nothing_replaces_it(yuv, cache,
                                                          monkeypatch):
    calls = []
    for impl, fn in list(gop_mod.FRAME_DECODERS.items()):
        monkeypatch.setitem(gop_mod.FRAME_DECODERS, impl,
                            lambda *a, _fn=fn, **k: calls.append(1)
                            or _fn(*a, **k))

    def run(self, copied, metrics):
        raise RuntimeError("replay failed")

    monkeypatch.setattr(GopProgram, "run", run)
    for scan in (True, False):
        with pytest.raises(RuntimeError, match="replay failed"):
            StreamDecoder(yuv, device="cpu").decode(use_gop_scan=scan)
        d = Decoder(PlayerConfig(use_gop_scan=scan), device="cpu")
        d.feed(0, yuv, total=len(yuv))
        with pytest.raises(RuntimeError, match="replay failed"):
            d.decode_frame()
        assert d._refs is not None and not any(map(torch.any, d._refs))
    tall = _batch(yuv)
    with pytest.raises(RuntimeError, match="replay failed"):
        decode_gops_parallel(tall["batch"], tall["h"], tall["w"],
                             tall["consts"], build_mesh({"gop": 1}),
                             device="cpu")
    # each program the failed calls loaded was closed on check-in
    assert cache.programs() == [] and not cache._busy
    assert calls == []


# ---------------------------------------------------------------------------
# decode_gops_parallel


def _batch(data):
    """The stream's GOPs of GOP 0's length, packed and stacked on a GOP
    axis (numpy), with what ``decode_gops_parallel`` takes besides."""
    d = StreamDecoder(data, device="cpu")
    fts = d.parse_all()
    seq = d.parser.seq
    starts = [i for i, ft in enumerate(fts) if ft.is_intra_picture]
    n = starts[1] if len(starts) > 1 else len(fts)
    gops = [fts[a:a + n] for a in starts if len(fts[a:a + n]) == n]
    port = [stack_device_frames([frame_to_device(ft) for ft in g])
            for g in gops]
    batch = {k: ({f: np.stack([g[k][f] for g in port]) for f in v}
                 if isinstance(v, dict) else np.stack([g[k] for g in port]))
             for k, v in port[0].items()}
    return dict(batch=batch, gops=gops, seq=seq, h=seq.coded_height,
                w=seq.coded_width, consts=make_constants(seq, "cpu"),
                n_comps=d.meta.n_components)


def _eager_gops_parallel(t, gops):
    """``decode_gops_parallel`` as it ran before its program."""
    return stack_gops([decode_gop(
        cut_band(gop_at(t["batch"], g), 0, 1, "cpu"),
        zero_refs(t["h"], t["w"], t["n_comps"], "cpu"), t["consts"], False,
        "fused") for g in gops])


@needs_jax
def test_gops_parallel_on_its_program(stream, cache, asked):
    t = _batch(stream)
    mesh = build_mesh({"gop": 1})
    outs, final, gops = decode_gops_parallel(t["batch"], t["h"], t["w"],
                                             t["consts"], mesh,
                                             device="cpu")
    assert list(gops) == [0, 1]
    assert len(asked) == 1 and asked[0].gops == 2 and not asked[0].refs_in
    assert asked[0].impl == "fused" and asked[0].n_comps == t["n_comps"]
    want, want_final = _eager_gops_parallel(t, gops)
    for o, f, w, wf in zip(outs, final, want, want_final, strict=True):
        assert o.shape == w.shape and torch.equal(o, w)
        assert torch.equal(f, wf)
    # jsvx: the same batch, its own packing, on a 2-device CPU mesh
    jbatch = jax.tree.map(lambda *xs: np.stack(xs), *[
        j_stack([j_frame_to_device(ft) for ft in g]) for g in t["gops"]])
    jouts, jfinal = j_gops_parallel(jbatch, t["h"], t["w"],
                                    j_make_constants(t["seq"]),
                                    j_build_mesh({"gop": 2}))
    for g in range(2):
        _close([tuple(o[g].numpy() for o in outs)],
               [tuple(np.asarray(o[g]) for o in jouts)])
        _close([tuple(f[g].numpy() for f in final)],
               [tuple(np.asarray(f[g]) for f in jfinal)])
    # the program is kept: a second call of the key, one of another G
    decode_gops_parallel(t["batch"], t["h"], t["w"], t["consts"], mesh,
                         device="cpu")
    one = {k: ({f: a[:1] for f, a in v.items()} if isinstance(v, dict)
               else v[:1]) for k, v in t["batch"].items()}
    decode_gops_parallel(one, t["h"], t["w"], t["consts"], mesh,
                         device="cpu")
    assert asked[1] == asked[0] and asked[2].gops == 1
    assert len(cache.programs()) == 2 and not cache._busy


def test_gops_parallel_takes_tensors(yuv, cache):
    t = _batch(yuv)
    tensors = {k: ({f: torch.from_numpy(a) for f, a in v.items()}
                   if isinstance(v, dict) else torch.from_numpy(v))
               for k, v in t["batch"].items()}
    mesh = build_mesh({"gop": 1})
    a = decode_gops_parallel(tensors, t["h"], t["w"], t["consts"], mesh,
                             device="cpu")
    b = decode_gops_parallel(t["batch"], t["h"], t["w"], t["consts"], mesh,
                             device="cpu")
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)
    assert len(cache.programs()) == 1


# ---------------------------------------------------------------------------
# The card


@pytest.mark.cuda
@pytest.mark.parametrize("label,quirk", [
    ("48x64", False), ("1080p", False), ("1080p", True),
    ("yuva-128x96", False), ("cif-352x288", False), ("48x64-dirty", False)])
def test_group_programs_replay_equals_eager_and_cpu_on_the_card(
        monkeypatch, label, quirk):
    """Every ``decode_group`` path (``StreamDecoder`` by GOP and by picture
    on both routes, the Decoder's GOP batch and picture path, the Player
    with RGB) and ``decode_gops_parallel`` on a mesh of one rank, on the
    card from a cold program cache, again and on the eager loop: the
    CPU's planes; captures = the distinct keys asked for, replays = the
    units less the first sights and then every unit; in each card run
    each picture through its route's kernels once (and each frame shown
    through the colour kernel once), nothing else counted."""
    dev = torch_card.card()
    data = (_encode(zoom_clip(48, 64, 10, seed=3), gop_size=4,
                    quantizer_scale=5, me_range=4, half_pel_refine=True)
            if label == "48x64" else torch_card.stream(label))
    keys = torch_card.recording_keys(monkeypatch)

    def runs(fn, kernels, n_frames=None):
        """``fn(device, metrics)`` on the CPU, then on the card, where
        each of ``kernels`` runs once a picture (``n_frames`` of them,
        the CPU's frames unless given) -> the first card run's
        counters."""
        cpu = fn("cpu", Metrics())
        program.CACHE.clear()
        card = []
        for name in ("first", "again", "eager"):
            m = Metrics()
            keys.clear()
            with monkeypatch.context() as mp:
                if name == "eager":
                    mp.setattr(GopProgram, "run", torch_card.eager_run)
                got, n = torch_card.counted(lambda: fn(dev, m))
            _equal(got, cpu)
            card.append((m.counters, len(keys), len(set(keys)), n))
        (c1, u1, k1, n1), (c2, u2, _, n2), (_, _, _, n3) = card
        assert k1 > 0 and c1.get("gop_program.captures", 0) == k1
        assert c1.get("gop_program.replays", 0) == u1 - k1
        assert c2.get("gop_program.captures", 0) == 0
        assert c2.get("gop_program.replays", 0) == u2
        n = len(cpu) if n_frames is None else n_frames
        # the Decoder's GOP batches on the compact wire expand on the card
        want = torch_card.want_counts(
            **dict.fromkeys(kernels, n),
            expand=c1.get("decoder.gop_batches.compact", 0))
        assert n1 == n2 == n3 == want, (n1, want)
        return c1

    def stream_decoder(scan, impl):
        def fn(device, m):
            res = StreamDecoder(data, quirk, device=device).decode(
                use_gop_scan=scan, impl=impl, metrics=m)
            return _np([tuple(p.cpu() for p in f) for f in res.frames])
        return fn

    def decoder(scan):
        def fn(device, m):
            d = Decoder(PlayerConfig(use_gop_scan=scan,
                                     quirk_oddify_zeros=quirk),
                        device=device)
            d.metrics = m
            d.feed(0, data, total=len(data))
            return _np([tuple(p.cpu() for p in f.planes)
                        for f in d.iter_frames()])
        return fn

    def player(device, m):
        _, rgb, planes, p = torch_card.play_rgb(data, device, quirk)
        for k, v in p.decoder.metrics.counters.items():
            m.count(k, v)
        return [f + (x,) for f, x in zip(planes, rgb, strict=True)]

    def gops_parallel(device, m):
        t = _batch(data)
        outs, final, gops = decode_gops_parallel(
            t["batch"], t["h"], t["w"], make_constants(t["seq"], device),
            build_mesh({"gop": 1}), quirk_oddify_zeros=quirk, device=device,
            metrics=m)
        return _np([tuple(o[g].cpu() for o in outs) for g in range(len(gops))]
                   + [tuple(f.cpu() for f in final)])

    for scan in (True, False):
        for impl in IMPLS:
            runs(stream_decoder(scan, impl),
                 ("fused",) if impl == "fused" else ("mc", "recon"))
        batches = runs(decoder(scan), ("fused",))
        compact = torch_card.compact_gops(data) if scan and not quirk else 0
        assert batches.get("decoder.gop_batches.compact", 0) == compact
        assert batches.get("decoder.gop_batches.dense", 0) == (
            len(walk_stream(data)[2]) - compact if scan else 0)
    runs(player, ("fused", "color"))
    runs(gops_parallel, ("fused",), sum(map(len, _batch(data)["gops"])))
    assert not any(p.loaded for p in program.CACHE.programs())
