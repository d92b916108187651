"""The GOP program (jsvx_torch.pipeline.program) and ``transcode`` on it.

* the key, the process cache's LRU bound and its exclusive checkout, with
  fake programs;
* the kernels' counter registry, which a program's replays add to;
* the order of a 3-GOP ``transcode`` on the CPU, its real route (the
  programs, the copier, the loop) with events that log: each GOP's copy
  into a program's static wire waits for the "consumed" event of that
  program's previous GOP, and delivery runs one GOP behind;
* the body a program captures, run eagerly on the CPU from its static
  wire, against jsvx's ``decode_gop_scan_wire`` / ``decode_gop_scan``
  (``impl="xla"``, jsvx's plain reference) on the same wire: compact and
  dense, 3 and 4 planes, both ``impl``s, the quirk; <= 1 LSB on at most
  0.1 % of the pixels (an IDCT rounding tie flipped by jsvx's summation
  order, copied into the P frames that predict from it), and the two
  ``impl``s bit-equal;
* on a card (``cuda``-marked): replay == eager == CPU, captures and
  replays counted, two threads at once, on a small stream and on the
  streams of ``tests/torch_card.py``; the planes a sink keeps are still
  right after the run:
  ``python -m pytest tests/test_torch_gop_program.py -m cuda --noconftest``.
"""

import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

try:                                     # the card's machine has no JAX
    import jax.numpy as jnp

    from jsvx.kernels.decode import make_constants as j_make_constants
    from jsvx.pipeline import wire as jwire
    from jsvx.pipeline.gop import decode_gop_scan, decode_gop_scan_wire
    from jsvx.pipeline.gop import zero_refs as j_zero_refs
except ImportError:
    jnp = None

import jsvx_torch.pipeline.transcode as ttr
from jsvx_torch.kernels import color, counters, expand, fused, mc, recon
from jsvx_torch.kernels.decode import make_constants
from jsvx_torch.pipeline import packed_parse as tpp
from jsvx_torch.pipeline import program
from jsvx_torch.pipeline.program import (GopProgram, ProgramCache,
                                         ProgramSet, program_key)
from jsvx_torch.pipeline.stream import StreamDecoder
from jsvx_torch.pipeline.wire import flatten_wire, wire_spec
from jsvx_torch.runtime.profiler import Metrics
from jsvx_torch.tools import EncoderConfig, JsvEncoder
from jsvx_torch.tools.fixture import zoom_clip

import torch_card

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(jnp is None, reason="needs jax")


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
    clip = (_yuva_clip(8, 48, 64) if request.param == "yuva"
            else zoom_clip(48, 64, 8, seed=3))
    return _encode(clip, gop_size=4, quantizer_scale=5, me_range=4,
                   half_pel_refine=True)


@pytest.fixture(scope="module")
def three_gops():
    return _encode(zoom_clip(48, 64, 9, seed=21), gop_size=3,
                   quantizer_scale=4, me_range=4)


# ---------------------------------------------------------------------------
# The key and the cache


def _key(**kw):
    data = _encode(zoom_clip(32, 32, 2, seed=1), gop_size=2,
                   quantizer_scale=4)
    meta, seq, groups = tpp.walk_stream(data)
    g = tpp.parse_gop_compact(np.frombuffer(data, np.uint8), groups[0], seq,
                              meta, tpp.BufferPool(), {})
    args = dict(spec=wire_spec(g.stacked), mb_h=seq.mb_height,
                mb_w=seq.mb_width, n_comps=meta.n_components, impl="fused",
                quirk=False, consts=make_constants(seq, "cpu"),
                device="cpu")
    args.update(kw)
    return program_key(**args)


def _other_consts(**kw):
    return dataclasses.replace(make_constants(None, "cpu"), **kw)


@pytest.mark.parametrize("field,value", [
    ("mb_h", 3), ("mb_w", 3), ("n_comps", 4), ("impl", "two_kernel"),
    ("quirk", True), ("device", "meta")])
def test_key_changes_with_each_static_argument(field, value):
    assert _key() == _key()
    assert hash(_key()) == hash(_key())
    assert _key(**{field: value}) != _key()


def test_key_holds_the_layout_and_the_quant_matrices():
    base = _key()
    spec, total = base.spec
    assert _key(spec=(spec, total + 128)) != base
    assert _key(spec=(spec[:-1], total)) != base
    assert _key(consts=_other_consts(intra_q_key=(9,) * 64)) != base
    assert _key(consts=_other_consts(non_intra_q_key=(17,) * 64)) != base
    assert base.quant == tuple(make_constants(None, "cpu").intra_q_key
                               + make_constants(None, "cpu").non_intra_q_key)


class _Fake:
    """A program as the cache sees one."""

    def __init__(self, key, name):
        self.key, self.name = key, name
        self.key_id = hash(key) & 0xffffffff
        self.loaded = False
        self.closed = False
        self.held_bytes = 10

    def close(self):
        self.closed = True


def test_cache_checkout_is_exclusive():
    cache = ProgramCache(capacity=4)
    made = []

    def build(key):
        return lambda: made.append(_Fake(key, len(made))) or made[-1]

    a = cache.checkout("k", build("k"))
    b = cache.checkout("k", build("k"))
    assert a is not b and len(made) == 2          # busy: a second instance
    cache.checkin(a)
    c = cache.checkout("k", build("k"))
    assert c is a and len(made) == 2              # idle: reused
    cache.checkin(b)
    cache.checkin(c)
    assert len(cache.programs()) == 2 and cache.held_bytes() == 20
    # one call holds one program per key however often it asks
    calls = [ProgramSet(cache), ProgramSet(cache)]
    got = [s.get("k", build("k")) for s in calls]
    assert got[0] is not got[1]
    assert calls[0].get("k", build("k")) is got[0]
    for s in calls:
        s.close()
    assert len(cache.programs()) == 2 and not any(p.closed for p in made)


def test_cache_bound_closes_least_recently_used_idle():
    cache = ProgramCache(capacity=2)
    progs = {}

    def use(key):
        p = cache.checkout(key, lambda: progs.setdefault(
            key, []).append(_Fake(key, key)) or progs[key][-1])
        cache.checkin(p)
        return p

    a, b = use("a"), use("b")
    assert use("a") is a                           # "a" is now the newest
    c = use("c")                                   # evicts "b"
    assert b.closed and not a.closed and not c.closed
    assert {p.key for p in cache.programs()} == {"a", "c"}
    held = cache.checkout("a", lambda: _Fake("a", "a2"))
    assert held is a
    d = use("d")                                   # "a" is checked out
    assert c.closed and not a.closed and not d.closed
    cache.checkin(held)
    assert {p.key for p in cache.programs()} == {"a", "d"}
    cache.clear()
    assert cache.programs() == [] and a.closed and d.closed


def test_a_program_left_loaded_is_closed_not_reused():
    cache = ProgramCache(capacity=4)
    p = cache.checkout("k", lambda: _Fake("k", 0))
    p.loaded = True                                # its call failed
    cache.checkin(p)
    assert p.closed and cache.programs() == []


def test_program_loads_once_and_runs_its_body_on_the_cpu(stream):
    meta, seq, groups = tpp.walk_stream(stream)
    g = tpp.parse_gop_compact(np.frombuffer(stream, np.uint8), groups[0],
                              seq, meta, tpp.BufferPool(), {})
    consts = make_constants(seq, "cpu")
    spec = wire_spec(g.stacked)
    key = program_key(spec, seq.mb_height, seq.mb_width, meta.n_components,
                      "fused", False, consts, "cpu")
    prog = GopProgram(key, consts)
    assert prog.wire.shape == (key.spec[1],) and prog.held_bytes == \
        key.spec[1]
    wire, after = prog.load()
    assert wire is prog.wire and after is None
    with pytest.raises(RuntimeError, match="not yet decoded"):
        prog.load()
    flatten_wire(g.stacked, spec, out=wire.numpy())
    outs = []
    for _ in range(2):           # the CPU runs the body every time
        got, done = prog.run(None, Metrics())
        assert done is None and prog.graph is None and not prog.loaded
        outs.append(got)
        prog.load()
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(*outs))
    for a, b in zip(outs[0], prog.body()):
        assert torch.equal(a, b)


def test_transcode_on_the_cpu_captures_nothing(three_gops, monkeypatch):
    """The CPU decodes every GOP through its program's eager body: no
    capture, no replay, and the planes of the per-picture decode."""
    cache = ProgramCache()
    monkeypatch.setattr(ttr, "CACHE", cache)
    kept = {}
    res = ttr.transcode(three_gops, kept.__setitem__, device="cpu")
    assert not any(k.startswith("gop_program") for k in
                   list(res.metrics.counters) + list(res.metrics.gauges))
    progs = cache.programs()
    assert progs and all(p.graph is None and not p.loaded for p in progs)
    got = [tuple(s[i].numpy() for s in kept[g]) for g in sorted(kept)
           for i in range(kept[g][0].shape[0])]
    want = [tuple(p.numpy() for p in f) for f in
            StreamDecoder(three_gops, device="cpu").decode().frames]
    assert len(got) == len(want) == 9
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            assert np.array_equal(a, b)


def test_counter_registry_holds_every_wrapper_counter():
    names = {"fused": (fused, "launches"), "mc": (mc, "launches"),
             "recon": (recon, "launches"),
             "expansions": (recon, "expansions"),
             "expand": (expand, "launches"),
             "expand_plain": (expand, "plain_calls"),
             "color": (color, "launches"),
             "color_plain": (color, "plain_calls")}
    saved = counters.snapshot()
    try:
        assert set(saved) == set(names)
        counters.reset()
        assert set(counters.snapshot().values()) == {0}
        counters.add({"mc": 3, "expand_plain": 2})
        assert mc.launches == 3 and expand.plain_calls == 2
        for n, (mod, attr) in names.items():
            setattr(mod, attr, getattr(mod, attr) + 1)
            assert counters.snapshot()[n] == getattr(mod, attr)
    finally:
        for n, (mod, attr) in names.items():
            setattr(mod, attr, saved[n])


# ---------------------------------------------------------------------------
# The order of a transcode on the programs


def _logged_program_run(monkeypatch, data, quirk):
    """``transcode`` of ``data`` on the CPU, on its real route, with
    events that log: each copy's event and each program run's "consumed"
    event, which the host's waits and the next copy into that program's
    wire name.  Returns (the log, the cache, the planes the sink got)."""
    log = []

    class Event:
        def __init__(self, label):
            self.label = label

        def synchronize(self):
            log.append(f"wait {self.label}")

    real_copy, real_run = ttr.WireCopier.copy, GopProgram.run
    names: dict = {}

    def copy(self, host, out, after):
        log.append(f"copy after {after.label if after else None}")
        real_copy(self, host, out, None)
        return out, Event("copied")

    def run(self, copied, metrics):
        name = names.setdefault(id(self), f"P{len(names)}")
        n = sum(e.startswith(f"run {name} ") for e in log)
        log.append(f"run {name} after {copied.label}")
        outs, done = real_run(self, None, metrics)
        assert done is None
        self.consumed = Event(f"consumed {name}.{n}")
        return outs, self.consumed

    cache = ProgramCache()
    monkeypatch.setattr(ttr.WireCopier, "copy", copy)
    monkeypatch.setattr(GopProgram, "run", run)
    monkeypatch.setattr(ttr, "CACHE", cache)
    kept = {}

    def sink(gi, outs):
        log.append(f"sink {gi}")
        kept[gi] = outs

    ttr.transcode(data, sink, device="cpu", quirk_oddify_zeros=quirk)
    return log, cache, kept


@pytest.mark.parametrize("quirk", [False, True], ids=["compact", "quirk"])
def test_transcode_order_on_programs(three_gops, monkeypatch, quirk):
    log, cache, kept = _logged_program_run(monkeypatch, three_gops, quirk)
    # a copy into a program waits for the event after that program's last
    # run (the first copy of each program waits for nothing)
    last = {}
    done = []                    # the "consumed" event of GOP g's run
    pending = None
    for entry in log:
        if entry.startswith("copy"):
            pending = entry
        elif entry.startswith("run"):
            name = entry.split()[1]
            assert pending == f"copy after {last.get(name)}", log
            n = sum(d.startswith(f"consumed {name}.") for d in done)
            last[name] = f"consumed {name}.{n}"
            done.append(last[name])
            pending = None
    assert len(done) == 3
    kinds = [e.split()[0] + (" copied" if e == "wait copied" else "")
             for e in log]
    if quirk:      # GOP g is waited for and delivered before g+1 runs
        want = ["copy", "run", "copy", "wait", "sink",
                "run", "copy", "wait", "sink", "run", "wait", "sink"]
    else:          # GOP g-1 is delivered after GOP g's dispatch
        want = ["copy", "wait copied", "run", "copy", "wait copied", "run",
                "copy", "wait", "sink", "wait copied", "run", "wait",
                "sink", "wait", "sink"]
    assert kinds == want, log
    # each GOP is delivered right after the host waited for its own run
    sinks = [i for i, e in enumerate(log) if e.startswith("sink")]
    assert [log[i] for i in sinks] == ["sink 0", "sink 1", "sink 2"]
    assert [log[i - 1] for i in sinks] == [f"wait {d}" for d in done]
    # every program went back to the cache, none left loaded
    assert cache.programs() and not any(p.loaded for p in cache.programs())
    # and the planes are the per-picture decode's (whose programs run
    # unpatched)
    monkeypatch.undo()
    got = [tuple(s[i].numpy() for s in kept[g]) for g in sorted(kept)
           for i in range(kept[g][0].shape[0])]
    want = [tuple(p.numpy() for p in f) for f in StreamDecoder(
        three_gops, quirk, device="cpu").decode().frames]
    assert len(got) == len(want) == 9
    for fg, fw in zip(got, want):
        for x, y in zip(fg, fw):
            assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# The captured body against jsvx


def _gops(data, dense):
    """(port stacked, wire bytes, spec) per GOP: the compact parse with
    sticky buckets as ``transcode``'s, or the dense parse."""
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = tpp.walk_stream(data)
    buckets: dict = {}
    out = []
    for gi, grp in enumerate(groups):
        if dense:
            g = tpp.parse_gop_packed(arr, grp, seq, meta)
        else:
            g = tpp.parse_gop_compact(arr, grp, seq, meta, tpp.BufferPool(),
                                      buckets)
            assert not g.dirty
        spec = wire_spec(g.stacked)
        out.append((g.stacked, flatten_wire(
            g.stacked, spec, out=np.zeros(spec[1], np.uint8)), spec))
    return meta, seq, out


def _close(got, want):
    n_diff = n_pix = 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.uint8
        diff = np.abs(g.numpy().astype(int) - w.astype(int))
        assert diff.max() <= 1
        n_diff += int((diff > 0).sum())
        n_pix += diff.size
    assert n_diff <= 1e-3 * n_pix
    return n_diff


@needs_jax
@pytest.mark.parametrize("wire", ["compact", "dense", "dense-quirk"])
def test_body_matches_jsvx(stream, wire):
    """Each GOP of the stream loaded into a program's static wire and its
    body run on the CPU, against jsvx's compiled GOP program on the same
    wire; the same program (one per key) decodes every GOP of its key."""
    dense, quirk = wire != "compact", wire == "dense-quirk"
    meta, seq, gops = _gops(stream, dense)
    consts = make_constants(seq, "cpu")
    jconsts = j_make_constants(seq)
    programs = {}
    for stacked, buf, spec in gops:
        refs = j_zero_refs(seq.coded_height, seq.coded_width,
                           n_comps=meta.n_components)
        if dense:
            want, _ = decode_gop_scan(
                jax_tree(stacked), refs, jconsts, quirk, mc_impl="gather",
                impl="xla")
        else:
            assert jwire.wire_spec(stacked) == spec
            want, _ = decode_gop_scan_wire(
                jnp.asarray(buf), spec, refs, jconsts, seq.mb_height,
                seq.mb_width, mc_impl="gather", impl="xla")
        outs = {}
        for impl in ("fused", "two_kernel"):
            key = program_key(spec, seq.mb_height, seq.mb_width,
                              meta.n_components, impl, quirk, consts, "cpu")
            prog = programs.setdefault(key, GopProgram(key, consts))
            prog.wire.copy_(torch.from_numpy(buf))
            outs[impl] = prog.body()
            assert len(outs[impl]) == meta.n_components
            _close(outs[impl], want)
        for a, b in zip(outs["fused"], outs["two_kernel"]):
            assert torch.equal(a, b)
    assert len(programs) >= 2


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The card


def _outcome(data, device, impl, quirk, metrics=None):
    """``transcode`` of ``data``, planes read after the run: (GOPs
    delivered, frames as numpy, the error's name or None)."""
    kept, err = {}, None
    try:
        ttr.transcode(data, lambda gi, outs: kept.__setitem__(gi, outs),
                      device=device, impl=impl, quirk_oddify_zeros=quirk,
                      metrics=metrics or Metrics())
    except ValueError as e:
        err = type(e).__name__
    frames = [tuple(s[i].cpu().numpy() for s in kept[g])
              for g in sorted(kept) for i in range(kept[g][0].shape[0])]
    return sorted(kept), frames, err


def _same(a, b):
    assert (a[0], a[2]) == (b[0], b[2])
    torch_card.assert_frames_equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("label,quirk", [
    ("three_gops", False), ("three_gops", True), ("1080p", False),
    ("1080p", True), ("1080p-8-gops", False), ("1080p-varied", False),
    ("1080p-damaged", False), ("48x64-dirty", False), ("yuva-128x96", False),
    ("cif-352x288", False), ("320x320-256mv", False)])
def test_replay_equals_eager_and_cpu_on_the_card(three_gops, monkeypatch,
                                                 label, quirk):
    """``transcode`` on both routes from a cold program cache (each key
    captured at first sight), again (replays), on the eager loop and in
    two threads at once: the CPU's outcome and planes, read after the run;
    captures = the distinct keys asked for, replays = the GOPs dispatched
    less the captures, the kernels' launch counts of the three runs
    equal.  The damaged copies are ``torch_card.damaged`` of the
    fixture."""
    dev = torch_card.card()
    if label == "three_gops":
        streams = [three_gops]
    elif label == "1080p-damaged":
        streams = torch_card.damaged(torch_card.stream("1080p"))
    else:
        streams = [torch_card.stream(label)]
    keys = torch_card.recording_keys(monkeypatch)
    for data, impl in itertools.product(streams, ("fused", "two_kernel")):
        want = _outcome(data, "cpu", impl, quirk)
        program.CACHE.clear()
        runs = []
        for name in ("first", "again", "eager"):
            m = Metrics()
            with monkeypatch.context() as mp:
                if name == "eager":
                    mp.setattr(GopProgram, "run", torch_card.eager_run)
                keys.clear()
                out, n = torch_card.counted(
                    lambda: _outcome(data, dev, impl, quirk, m))
            _same(out, want)
            runs.append((m.counters, m.timers.counts.get(
                "device_dispatch", 0), len(set(keys)), n))
        (c1, g1, k1, n1), (c2, g2, _, n2), (_, _, _, n3) = runs
        recaptures = max(0, k1 - program.CACHE.capacity)
        assert c1.get("gop_program.captures", 0) == k1, (impl, k1)
        assert c1.get("gop_program.replays", 0) == g1 - k1
        assert c2.get("gop_program.captures", 0) == recaptures
        assert c2.get("gop_program.replays", 0) == g2 - recaptures
        assert n1 == n2 == n3 and (sum(n1.values()) > 0) == (g1 > 0)
        program.CACHE.clear()
        with ThreadPoolExecutor(2) as pool:
            both = list(pool.map(lambda _: _outcome(data, dev, impl, quirk),
                                 range(2)))
        for out in both:
            _same(out, want)
