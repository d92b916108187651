"""The port's compact-wire pipeline (jsvx_torch.pipeline) vs jsvx.

Parse, wire and expansion are integer and must be bit-equal to jsvx.  The
end-to-end decode runs the port on the CPU (its plain decode) against
jsvx ``transcode(impl="xla")``: <= 1 LSB, and at most 0.1 % of the
stream's pixels may differ (a rounding tie flipped by the IDCT's f32
summation order is copied into the P frames that predict from it; the
count is printed); and <= 1 LSB of the float64 oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jsvx.bitstream.native import get_native_parser
from jsvx.coding import tables as T
from jsvx.kernels.expand import expand_compact_gop as j_expand_gop
from jsvx.kernels.expand import expand_levels as j_expand_levels
from jsvx.pipeline import packed_parse as jpp
from jsvx.pipeline import wire as jwire
from jsvx.pipeline.transcode import transcode as j_transcode
from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.oracle import decode_stream_oracle
from jsvx_torch.kernels.expand import expand_compact_gop, expand_levels
from jsvx_torch.pipeline import packed_parse as tpp
from jsvx_torch.pipeline import wire as twire
from jsvx_torch.pipeline.stream import StreamDecoder
from jsvx_torch.pipeline.transcode import transcode

from conftest import synthetic_frames, synthetic_frames_yuva
from test_high_motion import MB, _forced_mvs

pytestmark = pytest.mark.skipif(get_native_parser() is None,
                                reason="no C++ parser")

torch.set_num_threads(1)


class _ZeroPool(tpp.BufferPool):
    """Pool whose fresh buffers are zeroed, so bucket padding is equal
    bytes in both packages' wires."""

    def acquire(self, shape, dtype):
        return np.zeros(shape, dtype)


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**kw)).encode(clip)


@pytest.fixture(scope="module", params=["yuv", "yuva"])
def stream(request):
    make = synthetic_frames_yuva if request.param == "yuva" \
        else synthetic_frames
    return _encode(make(10, 64, 96, seed=5), gop_size=5, quantizer_scale=6,
                   me_range=8, half_pel_refine=True)


def _wires(data):
    """(jsvx stacked, jsvx wire, port stacked, port wire, spec) per GOP."""
    arr = np.frombuffer(data, np.uint8)
    jm, js, jg = jpp.walk_stream(data)
    tm, ts, tg = tpp.walk_stream(data)
    assert len(jg) == len(tg) and jm.n_components == tm.n_components
    jb, tb = {}, {}
    out = []
    for gi in range(len(tg)):
        jgop = jpp.parse_gop_compact(arr, jg[gi], js, jm, _ZeroPool(), jb,
                                     0, index=gi)
        tgop = tpp.parse_gop_compact(arr, tg[gi], ts, tm, _ZeroPool(), tb)
        assert not jgop.dirty and not tgop.dirty
        jspec = jwire.wire_spec(jgop.stacked)
        tspec = twire.wire_spec(tgop.stacked)
        assert tspec == jspec
        # zeroed buffers: the alignment gaps between leaves are equal too
        out.append((jgop.stacked,
                    jwire.flatten_wire(jgop.stacked, jspec,
                                       out=np.zeros(jspec[1], np.uint8)),
                    tgop.stacked,
                    twire.flatten_wire(tgop.stacked, tspec,
                                       out=np.zeros(tspec[1], np.uint8)),
                    tspec))
    return ts, out


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_wire_bytes_identical(stream):
    _, gops = _wires(stream)
    assert len(gops) == 2
    for _, jbuf, _, tbuf, _ in gops:
        assert jbuf.dtype == tbuf.dtype == np.uint8
        assert np.array_equal(jbuf, tbuf)


def test_unflatten_wire_leaves_equal(stream):
    for _, jbuf, _, tbuf, spec in _wires(stream)[1]:
        want = dict(_leaves(jwire.unflatten_wire(jnp.asarray(jbuf), spec)))
        got = dict(_leaves(twire.unflatten_wire(torch.from_numpy(tbuf),
                                                spec)))
        assert want.keys() == got.keys()
        for path, g in got.items():
            w = np.asarray(want[path])
            assert g.shape == w.shape, path
            assert np.array_equal(g.numpy(), w), path
        assert got[("coef", "y", "cpk")].dtype == torch.uint16
        assert got[("coef", "y", "n")].shape == ()


def test_expand_compact_gop_bit_equal(stream):
    seq, gops = _wires(stream)
    for jstacked, _, tstacked, tbuf, spec in gops:
        want = dict(_leaves(j_expand_gop(jstacked, seq.mb_height,
                                         seq.mb_width)))
        got = dict(_leaves(expand_compact_gop(
            twire.unflatten_wire(torch.from_numpy(tbuf), spec),
            seq.mb_height, seq.mb_width)))
        assert want.keys() == got.keys()
        for path, g in got.items():
            w = np.asarray(want[path])
            assert g.shape == w.shape and g.numpy().dtype == w.dtype, path
            assert np.array_equal(g.numpy(), w), path
        assert got[("y", "levels")].abs().sum() > 0


@pytest.mark.parametrize("luma_like", [True, False])
def test_expand_levels_padding_is_dropped(luma_like):
    """Entries past n_coef go to the sacrificial slot, and a last block
    that ends exactly at the buffer's end is dropped from the rank."""
    n_blocks = 4 if luma_like else 1
    zz = int(T.ZIG_ZAG[5])                 # wire carries SPATIAL positions
    cases = [(8, 1), (3, 3)]               # (entries, coded) per case
    for n_ent, n_coef in cases:
        counts = np.zeros((1, n_blocks), np.uint8)
        counts[0, -1] = n_coef
        cpk = np.full((n_ent,), (zz << 10) | (7 + 512), np.uint16)
        want = np.asarray(j_expand_levels(
            jnp.asarray(cpk), jnp.int32(n_coef), jnp.asarray(counts), 1, 1,
            luma_like))
        got = expand_levels(torch.from_numpy(cpk),
                            torch.tensor(n_coef, dtype=torch.int32),
                            torch.from_numpy(counts), 1, 1,
                            luma_like).numpy()
        assert np.array_equal(got, want)
        assert got.sum() == 7              # one write: same position
        assert got.shape == ((1, 16, 16) if luma_like else (1, 8, 8))


def _collect(run):
    got = {}
    run(lambda gi, outs: got.__setitem__(
        gi, [np.asarray(o.numpy() if isinstance(o, torch.Tensor) else o)
             .copy() for o in outs]))
    return [tuple(s[i] for s in got[g]) for g in sorted(got)
            for i in range(got[g][0].shape[0])]


def _transcode_vs_jsvx_and_oracle(data, label):
    port = _collect(lambda sink: transcode(data, sink, device="cpu"))
    ref = _collect(lambda sink: j_transcode(data, sink, impl="xla"))
    oracle = decode_stream_oracle(data)
    assert len(port) == len(ref) == len(oracle)
    n_diff = n_pix = 0
    for fp, fr, fo in zip(port, ref, oracle):
        assert len(fp) == len(fr)
        for p, r, o in zip(fp, fr, fo.planes):
            assert p.dtype == np.uint8 and p.shape == r.shape
            diff = np.abs(p.astype(int) - r.astype(int))
            assert diff.max() <= 1
            n_diff += int((diff > 0).sum())
            n_pix += diff.size
            assert np.abs(p.astype(int) - o.astype(int)).max() <= 1
    print(f"{label}: {n_diff} of {n_pix} pixels differ from jsvx")
    assert n_diff <= 1e-3 * n_pix


def test_transcode_cpu_vs_jsvx(stream):
    _transcode_vs_jsvx_and_oracle(stream, "64x96")


def test_transcode_high_motion_vs_jsvx():
    """A P frame with 256 distinct vectors (above jsvx's 255 table cap):
    the port's kernel reads per-block vectors and has no cap."""
    frames = synthetic_frames(4, MB * 16, MB * 16, seed=11)
    enc = JsvEncoder(MB * 16, MB * 16, EncoderConfig(
        gop_size=2, quantizer_scale=8, f_code=3, intra_sad_threshold=1e9,
        key_map=True))
    calls = []

    def forced(y, ref_y):
        calls.append(len(calls))
        return _forced_mvs(calls[-1])

    enc._motion_search = forced
    data = enc.encode(frames)
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = tpp.walk_stream(data)
    g = tpp.parse_gop_compact(arr, groups[1], seq, meta, tpp.BufferPool(),
                              {})
    mv = g.stacked["mb"]["mv"][1].reshape(-1, 2)
    assert len(np.unique(mv, axis=0)) >= 256
    _transcode_vs_jsvx_and_oracle(data, "high-motion")


def test_transcode_result_and_metrics(stream):
    res = transcode(stream, device="cpu")
    assert res.n_frames == 10 and res.n_gops == 2
    stages = res.metrics.to_dict()["stages"]
    assert {"parse", "wire_wait", "device_dispatch",
            "device_wait"} <= stages.keys()
    assert res.metrics.counters["frames"] == 10
    assert res.metrics.gauges["wire_bytes"] > 0


def test_transcode_quirk_matches_jsvx(stream):
    """The oddify-zeros quirk goes through the dense wire
    (``_transcode_packed``), as in jsvx."""
    port = _collect(lambda sink: transcode(stream, sink, device="cpu",
                                           impl="two_kernel",
                                           quirk_oddify_zeros=True))
    ref = _collect(lambda sink: j_transcode(stream, sink, impl="xla",
                                            quirk_oddify_zeros=True))
    plain = _collect(lambda sink: transcode(stream, sink, device="cpu"))
    assert len(port) == len(ref) == len(plain) == 10
    n_diff = n_pix = n_quirk = 0
    for fp, fr, fq in zip(port, ref, plain):
        for p, r, q in zip(fp, fr, fq):
            diff = np.abs(p.astype(int) - r.astype(int))
            assert diff.max() <= 1
            n_diff += int((diff > 0).sum())
            n_pix += diff.size
            n_quirk += int((p != q).sum())
    print(f"quirk: {n_diff} of {n_pix} pixels differ from jsvx; the quirk "
          f"changed {n_quirk}")
    assert n_diff <= 1e-3 * n_pix
    assert n_quirk > 0
    fused = _collect(lambda sink: transcode(stream, sink, device="cpu",
                                            quirk_oddify_zeros=True))
    for fp, ff in zip(port, fused):
        for p, f in zip(fp, ff):
            assert np.array_equal(p, f)


def test_transcode_two_kernel_bit_equal_to_fused(stream):
    res = transcode(stream, device="cpu", impl="two_kernel")
    assert res.n_frames == 10
    two = _collect(lambda sink: transcode(stream, sink, device="cpu",
                                          impl="two_kernel"))
    fused = _collect(lambda sink: transcode(stream, sink, device="cpu"))
    for ft, ff in zip(two, fused):
        for a, b in zip(ft, ff):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="impl must be one of"):
        transcode(stream, device="cpu", impl="pallas")


def test_parse_gop_packed_bit_equal(stream):
    """The dense parse: the port's copy of jsvx's ``parse_gop_packed``
    (mv_capacity=0) gives the same stacked arrays and the same wire."""
    arr = np.frombuffer(stream, np.uint8)
    jm, js, jg = jpp.walk_stream(stream)
    tm, ts, tg = tpp.walk_stream(stream)
    for gi in range(len(tg)):
        want = jpp.parse_gop_packed(arr, jg[gi], js, jm, 0,
                                    pool=_ZeroPool(), index=gi)
        got = tpp.parse_gop_packed(arr, tg[gi], ts, tm, pool=_ZeroPool())
        assert len(got.fts) == len(want.fts)
        wl, gl = dict(_leaves(want.stacked)), dict(_leaves(got.stacked))
        assert wl.keys() == gl.keys()
        for path, w in wl.items():
            assert gl[path].dtype == w.dtype, path
            assert np.array_equal(gl[path], w), path
        spec = twire.wire_spec(got.stacked)
        assert spec == jwire.wire_spec(want.stacked)
        assert np.array_equal(
            twire.flatten_wire(got.stacked, spec,
                               out=np.zeros(spec[1], np.uint8)),
            jwire.flatten_wire(want.stacked, spec,
                               out=np.zeros(spec[1], np.uint8)))


def test_dirty_stream_matches_jsvx_dense_fallback():
    """A GOP whose slices overlap cannot go on the compact wire: it falls
    back to the dense wire, GOP by GOP, as in jsvx."""
    from test_compact_wire import _duplicate_first_slice

    clip = synthetic_frames(3, 48, 64, seed=13)
    data = _duplicate_first_slice(_encode(clip, gop_size=3,
                                          quantizer_scale=4))
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = tpp.walk_stream(data)
    assert tpp.parse_gop_compact(arr, groups[0], seq, meta,
                                 tpp.BufferPool(), {}).dirty
    ref = _collect(lambda sink: j_transcode(data, sink, impl="xla"))
    for impl in ("fused", "two_kernel"):
        port = _collect(lambda sink: transcode(data, sink, device="cpu",
                                               impl=impl))
        assert len(port) == len(ref) == 3
        for fp, fr in zip(port, ref):
            for p, r in zip(fp, fr):
                diff = np.abs(p.astype(int) - r.astype(int))
                assert diff.max() <= 1
                assert (diff > 0).sum() <= 1e-3 * diff.size


# ---------------------------------------------------------------------------
# The pipelined GOP loop: jsvx's order, stages and gauges


@pytest.fixture(scope="module")
def three_gops():
    return _encode(synthetic_frames(9, 48, 64, seed=21), gop_size=3,
                   quantizer_scale=4, me_range=4)


def _frames_of(run) -> list:
    return [tuple(p.numpy() for p in f) for f in run.frames]


@pytest.mark.parametrize("quirk", [False, True], ids=["compact", "quirk"])
@pytest.mark.parametrize("impl", ["fused", "two_kernel"])
def test_transcode_bit_equal_to_stream_decoder(stream, impl, quirk):
    """The pipelined loop gives the planes the port's ``StreamDecoder``
    gives (one GOP at a time, no overlap), bit for bit."""
    got = _collect(lambda sink: transcode(stream, sink, device="cpu",
                                          impl=impl,
                                          quirk_oddify_zeros=quirk))
    want = _frames_of(StreamDecoder(stream, quirk, device="cpu")
                      .decode(impl=impl))
    assert len(got) == len(want) == 10
    for fg, fw in zip(got, want):
        for g, w in zip(fg, fw):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("impl", ["fused", "two_kernel"])
def test_dirty_stream_bit_equal_to_stream_decoder(impl):
    from test_compact_wire import _duplicate_first_slice

    data = _duplicate_first_slice(_encode(
        synthetic_frames(6, 48, 64, seed=13), gop_size=3,
        quantizer_scale=4))
    got = _collect(lambda sink: transcode(data, sink, device="cpu",
                                          impl=impl))
    want = _frames_of(StreamDecoder(data, device="cpu").decode(impl=impl))
    assert len(got) == len(want) == 6
    for fg, fw in zip(got, want):
        for g, w in zip(fg, fw):
            assert np.array_equal(g, w)


def _logged_order(monkeypatch, run, parse_mod, parse_names, decode_mod,
                  decode_name) -> list:
    """Run ``run(sink)`` with each parse of ``parse_mod`` and the GOP
    decode of ``decode_mod`` logging; returns the log."""
    log = []

    def parse(fn):
        def logged(*a, **kw):
            log.append(f"parse {kw['index']}")
            return fn(*a, **kw)
        return logged

    def decode(fn):
        def logged(*a, **kw):
            log.append(f"decode {sum(e.startswith('decode') for e in log)}")
            return fn(*a, **kw)
        return logged

    for name in parse_names:
        monkeypatch.setattr(parse_mod, name, parse(getattr(parse_mod, name)))
    monkeypatch.setattr(decode_mod, decode_name,
                        decode(getattr(decode_mod, decode_name)))
    run(lambda gi, outs: log.append(f"sink {gi}"))
    return log


@pytest.mark.parametrize("quirk,order", [
    # the compact route: GOP g-1 is delivered after GOP g is dispatched
    # and GOP g+1 parsed
    (False, ["parse 0", "decode 0", "parse 1", "decode 1", "parse 2",
             "sink 0", "decode 2", "sink 1", "sink 2"]),
    # the dense quirk route: GOP g is delivered after GOP g+1 is parsed
    (True, ["parse 0", "decode 0", "parse 1", "sink 0", "decode 1",
            "parse 2", "sink 1", "decode 2", "sink 2"])],
    ids=["compact", "quirk"])
def test_transcode_order_is_jsvx(three_gops, monkeypatch, quirk, order):
    """Parse, dispatch and delivery on a 3-GOP stream, the port's and
    jsvx's ``transcode`` logged the same way."""
    import jsvx.pipeline.gop as jgop
    import jsvx.pipeline.transcode as jtr
    import jsvx_torch.pipeline.program as tprog
    import jsvx_torch.pipeline.transcode as ttr

    # the port decodes each GOP in its GOP program's body
    port = _logged_order(
        monkeypatch, lambda sink: transcode(three_gops, sink, device="cpu",
                                            quirk_oddify_zeros=quirk),
        ttr, ("parse_gop_compact", "parse_gop_packed"), tprog,
        "decode_gop_wire")
    # jsvx imports its parse (and its compact route's decode) inside the
    # function, its quirk route's decode at the top of the module
    ref = _logged_order(
        monkeypatch, lambda sink: j_transcode(three_gops, sink, impl="xla",
                                              quirk_oddify_zeros=quirk),
        jpp, ("parse_gop_compact", "parse_gop_packed"),
        jtr if quirk else jgop,
        "decode_gop_scan" if quirk else "decode_gop_scan_wire")
    assert port == ref == order


def test_sink_tensors_distinct_and_intact(three_gops):
    """Each GOP's planes are new tensors, kept by the sink without a copy
    and unchanged once every later GOP has been decoded."""
    kept, at_sink = [], []

    def sink(gi, outs):
        kept.append(outs)
        at_sink.append([o.clone() for o in outs])

    transcode(three_gops, sink, device="cpu")
    ptrs = [o.data_ptr() for outs in kept for o in outs]
    assert len(ptrs) == 9 and len(set(ptrs)) == 9
    for outs, copies in zip(kept, at_sink):
        for o, c in zip(outs, copies):
            assert torch.equal(o, c)


def test_transcode_stages_and_probe_expand(stream):
    """jsvx's stage names and gauges, ``probe_expand`` included, with the
    same counts as jsvx's run of the same stream."""
    res = transcode(stream, lambda gi, outs: None, device="cpu",
                    probe_expand=True)
    ref = j_transcode(stream, lambda gi, outs: None, impl="xla",
                      probe_expand=True)
    stages = res.metrics.timers.report()
    assert set(stages) == {"parse", "wire_wait", "device_dispatch",
                           "device_wait", "sink", "expand_probe_compile"}
    assert ({k: v["count"] for k, v in stages.items()}
            == {k: v["count"]
                for k, v in ref.metrics.timers.report().items()})
    assert stages["parse"]["count"] == res.n_gops + 1 == 3
    assert res.metrics.gauges.keys() == ref.metrics.gauges.keys() == {
        "width", "height", "wire_bytes", "expand_probe_s_per_gop"}
    assert res.metrics.gauges["expand_probe_s_per_gop"] > 0
    quirk = transcode(stream, lambda gi, outs: None, device="cpu",
                      quirk_oddify_zeros=True)
    assert set(quirk.metrics.timers.report()) == {
        "parse", "device_dispatch", "device_wait", "sink"}
    assert "expand_probe_s_per_gop" not in transcode(
        stream, device="cpu").metrics.gauges


def test_manifest_checkpoint_resume(three_gops, tmp_path):
    """jsvx's resume case (``tests/test_runtime.py``) on the port."""
    from jsvx_torch.runtime.multihost import GopManifest

    journal = str(tmp_path / "journal.jsonl")
    m = GopManifest.from_stream(three_gops, journal_path=journal)
    got = []
    # decode only GOP 0 and 2 (process 0 of 2), journaling progress
    res = transcode(three_gops, lambda gi, outs: got.append(gi),
                    device="cpu", manifest=m, process_id=0, process_count=2)
    assert res.n_gops == 2 and m.n_done == 2 and got == [0, 2]
    # resume in a fresh manifest: nothing pending for process 0
    m2 = GopManifest.from_stream(three_gops, journal_path=journal)
    assert m2.n_done == 2
    assert m2.pending(0, 2) == []
    assert [s.index for s in m2.pending(1, 2)] == [1]
    res2 = transcode(three_gops, device="cpu", manifest=m2, process_id=1,
                     process_count=2)
    assert res2.n_gops == 1 and res2.n_frames == 3 and m2.complete


def test_cpu_wire_is_a_clone_so_its_buffer_can_go_back():
    """On the CPU the pool is not pinned and a wire is a copy (into its GOP
    program's static wire), complete when ``copy`` returns: the pooled
    buffer may be reused (released in ``wire_wait``) at once."""
    from jsvx_torch.pipeline.transcode import WireCopier

    pool = tpp.BufferPool()
    assert not pool.pin
    buf = pool.acquire((256,), np.uint8)
    buf[:] = 7
    host = pool.host_tensor(buf)
    assert host.data_ptr() == buf.ctypes.data
    static = torch.zeros(256, dtype=torch.uint8)
    wire, copied = WireCopier(torch.device("cpu")).copy(host, static, None)
    buf[:] = 9
    assert wire is static and wire.data_ptr() != host.data_ptr()
    assert copied is None and int(wire.sum()) == 7 * 256
    with pytest.raises(ValueError, match="1-D uint8"):
        pool.host_tensor(np.zeros((2, 2), np.uint8))

