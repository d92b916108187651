"""The port stands alone, and its copies of jsvx's host side do not drift.

``jsvx_torch`` imports nothing of the ``jsvx`` package, of ``bench.py``
or of JAX: it carries its own copies of the host front end (bitstream,
C++ parser, VLC tables), the tools (encoder, float64 oracle, refmath,
PSNR, the 1080p fixture), the runtime (metrics, sources, GOP manifest) and
the streaming API.  Shown here two ways: a subprocess whose import system
refuses ``jsvx``, ``bench`` and ``jax`` imports every module of the port
and ``chip_smoke.py`` and decodes a clip through every entry point; and an
AST scan of every source file.

Each copy is then held to its jsvx original on the same inputs (this
file may import jsvx): tables and VLC LUTs, parsed pictures (the Python
and the C++ parser), the parser's C++ source byte for byte, encoded
streams, oracle planes, colour and PSNR, the fixture's pattern, GOP
manifests, and the events of the Decoder and the Player.
"""

import ast
import dataclasses
import filecmp
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import jsvx.api as japi
import jsvx.bitstream.native as jnative
import jsvx.coding.tables as jtables
import jsvx.coding.vlc as jvlc
import jsvx.runtime.multihost as jmultihost
import jsvx.tools.encoder as jencoder
import jsvx.tools.oracle as joracle
import jsvx.tools.refmath as jrefmath
from jsvx.bitstream.bitio import BitReader as JBitReader
from jsvx.bitstream.container import StartCodeIndex as JStartCodeIndex
from jsvx.bitstream.container import \
    parse_container_header as j_parse_container_header
from jsvx.bitstream.parser import StreamParser as JStreamParser

import jsvx_torch.api as tapi
import jsvx_torch.bitstream.native as tnative
import jsvx_torch.coding.tables as ttables
import jsvx_torch.coding.vlc as tvlc
import jsvx_torch.runtime.multihost as tmultihost
import jsvx_torch.tools.encoder as tencoder
import jsvx_torch.tools.oracle as toracle
import jsvx_torch.tools.refmath as trefmath
from jsvx_torch.bitstream.bitio import BitReader
from jsvx_torch.bitstream.container import (StartCodeIndex,
                                            parse_container_header)
from jsvx_torch.bitstream.parser import StreamParser
from jsvx_torch.tools import fixture

from conftest import synthetic_frames, synthetic_frames_yuva

# the packages' ``tools.psnr`` attribute is the function, not the module
jpsnr = importlib.import_module("jsvx.tools.psnr")
tpsnr = importlib.import_module("jsvx_torch.tools.psnr")

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "jsvx_torch")
FORBIDDEN = ("jsvx", "bench", "jax")


def _sources() -> list:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def _imported_roots(path: str) -> set:
    """Top-level module names a source file imports, anywhere in it
    (relative imports excluded)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


# ---------------------------------------------------------------------------
# Independence


def test_ast_scan_finds_no_jsvx_bench_or_jax_import():
    found = {os.path.relpath(p, REPO): sorted(_imported_roots(p)
                                              & set(FORBIDDEN))
             for p in _sources()}
    assert len(found) > 40
    for path in ("shard/__init__.py", "shard/mesh.py", "shard/slice_rows.py",
                 "shard/gop_parallel.py", "shard/launch.py",
                 "tools/synthetic.py", "tools/bench_scaling.py",
                 "pipeline/parallel_parse.py", "tools/bench_parse.py",
                 "tools/bench_mc.py", "graft_entry.py"):
        assert os.path.join("jsvx_torch", path) in found, path
    assert not {p: r for p, r in found.items() if r}


def test_ast_scan_sees_a_forbidden_import(tmp_path):
    """The scan is not blind: it reports each form of import."""
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom . import x\ndef f():\n"
                   "    import jsvx.api\n    from bench import _zoom_clip\n"
                   "    import jax.numpy as jnp\n")
    assert _imported_roots(str(src)) & set(FORBIDDEN) == set(FORBIDDEN)


_BLOCKED_RUN = r'''
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jsvx", "bench", "jax"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import jsvx_torch
names = [m.name for m in pkgutil.walk_packages(jsvx_torch.__path__,
                                               "jsvx_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("jsvx_torch.shard", "jsvx_torch.shard.mesh",
             "jsvx_torch.shard.slice_rows", "jsvx_torch.shard.gop_parallel",
             "jsvx_torch.shard.launch", "jsvx_torch.tools.synthetic",
             "jsvx_torch.tools.bench_scaling",
             "jsvx_torch.pipeline.parallel_parse",
             "jsvx_torch.tools.bench_parse", "jsvx_torch.tools.bench_mc",
             "jsvx_torch.graft_entry"):
    assert name in names, name
import chip_smoke

from jsvx_torch import StreamDecoder, transcode
from jsvx_torch.api import Decoder, Player, PlayerConfig
from jsvx_torch.tools.encoder import EncoderConfig, JsvEncoder
from jsvx_torch.tools.oracle import decode_stream_oracle
yy, xx = np.mgrid[0:32, 0:48]
frames = [((96 + 40 * np.sin((xx + 2 * t) / 5.0)).astype(np.uint8),
           np.full((16, 24), 120, np.uint8), np.full((16, 24), 130, np.uint8))
          for t in range(4)]
data = JsvEncoder(48, 32, EncoderConfig(gop_size=2)).encode(frames)
oracle = decode_stream_oracle(data)
got = {}
res = transcode(data, lambda gi, outs: got.__setitem__(gi, outs),
                device="cpu", probe_expand=True)
assert res.n_frames == 4 and sorted(got) == [0, 1], res
assert res.metrics.gauges["expand_probe_s_per_gop"] > 0
from jsvx_torch.pipeline.packed_parse import parse_stream_packed
from jsvx_torch.pipeline.parallel_parse import parse_stream_parallel
from jsvx_torch.runtime.profiler import device_trace
from jsvx_torch.tools import bench_mc, bench_parse
assert len(parse_stream_parallel(data).frames) == 4
assert parse_stream_packed(data).n_frames == 4
with device_trace(None):
    assert bench_parse.bench_packed(data, reps=1) > 0
rows = bench_mc.rows("cpu", 48, 64, (4,), reps=1)
assert rows[0]["mismatching_pixels"] == 0, rows
assert len(StreamDecoder(data, device="cpu").decode().frames) == 4
for scan in (True, False):
    d = Decoder(PlayerConfig(use_gop_scan=scan), device="cpu")
    d.feed(0, data, total=len(data))
    planes = [f.planes for f in d.iter_frames()]
    assert d.ended and len(planes) == 4
    for p, o in zip(planes, oracle):
        assert abs(p[0].numpy().astype(int) - o.planes[0]).max() <= 1
p = Player(PlayerConfig(emit_rgb=True), device="cpu")
shown = []
p.set_frame_sink(lambda rgb, t: shown.append(tuple(rgb.shape)))
p.src = data
p.play()
t = 0.0
while not p.ended and t < 2.0:
    t += 1 / 30.0
    p.tick(t)
assert p.ended and shown == [(32, 48, 3)] * 4, shown
from jsvx_torch.kernels.decode import make_constants
from jsvx_torch.pipeline.gop import zero_refs
from jsvx_torch.shard import build_mesh, decode_gop_rows_sharded
from jsvx_torch.tools.synthetic import synthetic_gop
gop = synthetic_gop(2, 2, 3, max_mv=6)
consts = make_constants(None, "cpu")
bands, _ = decode_gop_rows_sharded(gop, zero_refs(32, 48, 3, "cpu"), consts,
                                   build_mesh({"rows": 1}), device="cpu")
assert bands[0].shape == (2, 32, 48), bands[0].shape
from jsvx_torch.graft_entry import entry
fn, args = entry(device="cpu")
assert [tuple(p.shape) for p in fn(*args)] == [(128, 128), (64, 64),
                                                (64, 64)]
blocked =[m for m in sys.modules if m.split(".")[0] in ("jsvx", "bench",
                                                         "jax")]
assert not blocked, blocked
print("ok", len(names))
'''


def test_port_runs_with_jsvx_bench_and_jax_refused():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    word, n = proc.stdout.split()
    assert word == "ok" and int(n) > 30


def test_refusing_finder_does_refuse():
    """The finder of the subprocess above blocks what it must."""
    code = _BLOCKED_RUN.split("import numpy as np")[0] + (
        "try:\n    import bench\nexcept ImportError:\n    print('refused')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=60)
    assert proc.stdout.strip() == "refused", proc.stderr


# ---------------------------------------------------------------------------
# The copies, held to jsvx


def _public(module) -> dict:
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and not callable(v)
            and not isinstance(v, type(os))}


def test_tables_equal():
    want, got = _public(jtables), _public(ttables)
    assert set(want) == set(got) and len(want) > 20
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_vlc_luts_equal():
    want, got = jvlc.compiled_tables(), tvlc.compiled_tables()
    assert set(want) == set(got) and len(want) >= 8
    for name, t in want.items():
        u = got[name]
        assert u.max_len == t.max_len, name
        assert np.array_equal(u.lut_value, t.lut_value), name
        assert np.array_equal(u.lut_length, t.lut_length), name


def test_jsv_parse_cc_is_byte_identical():
    src = os.path.join(PORT, "native", "jsv_parse.cc")
    assert filecmp.cmp(src, os.path.join(REPO, "jsvx", "native",
                                         "jsv_parse.cc"), shallow=False)


def test_native_parser_builds_under_build_and_raises_on_failure(
        tmp_path, monkeypatch):
    path = tnative.library_path()
    assert path.startswith(os.path.join(REPO, "build", "jsvx_torch") + os.sep)
    assert tnative.get_native_parser() is not None and os.path.exists(path)
    assert not os.path.exists(os.path.join(PORT, "native",
                                           "libjsv_parse.so"))
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative._build(str(tmp_path / "out" / "lib.so"))


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return tuple(mod.JsvEncoder(w, h, mod.EncoderConfig(**kw)).encode(clip)
                 for mod in (jencoder, tencoder))


ENCODINGS = {
    "tiny": (lambda: synthetic_frames(6, 48, 64), dict(gop_size=3)),
    "tiny_quirk_stream": (lambda: synthetic_frames(6, 48, 64),
                          dict(gop_size=3, quantizer_scale=4, me_range=4)),
    "small": (lambda: synthetic_frames(10, 96, 112),
              dict(gop_size=5, quantizer_scale=4)),
    "small_no_key_map": (lambda: synthetic_frames(10, 96, 112),
                         dict(gop_size=4, key_map=False, use_skips=False)),
    "yuva": (lambda: synthetic_frames_yuva(5, 48, 64),
             dict(gop_size=3, quantizer_scale=4, me_range=4)),
    "full_pel_custom_q": (lambda: synthetic_frames(4, 48, 64),
                          dict(gop_size=4, full_pel=True, f_code=2,
                               custom_intra_q=np.full(64, 12, np.uint8),
                               custom_non_intra_q=np.full(64, 20, np.uint8))),
}


@pytest.fixture(scope="module")
def streams():
    return {name: _encode(make(), **kw)
            for name, (make, kw) in ENCODINGS.items()}


@pytest.mark.parametrize("name", sorted(ENCODINGS))
def test_encoder_streams_byte_identical(streams, name):
    want, got = streams[name]
    assert len(want) > 100 and got == want


def _parse_all(parser_cls, reader_cls, index_cls, header, data, native):
    r = reader_cls(data)
    meta = header(r)
    index = index_cls.scan(data)
    parser = parser_cls(use_native=native, yuva=meta.yuva)
    out = []
    while True:
        nxt = index.next_code(r.byte_pos)
        if nxt is None:
            return meta, out
        off, code = nxt
        r.seek_bits((off + 4) << 3)
        if code == ttables.START_SEQUENCE:
            parser.parse_sequence_header(r)
        elif code == ttables.START_GOP:
            parser.parse_gop_header(r)
        elif code == ttables.START_PICTURE:
            ft = parser.parse_picture(r, index, len(data))
            if ft is not None:
                out.append(ft)


def _same_value(a, b, what):
    if isinstance(a, (tuple, list)):
        assert type(b) in (tuple, list) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert b.dtype == a.dtype and np.array_equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("native", [False, True], ids=["python", "c++"])
@pytest.mark.parametrize("name", ["tiny", "tiny_quirk_stream", "small",
                                  "yuva", "full_pel_custom_q"])
def test_parsed_pictures_equal(streams, name, native):
    data, _ = streams[name]
    jmeta, want = _parse_all(JStreamParser, JBitReader, JStartCodeIndex,
                             j_parse_container_header, data, native)
    meta, got = _parse_all(StreamParser, BitReader, StartCodeIndex,
                           parse_container_header, data, native)
    assert dataclasses.asdict(meta).keys() == dataclasses.asdict(jmeta).keys()
    _same_value([getattr(meta, f) for f in ("width", "height", "yuva",
                                            "duration", "header_bytes")],
                [getattr(jmeta, f) for f in ("width", "height", "yuva",
                                             "duration", "header_bytes")],
                "meta")
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for f in dataclasses.fields(w):
            _same_value(getattr(w, f.name), getattr(g, f.name),
                        f"picture {i} {f.name}")


def test_native_compact_parse_equal(streams):
    """The C++ parser's compact wire entries and sideband, both copies."""
    data, _ = streams["small"]
    arr = np.frombuffer(data, np.uint8)
    from jsvx_torch.pipeline.packed_parse import walk_stream

    meta, seq, groups = walk_stream(data)
    outs = []
    for mod in (jnative, tnative):
        parser = mod.get_native_parser()
        per = []
        for hdr, start_bit in groups[0]:
            n = seq.mb_height * seq.mb_width
            cpk = tuple(np.zeros(k * 64, np.uint16) for k in (4 * n, n, n))
            counts = tuple(np.zeros(k, np.uint8) for k in (4 * n, n, n))
            sb = (np.zeros((seq.mb_height, seq.mb_width), np.uint8),
                  np.zeros((seq.mb_height, seq.mb_width), np.uint8),
                  np.zeros((seq.mb_height, seq.mb_width, 2), np.int16),
                  np.zeros((seq.mb_height, seq.mb_width), np.uint8))
            ns, dirty = parser.parse_picture_compact(
                arr, start_bit, hdr, seq.mb_width, seq.mb_height, False,
                cpk + (None,), counts + (None,), *sb)
            per.append((ns, dirty, cpk, counts, sb))
        outs.append(per)
    assert len(outs[0]) == len(outs[1]) > 1
    _same_value(outs[0], outs[1], "compact parse")


@pytest.mark.parametrize("name", ["tiny_quirk_stream", "small", "yuva",
                                  "full_pel_custom_q"])
@pytest.mark.parametrize("quirk", [False, True])
def test_oracle_planes_equal(streams, name, quirk):
    data, _ = streams[name]
    want = joracle.decode_stream_oracle(data, quirk_oddify_zeros=quirk)
    got = toracle.decode_stream_oracle(data, quirk_oddify_zeros=quirk)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.picture_type == w.picture_type
        _same_value(w.planes, g.planes, "planes")


def test_refmath_colour_and_psnr_equal():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    cb = rng.integers(0, 256, (24, 32)).astype(np.uint8)
    cr = rng.integers(0, 256, (24, 32)).astype(np.uint8)
    assert np.array_equal(trefmath.ycbcr_to_rgb(y, cb, cr),
                          jrefmath.ycbcr_to_rgb(y, cb, cr))
    assert np.array_equal(trefmath.C_BASIS, jrefmath.C_BASIS)
    assert np.array_equal(trefmath.YCBCR_TO_RGB, jrefmath.YCBCR_TO_RGB)
    z = np.clip(y.astype(int) + rng.integers(-3, 4, y.shape), 0, 255)
    assert tpsnr.psnr(y, z) == jpsnr.psnr(y, z)
    assert tpsnr.psnr(y, y) == jpsnr.psnr(y, y)
    frames = [(y, cb, cr)] * 2
    assert tpsnr.frames_psnr(frames, frames) == jpsnr.frames_psnr(frames,
                                                                  frames)


def test_fixture_pattern_equals_bench():
    got = fixture.zoom_clip(48, 64, 3, seed=5)
    want = bench._zoom_clip(48, 64, 3, seed=5)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_value(w, g, "zoom clip")
    assert os.path.basename(fixture.fixture_path()).startswith(
        "jsvx_torch_1080p_")
    assert fixture.fixture_path().startswith(
        os.path.join(REPO, "build", "jsvx_torch") + os.sep)


@pytest.mark.parametrize("name", ["tiny", "tiny_quirk_stream", "small",
                                  "yuva", "full_pel_custom_q"])
def test_parse_stream_parallel_equal(streams, name):
    """The picture-parallel parse: every field of every picture equal to
    jsvx's parallel parse and to the port's serial ``parse_all``, the GOP
    starts equal to jsvx's."""
    from jsvx.pipeline.parallel_parse import parse_stream_parallel as jpar

    from jsvx_torch.pipeline.parallel_parse import parse_stream_parallel
    from jsvx_torch.pipeline.stream import StreamDecoder

    data, _ = streams[name]
    got = parse_stream_parallel(data, n_threads=4)
    want = jpar(data, n_threads=4)
    serial = StreamDecoder(data, device="cpu").parse_all()
    assert got.gop_starts == want.gop_starts and len(got.gop_starts) >= 1
    assert len(got.frames) == len(want.frames) == len(serial) > 0
    _same_value([getattr(got.seq, f) for f in ("mb_width", "mb_height")],
                [getattr(want.seq, f) for f in ("mb_width", "mb_height")],
                "seq")
    for i, (g, w, s) in enumerate(zip(got.frames, want.frames, serial)):
        for f in dataclasses.fields(w):
            _same_value(getattr(w, f.name), getattr(g, f.name),
                        f"picture {i} {f.name} vs jsvx")
        # the serial parse emits no per-pixel dequant sideband
        for f in ("levels", "lnz", "mb_mv", "mb_quant", "mb_intra",
                  "mb_rep_add", "gop_time_ms", "picture_type"):
            _same_value(getattr(s, f), getattr(g, f),
                        f"picture {i} {f} vs serial")


@pytest.mark.parametrize("name", ["small", "yuva"])
def test_parse_stream_packed_equal(streams, name):
    """The dense stacked parse of a stream: jsvx's with ``mv_capacity=0``
    on every field the two share (jsvx's own capacity field aside)."""
    import jsvx.pipeline.packed_parse as jpp

    import jsvx_torch.pipeline.packed_parse as tpp

    def zeroed(pool_cls):
        # coefficient planes are not cleared between uses (positions past
        # a block's lnz are never read), so compare fresh zeroed buffers
        return type("ZeroPool", (pool_cls,), {
            "acquire": lambda self, shape, dtype: np.zeros(shape, dtype)})()

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v

    data, _ = streams[name]
    got = tpp.parse_stream_packed(data, n_threads=2,
                                  pool=zeroed(tpp.BufferPool))
    want = jpp.parse_stream_packed(data, n_threads=2, mv_capacity=0,
                                   pool=zeroed(jpp.BufferPool))
    assert got.n_frames == want.n_frames > 0
    assert len(got.gops) == len(want.gops) >= 2
    for g, w in zip(got.gops, want.gops):
        assert g.index == w.index
        gl, wl = dict(leaves(g.stacked)), dict(leaves(w.stacked))
        assert gl.keys() == wl.keys()
        for path, leaf in wl.items():
            _same_value(leaf, gl[path], f"GOP {g.index} {path}")
        assert len(g.fts) == len(w.fts)
        for fg, fw in zip(g.fts, w.fts):
            _same_value([fw.levels, fw.mb_mv, fw.gop_time_ms],
                        [fg.levels, fg.mb_mv, fg.gop_time_ms], "fts")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from jsvx_torch.runtime.profiler import TRACE_FILE, device_trace

    with device_trace(None, "cpu"):
        pass
    with device_trace("", "cpu"):
        pass
    assert not os.listdir(tmp_path)
    with device_trace(str(tmp_path / "t"), "cpu"):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "t" / TRACE_FILE) as f:
        names = {e.get("name") for e in __import__("json").load(f)[
            "traceEvents"]}
    assert "aten::cumsum" in names


def test_bench_parse_stream_and_runs():
    """``tools/bench_parse.py``: jsvx's stream, byte for byte, and each
    bench at a small size."""
    import jsvx.tools.bench_parse as jbench

    from jsvx_torch.tools import bench_parse

    kw = dict(n_frames=4, h=48, w=64, gop=2)
    data = bench_parse.make_stream(**kw)
    assert data == jbench.make_stream(**kw)
    for native in (True, False):
        res = bench_parse.bench(data, use_native=native)
        assert res["pictures"] == 4 and res["mb_per_s"] > 0
    assert bench_parse.bench_parallel(data, reps=1) > 0
    assert bench_parse.bench_packed(data, reps=1) > 0
    assert bench_parse.bench_packed(data, reps=1, slice_threads=2,
                                    n_threads=1) > 0


def test_bench_mc_rows_at_a_small_size(capsys):
    """``tools/bench_mc.py`` on the CPU: exactly K distinct vectors per
    plane, the wrapper (its plain version here) equal to the plain
    version; the command prints jsvx's keys."""
    from jsvx_torch.tools import bench_mc

    rows = bench_mc.rows("cpu", 48, 64, (8, 32, 48), reps=1)
    assert [(r["impl"], r["k"]) for r in rows] == [
        (impl, k) for k in (8, 32, 48)
        for impl in ("predict_plane_mc", "predict_plane")]
    assert all(r["distinct"] == r["k"] and r["ms_per_plane"] > 0
               for r in rows)
    assert all(r["mismatching_pixels"] == 0 for r in rows[::2])
    _, mv, _ = bench_mc.plane_inputs(48, 64, 48, "cpu")
    assert int(mv.abs().max()) <= bench_mc.MV_RANGE
    with pytest.raises(ValueError, match="distinct vectors"):
        bench_mc.plane_inputs(48, 64, 49, "cpu")
    bench_mc.main(["--device", "cpu", "--shape", "160x128"])
    out = __import__("json").loads(capsys.readouterr().out)
    assert {"platform", "plane", "rows"} <= out.keys()
    assert out["platform"] == "cpu" and out["plane"] == "160x128 luma"
    assert [r["k"] for r in out["rows"][::2]] == list(bench_mc.KS)


@pytest.mark.parametrize("name", ["small", "small_no_key_map", "yuva"])
def test_gop_manifests_equal(streams, name, tmp_path):
    data, _ = streams[name]
    ms = []
    for mod, tag in ((jmultihost, "j"), (tmultihost, "t")):
        journal = tmp_path / f"{tag}.jsonl"
        m = mod.GopManifest.from_stream(data, journal_path=str(journal))
        m.mark_done(1, frames=4)
        resumed = mod.GopManifest.from_stream(data,
                                              journal_path=str(journal))
        ms.append(([dataclasses.astuple(s) for s in m.spans],
                   [s.index for s in resumed.pending(0, 2)],
                   [s.index for s in resumed.assigned(1, 2)],
                   resumed.n_done, resumed.complete, journal.read_text()))
    assert len(ms[0][0]) >= 2
    assert ms[0] == ms[1]


# ---------------------------------------------------------------------------
# The streaming API: the same events as jsvx's on the same clip and clock

DECODER_EVENTS = ("meta", "seq", "frame", "ended", "seeked", "stalled")
PLAYER_EVENTS = ("loadstart", "durationchange", "loadedmetadata",
                 "loadeddata", "progress", "canplay", "canplaythrough",
                 "play", "playing", "pause", "timeupdate", "waiting",
                 "stalled", "unstalled", "seeking", "seeked", "ended",
                 "error", "resize", "suspend", "frameout")


def _decoder_log(d, data):
    log = []
    for name in DECODER_EVENTS:
        d.on(name, lambda *a, n=name: log.append(
            (n,) + ((a[0].picture_type, a[0].ts_ms) if n == "frame"
                    else tuple(a) if n in ("stalled", "seeked") else ())))
    pos = 0
    while not d.ended and pos <= len(data) + 700:
        if d.decode_frame() is None:
            d.feed(pos, data[pos:pos + 700], len(data))
            pos += 700
    d.seek(150.0)
    list(d.iter_frames())
    return log


@pytest.mark.parametrize("backend", ["torch", "oracle"])
@pytest.mark.parametrize("name", ["small", "yuva"])
def test_decoder_events_equal_jsvx(streams, name, backend):
    data, _ = streams[name]
    port = _decoder_log(tapi.Decoder(tapi.PlayerConfig(), backend=backend,
                                     device="cpu"), data)
    # jsvx batches buffered GOPs on its device backend, as the port's
    # torch backend does, and decodes picture by picture on the oracle
    ref = _decoder_log(japi.Decoder(japi.PlayerConfig(), backend={
        "torch": "jax", "oracle": "oracle"}[backend]), data)
    assert [e for e in port if e[0] == "frame"]
    assert ("seeked", 150.0) == port[-1][:2] or ("ended",) in port
    assert port == ref


def _player_log(p, data):
    log = []
    for name in PLAYER_EVENTS:
        p.on(name, lambda *a, n=name: log.append((n, int(p.ready_state))))
    p.src = data
    p.play()
    t = 0.0
    while not p.ended and t < 5.0:
        t += 1 / 30.0
        p.tick(t)
    assert p.ended
    return log


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("backend", ["torch", "oracle"])
@pytest.mark.parametrize("name", ["small", "yuva"])
def test_player_events_equal_jsvx(streams, name, backend, rgb):
    data, _ = streams[name]
    port = _player_log(tapi.Player(tapi.PlayerConfig(emit_rgb=rgb),
                                   backend=backend, device="cpu"), data)
    ref = _player_log(japi.Player(japi.PlayerConfig(), backend="oracle"),
                      data)
    assert port == ref
    assert port[0][0] == "loadstart" and port[-1][0] == "ended"


@pytest.mark.parametrize("pair", [
    ("api.config", "PlayerConfig"), ("api.errors", "MediaError"),
    ("bitstream.ranges", "RangeBuffer"), ("runtime.source", "MemorySource"),
    ("runtime.profiler", "Metrics"), ("utils.events", "EventDispatcher"),
    ("bitstream.container", "ContainerMeta"),
    ("bitstream.parser", "SequenceInfo"),
    ("runtime.multihost", "initialize"), ("shard.mesh", "build_mesh"),
    ("shard.slice_rows", "decode_gop_rows_sharded"),
    ("pipeline.parallel_parse", "ParsedStream"),
    ("tools.bench_parse", "bench_packed"), ("tools.bench_mc", "main")],
    ids=lambda p: p[0])
def test_copied_modules_keep_jsvx_public_names(pair):
    """Each copied or ported module defines the names its jsvx original
    does: apart from the modules it imports and JAX's own objects (a JAX
    ``Mesh``, ``PartitionSpec``), which the port has no use for, and the
    whole-plane decode that only jsvx's ``mc_impl="gather"`` band route
    calls (the port's one band route is the two kernels), and the
    executor jsvx's picture-parallel parse imports (the port parses on
    its process's parse pool, ``pipeline/parse_pool.py``)."""
    mod, cls = pair
    j = importlib.import_module(f"jsvx.{mod}")
    t = importlib.import_module(f"jsvx_torch.{mod}")
    names = {k for k, v in vars(j).items() if not k.startswith("_")
             and not isinstance(v, type(os))
             and not str(getattr(v, "__module__", "")).startswith("jax")}
    if mod == "shard.slice_rows":
        names -= {"decode_frame_plane"}
    if mod == "pipeline.parallel_parse":
        names -= {"ThreadPoolExecutor"}
    assert names <= set(vars(t)), names - set(vars(t))
    assert getattr(t, cls).__module__ == f"jsvx_torch.{mod}"


def test_synthetic_inputs_equal_graft_entry():
    """``tools/synthetic.py`` draws what ``__graft_entry__`` draws, field
    by field, for the fields it keeps (jsvx's vector table dropped)."""
    from __graft_entry__ import _synthetic_frame_inputs

    from jsvx_torch.tools.synthetic import (synthetic_frame_inputs,
                                            synthetic_gop)

    for args, kw in (((68, 120, True), dict(seed=60, max_mv=200,
                                            mv_capacity=8)),
                     ((68, 120, False), dict(seed=40)),
                     ((3, 5, True), dict(seed=2))):
        want = _synthetic_frame_inputs(*args, **kw)
        got = synthetic_frame_inputs(*args, **kw)
        assert set(want) - set(got) == {"mv_table", "mv_count"}
        assert set(got) == {"y", "cb", "cr", "is_p", "f_code"}
        for k in ("is_p", "f_code"):
            _same_value(want[k], got[k], k)
        for key in ("y", "cb", "cr"):
            assert set(want[key]) - set(got[key]) == {"mv_idx"}
            for f, a in got[key].items():
                _same_value(want[key][f], a, f"{key}.{f}")
        assert np.array_equal(want["mv_table"][want["y"]["mv_idx"]],
                              got["y"]["mv"])
    gop = synthetic_gop(max_mv=200, seed=60)
    assert gop["y"]["levels"].shape == (2, 1088, 1920)
    assert int(gop["f_code"].max()) >= 6
    for i in range(2):
        _same_value(_synthetic_frame_inputs(
            68, 120, i > 0, seed=60 + i, max_mv=200, mv_capacity=8)["cb"][
            "levels"], gop["cb"]["levels"][i], "gop")


# ---------------------------------------------------------------------------
# The card by default


def test_entry_points_default_to_the_card():
    import inspect

    import jsvx_torch

    for fn in (jsvx_torch.transcode, jsvx_torch.StreamDecoder,
               jsvx_torch.Decoder, jsvx_torch.Player):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert tapi.Decoder().device == torch.device("cuda")


@pytest.mark.parametrize("cmd", ["decode", "play", "bench", "warm"])
def test_cli_fails_without_a_card_unless_asked_for_the_cpu(
        cmd, streams, tmp_path, monkeypatch, capsys):
    """No silent fall back to the CPU: without ``--device`` the command
    needs a card, and ``--device cpu`` runs it on the CPU."""
    from jsvx_torch.__main__ import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clip = tmp_path / "clip.jsv"
    clip.write_bytes(streams["tiny"][1])
    args = {"decode": [cmd, str(clip), str(tmp_path / "out")],
            "play": [cmd, str(clip), "--rate", "8"],
            "bench": [cmd, str(clip), "--trace", str(tmp_path / "out")],
            "warm": [cmd, str(clip)]}[cmd]
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_main(args)
    assert not (tmp_path / "out").exists()
    assert cli_main(args + ["--device", "cpu"]) == 0
    assert '"device": "cpu"' in capsys.readouterr().out
