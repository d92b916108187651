"""The port's command line and fault injection, on the CPU.

The cases of jsvx's ``tests/test_cli_and_chaos.py`` on ``python -m
jsvx_torch`` with ``--device cpu``: ``info``, ``decode --impl oracle``,
``bench --trace``, ``warm``, ``encode``, ``play`` (a file, HTTP, a seek,
a WAV clock, wall-clock pacing), the Decoder's ``iter_frames`` and the
Player over a ``ChaosSource``.  Where both CLIs make the same thing
(``info``'s JSON, the oracle's frames, ``encode``'s bytes, ``bench``'s
stages and counters, ``warm``'s synthesised stream), the port's is held
equal to jsvx's.
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from jsvx.__main__ import main as jsvx_main
from jsvx_torch.__main__ import main as cli_main
from jsvx_torch.api import Decoder, Player, PlayerConfig
from jsvx_torch.pipeline.parse_pool import POOL
from jsvx_torch.runtime.profiler import TRACE_FILE
from jsvx_torch.runtime.source import ChaosSource, MemorySource
from jsvx_torch.tools.encoder import EncoderConfig, JsvEncoder, rgb_to_ycbcr
from jsvx_torch.tools.oracle import decode_stream_oracle

from conftest import synthetic_frames

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    clip = synthetic_frames(6, 48, 64, seed=31)
    data = JsvEncoder(64, 48, EncoderConfig(
        gop_size=3, quantizer_scale=4)).encode(clip)
    path = tmp_path_factory.mktemp("cli") / "clip.jsv"
    path.write_bytes(data)
    return str(path), data, clip


def _json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_info(stream_file, capsys):
    path, data, clip = stream_file
    assert cli_main(["info", path]) == 0
    out = capsys.readouterr().out
    info = json.loads(out)
    assert info["width"] == 64 and info["height"] == 48
    assert info["pictures"] == 6 and info["gops"] == 2
    assert info["gop_key_map"] == 2
    assert jsvx_main(["info", path]) == 0
    assert capsys.readouterr().out == out


@pytest.mark.parametrize("rgb", [True, False])
def test_cli_decode_oracle(stream_file, tmp_path, capsys, rgb):
    """``decode --impl oracle`` runs on the host, with no card asked for,
    and writes jsvx's files byte for byte."""
    path, data, clip = stream_file
    flag = ["--rgb"] if rgb else []
    out = str(tmp_path / "port")
    assert cli_main(["decode", path, out, "--impl", "oracle"] + flag) == 0
    res = _json(capsys)
    assert res["frames"] == 6 and res["device"] == "host"
    ref = str(tmp_path / "jsvx")
    assert jsvx_main(["decode", path, ref, "--impl", "oracle"] + flag) == 0
    capsys.readouterr()
    names = sorted(os.listdir(out))
    assert len(names) == 6 and names == sorted(os.listdir(ref))
    assert names[0].endswith(".ppm" if rgb else ".npz")
    if rgb:
        head = open(os.path.join(out, names[0]), "rb").read(20)
        assert head.startswith(b"P6\n64 48\n255\n")
    for name in names:
        if rgb:
            assert (open(os.path.join(out, name), "rb").read()
                    == open(os.path.join(ref, name), "rb").read())
        else:
            a, b = np.load(os.path.join(out, name)), \
                np.load(os.path.join(ref, name))
            for k in ("y", "cb", "cr"):
                assert np.array_equal(a[k], b[k])


def test_cli_bench_with_device_trace(stream_file, tmp_path, capsys):
    """``bench --trace DIR`` wraps the run in a ``torch.profiler`` trace
    and leaves a Chrome trace behind; its stages and counters are jsvx's
    ``bench``'s, and its parse pool's threads started."""
    path, _, _ = stream_file
    trace_dir = str(tmp_path / "trace")
    assert cli_main(["bench", path, "--trace", trace_dir] + CPU) == 0
    out = _json_block(capsys)
    assert out["trace_dir"] == trace_dir and out["device"] == "cpu"
    assert out["fps_end_to_end"] > 0
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        assert json.load(f)["traceEvents"], "the trace holds no event"
    assert jsvx_main(["bench", path]) == 0
    ref = _json_block(capsys)
    assert set(out["stages"]) == set(ref["stages"]) == {
        "parse", "wire_wait", "device_dispatch", "device_wait"}
    # and the port's count of the parse pool's threads the call started
    counters = dict(out["counters"])
    assert counters.pop("parse_threads_started") in (0, POOL.workers)
    assert counters == ref["counters"] == {"frames": 6, "gops": 2}
    # jsvx's wire also carries its distinct-vector table, the port's not
    assert out["gauges"].keys() == ref["gauges"].keys()
    assert 0 < out["gauges"]["wire_bytes"] < ref["gauges"]["wire_bytes"]


def _json_block(capsys) -> dict:
    """The indented JSON object at the end of the captured output."""
    text = "\n" + capsys.readouterr().out
    return json.loads(text[text.rindex("\n{") + 1:])


def test_cli_warm(stream_file, capsys):
    """``warm CLIP --device cpu`` builds the parser (no kernels on the
    CPU) and reports the first and the second ``transcode``."""
    path, _, _ = stream_file
    assert cli_main(["warm", path] + CPU) == 0
    rep = _json(capsys)
    assert rep["frames"] == 6 and rep["kernels"] is None
    assert os.path.exists(rep["parser"]["path"])
    assert rep["compile_plus_first_decode_s"] > 0
    assert rep["warm_decode_s"] > 0 and rep["warm_fps"] > 0
    # the CPU runs the eager loop: no GOP program is captured
    assert rep["programs"] == rep["second_run_captures"] == 0
    assert rep["capture_s"] == 0.0 and "process" in rep["note"]


def test_cli_warm_shape_synthesises_jsvx_stream(tmp_path, capsys,
                                                monkeypatch):
    """``warm --shape`` encodes jsvx's warm stream, byte for byte.  jsvx's
    ``warm`` points JAX's persistent compile cache at its directory; the
    cache and its settings are put back after it, so a later test in the
    same process (jsvx's ``test_cli_warm_populates_cache``) can point it
    elsewhere."""
    import tempfile

    import jax
    from jax._src import compilation_cache

    assert cli_main(["warm", "--shape", "64x48", "--gop", "2"] + CPU) == 0
    rep = _json(capsys)
    assert rep["frames"] == 4 and rep["device"] == "cpu"
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.setenv("JSVX_JIT_CACHE", str(tmp_path / "jit"))
    settings = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    try:
        assert jsvx_main(["warm", "--shape", "64x48", "--gop", "2"]) == 0
    finally:
        for k, v in settings.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
    ref = _json(capsys)
    with open(rep["stream"], "rb") as f, open(ref["stream"], "rb") as g:
        assert f.read() == g.read()


def test_cli_warm_needs_a_stream_or_a_shape(capsys):
    assert cli_main(["warm"] + CPU) == 2
    assert "need a stream path" in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["npz", "rgb"])
def test_cli_encode_equals_jsvx(stream_file, tmp_path, capsys, kind):
    """``encode`` writes jsvx's bytes for the same ``.npz`` or RGB
    ``.npy``; the stream decodes to the frames given."""
    _, _, clip = stream_file
    if kind == "npz":
        src = str(tmp_path / "frames.npz")
        np.savez(src, y=np.stack([f[0] for f in clip]),
                 cb=np.stack([f[1] for f in clip]),
                 cr=np.stack([f[2] for f in clip]))
    else:
        src = str(tmp_path / "frames.npy")
        rng = np.random.default_rng(5)
        np.save(src, rng.integers(0, 256, (4, 32, 48, 3)).astype(np.uint8))
    out, ref = str(tmp_path / "port.jsv"), str(tmp_path / "jsvx.jsv")
    assert cli_main(["encode", src, out, "--gop", "3", "--q", "4"]) == 0
    rep = _json(capsys)
    assert jsvx_main(["encode", src, ref, "--gop", "3", "--q", "4"]) == 0
    assert _json(capsys) == {k: v for k, v in rep.items() if k != "device"}
    with open(out, "rb") as f, open(ref, "rb") as g:
        data = f.read()
        assert data == g.read()
    frames = decode_stream_oracle(data)
    assert len(frames) == rep["frames"] == (6 if kind == "npz" else 4)
    if kind == "rgb":
        y = rgb_to_ycbcr(np.load(src)[0])[0]
        assert np.abs(frames[0].planes[0][:32, :48].astype(int)
                      - y.astype(int)).mean() < 8


def test_cli_play_realtime(stream_file, capsys):
    """``play`` drives ``Player.run_realtime`` over a file source with a
    headless sink, faster than realtime, and reports at exit."""
    path, _, _ = stream_file
    assert cli_main(["play", path, "--seconds", "20", "--rate", "16"]
                    + CPU) == 0
    rep = _json(capsys)
    assert rep["ended"] is True and rep["error"] is None
    assert rep["frames_shown"] == 6 and rep["device"] == "cpu"
    # 6 frames at 30 fps = 0.2 s of media, one contiguous played range
    assert rep["played_ranges"] == [[0.0, 0.2]]
    assert rep["events"]["playing"] >= 1 and rep["events"]["ended"] == 1
    assert rep["event_order"][0] == "loadstart"
    assert rep["event_order"][-1] == "ended"
    assert rep["events"].get("canplay", 0) >= 1


def test_cli_play_over_http(stream_file, capsys):
    """``play http://...``: ranged HTTP fetch -> sparse buffer -> decode
    -> realtime clock -> sink, against a local server."""
    _, data, _ = stream_file

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_HEAD(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()

        def do_GET(self):
            rng = self.headers.get("Range")
            if rng:
                s, e = rng.split("=")[1].split("-")
                s = int(s)
                e = min(int(e) if e else len(data) - 1, len(data) - 1)
                body = data[s:e + 1]
                self.send_response(206)
                self.send_header("Content-Range",
                                 f"bytes {s}-{e}/{len(data)}")
            else:
                body = data
                self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/clip.jsv"
        assert cli_main(["play", url, "--seconds", "20", "--rate", "16"]
                        + CPU) == 0
        rep = _json(capsys)
        assert rep["ended"] is True and rep["error"] is None
        assert rep["frames_shown"] == 6
        # ranged-HTTP chunk delivery fired progress events
        assert rep["events"].get("progress", 0) >= 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_cli_play_with_start_seek(stream_file, capsys):
    """``play --start T`` seeks (key-map assisted, <= 150 ms) before the
    realtime loop: the played range starts at the second GOP."""
    path, _, _ = stream_file
    assert cli_main(["play", path, "--seconds", "20", "--rate", "16",
                     "--start", "0.19"] + CPU) == 0
    rep = _json(capsys)
    assert rep["ended"] is True and rep["error"] is None
    assert rep["frames_shown"] == 3
    (a, b), = rep["played_ranges"]
    assert abs(a - 0.1) <= 0.151 and abs(b - 0.2) < 1e-6


def test_cli_play_with_wav_audio_clock(stream_file, tmp_path, capsys):
    """``play --audio X.wav`` syncs against a ``WallClockAudio`` parsed
    from a RIFF/WAVE header."""
    path, _, _ = stream_file
    byte_rate = 8000
    fmt = (b"fmt " + (16).to_bytes(4, "little")
           + (1).to_bytes(2, "little") + (1).to_bytes(2, "little")
           + (8000).to_bytes(4, "little")
           + byte_rate.to_bytes(4, "little")
           + (1).to_bytes(2, "little") + (8).to_bytes(2, "little"))
    dat = b"data" + (4000).to_bytes(4, "little") + bytes(4000)  # 0.5 s
    body = b"WAVE" + fmt + dat
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"RIFF" + len(body).to_bytes(4, "little") + body)
    assert cli_main(["play", path, "--seconds", "20", "--rate", "8",
                     "--audio", str(wav)] + CPU) == 0
    rep = _json(capsys)
    assert rep["ended"] is True and rep["frames_shown"] == 6


def test_cli_play_wall_clock_pacing(stream_file, capsys):
    """At rate 1.0 the realtime loop paces frames by the stream clock: a
    0.2 s clip takes >= 0.15 s of wall time and shows every frame."""
    import time

    path, _, _ = stream_file
    t0 = time.monotonic()
    assert cli_main(["play", path, "--seconds", "20"] + CPU) == 0
    wall = time.monotonic() - t0
    rep = _json(capsys)
    assert rep["frames_shown"] == 6 and rep["ended"] is True
    assert wall >= 0.15


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_decoder_iter_frames(stream_file, backend):
    _, data, clip = stream_file
    dec = Decoder(PlayerConfig(), backend=backend, device="cpu")
    dec.feed(0, data, len(data))
    frames = list(dec.iter_frames())
    assert len(frames) == 6 and dec.ended


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_player_survives_chaotic_network(stream_file, backend):
    """Dropped chunks make holes in the buffer; stall and refill heal."""
    _, data, clip = stream_file
    p = Player(PlayerConfig(chunk_size=300), backend=backend, device="cpu")
    chaotic = ChaosSource(MemorySource(data), drop_rate=0.4, seed=3)
    # inject by bypassing source_for
    p._sources = [type("V", (), {"src": data, "bitrate": 0})()]
    p._reset_for_source()
    p.emit("loadstart")
    p._source = chaotic
    p._request_range(0)
    p.play()
    shown = []
    p.set_frame_sink(lambda f, t: shown.append(t))
    t = 0.0
    for _ in range(400):
        t += 1 / 30.0
        p.tick(t)
        if p.ended:
            break
    assert len(shown) == len(clip), f"only {len(shown)} frames shown"
    assert p.ended


def test_chaos_error_path(stream_file):
    _, data, _ = stream_file
    p = Player(PlayerConfig(), backend="oracle", device="cpu")
    errors = []
    p.on("error", errors.append)
    p._sources = [type("V", (), {"src": data, "bitrate": 0})()]
    p._reset_for_source()
    p._source = ChaosSource(MemorySource(data), error_rate=1.0)
    p._request_range(0)
    assert errors and errors[0].code == errors[0].MEDIA_ERR_NETWORK
