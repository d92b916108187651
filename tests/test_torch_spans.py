"""The span log (``jsvx_torch/runtime/profiler.py``): what the program logs
while a torch profiler records, on the profiler's clock; nothing without
one; the spans merged into ``device_trace``'s Chrome trace; and the eight
benchmark readers that read the log (``jsvbench/metrics``), on a known log
and known device intervals."""

from __future__ import annotations

import ast
import gc
import json
import os
import pathlib
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from jsvbench import manifest
from jsvbench.work import Window
from jsvx_torch.api import Player, PlayerConfig
from jsvx_torch.pipeline import parse_pool, program
from jsvx_torch.pipeline.transcode import transcode
from jsvx_torch.runtime import profiler
from jsvx_torch.tools.encoder import EncoderConfig, JsvEncoder

from conftest import synthetic_frames

TRANSCODE_STAGES = {"parse", "wire_wait", "device_dispatch", "device_wait",
                    "sink"}
RANGE = "test_torch_spans.call"


@pytest.fixture(scope="module")
def stream():
    clip = synthetic_frames(9, 48, 64, seed=21)
    return JsvEncoder(64, 48, EncoderConfig(gop_size=3, quantizer_scale=4,
                                            me_range=4)).encode(clip)


def _traced(fn):
    """``fn()`` inside a CPU profiler and a ``record_function`` range of
    the test's own -> (the log's entries of the range, its drops, the
    range's kineto start and end (ns), fn's result)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with record_function(RANGE):
            out = fn()
        t1 = time.time_ns()
    got, dropped = profiler.spans(t0, t1)
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == RANGE)
    return got, dropped, (ev.start_ns(), ev.end_ns()), out


def _named(got, name):
    return [e for e in got if e[0] == name]


def test_transcode_spans_a_call_its_walk_and_each_gop(stream):
    program.CACHE.clear()
    sunk = []
    got, dropped, (r0, r1), res = _traced(lambda: transcode(
        stream, lambda gi, outs: sunk.append(gi), device="cpu"))
    assert dropped == 0 and res.n_gops == 3 and sunk == [0, 1, 2]
    root, = _named(got, "transcode")
    assert root[4]["gops"] == 3 and root[4]["route"] == "compact"
    walk, = _named(got, "walk")
    assert walk[4] == {"gops": 3, "pictures": 9}
    parses = _named(got, "parse")
    first = min(parses, key=lambda e: e[1])
    assert "gop" not in first[4]        # the call's first parse: the walk
    assert first[1] <= walk[1] <= walk[2] <= first[2]
    assert len(_named(got, "call_setup")) == len(_named(got, "call_close"))
    assert len(_named(got, "call_setup")) == 1
    for stage in TRANSCODE_STAGES:
        gops = sorted(e[4]["gop"] for e in _named(got, stage)
                      if "gop" in e[4])
        assert gops == [0, 1, 2], stage
    assert {e[4]["wire"] for e in parses if "gop" in e[4]} == {"compact"}
    # every span and event inside the call, the call inside the test's
    # range on kineto's clock (within 1 ms)
    for name, s, e, tid, _ in got:
        assert root[1] <= s <= e <= root[2], name
        assert tid == root[3]
    assert r0 - 1_000_000 <= root[1] and root[2] <= r1 + 1_000_000
    # the program cache: one checkout a key, a build; the next call hits
    builds = _named(got, "checkout")
    assert builds and all(not e[4]["hit"] and e[1] == e[2] for e in builds)
    assert len({e[4]["key"] for e in builds}) == len(builds)
    again, _, _, _ = _traced(lambda: transcode(stream, device="cpu"))
    hits = _named(again, "checkout")
    assert sorted(e[4]["key"] for e in hits) == sorted(
        e[4]["key"] for e in builds)
    assert all(e[4]["hit"] for e in hits)


def test_the_dense_route_spans_its_parses(stream):
    got, dropped, _, res = _traced(lambda: transcode(
        stream, device="cpu", quirk_oddify_zeros=True))
    assert dropped == 0
    root, = _named(got, "transcode")
    assert root[4] == {"call": root[4]["call"], "route": "dense", "gops": 3}
    assert sorted(e[4]["gop"] for e in _named(got, "parse")
                  if "gop" in e[4]) == [0, 1, 2]
    assert {e[4]["wire"] for e in _named(got, "parse")
            if "gop" in e[4]} == {"dense"}


@pytest.mark.parametrize("quirk", [False, True], ids=["compact", "dense"])
@pytest.mark.parametrize("task_bytes", [None, 1], ids=["rule", "per_picture"])
def test_each_parse_span_has_its_tasks_and_whether_it_was_queued_ahead(
        stream, monkeypatch, quirk, task_bytes):
    """On the pool every GOP but the first was queued before the previous
    GOP was packed; one thread queues nothing ahead.  A 48x64 GOP is far
    under ``TASK_BYTES``: one task; with a byte a task, one a picture up
    to the int's or the CPUs' count.  The call's ``parse_threads_started``
    stays 0 once the pool runs."""
    transcode(stream, device="cpu")             # the pool's threads start
    if task_bytes is not None:
        monkeypatch.setattr(parse_pool, "TASK_BYTES", task_bytes)
    many = task_bytes is not None
    for n_threads, ahead, tasks in (
            (None, [False, True, True], min(3, parse_pool.cpus()) if many
             else 1),
            (1, [False, False, False], 1),
            (2, [False, True, True], 2 if many else 1)):
        got, dropped, _, res = _traced(lambda: transcode(
            stream, device="cpu", quirk_oddify_zeros=quirk,
            n_parse_threads=n_threads))
        assert dropped == 0
        parses = sorted((e for e in _named(got, "parse") if "gop" in e[4]),
                        key=lambda e: e[4]["gop"])
        assert [e[4]["ahead"] for e in parses] == ahead, n_threads
        assert [e[4]["tasks"] for e in parses] == [tasks] * 3, n_threads
        assert set(parses[0][4]) == {"gop", "wire", "tasks", "ahead"}
        assert res.metrics.counters["parse_threads_started"] == 0


def test_without_a_profiler_the_log_gains_nothing(stream):
    assert profiler.span("x") is profiler.span("y", gop=1)   # one no-op
    t0 = time.time_ns()
    untraced = transcode(stream, lambda gi, outs: None, device="cpu")
    player = Player(PlayerConfig(emit_rgb=True), device="cpu")
    _play(player, stream)
    assert profiler.spans(t0, time.time_ns()) == ([], 0)
    # the stage, counter and gauge names are jsvx's, traced or not, and
    # the port's count of the parse pool's threads each call started
    _, _, _, traced = _traced(lambda: transcode(
        stream, lambda gi, outs: None, device="cpu"))
    for res in (untraced, traced):
        assert set(res.metrics.timers.report()) == TRANSCODE_STAGES
        counters = dict(res.metrics.counters)
        assert counters.pop("parse_threads_started") in (
            0, parse_pool.POOL.workers)
        assert counters == {"frames": 9, "gops": 3}
        assert set(res.metrics.gauges) == {"width", "height", "wire_bytes"}
    assert traced.metrics.counters["parse_threads_started"] == 0
    assert traced.metrics.timers.counts == untraced.metrics.timers.counts


def _play(player, data):
    shown = []
    player.set_frame_sink(lambda frame, t: shown.append(t))
    player.src = data
    player.play()
    t = 0.0
    while not player.ended and t < 5.0:
        t += 1 / 30.0
        player.tick(t)
    assert player.ended
    return shown


def test_player_spans_ticks_the_decoder_and_the_display(stream):
    player = Player(PlayerConfig(emit_rgb=True), device="cpu")
    got, dropped, (r0, r1), shown = _traced(lambda: _play(player, stream))
    assert dropped == 0 and len(shown) == 9
    names = {e[0] for e in got}
    assert {"tick", "fill", "parse", "scan", "buffer_copy",
            "picture_parse", "to_rgb", "sink", "pack", "h2d",
            "device_decode"} <= names
    assert sorted(e[4]["frame"] for e in _named(got, "to_rgb")) == list(
        range(9))
    assert sorted(e[4]["frame"] for e in _named(got, "sink")) == list(
        range(9))
    assert sorted(e[4]["picture"] for e in _named(got, "picture_parse")) \
        == list(range(9))
    assert all(e[4]["pictures"] == 3 for e in _named(got, "pack"))
    fills = _named(got, "fill")
    assert all(e[4]["after"] >= e[4]["before"] for e in fills)
    # the Decoder's parse of each GOP batch holds its picture parses
    parses = _named(got, "parse")
    assert len(parses) == 3
    for _, s, e, _, _ in _named(got, "picture_parse"):
        assert any(p[1] <= s <= e <= p[2] for p in parses)
    for _, s, e, _, _ in got:
        assert r0 - 1_000_000 <= s <= e <= r1 + 1_000_000


def test_device_trace_merges_the_spans_into_its_trace(stream, tmp_path):
    path = str(tmp_path / "t")
    with profiler.device_trace(path, "cpu"):
        with record_function(RANGE):
            transcode(stream, device="cpu")
    with open(os.path.join(path, profiler.TRACE_FILE)) as f:
        trace = json.load(f)
    ev = trace["traceEvents"]
    rng, = [e for e in ev if e.get("name") == RANGE and e.get("ph") == "X"]
    mine = [e for e in ev if e.get("cat") == "jsvx_torch"]
    assert trace["jsvx_torch_spans_dropped"] == 0
    assert {"transcode", "walk", "parse", "device_dispatch", "checkout"} \
        <= {e["name"] for e in mine}
    for e in mine:
        assert e["pid"] == rng["pid"] and e["tid"] == rng["tid"]
        end = e["ts"] + e.get("dur", 0)
        assert rng["ts"] - 1e3 <= e["ts"] <= end <= \
            rng["ts"] + rng["dur"] + 1e3, e
    assert {e["ph"] for e in mine} == {"X", "i"}    # checkouts: instants
    assert "gop" in next(e for e in mine if e["name"] == "device_dispatch"
                         )["args"]


def test_card_tests_stage_timer_runs_transcode_and_logs_its_stages(stream):
    """``tests/torch_card.py``'s ``StageWatch``, the ``StageTimer``
    subclass the card's tests watch ``transcode`` with, which overrides
    ``stage``, runs ``transcode`` on both routes, untraced and traced,
    and passes the stages' attrs and span through."""
    import torch_card
    dev = torch.device("cpu")
    for quirk in (False, True):
        out = torch_card.watched_transcode(stream, dev, quirk=quirk)
        assert out["res"].n_gops == 3 and len(out["frames"]) == 9
        got, dropped, _, traced = _traced(
            lambda q=quirk: torch_card.watched_transcode(stream, dev,
                                                          quirk=q))
        assert dropped == 0 and len(traced["frames"]) == 9
        for a, b in zip(out["frames"], traced["frames"]):
            assert all((x == y).all() for x, y in zip(a, b))
        for stage in ("parse", "device_dispatch", "device_wait", "sink"):
            assert sorted(e[4]["gop"] for e in _named(got, stage)
                          if "gop" in e[4]) == [0, 1, 2], stage
    timer = torch_card.StageWatch([])
    got, _, _, _ = _traced(lambda: _set_in_stage(timer))
    assert _named(got, "parse")[0][4] == {"gop": 4, "wire": "dense"}
    assert timer.spans == [("parse", 0, 0)] and timer.counts["parse"] == 1


def _set_in_stage(timer):
    with timer.stage("parse", gop=4, wire="compact") as s:
        s.set(wire="dense")


def test_a_span_on_another_thread_carries_that_threads_id():
    ids = []

    def work():
        ids.append(threading.get_native_id())
        with profiler.span("worker"):
            pass

    def run():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with profiler.span("main"):
            pass
    got, dropped, _, _ = _traced(run)
    (worker,), (main,) = _named(got, "worker"), _named(got, "main")
    assert dropped == 0 and worker[3] == ids[0] != main[3]
    assert main[3] == threading.get_native_id()


def test_the_log_is_bounded_and_counts_its_drops():
    log = profiler.SpanLog(capacity=3)
    for i in range(5):
        log.add("s", 10 * i, 10 * i + 5, {"i": i})
    got, dropped = log.window(0, 100)
    assert [e[4]["i"] for e in got] == [2, 3, 4] and dropped == 2
    assert got[0] == ("s", 20, 25, got[0][3], {"i": 2})
    assert log.window(12, 100) == (got, 2)
    # the oldest entry kept ended before 26, and so did every drop
    assert log.window(26, 100) == (got[1:], 0)
    assert profiler.LOG_ENTRIES == 1 << 17


def test_an_entry_keeps_no_object_for_the_garbage_collector():
    """The log's entries leave the collector's count of live container
    objects as they found it, so tracing does not change when the
    program's own objects are collected."""
    log = profiler.SpanLog(capacity=64)
    log.add("s", 0, 1, {})                  # the slots, made once
    gc.disable()
    try:
        before = gc.get_count()[0]
        for i in range(1000):
            log.add("parse", i, i + 1, {"gop": i, "wire": "dense"})
        grew = gc.get_count()[0] - before
    finally:
        gc.enable()
    assert grew < 10
    got, dropped = log.window(0, 2000)
    assert dropped == 1000 + 1 - 64 and len(got) == 64
    assert got[-1] == ("parse", 999, 1000, got[-1][3],
                       {"gop": 999, "wire": "dense"})
    log.add("many", 0, 0, {f"a{k}": k for k in range(6)})
    assert log.window(0, 0)[0][-1][4] == {
        f"a{k}": k for k in range(profiler.MAX_ATTRS)}


def test_the_program_opens_no_record_function_range():
    root = pathlib.Path(profiler.__file__).parents[1]
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = {n.attr if isinstance(n, ast.Attribute) else n.id
                 for n in ast.walk(tree)
                 if isinstance(n, (ast.Attribute, ast.Name))}
        assert "record_function" not in names, path


# ---------------------------------------------------------------------------
# The readers, on a known log and known device intervals

MS = 1_000_000
#: (name, start ms, end ms, attrs): a call with its walk in its first parse,
#: a second parse, two replays; a Player's parse, scans and copies
LOG = [("transcode", 0, 100, {}), ("parse", 0, 30, {}), ("walk", 0, 15, {}),
       ("parse", 40, 55, {"gop": 0}), ("device_dispatch", 55, 58, {}),
       ("replay", 56, 57, {}), ("replay", 70, 71, {}),
       ("checkout", 50, 50, {"hit": False}),
       ("tick", 0, 100, {}), ("scan", 1, 4, {}), ("scan", 41, 43, {}),
       ("buffer_copy", 5, 6, {}), ("buffer_copy", 44, 47, {})]
#: the device busy over [10, 20] and [50, 60] ms of a [0, 100] ms window:
#: idle [0, 10], [20, 50], [60, 100] = 80 ms
BUSY = [(10 * MS, 20 * MS), (50 * MS, 60 * MS)]
#: parse spans [0, 30] u [40, 55]: idle inside 10 + 10 + 10 ms; the
#: non-root spans [0, 30] u [40, 58] u [70, 71]: idle inside 31 ms
WANT = {"walk_ms_per_call.transcode": 15.0,
        "replay_ms_per_gop.transcode": 1.0,
        "idle_in_parse_pct.transcode": 30.0,
        "idle_unattributed_pct.transcode": 49.0,
        "scan_ms_per_frame.play": 1.0,
        "buffer_copy_ms_per_frame.play": 0.8,
        "idle_in_parse_pct.play": 30.0,
        "idle_unattributed_pct.play": 49.0}


class _Record:
    def __init__(self):
        self.units = {"calls": 1, "gops": 2, "frames": 5}
        self.window = Window(True)
        self.window.start, self.window.end = 0, 100 * MS
        self.window.device_intervals = list(BUSY)


def _log(entries, dropped):
    def spans(start, end):
        return [(n, s * MS, e * MS, 1, a) for n, s, e, a in entries
                if start <= s * MS and e * MS <= end], dropped
    return spans


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_known_log(name, monkeypatch):
    spec = next(m for m in manifest.load()["per_layer"]
                if m["name"] == name)
    assert spec["workloads"] and spec["moves"] in ("transcode_fps",
                                                   "play_fps")
    reader = manifest.load_module("metrics", name)
    monkeypatch.setattr(profiler, "spans", _log(LOG, 0))
    assert reader.read(_Record()) == pytest.approx(WANT[name])
    monkeypatch.setattr(profiler, "spans", _log(LOG, 1))
    assert reader.read(_Record()) is None           # the log dropped
    monkeypatch.setattr(profiler, "spans", _log([], 0))
    assert reader.read(_Record()) is None           # nothing logged
    monkeypatch.delattr(profiler, "spans")
    assert reader.read(_Record()) is None           # a program without it
