"""The process's parse pool (``jsvx_torch/pipeline/parse_pool.py``) and
``transcode``'s parse fed to it a GOP ahead.

* the compact and dense wires of every GOP are the same bytes whatever
  ``n_parse_threads`` is (1: the serial loop, nothing queued ahead; None
  and 2: the ahead loop), with the pictures cut into one task a picture
  too, on the port's fixture streams, a stream whose first GOP falls back
  to the dense wire and the rendition switch;
* the pool's threads start once: a second call starts none;
* two concurrent calls give what two calls one after the other give;
* the number of tasks a batch is cut into, from its bytes and the CPUs;
* an int ``n_threads`` keeps at most that many of its tasks in flight;
* a task that raises fails its own call, and the next call succeeds.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import jsvx_torch.pipeline.transcode as ttr
from jsvx_torch.bitstream.native import NativeStreamParser
from jsvx_torch.pipeline import packed_parse, parse_pool
from jsvx_torch.pipeline.parallel_parse import parse_stream_parallel
from jsvx_torch.tools import fixture
from jsvx_torch.tools.encoder import EncoderConfig, JsvEncoder

from conftest import synthetic_frames
from test_compact_wire import _duplicate_first_slice

#: seconds a test waits for a thread it started
JOIN_S = 120


class _ZeroPool(packed_parse.BufferPool):
    """A pool whose buffers are fresh and zeroed, so bucket padding and
    the dense planes' unwritten positions are equal bytes in every run."""

    def acquire(self, shape, dtype):
        return np.zeros(shape, dtype)


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**kw)).encode(clip)


STREAMS = {
    "tiny": lambda: _encode(synthetic_frames(6, 48, 64), gop_size=3),
    "tiny_quirk_stream": lambda: _encode(synthetic_frames(6, 48, 64),
                                         gop_size=3, quantizer_scale=4,
                                         me_range=4),
    "small": lambda: _encode(synthetic_frames(10, 96, 112), gop_size=5,
                             quantizer_scale=4),
    # GOP 0's slices overlap: it falls back to the dense wire while GOP 1
    # is queued ahead on the compact one
    "dirty": lambda: _duplicate_first_slice(_encode(
        synthetic_frames(9, 48, 64, seed=13), gop_size=3,
        quantizer_scale=4)),
    "rendition_switch": lambda: fixture.switch_stream(key_map=True),
}


@pytest.fixture(scope="module")
def streams():
    return {name: make() for name, make in STREAMS.items()}


def _wires(monkeypatch, data, quirk, n_threads):
    """Each wire ``transcode`` packs, in GOP order: (spec, bytes)."""
    got = []
    pack = ttr.pack

    def recorded(stacked, pool):
        spec, buf = pack(stacked, pool)
        got.append((spec, buf.tobytes()))
        return spec, buf

    monkeypatch.setattr(ttr, "BufferPool", _ZeroPool)
    monkeypatch.setattr(ttr, "pack", recorded)
    try:
        ttr.transcode(data, device="cpu", quirk_oddify_zeros=quirk,
                      n_parse_threads=n_threads)
    finally:
        monkeypatch.undo()
    return got


@pytest.mark.parametrize("quirk", [False, True], ids=["compact", "dense"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_wires_equal_across_thread_counts_and_the_ahead_loop(
        streams, monkeypatch, name, quirk):
    data = streams[name]
    serial = _wires(monkeypatch, data, quirk, 1)
    assert len(serial) >= 2
    for n_threads in (None, 2):
        assert _wires(monkeypatch, data, quirk, n_threads) == serial, \
            n_threads
    # one task a picture (the pool's threads all busy, GOPs ahead)
    monkeypatch.setattr(parse_pool, "TASK_BYTES", 1)
    try:
        assert _wires(monkeypatch, data, quirk, None) == serial
    finally:
        monkeypatch.undo()


def test_the_dirty_gop_goes_dense_between_compact_gops(streams, monkeypatch):
    """The dirty stream's first GOP is a dense wire, the others compact,
    on the serial and the ahead loop alike."""
    for n_threads in (1, None):
        specs = [spec for spec, _ in _wires(monkeypatch, streams["dirty"],
                                            False, n_threads)]
        compact = ["coef" in {p[0] for p, *_ in spec[0]} for spec in specs]
        assert compact == [False, True, True], n_threads


def test_a_second_call_starts_no_thread(streams, monkeypatch):
    pool = parse_pool.ParsePool()
    monkeypatch.setattr(parse_pool, "POOL", pool)
    data = streams["small"]
    first = ttr.transcode(data, device="cpu")
    assert first.metrics.counters["parse_threads_started"] == pool.workers
    assert pool.workers == parse_pool.cpus()
    before = {t.ident for t in threading.enumerate()}
    for quirk in (False, True):
        again = ttr.transcode(data, device="cpu", quirk_oddify_zeros=quirk)
        assert again.metrics.counters["parse_threads_started"] == 0
    assert {t.ident for t in threading.enumerate()} == before
    # a serial call never touches the pool
    serial = ttr.transcode(data, device="cpu", n_parse_threads=1)
    assert serial.metrics.counters["parse_threads_started"] == 0


def _planes(data, **kw):
    got = []
    ttr.transcode(data, lambda gi, outs: got.append(
        (gi, [o.clone() for o in outs])), device="cpu", **kw)
    return got


def test_concurrent_calls_give_the_serial_calls_planes(streams):
    data = [streams["small"], streams["rendition_switch"]]
    want = [_planes(d) for d in data]
    got = [None, None]
    errors = []

    def call(i):
        try:
            got[i] = _planes(data[i])
        except Exception as e:           # reported below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads) and not errors
    for g, w in zip(got, want):
        assert [gi for gi, _ in g] == [gi for gi, _ in w]
        for (_, a), (_, b) in zip(g, w):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("nbytes,n_items,cpus,want", [
    (0, 18, 8, 1),                  # no bytes: one task
    (1, 18, 8, 1),
    (50_000, 18, 8, 1),
    (50_001, 18, 8, 2),
    (86_376, 18, 8, 2),             # a Video CD GOP
    (86_376, 18, 1, 1),             # one CPU
    (1_075_783, 15, 8, 8),          # a 1080p GOP: every CPU
    (1_075_783, 15, 32, 15),        # ... and no more tasks than pictures
    (1_075_783, 15, 3, 3),
    (250_000, 4, 8, 4),
    (250_000, 18, 8, 5),
])
def test_tasks_follow_bytes_and_cpus(monkeypatch, nbytes, n_items, cpus,
                                     want):
    assert parse_pool.TASK_BYTES == 50_000
    assert parse_pool.task_count(nbytes, n_items, cpus) == want
    # the CPUs are the process's affinity set, not the machine's count
    monkeypatch.setattr(parse_pool.os, "sched_getaffinity",
                        lambda pid: set(range(100, 100 + cpus)))
    pool = parse_pool.ParsePool()
    assert pool.size() == cpus
    lane = parse_pool.Lane(None, pool)
    sizes = [nbytes // n_items] * n_items
    sizes[0] += nbytes - sum(sizes)
    batch = lane.submit(lambda i: None, sizes)
    batch.wait()
    assert batch.tasks == want and pool.workers == cpus
    assert lane.threads_started == cpus


@pytest.mark.parametrize("sizes,k", [
    ([148] + [65] * 14, 8), ([148] + [65] * 14, 15), ([9] + [5] * 17, 2),
    ([1] * 5, 1), ([0] * 4, 3), ([10, 0, 0, 0, 10], 4)])
def test_chunks_are_contiguous_non_empty_and_even(sizes, k):
    got = parse_pool.chunks(sizes, k)
    assert len(got) == k and all(len(c) for c in got)
    assert [i for c in got for i in c] == list(range(len(sizes)))
    if k == 2 and sizes[0] == 9:
        assert [sum(sizes[i] for i in c) for c in got] == [49, 45]


def test_picture_bytes_from_start_bits():
    assert parse_pool.picture_bytes([80, 800, 1600]) == [90, 100, 100]
    assert parse_pool.picture_bytes([80]) == [0]
    assert parse_pool.picture_bytes([]) == []


def test_an_int_keeps_at_most_that_many_tasks_in_flight():
    lock = threading.Lock()
    now, most = [0], [0]

    def task(i):
        with lock:
            now[0] += 1
            most[0] = max(most[0], now[0])
        threading.Event().wait(0.002)
        with lock:
            now[0] -= 1

    lane = parse_pool.Lane(2)
    batches = [lane.submit(task, [10**6] * 6) for _ in range(3)]
    for b in batches:
        b.wait()
    assert [b.tasks for b in batches] == [2, 2, 2] and most[0] <= 2
    with pytest.raises(ValueError, match="n_threads"):
        parse_pool.Lane(0)


def test_a_task_that_raises_fails_its_call_only(streams, monkeypatch):
    data = streams["small"]
    want = _planes(data)
    real = NativeStreamParser.parse_picture_compact
    lock = threading.Lock()
    calls = [0]

    def broken(self, *a, **kw):
        with lock:
            calls[0] += 1
            n = calls[0]
        if n == 7:                       # a picture of GOP 1
            raise ValueError("native compact parse failed: planted")
        return real(self, *a, **kw)

    monkeypatch.setattr(NativeStreamParser, "parse_picture_compact", broken)
    for _ in range(2):
        calls[0] = 0
        with pytest.raises(ValueError, match="planted"):
            ttr.transcode(data, device="cpu")
    monkeypatch.undo()
    got = _planes(data)
    assert [gi for gi, _ in got] == [gi for gi, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the picture-parallel parse shares the pool and its error path
    monkeypatch.setattr(NativeStreamParser, "parse_picture_slices",
                        lambda *a, **kw: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        parse_stream_parallel(data)
    monkeypatch.undo()
    assert len(parse_stream_parallel(data).frames) == 10


def test_many_lanes_at_once_run_every_item_once():
    """More submitting threads than CPUs, on one pool, with the
    interpreter switching threads as often as it can: every item of every
    batch runs exactly once and every wait returns."""
    import sys

    pool = parse_pool.ParsePool()
    ran = np.zeros((16, 5, 40), np.int64)
    errors = []

    def caller(c):
        try:
            lane = parse_pool.Lane(None if c % 2 else 3, pool)
            for b in range(5):
                batch = lane.submit(
                    lambda i, c=c, b=b: ran.__setitem__(
                        (c, b, i), ran[c, b, i] + 1), [10**5] * 40)
                batch.wait()
        except Exception as e:           # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(c,))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert (ran == 1).all()


def test_no_thread_pool_is_built_in_the_pipeline():
    """The pipeline's parses queue on the process's pool: no
    ``ThreadPoolExecutor`` is named anywhere in ``jsvx_torch/pipeline``."""
    import pathlib

    root = pathlib.Path(parse_pool.__file__).parent
    assert [p.name for p in root.glob("*.py")
            if "ThreadPoolExecutor" in p.read_text()] == []
