"""The port's sparse byte-range buffer (``jsvx_torch.bitstream.ranges``):
each case of jsvx's ``tests/test_ranges.py`` on the port's copy."""

from jsvx_torch.bitstream.ranges import RangeBuffer


def test_add_and_merge():
    b = RangeBuffer()
    b.add(0, b"aaaa", total=20)
    b.add(10, b"cccc")
    assert b.byte_ranges() == [(0, 3), (10, 13)]
    b.add(4, b"bbbb")                    # adjacent: merges with first
    assert b.byte_ranges() == [(0, 7), (10, 13)]
    b.add(8, b"xy")                      # bridges the hole
    assert b.byte_ranges() == [(0, 13)]
    view, base = b.contiguous_view(0)
    assert bytes(view.tobytes()) == b"aaaabbbbxycccc"


def test_overlap_overwrite():
    b = RangeBuffer()
    b.add(0, b"0123456789")
    b.add(3, b"XYZ")
    view, _ = b.contiguous_view(0)
    assert view.tobytes() == b"012XYZ6789"


def test_has_and_stall_events():
    b = RangeBuffer()
    stalls = []
    b.on("stalled", stalls.append)
    assert not b.has(4)                   # nothing buffered
    assert stalls == [0]
    b.add(0, b"abcd", total=100)
    assert b.has(4)
    assert not b.has(10)
    assert stalls == [0, 4]
    # EOS escape: short data passes when stream end is inside the run
    b2 = RangeBuffer()
    b2.add(0, b"abcd", total=4)
    assert b2.has(100)
    assert b2.fully_loaded


def test_next_range_planning():
    b = RangeBuffer()
    b.add(0, b"x" * 100, total=1000)
    # next hole starts after buffered data
    assert b.next_range_to_download(0, forward_limit=500) == (100, 499)
    b.add(300, b"y" * 100)
    # hole is bounded by the next buffered segment
    assert b.next_range_to_download(0, forward_limit=500) == (100, 299)
    # beyond the forward window -> nothing to do
    assert b.next_range_to_download(600, forward_limit=50) is None
    b.read_pos = 600
    assert b.next_range_to_download(600, forward_limit=50) == (600, 649)


def test_fully_loaded_and_seek():
    b = RangeBuffer()
    b.add(0, b"ab", total=4)
    assert not b.fully_loaded
    b.add(2, b"cd")
    assert b.fully_loaded
    assert b.next_range_to_download(0) is None
    assert b.seek(3)
    assert not b.seek(10)


def test_backward_trimming():
    b = RangeBuffer()
    removed = []
    b.on("bufferremoved", lambda s, e: removed.append((s, e)))
    b.add(0, b"x" * 1000, total=2000)
    b.bytes_backward_limit = 100
    b.advance_to(500)
    assert removed and removed[-1][1] == 399
    assert b.byte_ranges()[0][0] == 400
    # data before keep_from is gone; reads at cursor still work
    assert b.buffered_from(500) == 500


# ---------------------------------------------------------------------------
# The start-code index the buffer keeps, against jsvx's buffer and a fresh
# scan of every segment

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from jsvx.bitstream.ranges import RangeBuffer as JsvxRangeBuffer  # noqa: E402
from jsvx_torch.bitstream.container import find_start_codes  # noqa: E402


def _logged(b):
    log = []
    b.on("stalled", lambda pos: log.append(("stalled", pos)))
    b.on("bufferremoved", lambda s, e: log.append(("bufferremoved", s, e)))
    return log


def _same_state(port, ref):
    assert port.byte_ranges() == ref.byte_ranges()
    assert (port.read_pos, port.fully_loaded) == (ref.read_pos,
                                                  ref.fully_loaded)
    for s, e in ref.byte_ranges():
        want = ref.contiguous_view(s)[0].tobytes()
        assert port.contiguous_view(s)[0].tobytes() == want
        start, n, index = port.start_codes(e)
        assert (start, n) == (s, e - s + 1)
        assert np.array_equal(index.entries, find_start_codes(want, s))
    for pos in (0, ref.read_pos, ref.read_pos + 7):
        assert port.buffered_from(pos) == ref.buffered_from(pos)
        assert (port.next_range_to_download(pos, forward_limit=64)
                == ref.next_range_to_download(pos, forward_limit=64))


@pytest.mark.parametrize("seed", range(16))
def test_start_code_index_follows_adds_trims_and_seeks(seed):
    """Seeded runs of adds (1-3 byte chunks, so codes straddle seams;
    overlapping, overwriting and hole-bridging ones), ``advance_to`` with
    a small backward limit, and seeks: after each step the port's index
    is ``find_start_codes`` over each segment's bytes, and the ranges,
    events and views are jsvx's.  Each add scans its own bytes and at
    most 3 on each side."""
    rng = np.random.default_rng(seed)
    total = 600
    alphabet = np.array([0, 0, 0, 1, 1, 0xB8, 0xC3, 7], np.uint8)
    stream = rng.choice(alphabet, total).tobytes()
    port, ref = RangeBuffer(), JsvxRangeBuffer()
    logs = _logged(port), _logged(ref)
    port.bytes_backward_limit = ref.bytes_backward_limit = int(
        rng.integers(8, 40))
    budget = 0
    for _ in range(300):
        op = rng.random()
        if op < 0.7:
            start = int(rng.integers(0, total))
            n = int(rng.integers(1, 4) if rng.random() < 0.6
                    else rng.integers(4, 60))
            data = (stream[start:start + n] if rng.random() < 0.7
                    else rng.choice(alphabet, n).tobytes())
            data = data[:total - start]
            tot = total if rng.random() < 0.5 else None
            for b in (port, ref):
                b.add(start, data, tot)
            budget += len(data) + 6
        elif op < 0.9:
            pos = max(0, ref.read_pos + int(rng.integers(-10, 40)))
            for b in (port, ref):
                b.advance_to(pos)
        else:
            pos = int(rng.integers(0, total))
            assert port.seek(pos) == ref.seek(pos)
        assert logs[0] == logs[1]
        _same_state(port, ref)
    assert 0 < port.metrics.counters["scanned_bytes"] <= budget
