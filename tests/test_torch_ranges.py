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
