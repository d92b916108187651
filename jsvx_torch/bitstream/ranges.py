"""Sparse byte-range stream buffer with download planning and trimming.

The TPU-framework analog of the reference's linked-list-of-buffers
BitReader (``features/bitreader.js``): holds possibly-holey byte ranges of
the stream, answers availability queries (emitting ``stalled`` with the
missing offset), plans the next range to download against a forward-buffer
window, trims the backward buffer to a byte budget, and exposes
``buffered`` ranges for the player's TimeRanges surface.

Data is stored in merged contiguous segments (``bytearray``s) rather than
a linked list of chunks: merge-on-insert keeps reads O(log n_segments) and
hands the parser flat contiguous spans.  Each segment keeps its start-code
index (absolute offsets) across appends, merges, overwrites and trims: an
``add`` scans only the bytes it brought, plus 3 on each side for codes
that straddle a seam, and a trim drops the entries below the new start.
Trims and appends work in place, so the bytes left are never copied.  A
``bytearray`` cannot be resized while a view of it is alive, so nothing
outside this module holds one: readers get copies (:meth:`read`).

``metrics`` counts ``scanned_bytes`` (the bytes handed to the start-code
scanner) and ``copied_bytes`` (the bytes copied out for readers and
views).
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

import numpy as np

from ..runtime.profiler import Metrics, span
from ..utils.events import EventDispatcher
from .container import StartCodeIndex, find_start_codes

_NO_CODES = np.empty((0, 2), dtype=np.int64)


@dataclass
class _Segment:
    start: int
    data: bytearray
    # find_start_codes(data, start): int64[n, 2] of (offset, code)
    codes: np.ndarray = field(default_factory=lambda: _NO_CODES)

    @property
    def end(self) -> int:                  # inclusive, reference convention
        return self.start + len(self.data) - 1


class RangeBuffer(EventDispatcher):
    """Sparse byte store for a single remote/local stream.

    Events (mirroring ``features/bitreader.js``):

    * ``stalled``(needed_byte) — a query needed unbuffered data;
    * ``bufferadvance``()      — the read cursor crossed into new data;
    * ``bufferremoved``(start, end) — a backward range was trimmed.
    """

    def __init__(self, metrics: Metrics | None = None):
        super().__init__()
        self.metrics = Metrics() if metrics is None else metrics
        self._segs: list[_Segment] = []
        self.total_length: int = 0         # 0 until known
        self.fully_loaded = False
        self.read_pos = 0                  # decoder's current byte
        self.bytes_backward_limit: int | None = None

    # -- ingest --------------------------------------------------------

    def add(self, start: int, data: bytes, total: int | None = None) -> None:
        """Insert a downloaded chunk (sorted insert + merge; the new bytes
        win where they overlap buffered ones)."""
        if total:
            self.total_length = total
        if not data:
            return
        end = start + len(data) - 1
        segs = self._segs
        lo = 0
        while lo < len(segs) and segs[lo].end + 1 < start:
            lo += 1
        hi = lo
        while hi < len(segs) and segs[hi].start <= end + 1:
            hi += 1
        if lo == hi:
            seg = _Segment(start, bytearray(data))
            head = tail = _NO_CODES
        else:
            first, last = segs[lo], segs[hi - 1]
            head = first.codes[:np.searchsorted(first.codes[:, 0],
                                                start - 3)]
            tail = last.codes[np.searchsorted(last.codes[:, 0], end,
                                              side="right"):]
            if first.start <= start and end <= first.end:
                seg = first                 # an overwrite inside a segment
                seg.data[start - seg.start:end + 1 - seg.start] = data
            else:
                if first.start <= start:
                    seg = first             # an append to its end
                    del seg.data[start - seg.start:]
                    seg.data += data
                else:
                    seg = _Segment(start, bytearray(data))
                if last.end > end:          # bridges up to ``last``
                    seg.data += memoryview(last.data)[end + 1 - last.start:]
        seg.codes = np.concatenate([head, self._scan(seg, start - 3, end + 4),
                                    tail])
        self._segs = segs[:lo] + [seg] + segs[hi:]
        if (self.total_length
                and self.buffered_from(0) >= self.total_length):
            self.fully_loaded = True

    def _scan(self, seg: _Segment, lo: int, hi: int) -> np.ndarray:
        """The start codes of ``seg`` whose four bytes lie in [lo, hi)."""
        lo, hi = max(lo, seg.start), min(hi, seg.end + 1)
        n = max(0, hi - lo)
        with span("scan", bytes=n):
            view = np.frombuffer(seg.data, dtype=np.uint8, count=n,
                                 offset=lo - seg.start)
            codes = find_start_codes(view, lo)
            del view                        # the segment may resize again
        self.metrics.count("scanned_bytes", n)
        return codes

    # -- queries -------------------------------------------------------

    def _seg_at(self, pos: int) -> _Segment | None:
        i = bisect_right([s.start for s in self._segs], pos) - 1
        if i >= 0 and self._segs[i].end >= pos:
            return self._segs[i]
        return None

    def buffered_from(self, pos: int) -> int:
        """Contiguous bytes available starting at ``pos``."""
        seg = self._seg_at(pos)
        return 0 if seg is None else seg.end - pos + 1

    def has(self, n_bytes: int, pos: int | None = None) -> bool:
        """Availability gate with the reference's end-of-stream escape
        (bitreader.js:135-162): short data still passes when the stream
        end is within the contiguous run."""
        pos = self.read_pos if pos is None else pos
        seg = self._seg_at(pos)
        if seg is None:
            self.emit("stalled", pos)
            return False
        avail = seg.end - pos + 1
        if avail >= n_bytes:
            return True
        if self.total_length and seg.end + 1 >= self.total_length:
            return True
        self.emit("stalled", seg.end + 1)
        return False

    def contiguous_view(self, pos: int) -> tuple[np.ndarray, int] | None:
        """(array, start) of the contiguous segment containing ``pos``."""
        seg = self._seg_at(pos)
        if seg is None:
            return None
        return np.frombuffer(self.read(seg.start, seg.end + 1),
                             dtype=np.uint8), seg.start

    def read(self, lo: int, hi: int) -> bytes:
        """A copy of the bytes [lo, hi), cut at the end of the contiguous
        segment that holds ``lo`` (which must be buffered)."""
        seg = self._seg_at(lo)
        a, b = lo - seg.start, min(hi, seg.end + 1) - seg.start
        with span("buffer_copy", bytes=b - a):
            out = memoryview(seg.data)[a:b].tobytes()
        self.metrics.count("copied_bytes", b - a)
        return out

    def start_codes(self, pos: int) -> tuple[int, int, StartCodeIndex] | None:
        """(start, length, start-code index) of the contiguous segment
        containing ``pos``; the index holds absolute offsets."""
        seg = self._seg_at(pos)
        if seg is None:
            return None
        return seg.start, len(seg.data), StartCodeIndex(seg.codes)

    def byte_ranges(self) -> list[tuple[int, int]]:
        """Merged (start, end_inclusive) list — the ``buffered`` surface."""
        return [(s.start, s.end) for s in self._segs]

    # -- cursor / trimming ---------------------------------------------

    def advance_to(self, pos: int) -> None:
        old = self.read_pos
        self.read_pos = pos
        if pos > old:
            self.emit("bufferadvance")
            self._trim_backward()

    def seek(self, pos: int) -> bool:
        """Position the cursor; False (+stalled) when ``pos`` unbuffered
        (bitreader.js:606-667)."""
        if self._seg_at(pos) is None:
            self.emit("stalled", pos)
            return False
        self.read_pos = pos
        return True

    def _trim_backward(self) -> None:
        limit = self.bytes_backward_limit
        if limit is None:
            return
        keep_from = max(0, self.read_pos - limit)
        out = []
        for s in self._segs:
            if s.end < keep_from:
                self.emit("bufferremoved", s.start, s.end)
                continue
            if s.start < keep_from <= s.end:
                drop = keep_from - s.start
                self.emit("bufferremoved", s.start, keep_from - 1)
                del s.data[:drop]           # moves the start: no copy
                s.start = keep_from
                s.codes = s.codes[np.searchsorted(s.codes[:, 0], keep_from):]
            out.append(s)
        self._segs = out

    # -- download planning ---------------------------------------------

    def next_range_to_download(self, start: int | None = None,
                               forward_limit: int = 1 << 30,
                               seeking: bool = False
                               ) -> tuple[int, int | None] | None:
        """Next hole to fetch, clipped to the forward-buffer window
        (bitreader.js:245-297).  Returns (start, end_inclusive|None=EOS)
        or None when nothing (useful) is missing."""
        if start is None:
            start = self.read_pos
        if self.fully_loaded or (self.total_length
                                 and start >= self.total_length):
            return None
        # extend start past contiguously buffered data
        seg = self._seg_at(start)
        if seg is not None:
            s = seg.end + 1
        else:
            s = start
        # find the next buffered segment after s to bound the hole
        nxt = None
        for sg in self._segs:
            if sg.start > s:
                nxt = sg.start
                break
        end = (nxt - 1) if nxt is not None else None

        anchor = s if (seeking or self._seg_at(self.read_pos) is None) \
            else self.read_pos
        limit = anchor + forward_limit - 1
        if s > limit:
            return None
        if end is not None and end > limit:
            end = limit
        elif end is None and self.total_length:
            end = min(limit, self.total_length - 1)
        if self.total_length and s >= self.total_length:
            return None
        return (s, end)
