"""Sparse byte-range stream buffer with download planning and trimming.

The TPU-framework analog of the reference's linked-list-of-buffers
BitReader (``features/bitreader.js``): holds possibly-holey byte ranges of
the stream, answers availability queries (emitting ``stalled`` with the
missing offset), plans the next range to download against a forward-buffer
window, trims the backward buffer to a byte budget, and exposes
``buffered`` ranges for the player's TimeRanges surface.

Data is stored in merged contiguous segments (numpy copies) rather than a
linked list of chunks: merge-on-insert keeps reads O(log n_segments) and
hands the parser flat contiguous spans.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

import numpy as np

from ..runtime.profiler import span
from ..utils.events import EventDispatcher


@dataclass
class _Segment:
    start: int
    data: bytearray

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

    def __init__(self):
        super().__init__()
        self._segs: list[_Segment] = []
        self.total_length: int = 0         # 0 until known
        self.fully_loaded = False
        self.read_pos = 0                  # decoder's current byte
        self.bytes_backward_limit: int | None = None

    # -- ingest --------------------------------------------------------

    def add(self, start: int, data: bytes, total: int | None = None) -> None:
        """Insert a downloaded chunk (sorted insert + merge)."""
        if total:
            self.total_length = total
        if not data:
            return
        end = start + len(data) - 1
        new = _Segment(start, bytearray(data))
        merged: list[_Segment] = []
        for seg in self._segs:
            if seg.end + 1 < new.start:
                merged.append(seg)
            elif new.end + 1 < seg.start:
                break
            else:
                # overlap/adjacent: splice
                if seg.start < new.start:
                    head = seg.data[:new.start - seg.start]
                    new.data = head + new.data
                    new.start = seg.start
                if seg.end > new.end:
                    new.data = new.data + seg.data[new.end + 1 - seg.start:]
        keep_tail = [s for s in self._segs
                     if s.start > new.end + 1]
        self._segs = merged + [new] + keep_tail
        if (self.total_length
                and self.buffered_from(0) >= self.total_length):
            self.fully_loaded = True

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
        with span("buffer_copy", bytes=len(seg.data)):
            data = bytes(seg.data)
        return np.frombuffer(data, dtype=np.uint8), seg.start

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
                with span("buffer_copy", bytes=len(s.data) - drop):
                    s.data = s.data[drop:]
                s.start = keep_from
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
