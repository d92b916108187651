"""JSV container layer: file header, GOP key map, start-code scanning.

Container layout (reference ``decoders/jsv.js:237-313``):

    16 bits   reserved/magic (skipped by the decoder)
    16 bits   width
    16 bits   height
    16 bits   duration * 100    -- if zero, an extended form follows:
      1 bit   yuva flag (4th alpha component plane)
     23 bits  duration * 100
    optional GOP key-map section:
     32 bits  0x000001C4 (START_MAP start code)
     32 bits  GOP count
     count * 8 bytes key-map entries:
        u32 BE   byte offset of the GOP's sequence header
        u32 BE   packed timecode: bit31 unused, hour(5), minute(6),
                 marker(1), second(6), frame(6), 7 unused low bits
                 (``decoders/jsv.js:315-326``)
    then the MPEG-1-style elementary stream (start codes 00 00 01 xx).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import tables as T
from .bitio import BitReader


@dataclass
class GopKeyMap:
    """Seek index: per-GOP byte offset and timecode."""

    offsets: np.ndarray          # uint32[count] byte offset of GOP
    times: np.ndarray            # float64[count] seconds (excl. +1 frame bias)
    raw_timecodes: np.ndarray    # uint32[count] packed timecodes

    @property
    def count(self) -> int:
        return len(self.offsets)

    def time_of(self, gop_number: int, picture_rate: float) -> float:
        """Reference time formula incl. its (frame+1)/rate bias
        (``decoders/jsv.js:315-326``)."""
        tc = int(self.raw_timecodes[gop_number])
        hour = (tc >> 26) & 0x1F
        minute = (tc >> 20) & 0x3F
        second = (tc >> 13) & 0x3F
        frame = (tc >> 7) & 0x3F
        return (hour * 60 + minute) * 60 + second + (frame + 1) / picture_rate

    def byte_for_time(self, t: float, duration: float,
                      picture_rate: float) -> int:
        """Guess-then-scan lookup mirroring ``_getByteFromKeyMap``
        (``decoders/jsv.js:327-350``)."""
        n = self.count
        g = min(int(n * t / duration), n - 1) if duration > 0 else 0
        time = self.time_of(g, picture_rate)
        if time > t:
            while time > t and g > 0:
                g -= 1
                time = self.time_of(g, picture_rate)
        elif time < t:
            while time <= t and g < n - 1:
                g += 1
                time = self.time_of(g, picture_rate)
            if time > t:
                g -= 1
        return int(self.offsets[g])


@dataclass
class ContainerMeta:
    width: int
    height: int
    duration: float              # seconds
    yuva: bool = False
    key_map: GopKeyMap | None = None
    header_bytes: int = 0        # offset where the elementary stream begins

    @property
    def n_components(self) -> int:
        return 4 if self.yuva else 3


def parse_container_header(reader: BitReader) -> ContainerMeta:
    reader.advance(16)
    width = reader.get_bits(16)
    height = reader.get_bits(16)
    d = reader.get_bits(16)
    yuva = False
    if d:
        duration = d / 100.0
    else:
        yuva = bool(reader.get_bits(1))
        duration = reader.get_bits(23) / 100.0

    key_map = None
    probe = reader.get_bits(32)
    if probe == (0x0100 | T.START_MAP):
        count = reader.get_bits(32)
        raw = np.frombuffer(
            reader.data[reader.byte_pos - reader.base:
                        reader.byte_pos - reader.base + 8 * count],
            dtype=">u4").reshape(count, 2)
        key_map = GopKeyMap(
            offsets=raw[:, 0].astype(np.uint32),
            raw_timecodes=raw[:, 1].astype(np.uint32),
            times=np.zeros(count),
        )
        reader.advance(count * 64)
    else:
        reader.rewind(32)

    return ContainerMeta(width=width, height=height, duration=duration,
                         yuva=yuva, key_map=key_map,
                         header_bytes=reader.byte_pos)


def find_start_codes(data: bytes | np.ndarray,
                     base: int = 0) -> np.ndarray:
    """All ``00 00 01 xx`` start codes in ``data``, vectorised.

    Returns int64[n, 2] of (absolute byte offset of the 00 00 01 prefix,
    code byte xx).  Replaces the reference's per-byte scan loop
    (``decoders/jsv.js:1670-1707``).
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    if len(buf) < 4:
        return np.empty((0, 2), dtype=np.int64)
    # scan for the rare byte (0x01) first, then verify the 00 00 prefix
    # on the few candidates — one full-width pass instead of three
    ones = np.flatnonzero(buf[2:-1] == 1)
    hits = ones[(buf[ones] == 0) & (buf[ones + 1] == 0)]
    codes = buf[hits + 3]
    return np.stack([hits.astype(np.int64) + base,
                     codes.astype(np.int64)], axis=1)


@dataclass
class StartCodeIndex:
    """Start-code directory for random access within a parsed span."""

    entries: np.ndarray = field(
        default_factory=lambda: np.empty((0, 2), dtype=np.int64))

    @classmethod
    def scan(cls, data, base: int = 0) -> "StartCodeIndex":
        return cls(entries=find_start_codes(data, base))

    def next_code(self, from_byte: int, codes=None) -> tuple[int, int] | None:
        """First start code at/after ``from_byte`` (optionally filtered)."""
        if len(self.entries) == 0:
            return None
        i = int(np.searchsorted(self.entries[:, 0], from_byte))
        while i < len(self.entries):
            off, code = int(self.entries[i, 0]), int(self.entries[i, 1])
            if codes is None or code in codes:
                return off, code
            i += 1
        return None
