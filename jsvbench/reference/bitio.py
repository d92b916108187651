"""Bit-granular reading/writing over contiguous byte buffers.

The reference streams bits out of a linked list of byte-range buffers
(``features/bitreader.js:443-540``).  In this framework the streaming layer
(:mod:`jsvx_torch.runtime.source` + :class:`jsvx_torch.api.decoder.Decoder`) assembles
contiguous spans and the parser reads them with this flat reader; sparse
byte-range bookkeeping lives in :mod:`jsvx_torch.bitstream.ranges`.

MSB-first bit order throughout (MPEG bit order).
"""

from __future__ import annotations

import numpy as np


class BitStallError(Exception):
    """Raised when a read runs past the available bytes.

    Carries the absolute byte offset needed so the streaming layer can
    schedule a refill (the analog of the reference's 'stalled' event,
    ``features/bitreader.js:187-189``).
    """

    def __init__(self, needed_byte: int):
        super().__init__(f"bitstream stalled; need byte {needed_byte}")
        self.needed_byte = needed_byte


class BitReader:
    """MSB-first bit reader over one contiguous ``bytes``/``ndarray`` span.

    ``base`` is the absolute byte offset of ``data[0]`` in the underlying
    stream, so absolute positions survive re-buffering.
    """

    __slots__ = ("data", "base", "pos", "_n")

    def __init__(self, data, base: int = 0, pos_bits: int | None = None):
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        self.data = bytes(data)
        self.base = base
        self._n = len(self.data)
        # absolute bit position
        self.pos = (base << 3) if pos_bits is None else pos_bits

    # -- positions ---------------------------------------------------------

    @property
    def bit_pos(self) -> int:
        return self.pos

    @property
    def byte_pos(self) -> int:
        return self.pos >> 3

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def seek_bits(self, abs_bits: int) -> None:
        self.pos = abs_bits

    def bits_left(self) -> int:
        return ((self.base + self._n) << 3) - self.pos

    def has_bits(self, n: int) -> bool:
        return self.bits_left() >= n

    # -- reads -------------------------------------------------------------

    def _window(self, first_byte: int, n_bytes: int) -> int:
        lo = first_byte - self.base
        hi = lo + n_bytes
        if lo < 0 or hi > self._n:
            raise BitStallError(self.base + max(0, min(hi, lo)))
        return int.from_bytes(self.data[lo:hi], "big")

    def peek(self, n: int) -> int:
        """Peek ``n`` (<= 57) bits without advancing; zero-pads past EOF."""
        first = self.pos >> 3
        shift = self.pos & 7
        want = (shift + n + 7) >> 3
        lo = first - self.base
        hi = lo + want
        if lo < 0:
            raise BitStallError(first)
        chunk = self.data[lo:hi]
        got = len(chunk)
        word = int.from_bytes(chunk, "big") << (8 * (want - got))
        word &= (1 << (8 * want)) - 1
        return (word >> (8 * want - shift - n)) & ((1 << n) - 1)

    def get_bits(self, n: int) -> int:
        if n == 0:
            return 0
        if not self.has_bits(n):
            raise BitStallError((self.pos + n + 7) >> 3)
        v = self.peek(n)
        self.pos += n
        return v

    def advance(self, n_bits: int) -> None:
        self.pos += n_bits

    def rewind(self, n_bits: int) -> None:
        self.pos -= n_bits

    def read_vlc(self, table) -> int:
        """Decode one code from a compiled :class:`~jsvx_torch.coding.vlc.VLCTable`."""
        peek = self.peek(table.max_len)
        value, n = table.decode_peek(peek)
        if not self.has_bits(n):
            raise BitStallError((self.pos + n + 7) >> 3)
        self.pos += n
        return value


class BitWriter:
    """MSB-first bit writer (encoder fixture generator support)."""

    def __init__(self):
        self._chunks = bytearray()
        self._acc = 0
        self._nacc = 0

    @property
    def bit_length(self) -> int:
        return len(self._chunks) * 8 + self._nacc

    def put_bits(self, value: int, n: int) -> None:
        if n == 0:
            return
        if value < 0 or value >= (1 << n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        self._acc = (self._acc << n) | value
        self._nacc += n
        while self._nacc >= 8:
            self._nacc -= 8
            self._chunks.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def put_code(self, table, value) -> None:
        code, n = table.encode[value]
        self.put_bits(code, n)

    def byte_align(self, fill: int = 0) -> None:
        if self._nacc:
            pad = 8 - self._nacc
            self.put_bits(fill & ((1 << pad) - 1), pad)

    def put_bytes(self, data: bytes) -> None:
        if self._nacc:
            for b in data:
                self.put_bits(b, 8)
        else:
            self._chunks.extend(data)

    def put_start_code(self, code: int) -> None:
        self.byte_align()
        self.put_bytes(bytes([0x00, 0x00, 0x01, code & 0xFF]))

    def getvalue(self) -> bytes:
        if self._nacc:
            raise ValueError("bitstream not byte-aligned; call byte_align()")
        return bytes(self._chunks)
