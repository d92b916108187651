"""Variable-length-code utilities.

The reference decoder walks flattened binary trees one bit at a time
(``decoders/jsv.js:1593-1599``).  Here each table is compiled once into a
flat lookup keyed by the next ``max_len`` bits, so a decoder consumes a whole
code per table lookup — the form both the NumPy/Python parser and the C++
parser share.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VLCTable:
    """A compiled VLC table.

    Attributes:
      encode:  {value: (code_int, n_bits)}
      max_len: longest code length in bits
      lut_value: int32[2**max_len] — decoded value for each max_len-bit peek
      lut_length: uint8[2**max_len] — code length consumed (0 = invalid code)
    """

    encode: dict
    max_len: int
    lut_value: np.ndarray
    lut_length: np.ndarray

    def decode_peek(self, peek: int):
        """Decode from a ``max_len``-bit peek; returns (value, n_bits)."""
        n = int(self.lut_length[peek])
        if n == 0:
            raise ValueError(f"invalid VLC code in peek {peek:0{self.max_len}b}")
        return int(self.lut_value[peek]), n


def build_lut(entries) -> VLCTable:
    """Compile ``[(value, '0101...'), ...]`` into a :class:`VLCTable`."""
    max_len = max(len(code) for _, code in entries)
    size = 1 << max_len
    lut_value = np.zeros(size, dtype=np.int32)
    lut_length = np.zeros(size, dtype=np.uint8)
    encode = {}
    for value, code in entries:
        n = len(code)
        prefix = int(code, 2)
        if value in encode:
            raise ValueError(f"duplicate value {value} in VLC table")
        encode[value] = (prefix, n)
        lo = prefix << (max_len - n)
        hi = lo + (1 << (max_len - n))
        if lut_length[lo:hi].any():
            raise ValueError(f"VLC code {code} is not prefix-free")
        lut_value[lo:hi] = value
        lut_length[lo:hi] = n
    return VLCTable(encode=encode, max_len=max_len,
                    lut_value=lut_value, lut_length=lut_length)


def _compile_all():
    from . import tables as t

    return {
        "mb_addr_inc": build_lut(t.MACROBLOCK_ADDRESS_INCREMENT),
        "mb_type_i": build_lut(t.MACROBLOCK_TYPE_I),
        "mb_type_p": build_lut(t.MACROBLOCK_TYPE_P),
        "mb_type_b": build_lut(t.MACROBLOCK_TYPE_B),
        "cbp": build_lut(t.CODE_BLOCK_PATTERN),
        "motion": build_lut(t.MOTION),
        "dc_size_lum": build_lut(t.DCT_DC_SIZE_LUMINANCE),
        "dc_size_chrom": build_lut(t.DCT_DC_SIZE_CHROMINANCE),
        "dct_coeff": build_lut(t.DCT_COEFF),
    }


_TABLES = None


def compiled_tables() -> dict:
    """All JSV VLC tables compiled to LUT form (cached)."""
    global _TABLES
    if _TABLES is None:
        _TABLES = _compile_all()
    return _TABLES
