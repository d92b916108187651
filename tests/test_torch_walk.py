"""The header walk (``jsvx_torch/pipeline/packed_parse.py``) reads headers
only.

Each picture of the walk is a ``PictureHeader``: the five header fields,
no planes.  The walk goes from a picture's header straight to the next
start code that can end the picture.  Held here, on every fixture stream
of ``tests/test_torch_standalone.py``, on the rendition switch of
``tests/test_torch_sequence_matrices.py`` and on a stream with user-data
and extension codes inside its pictures:

* the port's ``walk_stream`` and ``walk_stream_seqs`` give jsvx's GOPs,
  pictures, start bits and header fields, and the quant matrices of each
  GOP's own sequence header;
* the jump from a picture's header lands where jsvx's ``_picture_end``
  does, from every byte;
* the walk allocates no picture planes (``tracemalloc``), and no record
  holds an array.

``parse_stream_parallel``, which allocates the planes itself, is held
bit-equal to jsvx's on the same streams by
``tests/test_torch_standalone.py::test_parse_stream_parallel_equal``.
"""

import dataclasses
import tracemalloc

import numpy as np
import pytest

from jsvx.bitstream.bitio import BitReader as JBitReader
from jsvx.bitstream.container import StartCodeIndex as JStartCodeIndex
from jsvx.bitstream.container import \
    parse_container_header as j_parse_container_header
from jsvx.bitstream.parser import StreamParser as JStreamParser
from jsvx.coding import tables as JT
from jsvx.pipeline import parallel_parse as jpar
from jsvx.pipeline.packed_parse import walk_stream as j_walk_stream

from jsvx_torch.bitstream.container import StartCodeIndex
from jsvx_torch.kernels.decode import quant_key
from jsvx_torch.pipeline.packed_parse import walk_stream, walk_stream_seqs
from jsvx_torch.pipeline.parallel_parse import (PictureHeader, _picture_end,
                                                _picture_stops)
from jsvx_torch.tools import fixture

from test_torch_standalone import ENCODINGS, _encode, _same_value

HEADER_FIELDS = ("picture_type", "temporal_ref", "full_pel", "f_code",
                 "gop_time_ms")
STREAMS = ("tiny", "tiny_quirk_stream", "small", "yuva", "full_pel_custom_q",
           "switch", "switch_key_map", "tiny_user_data")


def _with_user_data(data: bytes) -> bytes:
    """``data`` with a user-data code before the second slice of every
    picture and an extension code before the third: codes inside a
    picture that the walk must step over, as it steps over slices."""
    codes = JStartCodeIndex.scan(data).entries
    slices = [int(off) for off, code in codes
              if JT.START_SLICE_FIRST <= code <= JT.START_SLICE_LAST]
    pictures = [int(off) for off, code in codes
                if code == JT.START_PICTURE]
    at = {}
    for p, q in zip(pictures, pictures[1:] + [len(data)]):
        inside = [o for o in slices if p < o < q]
        at[inside[1]] = b"\x00\x00\x01\xb2user"
        at[inside[2]] = b"\x00\x00\x01\xb5\x10"
    out, last = [], 0
    for off in sorted(at):
        out += [data[last:off], at[off]]
        last = off
    return b"".join(out + [data[last:]])


@pytest.fixture(scope="module")
def streams():
    out = {name: _encode(ENCODINGS[name][0](), **ENCODINGS[name][1])[1]
           for name in STREAMS[:5]}
    out["switch"] = fixture.switch_stream(False)
    out["switch_key_map"] = fixture.switch_stream(True)
    out["tiny_user_data"] = _with_user_data(out["tiny"])
    return out


def _plain(x):
    """A dataclass (and those it holds) as nested lists of its values."""
    if dataclasses.is_dataclass(x):
        return [_plain(getattr(x, f.name)) for f in dataclasses.fields(x)]
    return x


def _jsvx_seq_per_gop(data: bytes) -> list:
    """jsvx's serial header walk, keeping the sequence header current at
    each non-empty GOP's first picture."""
    r = JBitReader(data)
    j_parse_container_header(r)
    index = JStartCodeIndex.scan(data)
    parser = JStreamParser(use_native=False)
    seqs, fresh = [], True
    pos = r.byte_pos
    while (nxt := index.next_code(pos)) is not None:
        off, code = nxt
        rr = JBitReader(data, pos_bits=(off + 4) << 3)
        pos = off + 4
        if code == JT.START_SEQUENCE:
            parser.parse_sequence_header(rr)
            pos = rr.byte_pos
        elif code == JT.START_GOP:
            parser.parse_gop_header(rr)
            fresh = True
            pos = rr.byte_pos
        elif code == JT.START_PICTURE:
            ft, _ = jpar._parse_picture_header(parser, rr)
            pos = rr.byte_pos
            if ft is not None:
                if fresh or not seqs:
                    seqs.append(quant_key(parser.seq))
                fresh = False
                pos = jpar._picture_end(index, rr.byte_pos, len(data))
    return seqs


@pytest.mark.parametrize("name", STREAMS)
def test_walk_equals_jsvx(streams, name):
    """GOPs, pictures, start bits, header fields and each GOP's quant
    matrices: the port's two walks against jsvx's."""
    data = streams[name]
    jmeta, jseq, want = j_walk_stream(data)
    meta, seq, got = walk_stream(data)
    smeta, seqs, sgot = walk_stream_seqs(data)
    _same_value(_plain(jmeta), _plain(meta), "meta")
    _same_value(_plain(meta), _plain(smeta), "meta")
    assert quant_key(seq) == quant_key(jseq)
    assert (seq.mb_width, seq.mb_height) == (jseq.mb_width, jseq.mb_height)
    assert [len(g) for g in got] == [len(g) for g in sgot] \
        == [len(g) for g in want]
    assert len(want) >= 1 and all(want)
    for gi, (w, g, s) in enumerate(zip(want, got, sgot)):
        for pi, ((wf, wb), (gh, gb), (sh, sb)) in enumerate(zip(w, g, s)):
            assert gb == sb == wb, (gi, pi)
            for f in HEADER_FIELDS:
                assert getattr(gh, f) == getattr(sh, f) == getattr(wf, f), \
                    (gi, pi, f)
                assert type(getattr(gh, f)) is type(getattr(wf, f)), f
            assert gh.is_intra_picture == wf.is_intra_picture
    assert [quant_key(s) for s in seqs] == _jsvx_seq_per_gop(data)
    if name.startswith("switch"):
        assert quant_key(seqs[0]) != quant_key(seqs[1])


@pytest.mark.parametrize("name", ["tiny", "tiny_user_data", "switch_key_map"])
def test_picture_end_equals_jsvx(streams, name):
    """From every byte of the stream, the walk's jump lands where jsvx's
    code-by-code ``_picture_end`` does."""
    data = streams[name]
    index = JStartCodeIndex.scan(data)
    stops = _picture_stops(StartCodeIndex.scan(data))
    kinds = set(int(c) for c in index.entries[:, 1])
    if name == "tiny_user_data":
        assert {JT.START_USER_DATA, JT.START_EXTENSION} <= kinds
    for b in range(len(data) + 2):
        assert _picture_end(stops, b, len(data)) == \
            jpar._picture_end(index, b, len(data)), b


@pytest.mark.parametrize("name", ["tiny", "small"])
def test_walk_allocates_no_planes(streams, name):
    """The walk's peak stays under the start-code index's bytes plus 2 KB a
    picture (a 48x64 picture's planes alone are 9 KB), and no record holds
    an array."""
    data = streams[name]
    walk_stream_seqs(data)                   # imports and caches settled
    index_bytes = StartCodeIndex.scan(data).entries.nbytes
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        _, _, groups = walk_stream_seqs(data)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    n = sum(map(len, groups))
    assert n >= 6
    assert peak < index_bytes + 2048 * n, (peak, index_bytes, n)
    for group in groups:
        for hdr, start_bit in group:
            assert type(hdr) is PictureHeader
            assert not hasattr(hdr, "__dict__")
            values = [getattr(hdr, f.name) for f in dataclasses.fields(hdr)]
            assert [f.name for f in dataclasses.fields(hdr)] == \
                list(HEADER_FIELDS)
            assert not any(isinstance(v, np.ndarray) for v in values)
            assert isinstance(start_bit, int)
