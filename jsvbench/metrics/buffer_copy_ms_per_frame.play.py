"""The Decoder's copies of its buffered stream (api/decoder.py and
bitstream/ranges.py: ``contiguous_view``'s copy, ``tobytes`` for each
reader, the trim in ``advance_to``): the window's "buffer_copy" spans of
the program's span log, ms per frame shown."""

import os

from jsvbench import manifest

_spans = manifest.load_module("metrics", "walk_ms_per_call.transcode",
                              os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))


def read(r):
    return _spans.ms_per(r, "buffer_copy", "frames")
