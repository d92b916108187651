"""The Decoder's start-code scans (api/decoder.py, _view_and_index:
``find_start_codes`` over the buffered view): the window's "scan" spans of
the program's span log, ms per frame shown."""

import os

from jsvbench import manifest

_spans = manifest.load_module("metrics", "walk_ms_per_call.transcode",
                              os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))


def read(r):
    return _spans.ms_per(r, "scan", "frames")
