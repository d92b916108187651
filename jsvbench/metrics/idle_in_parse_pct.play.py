"""The card's idle time spent in the Decoder's parse (api/decoder.py, the
"parse" stage of each GOP batch): 100 x (the window's idle time inside the
union of the program's "parse" spans) / the window."""

import os

from jsvbench import manifest

_idle = manifest.load_module("metrics", "idle_in_parse_pct.transcode",
                             os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))))


def read(r):
    return _idle.idle_pct(r, lambda name: name == "parse")
