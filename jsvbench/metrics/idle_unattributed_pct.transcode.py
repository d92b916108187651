"""The card's idle time that no stage of the program accounts for: 100 x
(the window's idle time outside every span of the program's span log but
the roots, a whole call or tick) / the window: the harness between units,
and host time outside every stage."""

import os

from jsvbench import manifest

_idle = manifest.load_module("metrics", "idle_in_parse_pct.transcode",
                             os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))))


def read(r):
    return _idle.idle_pct(r, lambda name: name not in _idle.ROOTS,
                          outside=True)
