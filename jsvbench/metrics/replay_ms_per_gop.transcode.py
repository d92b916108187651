"""The host's graph replay a GOP (pipeline/program.py, GopProgram.run:
``graph.replay()`` alone, without the output stacks' copies): the window's
"replay" spans of the program's span log, ms per GOP delivered."""

import os

from jsvbench import manifest

_spans = manifest.load_module("metrics", "walk_ms_per_call.transcode",
                              os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))


def read(r):
    return _spans.ms_per(r, "replay", "gops")
