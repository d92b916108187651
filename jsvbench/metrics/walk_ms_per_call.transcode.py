"""The header walk at each call's start (pipeline/transcode.py,
packed_parse.walk_stream_seqs): the seconds of the window's "walk" spans in
the program's span log (runtime/profiler.py), ms per call.  Nothing when
the program keeps no span log, logged no such span, or dropped entries
inside the window.

Its sibling readers replay_ms_per_gop.transcode, scan_ms_per_frame.play
and buffer_copy_ms_per_frame.play load this file by its name for
:func:`ms_per`: rename or remove it with them."""

from jsvx_torch.runtime import profiler


def ms_per(r, name: str, unit: str):
    """1e3 x the seconds of the window's ``name`` spans / ``unit``."""
    spans = getattr(profiler, "spans", None)
    n = r.units.get(unit, 0)
    if spans is None or not n or r.window.start is None:
        return None
    got, dropped = spans(r.window.start, r.window.end)
    ns = [e - s for what, s, e, *_ in got if what == name]
    if dropped or not ns:
        return None
    return sum(ns) / 1e6 / n


def read(r):
    return ms_per(r, "walk", "calls")
