"""The card's idle time spent in the host parse: 100 x (the window's idle
time, outside the device's busy intervals, that lies inside the union of
the program's "parse" spans, the header walk's included) / the window.
Nothing when the program keeps no span log, logged no span, or dropped
entries inside the window.

Its sibling readers idle_in_parse_pct.play and idle_unattributed_pct.* load
this file by its name for :func:`idle_pct` and :data:`ROOTS`: rename or
remove it with them."""

from jsvbench.work import merge
from jsvx_torch.runtime import profiler

#: the root spans: a whole call or tick, not a stage of one
ROOTS = ("transcode", "tick")


def idle(w) -> list:
    """The window less the device's busy intervals (ns, sorted)."""
    out, t = [], w.start
    for s, e in w.busy():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w.end > t:
        out.append((t, w.end))
    return out


def overlap_ns(a: list, b: list) -> int:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(r, pick, outside: bool = False):
    """100 x the idle time inside (with ``outside``: outside) the union of
    the window's spans whose name ``pick`` takes, over the window."""
    spans = getattr(profiler, "spans", None)
    w = r.window
    if spans is None or w.start is None or w.end <= w.start:
        return None
    got, dropped = spans(w.start, w.end)
    chosen = [(s, e) for name, s, e, *_ in got if e > s and pick(name)]
    if dropped or not chosen:
        return None
    gaps = idle(w)
    inside = overlap_ns(gaps, merge(chosen))
    if outside:
        inside = sum(e - s for s, e in gaps) - inside
    return 100.0 * inside / (w.end - w.start)


def read(r):
    return idle_pct(r, lambda name: name == "parse")
