"""The steady stall inside a segment: the 95th percentile, over the
window's GOPs but each call's first, of the time from one GOP's delivery
at the harness's sink to the next (host clock)."""


def read(r):
    return r.clock.get("gop_gap_p95_ms")
