"""The stall at each segment's start: the 95th percentile, over the
window's calls, of the time from a call's start to its first GOP's
delivery at the harness's sink (host clock)."""


def read(r):
    return r.clock.get("segment_start_p95_ms")
