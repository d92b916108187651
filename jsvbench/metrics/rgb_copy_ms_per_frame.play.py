"""The sink: the host clock around each RGB frame's copy to host memory in
the harness's sink, per frame shown."""


def read(r):
    n = r.units["frames"]
    return 1e3 * r.sink["rgb_copy"] / n if n else None
