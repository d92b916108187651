"""The wire's un-overlapped copy tail a GOP (pipeline/wire.py,
transcode.WireCopier): the "wire_wait" stage per GOP delivered."""


def read(r):
    return r.per(["wire_wait"], "gops")
