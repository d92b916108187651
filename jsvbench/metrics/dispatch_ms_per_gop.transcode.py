"""The host's enqueue of a GOP (pipeline/transcode.py, pipeline/program.py:
one graph replay): the "device_dispatch" stage per GOP delivered."""


def read(r):
    return r.per(["device_dispatch"], "gops")
