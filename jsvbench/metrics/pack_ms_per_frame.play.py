"""Group decode (pipeline/stream.py::decode_group): the "pack" and "h2d"
stages of each playback's Decoder.metrics, per frame shown."""


def read(r):
    return r.per(["pack", "h2d"], "frames")
