"""The Decoder's parse (api/decoder.py): the "parse" stage of each
playback's Decoder.metrics, per frame shown."""


def read(r):
    return r.per(["parse"], "frames")
