"""Host parse a GOP (pipeline/packed_parse.py, native/jsv_parse.cc): the
"parse" stage of transcode's Metrics over the window, per GOP delivered."""


def read(r):
    return r.per(["parse"], "gops")
