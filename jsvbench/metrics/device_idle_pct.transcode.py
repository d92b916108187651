"""The share of the traced window in which nothing ran on the card: 100 x
(1 - the union of the device's kernel, copy and fill intervals / the
window)."""


def read(r):
    w = r.window
    if not w.window_s:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
