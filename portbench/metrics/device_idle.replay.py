"""The card's idle share (%) of the traced window: 1 - the union of device
intervals inside the window over the window."""


def read(r):
    w = r.digest["window_s"]
    return 100.0 * (1.0 - r.digest["busy_s"] / w) if w > 0 else None
