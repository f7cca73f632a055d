"""The card's idle share of the traced window, in percent: one less the
union of its kernels, copies and sets over the window."""


def read(run):
    t = run["trace"]
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
