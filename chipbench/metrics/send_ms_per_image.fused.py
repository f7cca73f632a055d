"""Host milliseconds in the transfer layer's span (framing, checksums,
the virtual link) per image."""


def read(run):
    t, win = run["trace"], run["window"]
    if t is None or not win["images"]:
        return None
    return 1e3 * t.total_s["transfer.send"] / win["images"]
