"""Host milliseconds in the wire codec's spans (encode and decode of every
boundary) per image."""


def read(run):
    t, win = run["trace"], run["window"]
    if t is None or not win["images"]:
        return None
    return 1e3 * (t.total_s["wire.encode"] + t.total_s["wire.decode"]) \
        / win["images"]
