"""Host milliseconds in the link's crc32 passes (the ``link/checksum``
spans of framing, sending and unframing) per image."""


def read(run):
    t, win = run["trace"], run["window"]
    if t is None or not win["images"] or not t.count.get("link/checksum"):
        return None
    return 1e3 * t.total_s["link/checksum"] / win["images"]
