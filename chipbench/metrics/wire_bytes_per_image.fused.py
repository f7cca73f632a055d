"""Bytes the runtime put on its links (every hop, every attempt) per image
served; a hop the runtime merged puts none."""


def read(run):
    win = run["window"]
    if run["trace"] is None or not win["images"]:
        return None
    return sum(win["wire_bytes"]) / win["images"]
