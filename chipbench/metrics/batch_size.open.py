"""Requests a batch in the window, by the engine's own counters (served
over batches dispatched): its dynamic batching."""


def read(run):
    win = run["window"]
    if not win["engine_batches"]:
        return None
    return win["engine_served"] / win["engine_batches"]
