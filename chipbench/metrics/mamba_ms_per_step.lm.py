"""Device milliseconds a decode step in the Mamba-2 mixers: the operations
launched inside ``model/mamba`` (a decode step's span only), over the
steps."""


def read(run):
    t, win = run["trace"], run["window"]
    steps = win["engine"]["decode_steps"]
    if t is None or not t.device or not steps \
            or not t.count.get("model/mamba"):
        return None
    return 1e3 * t.launched_in.get("model/mamba", 0.0) / steps
