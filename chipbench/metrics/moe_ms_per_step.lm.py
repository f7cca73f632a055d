"""Device milliseconds a decode step in the mixture of experts: the
operations launched inside ``model/moe`` (router, dispatch, experts,
combine and shared expert of every layer; a decode step's span only),
over the steps."""


def read(run):
    t, win = run["trace"], run["window"]
    steps = win["engine"]["decode_steps"]
    if t is None or not t.device or not steps \
            or not t.count.get("model/moe"):
        return None
    return 1e3 * t.launched_in.get("model/moe", 0.0) / steps
