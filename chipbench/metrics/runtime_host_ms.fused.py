"""Host milliseconds a batch in ``ChainRuntime.infer`` itself: its span
less its child spans (stage compute, encode, send, decode)."""


def read(run):
    t = run["trace"]
    if t is None or not t.count["runtime.infer"]:
        return None
    return 1e3 * t.self_s["runtime.infer"] / t.count["runtime.infer"]
