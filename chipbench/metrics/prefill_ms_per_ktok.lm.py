"""Device milliseconds of prefill per 1,000 prompt tokens: the operations
launched inside the engine's ``lm/prefill`` spans (a prefill opens no
span of its own inside it), over the window's prompt tokens."""


def read(run):
    t, win = run["trace"], run["window"]
    if t is None or not t.device or not t.count.get("lm/prefill"):
        return None
    return 1e3 * t.launched_in.get("lm/prefill", 0.0) \
        / (win["engine"]["prefill_tokens"] / 1e3)
