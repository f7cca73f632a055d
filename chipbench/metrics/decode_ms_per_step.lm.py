"""Device milliseconds a decode step: the operations launched inside the
engine's ``lm/decode`` spans and the model's sublayer spans nested in
them (``model/*``, opened in decode steps only), over the steps."""

PARTS = ("lm/decode", "model/mamba", "model/attention", "model/moe",
         "model/head")


def read(run):
    t, win = run["trace"], run["window"]
    steps = win["engine"]["decode_steps"]
    if t is None or not t.device or not steps \
            or not t.count.get("lm/decode"):
        return None
    return 1e3 * sum(t.launched_in.get(p, 0.0) for p in PARTS) / steps
