"""Device milliseconds a batch of the classifier: the operations launched
inside the ``model/linear`` spans (its weight's cast, the GEMM, the bias
and the cast of its output), over the window's batches."""


def read(run):
    t, win = run["trace"], run["window"]
    if t is None or not t.device or not win["batches"] \
            or not t.count.get("model/linear"):
        return None
    return 1e3 * t.launched_in.get("model/linear", 0.0) / win["batches"]
