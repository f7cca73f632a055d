"""The convs' share of their roofline, in percent: the least time of every
conv of the window's batches (the larger of its FLOPs at the bf16 peak
and its bytes at the HBM peak, from the layers' shapes) over the device
time of the operations launched inside the benchmark's span around each
conv call."""


def read(run):
    t = run["trace"]
    if t is None:
        return None
    spent = t.launched_in.get("kernels.conv2d", 0.0)
    if spent <= 0:
        return None
    return 100.0 * run["window"]["conv_least_s"] / spent
