"""The prefill flash calls' share of their roofline, in percent: the least
time of every prefill attention call of the window (the larger of its
causal FLOPs at the bf16 peak and its q, k, v and o bytes at the HBM
peak, from the configuration's shapes: ``chipbench.lm_counts``) over the
device time of the flash kernel's launches in the window."""

KERNEL = "flash_kernel"


def read(run):
    t = run["trace"]
    if t is None:
        return None
    spent = sum(min(b, t.w1) - max(a, t.w0) for a, b, name, *_ in t.device
                if KERNEL in name)
    if spent <= 0:
        return None
    return 100.0 * run["window"]["flash_least_s"] / spent
