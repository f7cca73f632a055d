"""The whole serving loop's share of the card's bf16 peak, in percent: the
model FLOPs of the window's prompt and generated tokens (every layer,
the head where logits are taken, causal attention's visible pairs;
``chipbench.lm_counts``) over the window's seconds."""
from chipbench import counts


def read(run):
    win = run["window"]
    if run["trace"] is None or not run["trace"].device or not win["images"]:
        return None
    return 100.0 * win["model_flops"] / win["elapsed_s"] / counts.PEAK_FLOPS
