"""The whole step's share of the card's bf16 peak, in percent: the model's
FLOPs (convs and linear layers, from the layers' shapes) times the images
served, over the traced window's seconds."""
from chipbench import counts


def read(run):
    win = run["window"]
    if run["trace"] is None or not run["trace"].device or not win["images"]:
        return None
    return 100.0 * win["flops_per_image"] * win["images"] \
        / win["elapsed_s"] / counts.PEAK_FLOPS
