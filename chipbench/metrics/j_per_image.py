"""The card's joules over the window (NVML's total-energy counter) per
image served in it."""


def read(run):
    win = run["window"]
    if win["joules"] is None or not win["images"]:
        return None
    return win["joules"] / win["images"]
