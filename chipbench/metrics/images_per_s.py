"""Images whose logits are ready, over all the seconds of the window."""


def read(run):
    win = run["window"]
    return win["images"] / win["elapsed_s"]
