"""95th percentile of every request due in the window, from its due time
to its logits ready; a request never answered counts as missing (its
latency infinite), and a run whose 95th percentile is missing has none."""
import math

import numpy as np


def read(run):
    win = run["window"]
    lat = list(win["latencies_s"])
    lat += [math.inf] * (win["attempted"] - len(lat))
    if not lat:
        return None
    p95 = float(np.percentile(np.asarray(lat), 95))
    if not math.isfinite(p95):
        raise RuntimeError(f"{win['attempted'] - len(win['latencies_s'])} "
                           f"of {win['attempted']} requests unanswered: "
                           f"the 95th percentile is missing")
    return 1e3 * p95
