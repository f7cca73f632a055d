"""Find the highest rate an open-loop cell sustains: at each rate in turn,
a fresh set-up and one window, as a benchmark run has.

    python3 chipbench/sweep.py --workload CELL --seed N --seconds S \\
        --rates 400,500,...

For each rate: the requests offered and served, the 50th and 95th
percentile latency, the mean latency of the last fifth of the requests
over that of the first fifth (a growing backlog makes it rise), the
seconds the queue took to drain once the window closed, the longest
garbage collection and the card's peak memory.  One JSON line a
rate, and all of them in ``chiprun_out/sweep_<cell>.json``."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    import numpy as np
    import torch

    from chipbench import manifest
    from chipbench.run import gc_pauses

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    config = manifest.config(cell["config"])
    mix = manifest.mix(cell["traffic"])
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        mix["rate_per_s"] = rate
        torch.cuda.reset_peak_memory_stats()
        sut = manifest.driver(config["driver"]).System(
            config, mix, args.seed, torch.device("cuda"))
        t0 = time.perf_counter()
        with gc_pauses() as pauses:
            win = sut.window(args.seconds)
        sut.free()
        del sut
        lat = np.asarray(win["latencies_s"])
        fifth = max(1, len(lat) // 5)
        row = dict(rate=rate, offered=win["attempted"],
                   served=win["images"], batches=win["batches"],
                   p50_ms=1e3 * float(np.percentile(lat, 50)),
                   p95_ms=1e3 * float(np.percentile(lat, 95)),
                   growth=float(lat[-fifth:].mean() / lat[:fifth].mean()),
                   drain_s=win["elapsed_s"] - args.seconds,
                   late_s=win["late_s"],
                   gc_max_ms=1e3 * max(pauses, default=0.0),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   wall_s=time.perf_counter() - t0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"sweep_{args.workload}.json"), "w") as f:
        json.dump(dict(card=torch.cuda.get_device_name(), rows=rows), f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
