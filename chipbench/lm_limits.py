"""The readings that set the language-model cell's limit on
``logit_err``: on many seeds, in one process, the program's comparison
and the control's.

    python3 chipbench/lm_limits.py --workload CELL --seeds 1,2,3 --seconds S

For each seed: the cell's set-up and a window of ``--seconds`` at the
cell's own load (untraced), then the requests it checked held to the
plain reference once, with the program's logits and with the reference's
own in float8 e4m3 storage (the control, the next precision below the
configuration's bf16) judged against it.  Prints a JSON line a seed and
writes them all to ``chiprun_out/limits_<cell>.json``.  The benchmark's
own runs never compute the control."""
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

CONTROL = "float8_e4m3fn"


def readings(workload: str, seeds, seconds: float, *, device="cuda",
             overrides=None) -> list[dict]:
    """For each seed, the program's and the control's ``logit_err`` on the
    requests one window checked, with its exact checks."""
    import torch

    from chipbench import manifest

    bench = manifest.load()
    cell = manifest.cell(bench, workload)
    overrides = overrides or {}
    config = {**manifest.config(cell["config"]),
              **overrides.get("config", {})}
    mix = {**manifest.mix(cell["traffic"]), **overrides.get("mix", {})}
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        sut = manifest.driver(config["driver"]).System(
            config, mix, seed, torch.device(device))
        win = sut.window(seconds)
        checks = sut.program_checks()
        kept = sut.free()
        t_ref = time.perf_counter()
        row = dict(seed=seed, answered=win["images"],
                   exact_ok=all(v == lim for v, lim in checks.values()),
                   **sut.readings(kept, getattr(torch, CONTROL)),
                   reference_s=time.perf_counter() - t_ref,
                   wall_s=time.perf_counter() - t)
        del sut, kept
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lm_limits: needs a CUDA card", file=sys.stderr)
        return 2
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.seconds)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"limits_{args.workload}.json"), "w") as f:
        json.dump(dict(card=torch.cuda.get_device_name(), rows=rows), f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
