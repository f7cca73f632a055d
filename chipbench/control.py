"""The readings that set a cell's limits: the program's comparison on many
seeds, and the control's, in one process.

    python3 chipbench/control.py --workload CELL --seeds 1,2,3 --seconds S

For each seed, two runs of the cell (a window of ``--seconds`` at the
cell's own load; untraced): the program's, and the control's, in which
the reference in float8 e4m3 storage, the next precision below the
configurations' bf16, takes the program's place in the comparison that
decides ``correct``, on the batches the window served.  Prints a JSON
line a seed and writes them all to ``chiprun_out/control_<cell>.json``.
The benchmark's own runs never compute the control."""
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
    """For each seed, the program's run and the control's run of the cell:
    whether each came out correct, and the ``logit_err`` each read."""
    import torch

    from chipbench import manifest
    from chipbench.run import run_cell

    bench = manifest.load()
    rows = []
    for seed in seeds:
        row = dict(seed=seed)
        for side, low in (("program", None), ("control",
                                              getattr(torch, CONTROL))):
            out = run_cell(bench, workload, seed=seed, seconds=seconds,
                           trace=False, device=device,
                           t_start=time.perf_counter(), control=low,
                           overrides=overrides)
            row.update({f"{side}_correct": out["correct"],
                        f"{side}_logit_err":
                            out["checks"]["logit_err"]["value"]})
        row.update(rows=out["reference"]["rows"],
                   batch_sizes=out["reference"]["batch_sizes"])
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    rows = readings(args.workload,
                    [int(s) for s in args.seeds.split(",")], args.seconds)
    for row in rows:
        print(json.dumps(row))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"control_{args.workload}.json"), "w") as f:
        json.dump(dict(card=torch.cuda.get_device_name(), rows=rows), f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
