#!/usr/bin/env python3
"""Measure the H100's energy constants on one card: ``--runs`` whole
calibrations (``repro_torch.analysis.energy.calibrate``: idle floor,
fp32 and bf16 GEMMs, a 4 GiB device-to-device copy, three windows of
each), each constant printed with its windows' spread beside the card's
name and power limit, and the spread across runs.  This is
the command behind ``core/hardware.py``'s measured constants and
``chip_smoke.py``'s ``ENERGY_BAND``:

    python3 scripts/energy_calibrate.py [--runs 3]

Writes every window to ``chiprun_out/energy_calibrate.json``.  Exits
non-zero without a CUDA card or NVML."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def energy_line(constants: dict) -> str:
    """Each calibrated constant's median and its windows' spread."""
    return ", ".join(f"{k} {v['median']:.4g} (spread {v['spread']:.3f} "
                     f"over {len(v['values'])} windows)"
                     for k, v in constants.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("energy_calibrate: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    from repro_torch.analysis import energy

    card = cs.card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    runs = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        cal = energy.calibrate("cuda")
        cal["seconds"] = time.perf_counter() - t0
        runs.append(cal)
        print(f"run {i}: {energy_line(cal['constants'])} "
              f"({cal['seconds']:.1f} s; NVML: {cal['card']}, enforced "
              f"limit {cal['power_limit_w']:.0f} W)")
    across = {k: energy.summary([r["constants"][k]["median"] for r in runs])
              for k in runs[0]["constants"]}
    print(f"across {len(runs)} runs ({card}): " + ", ".join(
        f"{k} median {v['median']:.4g} spread {v['spread']:.3f}"
        for k, v in across.items()))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "energy_calibrate.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, runs=runs,
                       across=across), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
