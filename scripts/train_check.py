#!/usr/bin/env python3
"""The training path on one card: phases 1 and 11 of ``chip_smoke.py``
alone (the card's name and power limit; Qwen3-4B trained at full width
and depth, the other block kinds held to the CPU, the checkpoint
resumed bitwise, the meter's joules of a warm step above an idle floor
it reads first) -- no kernel build and no other phase, the short call
after a change to the training path.

    python3 scripts/train_check.py

Prints the free space where ``tempfile`` writes phase 11's checkpoint
(about 12 GB).  Exits non-zero on a failed check.  Needs a CUDA card."""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_check: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    from repro_torch import configs
    from repro_torch.analysis import energy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import launches
    from repro_torch.launch import partition
    from repro_torch.models import transformer
    from repro_torch.training import checkpoint, optimizer, train_loop

    t0 = time.perf_counter()
    strict_fp32()
    print(cs.card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; {tempfile.gettempdir()} has "
          f"{shutil.disk_usage(tempfile.gettempdir()).free / 1e9:.0f} GB "
          f"free")
    meter = energy.EnergyMeter("cuda")
    idle_w = meter.measure(energy.idle).watts
    rows = cs.phase_train(torch, configs, transformer, train_loop, partition,
                          optimizer, checkpoint, SyntheticLM, launches,
                          (meter, idle_w), torch.device("cuda"))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train_check.json"), "w") as f:
        json.dump(dict(card=cs.card_line(), train_runs=rows), f, indent=1)
    print(f"train_check: every check passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
