#!/usr/bin/env python3
"""Build the kernels and hold the sequence kernels against their plain
versions on one card: phases 1-2 and 7-8 of ``chip_smoke.py`` alone (the
card's name and power limit; every source built, the SASS and register
checks; ``repro_torch.kernels.ops`` at the phase-7 calls with the launch
counts read; phase 8's checks at those calls and the small shapes) -- no
CNN path and no timing, the short first call after a kernel changes.

    python3 scripts/seq_check.py

Exits non-zero on a failed check.  Needs a CUDA card."""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("seq_check: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    from repro_torch import configs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import _build, launches, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.rwkv6_wkv import RWKV_HD, plan_wkv

    t0 = time.perf_counter()
    strict_fp32()
    print(cs.card_line())
    cs.phase_build(_build)
    dev = torch.device("cuda")
    cases = cs.mixer_cases(configs, RWKV_HD)
    inputs, outs, _ = cs.phase_mixers(torch, kops, launches, cases, dev)
    small = cs.SMALL_MIXERS + cs.wkv_stage_cases(torch, plan_wkv, RWKV_HD)
    cs.phase_mixer_checks(torch, kops, ref, cases, inputs, outs, small, dev)
    print(f"seq_check: every check passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
