#!/usr/bin/env python3
"""Time the sequence kernels of one tree's ``repro_torch`` at the phase-7
calls of ``chip_smoke.py``: flash attention (Qwen3-4B, Zamba2-7B, Qwen3-4B
with Sq 128), the RWKV6 WKV (RWKV6-7B, T 2000) and the Mamba2 SSD
(Zamba2-7B), fp32 and bf16, batch 2, through ``repro_torch.kernels.ops``;
CUDA-graph replays timed with CUDA events, warm L2, then each call traced
with ``torch.profiler`` for the device time of every kernel it launches
(the SSD's three passes apart, and any padding copy apart from the WKV
kernel).

    python3 scripts/seq_kernel_bench.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), e.g. that of a ``git archive`` of the parent commit
unpacked into a git-ignored directory; its kernels build into its own
``_build``.  Run it in turns -- parent, change, change, parent -- in one
call on one card to compare two trees.  Each run prints one JSON line
(label, card, per-call ms, per-kernel ms) and appends it to
``chiprun_out/seq_kernel_bench.jsonl``.  Needs a CUDA card."""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5      # calls in a captured graph
ROUNDS = 3    # timed replays of each graph, averaged


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("seq_kernel_bench: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.rwkv6_wkv import RWKV_HD

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = cs.mixer_cases(configs, RWKV_HD)
    ms, kernel_ms = {}, {}
    for case in cases:
        for d, tname in cs.DTYPES:
            a = cs.mixer_inputs(torch, case, getattr(torch, tname), gen, dev)
            key = f"{case['kernel']} {case['label']} {d}"
            # each call's graph is captured, timed and dropped before the
            # next is captured, as in chip_smoke.py's phase 6
            timer = cs.Timer(torch, lambda: cs.call_mixer(kops, case, a),
                             reps=REPS)
            ms[key] = sum(timer.ms() for _ in range(ROUNDS)) / ROUNDS
            del timer
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    cs.call_mixer(kops, case, a)
                torch.cuda.synchronize()
            kernel_ms[key] = {e.key: e.device_time_total / REPS / 1e3
                              for e in prof.key_averages()
                              if e.device_time_total > 0}
    out = dict(label=args.label, src=os.path.abspath(args.src), card=card,
               ms=ms, kernel_ms=kernel_ms)
    for kernel in cs.MIXERS:
        for d, _ in cs.DTYPES:
            out[f"{kernel} {d} total"] = sum(
                v for k, v in ms.items()
                if k.startswith(kernel) and k.endswith(d))
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "seq_kernel_bench.jsonl"),
              "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
