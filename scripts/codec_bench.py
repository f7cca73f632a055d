#!/usr/bin/env python3
"""Time one tree's int8 boundary codec on the card.

    python3 scripts/codec_bench.py [--src DIR] [--label NAME]

Times ``quantize_boundary`` and ``dequantize_boundary`` of the
``repro_torch`` under ``--src`` (default: this checkout's ``src``) at the
codec shapes of ``chip_smoke.py`` phase 4 -- the main path's microbatch
boundaries, every batch-4 boundary of the int8 plans, the per-tensor
flattens -- fp32 and bf16: warm (a CUDA graph of back-to-back calls on one
input, as ``chip_smoke.py`` phase 6 times them) and cold (the graph walks
enough copies of the input that they exceed the 50 MB L2, so each call
reads its input from HBM), with CUDA events; then each call traced with
``torch.profiler`` for its kernel's own device time.  ``torch.mul`` of the
int8 values by the broadcast scales is timed beside dequantize.  Each run
prints one JSON line (label, card, and per shape and dtype the times in us
and the byte bound at 3.35 TB/s) and appends it to
``chiprun_out/codec_bench.jsonl``.  To compare two trees, unpack the
parent's ``git archive`` into a git-ignored directory (e.g. ``build/``) and
run parent, change, change, parent in one call on one card.  Needs a CUDA
card."""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 40          # warm calls in a captured graph
ROUNDS = 3         # timed replays of each graph, averaged
COLD_BYTES = 100e6  # inputs walked by a cold graph: twice the L2


def graph_us(torch, fns) -> float:
    """Mean device time in us of one call of ``fns`` (a list of calls, run
    in turn and repeated to at least REPS) replayed as one CUDA graph."""
    import chip_smoke as cs
    calls = fns * max(1, -(-REPS // len(fns)))
    timer = cs.Timer(torch, lambda: [f() for f in calls], reps=1)
    us = sum(timer.ms() for _ in range(ROUNDS)) / ROUNDS * 1e3 / len(calls)
    del timer
    torch.cuda.synchronize()
    return us


def kernel_us(torch, fn, name: str) -> float:
    """Device time in us of the kernels whose name holds ``name``, a
    call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if name in e.key) / 10


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("codec_bench: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch import core
    from repro_torch.kernels import quant as kquant
    from repro_torch.models import cnn, profiles

    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    micro, batch4, *_ = cs.codec_shapes(cnn, core, profiles)
    rows = {}
    for shape in micro + batch4:
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            x = (3 * torch.randn(shape, generator=gen)).to(dtype).to(dev)
            axis = kquant.default_channel_axis(x.ndim)
            n, esize = x.numel(), x.element_size()
            copies = min(1024, max(2, math.ceil(COLD_BYTES
                                                / (n * (esize + 1)))))
            xs = [x] + [x.clone() for _ in range(copies - 1)]
            qs = [kquant.quantize_boundary(t) for t in xs]
            q, s = qs[0]
            groups = s.numel()
            s_b = s.view([-1 if d == axis else 1 for d in range(x.ndim)])
            row = {
                "quantize": graph_us(torch, [
                    lambda: kquant.quantize_boundary(x)]),
                "quantize_cold": graph_us(torch, [
                    (lambda t=t: kquant.quantize_boundary(t)) for t in xs]),
                "quantize_kernel": kernel_us(
                    torch, lambda: kquant.quantize_boundary(x),
                    "quantize_kernel"),
                "dequantize": graph_us(torch, [
                    lambda: kquant.dequantize_boundary(q, s,
                                                       out_dtype=dtype)]),
                "dequantize_cold": graph_us(torch, [
                    (lambda a=a, b=b: kquant.dequantize_boundary(
                        a, b, out_dtype=dtype)) for a, b in qs]),
                "dequantize_kernel": kernel_us(
                    torch, lambda: kquant.dequantize_boundary(
                        q, s, out_dtype=dtype), "dequantize_kernel"),
                "torch_mul": graph_us(torch, [lambda: torch.mul(q, s_b)]),
                "quantize_bound": (esize * n + n + 4 * groups)
                / cs.PEAK_BYTES * 1e6,
                "dequantize_bound": (n + 4 * groups + esize * n)
                / cs.PEAK_BYTES * 1e6,
                "cold_copies": copies}
            rows[f"{tuple(shape)} {dname}"] = row
            del xs, qs
            torch.cuda.empty_cache()
    out = dict(label=args.label, src=os.path.abspath(args.src), card=card,
               us=rows)
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "codec_bench.jsonl"),
              "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
