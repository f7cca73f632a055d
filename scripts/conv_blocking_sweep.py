#!/usr/bin/env python3
"""Time the dense conv kernel at every register blocking, on one card.

    python3 scripts/conv_blocking_sweep.py

For each dense conv of the served main path (AlexNet and MobileNetV2 at
224 px, batch 4 and its batch-1 microbatches, fp32), plans the launch at
each (COT, PT) blocking of ``repro_torch.kernels.conv2d.BLOCKINGS`` that
fits, times it (CUDA graph of back-to-back launches, CUDA events), and
times ``F.conv2d`` beside it.  Prints one row per shape with the fastest
blocking and the one ``plan_conv`` picks, and writes every time to
``chiprun_out/conv_blocking_sweep.json`` -- the data the planner's
blocking rule is set from.  Needs an NVIDIA card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("conv_blocking_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch.nn.functional as F

    from chip_smoke import Timer, conv_kwargs, in_turns, make_inputs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import _build
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.models import cnn

    strict_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    calls, seen = [], set()
    for name in ("alexnet", "mobilenetv2"):
        for batch in (4, 1):
            for c in cnn.conv_launches(cnn.CNN_MODELS[name], batch=batch):
                key = (c["x_shape"], c["w_shape"], c["stride"], c["pad"],
                       c["groups"], c["pool_k"])
                if c["groups"] == 1 and key not in seen:
                    seen.add(key)
                    calls.append(dict(c, model=name))
    all_blockings = kconv.BLOCKINGS
    rows = []
    for call in calls:
        x, w, b = make_inputs(torch, call, torch.float32, gen, dev)
        kw = conv_kwargs(call)
        kconv.plan_conv.cache_clear()
        picked = kconv.plan_conv(call["x_shape"], call["w_shape"],
                                 stride=call["stride"], pad=call["pad"],
                                 activation=call["activation"],
                                 pool_k=call["pool_k"],
                                 pool_s=call["pool_s"])
        timers, geoms = {}, {}
        for blocking in all_blockings:
            kconv.BLOCKINGS = (blocking,)
            kconv.plan_conv.cache_clear()
            try:
                g = kconv.plan_conv(call["x_shape"], call["w_shape"],
                                    stride=call["stride"], pad=call["pad"],
                                    activation=call["activation"],
                                    pool_k=call["pool_k"],
                                    pool_s=call["pool_s"])
            except ValueError:
                continue
            geoms[blocking] = g
            timers[blocking] = Timer(
                torch, lambda: kconv.conv2d(x, w, bias=b, **kw))
        kconv.BLOCKINGS = all_blockings
        kconv.plan_conv.cache_clear()
        timers["library"] = Timer(torch, lambda: F.conv2d(
            x, w, b, stride=call["stride"], padding=call["pad"]))
        t = in_turns(timers)
        lib = t.pop("library")
        best = min(t, key=t.get)
        rows.append(dict(
            model=call["model"], x=list(call["x_shape"]),
            w=list(call["w_shape"]), stride=call["stride"],
            pool=call["pool_k"], library_us=1e3 * lib,
            picked=[picked.cot, picked.pt], best=list(best),
            us={f"{c}x{p}": 1e3 * v for (c, p), v in t.items()},
            ctas={f"{c}x{p}": g.ctas for (c, p), g in geoms.items()}))
        print(f"{call['model'][:5]} x={call['x_shape']} w={call['w_shape']}"
              f" best {best} {1e3 * t[best]:.1f} us, picked "
              f"{(picked.cot, picked.pt)} "
              f"{1e3 * t[(picked.cot, picked.pt)]:.1f} us, library "
              f"{1e3 * lib:.1f} us")
    tot = {k: sum(r[k] for r in rows) for k in ("library_us",)}
    tot["best_us"] = sum(min(r["us"].values()) for r in rows)
    tot["picked_us"] = sum(r["us"]["{}x{}".format(*r["picked"])]
                           for r in rows)
    print(json.dumps(tot))
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "conv_blocking_sweep.json"), "w") as f:
        json.dump(dict(card=card, rows=rows, totals=tot), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
