#!/usr/bin/env python3
"""Time the dense conv kernels at every channel block, on one card.

    python3 scripts/conv_blocking_sweep.py [--ws]

For each dense conv of the served main path (AlexNet and MobileNetV2 at
224 px, batch 4 and its batch-1 microbatches, fp32 and bf16), plans the
launch at each channel block BN of ``repro_torch.kernels.conv2d.BNS``
and each shared-memory budget of BUDGETS (which sets the ring's depth
and how many CTAs share an SM), times it (CUDA graph of back-to-back
launches, CUDA events) and times ``F.conv2d`` beside it.  The K
decomposition (k-steps, stages, segments) is the weights' and is not a
lever.  Then scores the planner's rule -- the widest BN giving
``TARGET_CTAS[dtype]`` CTAs, else the one giving the most -- at several
targets and budgets against the per-shape best.  Prints one row per
shape and the score of each target and budget, and writes every time to
``chiprun_out/conv_blocking_sweep.json``: the data the planner's rule is
set from.

With ``--ws``, the warp-specialised kernel instead: each of VGG16's bf16
convs it takes, at batches 16, 4 and 1, planned at each BN of
``WS_BNS`` whose tiles fill, timed the same way; then the planner's BN
rule (the fewest waves at WS_IMAGES images, each weighed by
WS_STAGE_COST) scored at several weights against the per-shape best
(``chiprun_out/conv_ws_sweep.json``).  Needs an NVIDIA card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = (66, 132, 198, 264, 396, 528)
# WS_STAGE_COST candidates: a stage's weight at BN 256, 128, 64
WS_COSTS = ((2.0, 1.0, 1.0), (1.5, 1.0, 1.0), (1.25, 1.0, 1.0),
            (2.0, 1.0, 0.75), (1.5, 1.0, 0.75), (1.0, 1.0, 1.0))
BUDGETS = (113 * 1024, 75 * 1024, 56 * 1024)   # 2, 3, 4 CTAs an SM


def rule(ctas: dict, target: int) -> int:
    """The planner's pick among {bn: ctas} at ``target``."""
    for bn in sorted(ctas, reverse=True):
        if ctas[bn] >= target:
            return bn
    return max(ctas, key=lambda bn: (ctas[bn], bn))


def ws_rule(kconv, ctas: dict, costs) -> int:
    """The planner's BN among {bn: CTAs at WS_IMAGES images} weighed by
    ``costs`` (BN 256, 128, 64)."""
    weight = dict(zip(kconv.WS_BNS, costs))
    return min(ctas, key=lambda bn: (-(-ctas[bn] // kconv.SMS) * weight[bn],
                                     -bn))


def sweep_ws(torch, F, kconv, cnn, Timer, in_turns, conv_kwargs,
             make_inputs, card) -> int:
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)
    all_bns = kconv.WS_BNS
    rows = []
    for batch in (16, 4, 1):
        for call in cnn.conv_launches(cnn.CNN_MODELS["vgg16"], batch=batch):
            kw = conv_kwargs(call)
            x, w, b = make_inputs(torch, call, torch.bfloat16, gen, dev)
            timers, ctas = {}, {}
            for bn in all_bns:
                kconv.WS_BNS = (bn,)
                kconv.plan_conv.cache_clear()
                g = kconv.plan_conv(call["x_shape"], call["w_shape"],
                                    dtype=torch.bfloat16, **kw)
                if g.ws:
                    ctas[bn] = g.ctas // batch * kconv.WS_IMAGES
                    timers[bn] = Timer(
                        torch, lambda g=g: kconv.launch(x, w, b, g))
            kconv.WS_BNS = all_bns
            kconv.plan_conv.cache_clear()
            if not timers:
                continue
            t = in_turns(timers)
            picked = kconv.plan_conv(call["x_shape"], call["w_shape"],
                                     dtype=torch.bfloat16, **kw).bn
            rows.append(dict(batch=batch, x=list(call["x_shape"]),
                             w=list(call["w_shape"]), pool=call["pool_k"],
                             picked=picked, ctas=ctas,
                             us={bn: 1e3 * v for bn, v in t.items()}))
            print(f"b{batch} x={call['x_shape']} w={call['w_shape']} "
                  f"picked bn{picked}: " + ", ".join(
                      f"bn{bn} {1e3 * v:.1f} us" for bn, v in t.items()))
    scores = {}
    for costs in WS_COSTS:
        key = "/".join(map(str, costs))
        scores[key] = {b: sum(r["us"][ws_rule(kconv, r["ctas"], costs)]
                              for r in rows if r["batch"] == b)
                       for b in (16, 4, 1)}
    scores["best"] = {b: sum(min(r["us"].values()) for r in rows
                             if r["batch"] == b) for b in (16, 4, 1)}
    print(json.dumps(scores))
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "conv_ws_sweep.json"), "w") as f:
        json.dump(dict(card=card, rows=rows, scores=scores), f, indent=1)
    return 0


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
    if "--ws" in sys.argv[1:]:
        return sweep_ws(torch, F, kconv, cnn, Timer, in_turns, conv_kwargs,
                        make_inputs, card)
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
    all_bns, budget0 = kconv.BNS, kconv.RING_BUDGET
    rows = []
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for call in calls:
            x, w, b = make_inputs(torch, call, dtype, gen, dev)
            kw = conv_kwargs(call)
            timers, ctas = {}, {}
            for budget in BUDGETS:
                for bn in all_bns:
                    kconv.BNS, kconv.RING_BUDGET = (bn,), budget
                    kconv.plan_conv.cache_clear()
                    g = kconv.plan_conv(call["x_shape"], call["w_shape"],
                                        dtype=dtype, **kw)
                    ctas[bn] = g.ctas
                    timers[(bn, budget)] = Timer(
                        torch, lambda: kconv.conv2d(x, w, bias=b, **kw))
            kconv.BNS, kconv.RING_BUDGET = all_bns, budget0
            kconv.plan_conv.cache_clear()
            timers["library"] = Timer(torch, lambda: F.conv2d(
                x, w, b.to(dtype), stride=call["stride"],
                padding=call["pad"]))
            t = in_turns(timers)
            lib = t.pop("library")
            picked = kconv.plan_conv(call["x_shape"], call["w_shape"],
                                     dtype=dtype, **kw).bn
            best = min(t, key=t.get)
            rows.append(dict(
                dtype=dname, model=call["model"], x=list(call["x_shape"]),
                w=list(call["w_shape"]), stride=call["stride"],
                pool=call["pool_k"], library_us=1e3 * lib, picked=picked,
                best=list(best),
                us={f"{bn}/{bud // 1024}": 1e3 * v
                    for (bn, bud), v in t.items()},
                ctas={str(k): v for k, v in ctas.items()}))
            print(f"{dname} {call['model'][:5]} x={call['x_shape']} "
                  f"w={call['w_shape']} best bn{best[0]}/"
                  f"{best[1] // 1024}KB {1e3 * t[best]:.1f} us, picked "
                  f"bn{picked}/{budget0 // 1024}KB "
                  f"{1e3 * t[(picked, budget0)]:.1f} us, library "
                  f"{1e3 * lib:.1f} us")
    scores = {}
    for dname in ("fp32", "bf16"):
        sub = [r for r in rows if r["dtype"] == dname]

        def rule_us(r, tg, bud):
            bn = rule({int(k): v for k, v in r["ctas"].items()}, tg)
            return r["us"][f"{bn}/{bud // 1024}"]
        scores[dname] = dict(
            best_us=sum(min(r["us"].values()) for r in sub),
            library_us=sum(r["library_us"] for r in sub),
            picked_us=sum(r["us"][f"{r['picked']}/{budget0 // 1024}"]
                          for r in sub),
            rule_us={f"{tg}/{bud // 1024}": sum(rule_us(r, tg, bud)
                                                for r in sub)
                     for tg in TARGETS for bud in BUDGETS})
        print(dname, json.dumps(scores[dname]))
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "conv_blocking_sweep.json"), "w") as f:
        json.dump(dict(card=card, rows=rows, scores=scores), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
