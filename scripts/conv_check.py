#!/usr/bin/env python3
"""Build the kernels and hold the conv kernels to their plain version and
to each other on one card, then time VGG16's conv shapes on both dense
kernels: phases 1-3 of ``chip_smoke.py`` and its VGG16 conv-path timing
alone (the card's name and power limit; every source built, the SASS and
register checks; every served conv against the plain version, fused ==
unfused, batch 4 == four batch 1, the warp-specialised kernel == the
one-warpgroup kernel, bitwise; VGG16's 13 convs at bf16, batches 16 and
1) -- the short call after a conv kernel changes.  First it runs one
VGG16 conv on each dense kernel and prints how they differ, so a broken
kernel shows what it computed before the checks stop the run.  With
``--cnn`` it also runs the CNN paths of ``chip_smoke.py``: phase 4 (the
codec), phase 5 (``serve_cnn``, the five CNNs, launches and geometries),
phase 9 (the stream) and phase 6's CNN timings (rows 1-4 of the kernel
table, VGG16's batch-4 forward) -- everything of the script but the
sequence kernels, the transformer paths and the energy constants.

    python3 scripts/conv_check.py [--cnn]

Exits non-zero on a failed check; writes ``chiprun_out/conv_check.json``.
Needs a CUDA card."""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def first_launch(torch, cs, cnn, kconv, ref, dev) -> None:
    """One VGG16 conv of each warp-specialised BN at batch 2: its error
    against the plain version and against the one-warpgroup kernel."""
    gen = torch.Generator().manual_seed(30)
    seen = set()
    for call in cnn.conv_launches(cnn.CNN_MODELS["vgg16"], batch=2):
        plan = cs.conv_plan(kconv.plan_conv, call, torch.bfloat16)
        if not plan.ws or plan.bn in seen:
            continue
        seen.add(plan.bn)
        x, w, b = cs.make_inputs(torch, call, torch.bfloat16, gen, dev)
        kw = cs.conv_kwargs(call)
        got = kconv.launch(x, w, b, plan)
        old = kconv.launch(x, w, b, cs.conv_plan(kconv.plan_conv_dense, call,
                                                 torch.bfloat16))
        want = ref.conv2d_plain(x, w, bias=b, **kw)
        torch.cuda.synchronize()
        err, scale = cs.rel_err(got, want)
        diff = (got.float() - old.float()).abs()
        print(f"first launch: BN {plan.bn} {tuple(call['x_shape'])} "
              f"{tuple(call['w_shape'])} pool {call['pool_k']}: err "
              f"{err:.3g} of scale {scale:.3g}; against conv2d_dense "
              f"{int((diff > 0).sum())} of {diff.numel()} differ (max "
              f"{float(diff.max()):.3g})", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("conv_check: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.models import cnn

    t0 = time.perf_counter()
    strict_fp32()
    print(cs.card_line())
    _, report = cs.phase_build(_build)
    dev = torch.device("cuda")
    first_launch(torch, cs, cnn, kconv, ref, dev)
    worst, rows, conv_checked = cs.phase_conv(torch, F, cnn, kconv, ref,
                                              dev)
    detail = dict(card=cs.card_line(), kernel_report=report["conv2d"],
                  conv_checks=rows)
    if "--cnn" in sys.argv[1:]:
        from repro_torch import core, runtime
        from repro_torch.kernels import launches
        from repro_torch.kernels import quant as kquant
        from repro_torch.launch import serve
        from repro_torch.models import profiles
        micro, batch4, extra, every = cs.codec_shapes(cnn, core, profiles)
        shapes = micro + batch4 + extra + cs.SPLIT_CODEC_SHAPES + every
        quickstart = cs.quickstart_boundary(cnn, core, profiles)
        codec_worst, _, codec_checked = cs.phase_codec(
            torch, kquant, ref, shapes + [quickstart], dev)
        checked = (conv_checked, codec_checked)
        counts, runs, _ = cs.phase_main(torch, cnn, serve, launches, kquant,
                                        runtime, kconv, checked, dev)
        stream_counts, _, _ = cs.phase_stream(torch, cnn, serve, launches,
                                              kquant, kconv, checked, dev)
        agg, timings = cs.phase_time(torch, F, cnn, kconv, kquant, ref,
                                     micro + batch4, dev)
        vgg16 = cs.phase_time_vgg16(torch, F, cnn, kconv, runs, dev)
        print(json.dumps({"launches": counts, "launches_stream": stream_counts,
                          "kernels": {k: {q: v for q, v in a.items()
                                          if not isinstance(v, dict)}
                                      for k, a in agg.items()}}))
        detail.update(launches=counts, launches_stream=stream_counts,
                      kernels=agg, timings=timings, vgg16_forward=vgg16)
    detail["conv_paths"] = cs.phase_time_conv_paths(torch, F, cnn, kconv,
                                                    dev)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "conv_check.json"), "w") as f:
        json.dump(detail, f, indent=1)
    print(f"conv_check: every check passed in {time.perf_counter() - t0:.1f}"
          f" s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
