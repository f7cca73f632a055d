#!/usr/bin/env python3
"""Where a served request's time goes, on one card.

    python3 scripts/profile_main_path.py [--src DIR] [--label NAME]

Serves AlexNet (K=2, follow wire) and MobileNetV2 (K=3, M=4, int8 wire)
at 224 px, batch 4, through ``repro_torch.launch.serve.serve_cnn``, then
traces three more requests of each with ``torch.profiler`` (CPU and
CUDA).  The runtime's stages are wrapped in ``record_function`` spans
here, in the script: stage compute (``ChainRuntime._run``), boundary
encode, link send, decode.  Prints, per configuration: host time per
request, device busy time per request (the kernels' and copies' own
time), the device's idle share, the host time of each span, and the
device kernels by total time, and the memory copies between host and
card per request by kind (``Memcpy DtoH``, ``Memcpy HtoD``, ...).
``--src`` is the ``src`` directory whose ``repro_torch`` is profiled
(default: this checkout's), e.g. that of a ``git archive`` of the parent
commit unpacked into a git-ignored directory, to compare two trees in one
call.  Writes the same to ``chiprun_out/profile_main_path_<label>.json``
and a Chrome trace per configuration.  Needs an NVIDIA card."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [
    ("alexnet", ["--tiers", "2", "--microbatch", "1", "--wire-dtype",
                 "follow"]),
    ("mobilenetv2", ["--tiers", "3", "--microbatch", "4", "--wire-dtype",
                     "int8"]),
]
SPANS = ("stage_compute", "encode_boundary", "send_with_retry",
         "decode_boundary")


def _wrap(torch, module, name, label):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapped)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.runtime import runtime as rt_mod

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, args.label, os.path.abspath(args.src))
    _build.build_all()
    _wrap(torch, rt_mod.ChainRuntime, "_run", "stage_compute")
    for name in SPANS[1:]:
        _wrap(torch, rt_mod, name, name)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = {"card": card, "label": args.label,
              "src": os.path.abspath(args.src), "configs": []}
    n_req = 3
    for model, argv in CONFIGS:
        sargs = serve.parse_args(["--cnn", model, "--batch", "4",
                                  "--requests", "2", *argv])
        warm = serve.serve_cnn(sargs, quiet=True)     # builds, warms up
        rt, x = warm["runtime"], warm["x"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_req):
                rt.infer(x)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n_req
        # device time of the device's own events (kernels, copies): CPU ops
        # also report their kernels' time, and the spans appear again as
        # device-side annotations covering their kernels
        device = sorted(
            ((e.key, e.self_device_time_total / n_req, e.count // n_req)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0 and e.key not in SPANS),
            key=lambda r: -r[1])
        busy = sum(us for _, us, _ in device) / 1e6
        spans = dict.fromkeys(SPANS, 0.0)
        for e in prof.events():
            if e.name in SPANS and e.device_type == DeviceType.CPU:
                spans[e.name] += e.cpu_time_total / n_req / 1e3
        memcpy = {}
        for name, _, calls in device:
            if name.startswith("Memcpy"):
                memcpy[name] = memcpy.get(name, 0) + calls
        row = dict(model=model, argv=argv, host_ms_per_request=1e3 * wall,
                   device_busy_ms_per_request=1e3 * busy,
                   device_idle_share=1.0 - busy / wall,
                   span_host_ms_per_request=spans,
                   memcpy_per_request=memcpy,
                   device_us_per_request=[
                       dict(name=k, us=us, calls=c) for k, us, c in device])
        report["configs"].append(row)
        prof.export_chrome_trace(os.path.join(
            out_dir, f"trace_{args.label}_{model}.json"))
        print(f"{model} {' '.join(argv)}: {1e3 * wall:.2f} ms/request on "
              f"the host clock, device busy {1e3 * busy:.3f} ms "
              f"(idle share {1.0 - busy / wall:.3f})")
        print("  host ms per request by span: " + ", ".join(
            f"{k}={v:.3f}" for k, v in sorted(spans.items())))
        print(f"  memory copies per request: {json.dumps(memcpy)}")
        for k, us, c in device[:8]:
            print(f"  device {us:9.1f} us  x{c:<4d} {k[:90]}")
    with open(os.path.join(out_dir, f"profile_main_path_{args.label}.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
