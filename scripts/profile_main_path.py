#!/usr/bin/env python3
"""Where a served request's time goes, on one card.

    python3 scripts/profile_main_path.py [--src DIR] [--label NAME]
                                         [--paths request,stream,decode,train]
                                         [--dtype fp32|bf16]

Each path is traced with ``torch.profiler`` (CPU and CUDA) after an
untraced warm-up on the same shapes, under the storage policy ``--dtype``
(default fp32: CNN ``--dtype``, transformer params, cache and
``TrainConfig.dtype``):

- ``request`` (default): ``repro_torch.launch.serve.serve_cnn`` for AlexNet
  (K=2, follow wire), MobileNetV2 (K=3, M=4, int8 wire) and VGG16 (K=2,
  follow wire) at 224 px, batch 4; three more requests of each are
  traced.
- ``stream``: ``serve_cnn_stream`` for AlexNet and MobileNetV2, K=3 with
  the int8 wire, 16 single-sample requests in batch buckets of 4,
  pipelined; a second stream is traced around ``run_until_idle``.
- ``decode``: Qwen3-4B at full width and depth (seeded weights on the
  card) in ``repro_torch.serving.engine.Engine``; one batch of 4
  requests of 16 prompt tokens and 8 new tokens is traced after a warm-up
  batch of the same shapes, with ``prefill`` and ``decode_step`` spans.
- ``train``: Qwen3-4B at full width and depth in
  ``repro_torch.training.train_loop.train`` at the JAX package's
  ``TrainConfig`` defaults (batch 8 x 128 tokens); step 2 is traced, from
  the end of step 1 (synchronized) to the end of step 2 (synchronized),
  with ``data`` (the prefetcher's ``next``), ``forward`` (``loss_fn``),
  ``backward`` and ``optimizer`` (``apply_updates``) spans.

The CNN paths read the program's own spans (``repro_torch/spans.py``):
``chain/stage`` (``ChainRuntime._run``), ``codec/encode``, ``link/send``
and ``codec/decode``; on a ``--src`` tree whose program has no spans of
its own their columns read zero.  The decode and train spans are wrapped
around the program's functions here, in the script.  Prints, per
configuration and unit of work (a request, or a decode pass): host time,
device busy time (the kernels' and copies' own time), the device's idle
share, kernel launches, the memory copies between host and card by kind
(``Memcpy DtoH``, ``Memcpy HtoD``, ...), the host time of each span,
and the device kernels by total time.  ``--src`` is the ``src``
directory whose ``repro_torch`` is profiled (default: this
checkout's), e.g. that of a ``git archive`` of the parent commit unpacked
into a git-ignored directory, to compare two trees in one call.  Writes the
same to ``chiprun_out/profile_main_path_<label>.json`` and a Chrome trace
per CNN configuration (none of the decode batch: ~60 MB).  Needs an NVIDIA
card."""
from __future__ import annotations

import argparse
import gc
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
    ("vgg16", ["--tiers", "2", "--microbatch", "1", "--wire-dtype",
               "follow"]),
]
STREAM = ["--tiers", "3", "--wire-dtype", "int8", "--concurrency", "16",
          "--max-batch", "4"]
SPANS = ("chain/stage", "codec/encode", "link/send", "codec/decode")
DECODE_SPANS = ("prefill", "decode_step")
TRAIN_SPANS = ("data", "forward", "backward", "optimizer")


def _wrap(torch, owner, name, label):
    fn = getattr(owner, name)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(owner, name, wrapped)


def _summary(prof, spans, n, wall):
    """Device events per unit of work (n units over ``wall`` seconds).
    Device time counts the device's own events (kernels, copies): CPU ops
    also report their kernels' time, and every host span, the script's and
    the program's alike, appears again as a device-side annotation
    covering its kernels, under the span's name."""
    from torch.autograd import DeviceType
    averages = prof.key_averages()
    host = {e.key for e in averages if e.device_type == DeviceType.CPU}
    device = sorted(
        ((e.key, e.self_device_time_total / n, e.count / n)
         for e in averages
         if e.device_type == DeviceType.CUDA
         and e.self_device_time_total > 0 and e.key not in host),
        key=lambda r: -r[1])
    busy = sum(us for _, us, _ in device) / 1e6
    span_ms = dict.fromkeys(spans, 0.0)
    for e in prof.events():
        if e.name in spans and e.device_type == DeviceType.CPU:
            span_ms[e.name] += e.cpu_time_total / n / 1e3
    memcpy = {}
    for k, _, c in device:
        if k.startswith("Memcpy"):
            memcpy[k] = memcpy.get(k, 0) + c
    return dict(host_ms=1e3 * wall / n, device_busy_ms=1e3 * busy,
                device_idle_share=1.0 - busy / (wall / n),
                launches=sum(c for k, _, c in device
                             if not k.startswith("Memcpy")),
                memcpy=memcpy, span_host_ms=span_ms,
                device_us=[dict(name=k, us=us, calls=c)
                           for k, us, c in device])


def _print(what, row, top=8):
    print(f"{what}: {row['host_ms']:.3f} ms on the host clock, device busy "
          f"{row['device_busy_ms']:.3f} ms (idle share "
          f"{row['device_idle_share']:.3f}), {row['launches']:.1f} kernel "
          f"launches")
    print("  host ms by span: " + ", ".join(
        f"{k}={v:.3f}" for k, v in sorted(row["span_host_ms"].items())))
    print(f"  memory copies: {json.dumps(row['memcpy'])}")
    for d in row["device_us"][:top]:
        print(f"  device {d['us']:9.1f} us  x{d['calls']:<6.1f} "
              f"{d['name'][:80]}")


def profile_request(torch, profile, acts, serve, out_dir, label, dtype):
    rows, n_req = [], 3
    for model, argv in CONFIGS:
        argv = [*argv, "--dtype", dtype]
        sargs = serve.parse_args(["--cnn", model, "--batch", "4",
                                  "--requests", "2", *argv])
        warm = serve.serve_cnn(sargs, quiet=True)     # builds, warms up
        rt, x = warm["runtime"], warm["x"]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n_req):
                rt.infer(x)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        row = dict(model=model, argv=argv, **_summary(prof, SPANS, n_req,
                                                      wall))
        rows.append(row)
        prof.export_chrome_trace(os.path.join(
            out_dir, f"trace_{label}_{model}.json"))
        _print(f"{model} {' '.join(argv)}, per request", row)
    return rows


def profile_stream(torch, profile, acts, serve, cnn_engine, out_dir, label,
                   dtype):
    run = cnn_engine.CnnServingEngine.run_until_idle
    traced = []

    def run_traced(self):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run(self)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        traced.append((prof, wall))

    rows, argv = [], [*STREAM, "--dtype", dtype]
    for model in ("alexnet", "mobilenetv2"):
        args = serve.parse_args(["--cnn", model, *argv])
        serve.serve_cnn_stream(args, quiet=True)           # warm-up
        cnn_engine.CnnServingEngine.run_until_idle = run_traced
        try:
            out = serve.serve_cnn_stream(args, quiet=True)
        finally:
            cnn_engine.CnnServingEngine.run_until_idle = run
        prof, wall = traced.pop()
        n = out["engine"].stats()["served"]
        row = dict(model=model, argv=argv, requests=n,
                   **_summary(prof, SPANS, n, wall))
        rows.append(row)
        prof.export_chrome_trace(os.path.join(
            out_dir, f"trace_{label}_stream_{model}.json"))
        _print(f"stream {model} K3 int8 {dtype}, per request", row)
    return rows


def profile_decode(torch, profile, acts, all_configs, T, Engine, dtype):
    cfg = all_configs()["qwen3-4b"]
    dev = torch.device("cuda")
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    params = T.init_params(cfg, 0, tdt, dev)
    eng = Engine(cfg, params, max_len=128, max_batch=4, dtype=tdt,
                 device=dev)
    _wrap(torch, eng, "_prefill", "prefill")
    _wrap(torch, eng, "_decode", "decode_step")
    gen = torch.Generator().manual_seed(0)

    def batch():
        for _ in range(4):
            eng.submit(torch.randint(0, cfg.vocab_size, (16,),
                                     generator=gen).tolist(),
                       max_new_tokens=8)

    batch()
    eng.run_until_idle()                                   # warm-up
    batch()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    passes = 8                          # one prefill + 7 decode steps
    row = dict(config="qwen3-4b", dtype=dtype, batch=4, prompt=16,
               new_tokens=8, tokens_per_s=4 * 8 / wall, passes=passes,
               **_summary(prof, DECODE_SPANS, passes, wall))
    _print(f"decode qwen3-4b {dtype} batch 4, per pass (prefill or decode "
           f"step)", row, top=6)
    print(f"  {row['tokens_per_s']:.1f} tokens/s over the traced batch")
    return row


def profile_train(torch, profile, acts, all_configs, train_loop, T, opt,
                  pipeline, dtype):
    """One warm Qwen3-4B train step traced inside ``train()``."""
    cfg = all_configs()["qwen3-4b"]
    dev = torch.device("cuda")
    tcfg = train_loop.TrainConfig(
        steps=4, log_every=10,
        dtype="bfloat16" if dtype == "bf16" else "float32")
    _wrap(torch, T, "loss_fn", "forward")
    _wrap(torch, opt, "apply_updates", "optimizer")
    _wrap(torch, torch.autograd, "backward", "backward")
    _wrap(torch, pipeline.Prefetcher, "__next__", "data")
    real_step = train_loop.make_train_step
    state = {"calls": 0}

    def traced_step(cfg_, ocfg):
        step_fn = real_step(cfg_, ocfg)

        def step(*args):
            if state["calls"] == 2:
                prof = state["prof"]
            out = step_fn(*args)
            state["calls"] += 1
            if state["calls"] == 2:             # end of step 1
                torch.cuda.synchronize()
                state["prof"] = profile(activities=acts)
                state["prof"].__enter__()
                state["t0"] = time.perf_counter()
            elif state["calls"] == 3:           # end of step 2
                torch.cuda.synchronize()
                state["wall"] = time.perf_counter() - state["t0"]
                prof.__exit__(None, None, None)
            return out
        return step

    train_loop.make_train_step = traced_step
    try:
        train_loop.train(cfg, tcfg, log=lambda line: None, device=dev)
    finally:
        train_loop.make_train_step = real_step
    row = dict(config="qwen3-4b", dtype=dtype, batch=tcfg.batch,
               seq_len=tcfg.seq_len,
               tokens_per_s=tcfg.batch * tcfg.seq_len / state["wall"],
               **_summary(state["prof"], TRAIN_SPANS, 1, state["wall"]))
    _print(f"train qwen3-4b {dtype} batch 8 x 128, per step", row, top=10)
    print(f"  {row['tokens_per_s']:.0f} tokens/s over the traced step")
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--paths", default="request",
                    help="comma-separated: request, stream, decode, "
                         "train")
    ap.add_argument("--dtype", default="fp32", choices=("fp32", "bf16"),
                    help="storage policy of every path")
    args = ap.parse_args()
    paths = args.paths.split(",")
    bad = set(paths) - {"request", "stream", "decode", "train"}
    if bad:
        ap.error(f"unknown paths {sorted(bad)}")
    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import strict_fp32
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, args.label, os.path.abspath(args.src))
    strict_fp32()
    _build.build_all()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    report = {"card": card, "label": args.label, "dtype": args.dtype,
              "src": os.path.abspath(args.src)}
    if "request" in paths:
        report["request"] = profile_request(torch, profile, acts, serve,
                                            out_dir, args.label, args.dtype)
    if "stream" in paths:
        from repro_torch.serving import cnn_engine
        report["stream"] = profile_stream(torch, profile, acts, serve,
                                          cnn_engine, out_dir, args.label,
                                          args.dtype)
    if "decode" in paths:
        from repro_torch.configs import all_configs
        from repro_torch.models import transformer as T
        from repro_torch.serving.engine import Engine
        report["decode"] = profile_decode(torch, profile, acts, all_configs,
                                          T, Engine, args.dtype)
    if "train" in paths:
        # the decode engine's wrapped methods hold it (and its weights) in
        # a reference cycle: free them before the step needs the card
        gc.collect()
        torch.cuda.empty_cache()
        from repro_torch.configs import all_configs
        from repro_torch.data import pipeline
        from repro_torch.models import transformer as T
        from repro_torch.training import optimizer as opt
        from repro_torch.training import train_loop
        report["train"] = profile_train(torch, profile, acts, all_configs,
                                        train_loop, T, opt, pipeline,
                                        args.dtype)
    with open(os.path.join(out_dir, f"profile_main_path_{args.label}.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
