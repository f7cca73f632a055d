"""Time the hybrid LM's prefill and decode steps on the card at the
benchmark configuration's widths, and check the flash kernel's softmax
scale there.

    python3 scripts/granite_probe.py [--layers 20] [--seed N] [--src DIR]
        [--label NAME]

Draws the model of ``chipbench/configs/granite-4.0-h-small-bf16.json``
(20 layers, bf16) from the seed; times one prefill at each (batch, prompt
length) with a synchronise around it (CUDA events, after one untimed
call of the same shape); at each batch, after a 512-token prefill, runs
127 greedy decode steps (a request's 128 tokens less the prefill's) as
the engine does (the token to the card, ``decode``, the logits to the
host, the argmax) and reports the host milliseconds of the first step
and the median and mean of the rest, with what the model's counters say
of them (``decode_eager_steps``, ``decode_graph_steps``,
``graph_captures``, where the model has them); reads the peak memory;
and holds ``flash_attention(..., scale=1/128)`` and the default scale
against ``attention_plain`` at a prefill shape.
``--src`` is the ``src`` directory whose ``repro_torch`` is probed
(default: this tree's), so one call can probe two trees in turns.
Prints one JSON line and writes it to ``chiprun_out/granite_probe.json``
(``granite_probe_<label>.json`` with ``--label``).  ``--tiny --device
cpu`` rehearses the walk on the CPU at a tiny size."""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
COUNTERS = ("decode_eager_steps", "decode_graph_steps", "graph_captures")
STEPS = 127


def _time(fn, device) -> float:
    """Seconds of one call of ``fn`` after an untimed one."""
    import torch
    fn()
    if device.type != "cuda":
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t
    torch.cuda.synchronize(device)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=20)
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_plain
    from repro_torch.models import granite_hybrid as gh

    dev = torch.device(args.device)
    with open(os.path.join(ROOT, "chipbench", "configs",
                           "granite-4.0-h-small-bf16.json")) as f:
        cfg = gh.GraniteHybridConfig.from_dict(
            dict(json.load(f), num_hidden_layers=args.layers))
    lengths, batches = (512, 1024, 2048), (1, 4, 8, 16)
    if args.tiny:
        cfg = gh.tiny()
        lengths, batches = (8, 16), (1, 4)
    out = {"card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu", "layers": cfg.num_hidden_layers}

    # the flash kernel's scale at a prefill shape
    g = torch.Generator(device=dev).manual_seed(0)
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    S = lengths[-1]
    q = torch.randn(2, S, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(2, S, KV, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(2, S, KV, hd, generator=g, device=dev).bfloat16()
    for name, scale in (("granite", cfg.attention_multiplier),
                        ("default", None)):
        got = fa.flash_attention(q, k, v, causal=True, scale=scale).float()
        want = attention_plain(q.float(), k.float(), v.float(), causal=True,
                               scale=scale)
        out[f"flash_{name}_err"] = float(
            ((got - want).abs().amax(-1) / want.abs().amax(-1)).max())
    del q, k, v

    t = time.perf_counter()
    model = gh.GraniteHybrid(cfg, gh.init_params(cfg, args.seed, dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["init_s"] = time.perf_counter() - t
    ids = torch.Generator(device="cpu").manual_seed(1)
    prefill, decode = {}, {}
    for L in lengths:
        for B in batches:
            tok = torch.randint(0, cfg.vocab_size, (B, L), generator=ids)
            tok = tok.to(dev)

            def run_prefill():
                model.prefill(tok, model.init_cache(B, L + 8))
            prefill[f"{B}x{L}"] = _time(run_prefill, dev)
    L = lengths[0]
    for B in batches:
        tok = torch.randint(0, cfg.vocab_size, (B, L), generator=ids).to(dev)
        before = {k: model.stats.get(k) for k in COUNTERS}
        logits, cache = model.prefill(
            tok, model.init_cache(B, L + STEPS + 1))
        cur = logits.cpu().numpy().argmax(-1)
        host = []
        for _ in range(STEPS):
            t = time.perf_counter()
            logits, cache = model.decode(
                torch.as_tensor(cur, dtype=torch.long, device=dev)[:, None],
                cache)
            cur = np.argmax(logits.cpu().numpy(), axis=-1)
            host.append(time.perf_counter() - t)
        rest = [1e3 * h for h in host[1:]]
        decode[str(B)] = dict(
            first_ms=1e3 * host[0], median_ms=statistics.median(rest),
            mean_ms=statistics.fmean(rest),
            **{k: None if before[k] is None else model.stats[k] - before[k]
               for k in COUNTERS})
    out.update(src=os.path.abspath(args.src), prefill_s=prefill,
               decode_host_ms=decode, moe=model.load_stats())
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    print(json.dumps(out))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = f"granite_probe_{args.label}.json" if args.label \
        else "granite_probe.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
