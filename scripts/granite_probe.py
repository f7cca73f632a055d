"""Time the hybrid LM's prefill and decode steps on the card at the
benchmark configuration's widths, and check the flash kernel's softmax
scale there.

    python3 scripts/granite_probe.py [--layers 20] [--seed N]

Draws the model of ``chipbench/configs/granite-4.0-h-small-bf16.json``
(20 layers, bf16) from the seed; times one prefill at each (batch, prompt
length) and a decode step at each batch, with a synchronise around each
(CUDA events, after one untimed call of the same shape); reads the peak
memory; and holds ``flash_attention(..., scale=1/128)`` and the default
scale against ``attention_plain`` at a prefill shape.  Prints one JSON
line and writes it to ``chiprun_out/granite_probe.json``.  ``--tiny
--device cpu`` rehearses the walk on the CPU at a tiny size."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


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
    args = ap.parse_args()
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
        _, cache = model.prefill(tok, model.init_cache(B, L + 8))
        one = tok[:, :1]
        state = {"cache": cache}

        def run_decode():
            _, state["cache"] = model.decode(one, state["cache"])
        decode[str(B)] = _time(run_decode, dev)
    out.update(prefill_s=prefill, decode_s=decode, moe=model.load_stats())
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    print(json.dumps(out))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "granite_probe.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
