"""End-to-end serving on the PyTorch port (the paper's kind:
inference).

Serves a small qwen3-family model with batched requests through the
port's bucketed engine, THEN plans a SmartSplit two-tier placement for
the same model on the H100 edge + cloud pods (``h100-edge-cloud``, fp32
as the example runs) and executes the split
across a 2-pod mesh with the port's two-stage executor (both pods on one
device), verifying split == monolithic logits and reporting the boundary
bytes against the plan's prediction; then runs the paper's CNN on a
3-tier chain through the chain runtime.

Run:  PYTHONPATH=src python examples/torch_split_serving.py [--device cpu]
(the card by default; without one it raises unless ``--device cpu``).
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import all_configs
from repro_torch.core import H100_EDGE_CLOUD, smartsplit
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.smartsplit_exec import two_stage_apply
from repro_torch.models import transformer as T
from repro_torch.models.profiles import transformer_profile
from repro_torch.serving.engine import Engine


def close(a, b, tol):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=tol,
                               atol=tol)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(all_configs()["qwen3-4b"].reduced(),
                              num_layers=4, name="qwen3-mini")
    params = T.init_params(cfg, 0, torch.float32, dev)

    # ---- batched serving ---------------------------------------------------
    eng = Engine(cfg, params, max_len=96, max_batch=4, device=dev)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(10):
        plen = int(rng.choice([8, 8, 8, 16, 16, 24]))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        reqs.append(eng.submit(prompt, max_new_tokens=8))
    t0 = time.time()
    eng.run_until_idle()
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.output) for r in reqs)
    print(f"served {done}/10 requests, {toks} tokens in {dt:.1f}s "
          f"({eng.stats['batches']:.0f} batches, bucketed by length)")
    assert done == 10

    # ---- SmartSplit plan on the H100 two-tier profile -----------------------
    prof = transformer_profile(cfg, seq_len=32, batch=4, mode="prefill",
                               dtype_bytes=4)   # example runs f32
    plan = smartsplit(prof, H100_EDGE_CLOUD)
    print(f"SmartSplit plan for {cfg.name}: l1={plan.split_index}/"
          f"{cfg.num_layers} layers on the edge pod "
          f"(boundary {prof.boundary()[plan.split_index]:.0f} B predicted)")

    # ---- execute the split across the pod axis -----------------------------
    mesh = make_debug_mesh((2,), ("pod",), device=dev)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen).to(dev)
    with torch.no_grad():
        mono, _, _ = T.forward(cfg, params, {"tokens": toks}, mode="train")
        split = two_stage_apply(cfg, params, toks, mesh, plan.split_index)
        close(split, mono, 2e-3)
        print("two-stage (pod0=edge, pod1=cloud) logits match monolithic: "
              "OK")

        # boundary payload actually transferred = hidden state bytes
        actual = 4 * 32 * cfg.d_model * 4   # B x S x d, f32
        print(f"boundary activation transferred per ppermute: {actual} B")

        # ---- pipelined variant (beyond-paper) -------------------------------
        piped = two_stage_apply(cfg, params, toks, mesh, plan.split_index,
                                pipelined=True, microbatches=2)
        close(piped, mono, 2e-3)
    print("GPipe-style microbatched split matches monolithic: OK")

    # ---- N-tier CNN chain: device -> edge -> core ---------------------------
    # The paper's CNN workload on a 3-tier chain plan (K-1=2 cuts), executed
    # through the fault-tolerant chain runtime with M=2 microbatch pipelining.
    from repro_torch.core import paper_chain, smartsplit_chain
    from repro_torch.models import cnn as cnn_lib
    from repro_torch.models.profiles import cnn_profile
    from repro_torch.runtime import ChainRuntime

    in_shape, batch = (3, 64, 64), 4
    hw3 = paper_chain(3)                    # J6 phone -> edge server -> core DC
    cprof = cnn_profile("alexnet", batch=batch, in_shape=in_shape)
    cplan = smartsplit_chain(cprof, hw3, microbatches=2)
    chain = " -> ".join(f"{t}[{a}:{b})" for t, (a, b)
                        in zip(cplan.tiers, cplan.stages()))
    print(f"chain plan: {chain} "
          f"(predicted latency {cplan.objectives[0]:.3f}s at M=2)")

    layers = cnn_lib.CNN_MODELS["alexnet"]
    cparams = cnn_lib.init_cnn(layers, in_shape, device=dev)
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(batch,) + in_shape), dtype=torch.float32).to(dev)
    crt = ChainRuntime("alexnet", cparams, cplan, cprof, hw3,
                       microbatches=2)
    with torch.no_grad():
        res = crt.infer(x)
        mono_cnn = cnn_lib.apply_cnn(layers, cparams, x)
    close(res.logits, mono_cnn, 1e-5)
    print(f"device->edge->core chain logits match single-device: OK "
          f"(M={res.microbatches}, virtual makespan "
          f"{res.chain_elapsed_s:.3f}s)")


if __name__ == "__main__":
    main()
