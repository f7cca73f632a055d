"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
(the port of ``repro.launch.serve``, the same options).

Boots the bucketed batch decode engine (``serving.engine``) on the reduced
config (vocab <= 512), optionally planning the SmartSplit placement first
(``--plan-split`` prints the chosen split on the H100 edge + cloud pods
and its predicted objective triple).

``--cnn <model>`` instead serves one of the paper's CNNs through the
fault-tolerant chain runtime: plans a K-tier chain placement (``--tiers``,
K=2 being the paper's phone/cloud environment), executes
microbatch-pipelined requests across per-hop ``FaultyLink``s whose fault
profiles come from ``REPRO_LINK_*`` / ``REPRO_LINK{k}_*`` env knobs (or
``--drop``), and reports recoveries -- retries, stage merges, Pareto-front
re-picks -- next to throughput and the CUDA kernels' launch counts.
``--cnn --concurrency N`` serves a stream of N single-sample requests
through the batched split-serving engine (``serving.cnn_engine``).
``--tier-faults {crash,straggler,shed}`` layers a canned compute-side
chaos profile on the first server tier, on either CNN path.

Runs on the card (``--device cuda``, the default; it raises when there
is none) or, when asked, on the CPU through the plain PyTorch versions
(``--device cpu``)."""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import all_configs
from repro_torch.core import (CONV_DTYPES, WIRE_DTYPES, h100_edge_cloud,
                              smartsplit)
from repro_torch.core.dtype_policy import conv_dtype
from repro_torch.core.dtype_policy import dtype_bytes as policy_bytes
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.kernels import launches


def _tier_fault_models(profile, hw, clock):
    """Per-tier ``FaultyTier`` list for ``--tier-faults`` / env knobs.

    Env knobs (``REPRO_TIER_*`` / ``REPRO_TIER{k}_*``) are the baseline;
    a canned ``--tier-faults`` profile then replaces the first server
    tier's spec (never the phone -- tier 0 failing has no failover
    story).  Returns ``None`` when everything is fault free so callers
    keep the unprotected legacy runtime path."""
    from repro_torch.runtime.tier_faults import (FaultyTier, TierFaultSpec,
                                                 tier_faults_from_env)
    names = [t.name for t in hw.tiers]
    tiers = tier_faults_from_env(names, clock=clock)
    if profile is None:
        if all(t.faults.fault_free for t in tiers):
            return None
        return tiers
    canned = {
        # dies for the first quarter-second of virtual time: every early
        # request hits the window -> breaker trips -> standby failover
        "crash": TierFaultSpec(crash_windows=((0.0, 0.25),)),
        # half the stage executions run 6x slow: no failures, just
        # honest tail latency (TIER_SLOW events)
        "straggler": TierFaultSpec(slow_rate=0.5, slow_factor=6.0),
        # 1-byte admission budget: every stage is shed at dispatch
        "shed": TierFaultSpec(mem_budget=1.0),
    }[profile]
    k = 1 if len(names) > 1 else 0
    tiers[k] = FaultyTier(names[k], faults=canned, seed=tiers[k].seed,
                          clock=clock)
    return tiers


def serve_cnn_stream(args, *, params=None, quiet: bool = False) -> dict:
    """``--cnn --concurrency N``: a stream of N single-sample requests
    through the batched split-serving engine (``serving.cnn_engine``):
    bounded queue, (model, resolution, dtype, wire) batch buckets,
    cross-request pipelining on the virtual clock (``--no-pipeline``
    for the sequential baseline).  ``params`` (default: ``init_cnn`` at
    seed 0 on the device) lets a caller serve given weights.  Returns the
    engine, its requests, the wall time of ``run_until_idle`` and the
    kernel launch counts of the run."""
    from repro_torch.core import paper_chain
    from repro_torch.models import cnn as cnn_lib
    from repro_torch.runtime import FaultSpec, RetryPolicy
    from repro_torch.runtime.faults import chain_links_from_env
    from repro_torch.serving.cnn_engine import CnnServingEngine

    dev = resolve_device(args.device)
    strict_fp32()
    say = (lambda *a: None) if quiet else print
    num_tiers = args.tiers if args.tiers is not None \
        else int(os.environ.get("REPRO_CHAIN_TIERS", 2))
    hw = paper_chain(num_tiers)
    links = chain_links_from_env([link.bandwidth for link in hw.links])
    if args.drop:
        for link in links:
            link.faults = FaultSpec(drop_rate=args.drop)
    if params is None:
        params = cnn_lib.init_cnn(cnn_lib.CNN_MODELS[args.cnn], device=dev)
    tier_models = _tier_fault_models(args.tier_faults, hw,
                                     links[0]._clock if links else None)
    eng = CnnServingEngine(
        {args.cnn: params}, hw=hw, max_batch=args.max_batch,
        pipelined=False if args.no_pipeline else None, dtype=args.dtype,
        wire=args.wire_dtype, links=links, tier_faults=tier_models,
        policy=RetryPolicy.from_env(), device=dev)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.concurrency):
        x = rng.normal(size=cnn_lib.INPUT_SHAPE).astype(np.float32)
        reqs.append(eng.submit(x, args.cnn, at=0.0))
    before = launches.snapshot()
    t0 = time.perf_counter()
    eng.run_until_idle()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in launches.snapshot().items()}
    s = eng.stats()
    mode = "pipelined" if s["pipelined"] else "sequential"
    say(f"served {s['served']}/{s['submitted']} requests "
        f"({mode}, {s['batches']} batches of "
        f"~{s['avg_batch_size']:.1f}) in {dt:.1f}s wall / "
        f"{s['virtual_span_s']:.4f}s virtual "
        f"({s['requests_per_s']:.1f} req/s virtual; "
        f"p50={s['latency_p50_s'] * 1e3:.1f}ms "
        f"p99={s['latency_p99_s'] * 1e3:.1f}ms) "
        f"repicks={s['repicks']} merges={s['merges']}")
    if tier_models is not None:
        for k, (ft, br) in enumerate(zip(s["tiers"], s["breakers"])):
            say(f"  tier{k}: exec={ft['executions']} "
                f"crashes={ft['crashes']} sheds={ft['sheds']} "
                f"slow={ft['slowdowns']} breaker={br['state']} "
                f"(opened {br['opens']}x)")
        say(f"  failovers={s['failovers']} "
            f"fallback_device={s['fallback_device']}")
    for h in s["hops"]:
        link_c = h["link"]
        say(f"  hop{h['hop']}: wire={h['wire_dtype']} "
            f"attempts={h['attempts']} sent={h['wire_bytes']}B "
            f"goodput={h['goodput_Bps']:.3g}B/s "
            f"retx={h['retransmitted_bytes']}B "
            f"degradation={h['degradation']:.2f} "
            f"({link_c['dropped']} dropped / {link_c['timeouts']} "
            f"timeouts)")
    say(f"  on {dev}, kernel launches: "
        + " ".join(f"{k}={v}" for k, v in counts.items()))
    return {"engine": eng, "requests": reqs, "seconds": dt,
            "launches": counts}


def serve_cnn(args, *, params=None, quiet: bool = False) -> dict:
    """Fault-tolerant CNN chain serving (the paper's actual workload).

    Plans a K-tier chain placement and executes ``args.requests``
    requests of one ``(args.batch, 3, 224, 224)`` input through
    ``ChainRuntime``.  ``params`` (default: ``init_cnn`` at seed 0 on
    the device) lets a caller serve given weights.  Returns the runtime,
    its plan, the input, the last request's result, the wall time and
    the kernel launch counts of the run."""
    from repro_torch.core import paper_chain, smartsplit_chain
    from repro_torch.models import cnn as cnn_lib
    from repro_torch.models.profiles import cnn_profile
    from repro_torch.runtime import (ChainRuntime, FaultSpec, RetryPolicy,
                                     chain_links_from_env)

    dev = resolve_device(args.device)
    strict_fp32()
    say = (lambda *a: None) if quiet else print
    policy = conv_dtype(args.dtype)
    num_tiers = args.tiers if args.tiers is not None \
        else int(os.environ.get("REPRO_CHAIN_TIERS", 2))
    microbatch = args.microbatch if args.microbatch is not None \
        else int(os.environ.get("REPRO_CHAIN_MICROBATCH", 1))
    hw = paper_chain(num_tiers)
    prof = cnn_profile(args.cnn, batch=args.batch, dtype=policy)
    plan = smartsplit_chain(prof, hw, microbatches=microbatch,
                            wire=args.wire_dtype)
    lat, en, mem = plan.objectives
    chain = " -> ".join(f"{t}[{a}:{b})" for t, (a, b)
                        in zip(plan.tiers, plan.stages()))
    wires = plan.wire_dtypes or ("?",) * len(hw.links)
    say(f"SmartSplit chain: {chain}")
    say(f"  cuts={list(plan.cuts)}/{prof.num_layers} M={microbatch} "
        f"latency={lat:.2e}s energy={en:.2e}J "
        f"device-mem={mem / 2**20:.1f}MiB ({policy}, "
        f"wire={'/'.join(wires)})")

    links = chain_links_from_env([link.bandwidth for link in hw.links])
    if args.drop:
        for link in links:
            link.faults = FaultSpec(drop_rate=args.drop)
    tier_models = _tier_fault_models(args.tier_faults, hw,
                                     links[0]._clock if links else None)
    layers = cnn_lib.CNN_MODELS[args.cnn]
    if params is None:
        params = cnn_lib.init_cnn(layers, device=dev)
    rt = ChainRuntime(args.cnn, params, plan, prof, hw, links=links,
                      dtype=policy, wire=args.wire_dtype,
                      microbatches=microbatch, tier_faults=tier_models,
                      policy=RetryPolicy.from_env())
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.normal(size=(args.batch,) + cnn_lib.INPUT_SHAPE),
        dtype=torch.float32, device=dev)
    before = launches.snapshot()
    t0 = time.perf_counter()
    for _ in range(args.requests):
        r = rt.infer(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in launches.snapshot().items()}
    s = rt.stats()
    say(f"served {s['requests']} requests in {dt:.1f}s "
        f"({s['requests'] / dt:.2f} req/s) on {dev}; "
        f"recovered={s['recovered']} merges={s['merges']} "
        f"repicks={s['repicks']} proactive={s['proactive_resplits']} "
        f"active_cuts={s['active_cuts']}")
    if tier_models is not None:
        for k, (ft, br) in enumerate(zip(s["tiers"], s["breakers"])):
            say(f"  tier{k} ({s['active_tiers'][k]}): "
                f"exec={ft['executions']} crashes={ft['crashes']} "
                f"sheds={ft['sheds']} slow={ft['slowdowns']} "
                f"breaker={br['state']} (opened {br['opens']}x)")
        say(f"  failovers={s['failovers']} "
            f"fallback_device={s['fallback_device']}")
    for h in s["hops"]:
        link_c = h["link"]
        say(f"  hop{h['hop']}: wire={h['wire_dtype']} "
            f"attempts={h['attempts']} "
            f"sent={h['wire_bytes']}B (raw {h['raw_bytes']}B) "
            f"retx={h['retransmitted_bytes']}B merges={h['merges']} "
            f"est_bw={h['est_bandwidth']:.3g}B/s "
            f"degradation={h['degradation']:.2f} "
            f"({link_c['dropped']} dropped / {link_c['timeouts']} "
            f"timeouts / {link_c['outage_hits']} outage-hits)")
    say("  kernel launches: " + " ".join(f"{k}={v}"
                                         for k, v in counts.items()))
    return {"runtime": rt, "plan": plan, "x": x, "result": r,
            "seconds": dt, "launches": counts}


def plan_split(cfg, batch: int, dtype: str | None = None):
    """``--plan-split``: the SmartSplit placement of ``cfg``'s prefill
    profile (64 tokens, ``batch``) under the storage dtype policy, on the
    H100 edge + cloud pods computing in that dtype, and the
    ``SmartSplit:`` line the launcher prints."""
    from repro_torch.launch.partition import split_boundary_struct
    from repro_torch.models.profiles import transformer_profile

    policy = conv_dtype(dtype)
    prof = transformer_profile(cfg, seq_len=64, batch=batch, mode="prefill",
                               dtype_bytes=policy_bytes(policy))
    plan = smartsplit(prof, h100_edge_cloud(policy))
    lat, en, mem = plan.objectives
    _, link_bytes = split_boundary_struct(cfg, batch, 64, dtype=policy)
    return plan, (f"SmartSplit: l1={plan.split_index}/{cfg.num_layers} "
                  f"latency={lat:.2e}s energy={en:.2e}J "
                  f"edge-mem={mem / 2**20:.1f}MiB "
                  f"boundary={link_bytes}B ({policy})")


def serve_arch(args, *, quiet: bool = False) -> dict:
    """``--arch``: the bucketed decode engine on the reduced config (vocab
    <= 512) with ``init_params`` at seed 0 in fp32 on the device,
    ``--requests`` greedy requests of 8, 16 or 24
    prompt tokens; ``--plan-split`` first prints the SmartSplit placement
    of the prefill profile on the H100 pods (``plan_split``) and its
    boundary's bytes.  Returns the engine,
    its requests, the wall time of ``run_until_idle`` and the plan."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine

    dev = resolve_device(args.device)
    strict_fp32()
    say = (lambda *a: None) if quiet else print
    cfg = all_configs()[args.arch].reduced()
    cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512))
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only: no serving decode")

    plan = None
    if args.plan_split:
        plan, line = plan_split(cfg, args.max_batch, args.dtype)
        say(line)

    params = T.init_params(cfg, 0, torch.float32, dev)
    eng = Engine(cfg, params, max_len=128, max_batch=args.max_batch,
                 device=dev)
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.choice([8, 16, 24]))
        reqs.append(eng.submit(rng.integers(0, cfg.vocab_size,
                                            plen).tolist(),
                               max_new_tokens=args.max_new_tokens))
    t0 = time.perf_counter()
    eng.run_until_idle()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in reqs)
    say(f"served {len(reqs)} requests / {toks} tokens in {dt:.1f}s "
        f"({toks / dt:.1f} tok/s on {dev}, "
        f"{int(eng.stats['batches'])} batches, "
        f"p50={eng.stats['latency_p50_s'] * 1e3:.0f}ms "
        f"p99={eng.stats['latency_p99_s'] * 1e3:.0f}ms)")
    return {"engine": eng, "requests": reqs, "seconds": dt, "plan": plan,
            "config": cfg}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=sorted(all_configs()))
    ap.add_argument("--cnn", default=None,
                    help="serve a paper CNN through the fault-tolerant "
                         "split runtime instead (alexnet/vgg16/...)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                         "card) runs the CUDA kernels, cpu their plain "
                         "PyTorch versions")
    ap.add_argument("--drop", type=float, default=0.0,
                    help="--cnn only: injected per-attempt drop rate "
                         "(REPRO_LINK_* env knobs cover the rest)")
    ap.add_argument("--tier-faults", default=None,
                    choices=("crash", "straggler", "shed"),
                    help="--cnn only: canned compute-fault profile on the "
                         "first server tier (layered over REPRO_TIER_* / "
                         "REPRO_TIER{k}_* env knobs); exercises circuit "
                         "breakers and standby-tier failover")
    ap.add_argument("--tiers", type=int, default=None,
                    help="--cnn only: chain length K (2=paper phone/cloud, "
                         "3=+edge, 4=+regional; default REPRO_CHAIN_TIERS "
                         "or 2)")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="--cnn only: pipeline depth M (default "
                         "REPRO_CHAIN_MICROBATCH or 1)")
    ap.add_argument("--batch", type=int, default=4,
                    help="--cnn only: request batch size (microbatching "
                         "splits this)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--concurrency", type=int, default=None,
                    help="--cnn only: serve a stream of N concurrent "
                         "single-sample requests through the batched "
                         "split-serving engine instead of synchronous "
                         "whole-batch calls")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="--cnn --concurrency only: sequential baseline "
                         "(no cross-request pipelining)")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--plan-split", action="store_true")
    ap.add_argument("--dtype", default=None, choices=CONV_DTYPES,
                    help="storage dtype policy (--cnn) and boundary dtype "
                         "for --plan-split (default: REPRO_CONV_DTYPE, "
                         "else fp32)")
    ap.add_argument("--wire-dtype", default=None, choices=WIRE_DTYPES,
                    help="--cnn only: boundary wire format for every hop "
                         "(int8 = quantized streaming; default: "
                         "REPRO_LINK{k}_WIRE_DTYPE / REPRO_WIRE_DTYPE, "
                         "else follow = the storage dtype)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.cnn:
        if args.concurrency:
            serve_cnn_stream(args)
        else:
            serve_cnn(args)
        return
    serve_arch(args)


if __name__ == "__main__":
    main()
