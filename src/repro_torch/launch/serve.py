"""Serving launcher: ``python -m repro_torch.launch.serve --cnn <model>``.

Serves one of the paper's CNNs through the fault-tolerant chain runtime
(the synchronous ``--cnn`` path of ``repro.launch.serve``): plans a
K-tier chain placement (``--tiers``, K=2 being the paper's phone/cloud
environment), executes microbatch-pipelined requests across per-hop
``FaultyLink``s whose fault profiles come from ``REPRO_LINK_*`` /
``REPRO_LINK{k}_*`` env knobs (or ``--drop``), and reports recoveries --
retries, stage merges, Pareto-front re-picks -- next to throughput and
the CUDA kernels' launch counts.  ``--tier-faults {crash,straggler,shed}``
layers a canned compute-side chaos profile on the first server tier.

Runs on the card (``--device cuda``, the default; it raises when there
is none) or, when asked, on the CPU through the plain PyTorch versions
(``--device cpu``)."""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.core import CONV_DTYPES, WIRE_DTYPES
from repro_torch.core.dtype_policy import conv_dtype
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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--cnn", required=True,
                    help="serve a paper CNN through the fault-tolerant "
                         "split runtime (alexnet/vgg16/mobilenetv2/...)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                         "card) runs the CUDA kernels, cpu their plain "
                         "PyTorch versions")
    ap.add_argument("--drop", type=float, default=0.0,
                    help="injected per-attempt drop rate (REPRO_LINK_* "
                         "env knobs cover the rest)")
    ap.add_argument("--tier-faults", default=None,
                    choices=("crash", "straggler", "shed"),
                    help="canned compute-fault profile on the first "
                         "server tier (layered over REPRO_TIER_* / "
                         "REPRO_TIER{k}_* env knobs)")
    ap.add_argument("--tiers", type=int, default=None,
                    help="chain length K (2=paper phone/cloud, 3=+edge, "
                         "4=+regional; default REPRO_CHAIN_TIERS or 2)")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="pipeline depth M (default "
                         "REPRO_CHAIN_MICROBATCH or 1)")
    ap.add_argument("--batch", type=int, default=4,
                    help="request batch size (microbatching splits this)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--dtype", default=None, choices=CONV_DTYPES,
                    help="storage dtype policy (default: "
                         "REPRO_CONV_DTYPE, else fp32)")
    ap.add_argument("--wire-dtype", default=None, choices=WIRE_DTYPES,
                    help="boundary wire format for every hop (int8 = "
                         "quantized streaming; default: "
                         "REPRO_LINK{k}_WIRE_DTYPE / REPRO_WIRE_DTYPE, "
                         "else follow = the storage dtype)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    serve_cnn(parse_args(argv))


if __name__ == "__main__":
    main()
