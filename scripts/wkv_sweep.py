#!/usr/bin/env python3
"""Sweep the WKV kernel's launch geometry at ``chip_smoke.py``'s phase-7
WKV call (RWKV6-7B: B 2, T 2000, 64 heads of 64; ``--batch`` sets B),
fp32 and bf16, on one card.  Every run-time geometry in ``GRID``
(columns a CTA, steps a stage, stages) that ``plan_wkv`` takes with the
compiled tile (``TILES``) is set in ``DEFAULTS``, launched once through
the wrapper and held against the plain version at phase 8's tolerance,
then timed: a CUDA graph of back-to-back launches, CUDA events, warm L2,
the best of three replays.  The planner's default geometry is marked.
The tile a thread holds is fixed at compile time; comparing tiles means
editing ``TILES`` and the CUDA table alike.

    python3 scripts/wkv_sweep.py [--batch B]

Prints each dtype's fastest points and the default's rank; one JSON line
per point goes to ``chiprun_out/wkv_sweep.jsonl``.  Needs a CUDA card."""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = dict(jc=(16, 32, 64), steps=(8, 12, 16, 24, 32), stages=(2,))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wkv_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    from repro_torch import configs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as kwkv

    strict_fp32()
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda")
    case = dict(next(c for c in cs.mixer_cases(configs, kwkv.RWKV_HD)
                     if c["kernel"] == "rwkv6_wkv"), B=args.batch)
    gen = torch.Generator(device=dev).manual_seed(4)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    failed = 0
    with open(os.path.join(out_dir, "wkv_sweep.jsonl"), "a") as log:
        for d, tname in cs.DTYPES:
            dtype = getattr(torch, tname)
            inputs = cs.mixer_inputs(torch, case, dtype, gen, dev)
            want = ref.rwkv6_wkv_plain(*inputs)
            shape = (case["B"], case["T"], case["H"], case["hd"])
            key = (case["hd"], dtype)
            default = kwkv.DEFAULTS[key]
            bound = 1e3 * max(cs.mixer_bound(case, d)[:2])
            rows = []
            for geo in itertools.product(*GRID.values()):
                kwkv.DEFAULTS[key] = geo
                try:
                    plan = kwkv.plan_wkv(*shape, dtype)
                except ValueError:
                    continue
                got = kwkv.rwkv6_wkv(*inputs)
                err, rel = cs.row_err(got, want)
                ok = rel <= cs.MIXER_TOL[("rwkv6_wkv", d)]
                failed += not ok
                timer = cs.Timer(torch, lambda: kwkv.rwkv6_wkv(*inputs),
                                 reps=5)
                ms = min(timer.ms() for _ in range(3))
                del timer
                row = dict(card=card, dtype=d, B=case["B"],
                           **dict(zip(GRID, geo)), rows=plan.rows,
                           cols=plan.cols, threads=plan.threads,
                           smem=plan.smem, ctas_per_sm=plan.ctas_per_sm,
                           ms=ms, bound_ms=bound, max_abs_err=err,
                           max_row_rel_err=rel, ok=ok, default=geo == default)
                rows.append(row)
                log.write(json.dumps(row) + "\n")
            kwkv.DEFAULTS[key] = default
            rows.sort(key=lambda r: r["ms"])
            rank = next(i for i, r in enumerate(rows) if r["default"])
            print(f"{d} B {case['B']}: {len(rows)} geometries; default "
                  f"{[rows[rank][k] for k in GRID]} ranks {rank + 1} at "
                  f"{rows[rank]['ms']:.4f} ms (bound {bound:.4f})")
            for r in rows[:8]:
                print(f"  {[r[k] for k in GRID]} {r['ms']:.4f} ms "
                      f"threads {r['threads']} smem {r['smem']} "
                      f"ctas/SM {r['ctas_per_sm']} "
                      f"err {r['max_row_rel_err']:.2g}")
    if failed:
        print(f"wkv_sweep: {failed} geometries missed the tolerance",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
