"""The benchmark of ``repro_torch`` on NVIDIA cards: one run of one cell.

    python3 chipbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout.  ``--trace 0`` sets the cell up, serves
its traffic for ``--seconds`` and prints the cell's end-to-end metrics;
``--trace 1`` serves a window of at most ``TRACE_SECONDS`` under
``torch.profiler`` with the benchmark's spans around the program's layers
and prints the per-layer metrics.  Either way the run then frees the
program, holds what the window produced to the plain reference, and
prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, traced also ``breakdown``, then
``checks``: each number compared with its limit, also the last lines on
standard error).  Without a CUDA card, or with fewer than the cell asks
for, it prints no result and exits 2; if JAX or the JAX package was loaded
it exits 3.  Builds and kernel caches stay inside the checkout."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]

TRACE_SECONDS = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (default: ``sys.modules``) whose top-level name is
    JAX's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run_cell(bench: dict, workload: str, *, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = T_START,
             control=None, overrides: dict | None = None) -> dict:
    """One run of ``workload``: the result line's fields, ``checks`` last.
    ``device="cpu"`` runs the program's plain versions, and ``overrides``
    (``{"config": {...}, "mix": {...}}``) sizes a cell down to what the CPU
    can hold (the tests do both); ``control`` is a storage type whose
    reference takes the program's place in the comparison that decides
    ``correct``."""
    import torch

    from chipbench import energy, manifest, tracing

    cell = manifest.cell(bench, workload)
    overrides = overrides or {}
    config = {**manifest.config(cell["config"]), **overrides.get("config", {})}
    mix = {**manifest.mix(cell["traffic"]), **overrides.get("mix", {})}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sut = manifest.driver(config["driver"]).System(config, mix, seed, dev)
    meter = energy.Meter(dev) if on_card else None
    undo = [tracing.wrap(*s) for s in sut.spans()] if trace else []
    setup_s = time.perf_counter() - t_start
    found = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            win = sut.window(
                min(seconds, TRACE_SECONDS),
                span=lambda: torch.profiler.record_function(tracing.WINDOW))
        for u in undo:
            u()
        found = tracing.read(prof)
        del prof
    else:
        with gc_pauses() as pauses:
            win = sut.window(seconds, meter)
        win["gc_max_s"] = max(pauses, default=0.0)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    checks = sut.program_checks()
    refs = sut.reference_checks(sut.free(), control=control)
    checks["logit_err"] = (refs["logit_err"],
                           config["limits"]["logit_err"])
    correct = all(lim is not None and v <= lim
                  for v, lim in checks.values())
    run = dict(window=win, trace=found, setup_s=setup_s, peak_bytes=peak,
               config=config, mix=mix, workload=workload)
    metrics = {}
    for m in manifest.metrics_of(bench, workload, trace):
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(dev) if on_card
                else "cpu", "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["attempted"] - win["images"],
           "metrics": metrics, "device": dev_info}
    if found is not None:
        dev_info.update(busy_s=found.busy_s, window_s=found.window_s)
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in found.device_ops()],
            "idle_gaps": [[n, s] for n, s in found.idle_gaps()]}
        out["trace_counts"] = {"kernels": len(found.kernels),
                               "launch_calls": found.launch_calls,
                               "unmatched": found.unmatched}
    out["reference"] = {k: v for k, v in refs.items() if k != "logit_err"}
    if win.get("batch_ends_s"):
        print(steadiness(win), file=sys.stderr)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


@contextlib.contextmanager
def gc_pauses():
    """The seconds of each of the interpreter's garbage collections inside
    the block."""
    import gc
    pauses, t = [], {}

    def watch(phase, info):
        if phase == "start":
            t["s"] = time.perf_counter()
        elif "s" in t:
            pauses.append(time.perf_counter() - t.pop("s"))

    gc.callbacks.append(watch)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(watch)


def steadiness(win: dict) -> str:
    """How steady the window ran, for the run's standard error: the gaps
    between batches' ends, images a second, the longest gap, the longest
    garbage collection, and (open loop) how late the generator ran."""
    import numpy as np
    ends = np.asarray(win["batch_ends_s"])
    gaps = np.diff(ends, prepend=0.0) * 1e3
    q = np.percentile(gaps, [5, 25, 50, 75, 95])
    per = win["images"] / len(ends)
    rates = [(np.searchsorted(ends, k + 1) - np.searchsorted(ends, k)) * per
             for k in range(int(ends[-1]))]
    return ("batch gap ms p5/25/50/75/95 " + " ".join(f"{v:.2f}" for v in q)
            + f"; longest {gaps.max():.1f} ms at {ends[gaps.argmax()]:.2f} s"
            + f"; gc longest {1e3 * win.get('gc_max_s', 0.0):.1f} ms"
            + (f"; generator late {1e3 * win['late_s']:.1f} ms"
               if "late_s" in win else "")
            + "; images/s second by second "
            + " ".join(f"{r:.0f}" for r in rates))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from chipbench import manifest

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"chipbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    print(f"chipbench: {card_line()}", file=sys.stderr)
    out = run_cell(bench, args.workload, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"chipbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
