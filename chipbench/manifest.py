"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``mixes/<traffic>.json``); a configuration names its driver
(``drivers/<driver>.py``), and the driver owns the plain reference it
checks the system against (``reference/``).  Every metric, end to end or
per layer, is read by ``metrics/<name>.py``, or, where there is no such
file, by the reader of the name before its first dot (``idle_share.py``
reads ``idle_share.fused`` and ``idle_share.open``: one quantity, split
by the end-to-end metric it moves).  A new configuration, mix or metric
is new files and new entries only."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return _json(HERE / "mixes" / f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"chipbench.drivers.{name}")


def reader(name: str):
    """The module that reads metric ``name`` (its ``read(run)``): its own
    file, else the file of the name before the first dot."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric without a
    ``workloads`` key belongs to every cell that reports what it moves."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]
