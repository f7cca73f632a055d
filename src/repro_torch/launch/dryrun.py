"""Multi-pod dry-run of the port: the counterpart of
``repro.launch.dryrun``.

Runs every (architecture x input shape x mesh) cell's step function
(``partition.make_train_step``, ``make_prefill_step``,
``make_encode_step``, ``make_decode_step``) on the sharded structs of
``launch/partition.py`` -- meta tensors: no allocation and no card, at
any size -- and writes one JSON record a cell, with the JAX package's
keys, to a directory the caller names.  ``analysis/roofline.py`` reads
the records.

What each key holds (``analysis/hlo.py`` says what each counter counts):

* ``cost`` -- per-device flops and bytes of the real depth: the global
  eager counts over the number of devices.  Eager PyTorch runs every
  layer and every inner trip, so nothing is counted once for a loop as
  XLA counts a while body, and the port needs no extrapolation for its
  cost.  ``cost_scan_raw`` (the JAX package's key for the count before
  extrapolation) is the same count.  ``cost_extrapolated`` -- the same
  counts over the two depth variants of ``_variant_plan`` (B2/B4, or
  Z1/Z2 Zamba2 segments), extrapolated to the real depth by
  ``_extrapolate``, the slope the collectives are extrapolated by: its
  agreement with ``cost`` checks that slope.  The two agree wherever the depth
  fills whole Zamba2 segments (Zamba2-7B's 81 layers in segments of 6
  leave 3 padded slots and one shared attention that the port skips and
  the JAX package computes and masks, so the extrapolation counts them).
* ``memory`` -- ``argument_size_in_bytes``: the per-device bytes of the
  step's sharded arguments, from their specs.  The other sizes are
  ``null``: meta tensors have no allocator, so what the step allocates
  is not measured (``memory_note`` says so).
* ``collective_bytes`` / ``collective_counts`` -- from a second pass on
  DTensors under a fake process group of ``num_devices`` ranks (no data
  moves), extrapolated over the variants.  The pass runs on a 2-D
  (pod x data, model) DeviceMesh: every rule shards pod and data
  together (``mesh.data_axes``), so the layout is the same as on the
  3-D mesh, whose redistribution planner stalled (minutes for one
  layer).  The specs compared with the JAX package stay the 3-D ones.
  The DeviceMesh is a CPU one (its cost model is the same on every
  host), and DTensor's CPU mesh has no all-to-all: a Shard-to-Shard
  redistribution is an all-gather and a local slice, and counts as an
  all-gather.  A variant whose plain pass dispatches more than
  ``COLLECTIVE_OP_BUDGET`` aten ops, or whose DTensor pass raises, gets
  ``collective_bytes: null`` and a ``collectives`` key that says why; a
  one-device mesh issues no collectives, so its counts are 0 with no
  pass.  Under ``REPRO_MOE_EP=1`` (the default) the JAX package
  dispatches experts that divide the model axis expert-parallel; the
  port's pass runs the local dispatch, so ``moe_ep_in_counts`` is false.

No global state is set on import: the fake process group exists only
inside ``lower_cell``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out DIR
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out DIR \\
      --arch qwen3-4b --shape train_4k --mesh multi --force
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import warnings

import torch

from repro_torch.analysis.hlo import (COLLECTIVE_OPS, count_collectives,
                                      count_cost)
from repro_torch.configs import INPUT_SHAPES, all_configs, shape_skips
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import partition as PT
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, tree_map

LONG_WINDOW = 8192
# the most aten ops a variant's plain pass may dispatch for its DTensor
# pass to run: DTensor propagates each op's sharding in Python (~0.5 ms
# an op once cached, on a CPU core), so this bounds a pass at ~30 s
COLLECTIVE_OP_BUDGET = 60_000
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "fp32"}


def cell_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-cell variant: dense/MoE/VLM archs run long_500k with the
    sliding-window attention variant (DESIGN.md section 5); SSM/hybrid run
    natively."""
    if shape.name == "long_500k" and cfg.pattern in ("attn_mlp", "attn_moe") \
            and not cfg.sliding_window:
        return dataclasses.replace(cfg, sliding_window=LONG_WINDOW)
    return cfg


def _extrapolate(vals: dict[str, float], cfg: ModelConfig) -> float:
    """vals: measured scalar per variant tag -> the real depth's total, a
    constant plus the real number of layers (Zamba2: segments) times the
    slope between the two variants.  Every coefficient is a sum of op
    costs, hence non-negative in truth; each is clamped at 0, as the JAX
    package does."""
    if cfg.pattern == "mamba" and cfg.attn_every:
        n_seg, _ = T._zamba_segments(cfg)
        per_seg = max(vals["Z2"] - vals["Z1"], 0.0)
        return max(vals["Z1"] - per_seg, 0.0) + n_seg * per_seg
    slope = max((vals["B4"] - vals["B2"]) / 2.0, 0.0)
    return max(vals["B2"] - 2 * slope, 0.0) + cfg.num_layers * slope


def _variant_plan(cfg: ModelConfig) -> list[tuple[str, ModelConfig]]:
    """[(tag, cfg_variant)]: two depths a slope is taken between -- one
    and two Zamba2 segments, else 2 and 4 layers.  (The JAX package also
    unrolls scans and adds a variant for the inner loop's trips; the port
    has no scan, so it needs neither.)"""
    if cfg.pattern == "mamba" and cfg.attn_every:
        k = cfg.attn_every
        return [("Z1", dataclasses.replace(cfg, num_layers=k)),
                ("Z2", dataclasses.replace(cfg, num_layers=2 * k))]
    return [("B2", dataclasses.replace(cfg, num_layers=2)),
            ("B4", dataclasses.replace(cfg, num_layers=4))]


# ---------------------------------------------------------------------------
# One variant
# ---------------------------------------------------------------------------
def _structs(cfg: ModelConfig, shape: InputShape, mesh, dtype) -> tuple:
    """The step's arguments as struct trees, in the JAX package's order:
    (params, opt_state, batch), (params, batch[, cache]) or (params,
    tokens, cache)."""
    params = PT.param_struct(cfg, mesh, dtype, mode=shape.mode)
    batch = PT.batch_struct(cfg, shape, mesh, dtype)
    if shape.mode == "train":
        return params, PT.opt_state_struct(params), batch
    if shape.mode == "prefill" and cfg.is_encoder:
        return params, batch
    cache = PT.cache_struct(cfg, shape, mesh, dtype)
    if shape.mode == "prefill":
        return params, batch, cache
    return params, batch["tokens"], cache


def _step(cfg: ModelConfig, shape: InputShape, reduce_grads=None):
    if shape.mode == "train":
        return PT.make_train_step(cfg, reduce_grads=reduce_grads)
    if shape.mode == "prefill":
        return PT.make_encode_step(cfg) if cfg.is_encoder \
            else PT.make_prefill_step(cfg)
    return PT.make_decode_step(cfg)


def _measure(cfg: ModelConfig, shape: InputShape, mesh, dtype) -> dict:
    """The step on plain meta tensors of the global shapes: global flops,
    bytes and aten ops, and the wall seconds."""
    t0 = time.perf_counter()
    args = tuple(PT.tensors(s) for s in _structs(cfg, shape, mesh, dtype))
    cost = count_cost(_step(cfg, shape), *args)
    return {"flops": cost["flops"], "bytes": cost["bytes accessed"],
            "ops": cost["ops"], "wall_s": round(time.perf_counter() - t0, 2)}


def _device_mesh(mesh):
    """The 2-D (pod x data, model) CPU DeviceMesh of ``mesh`` and the
    ``joins`` that map its dims to the spec's axis names."""
    from torch.distributed.device_mesh import init_device_mesh
    daxes = M.data_axes(mesh)
    dims = [(name, axes) for name, axes in (("data", daxes),
                                            ("model", ("model",)))
            if set(axes) & set(mesh.axis_names)]
    shape = tuple(math.prod(mesh.shape[a] for a in axes) for _, axes in dims)
    names = tuple(name for name, _ in dims)
    return init_device_mesh("cpu", shape, mesh_dim_names=names), dict(dims)


def _dtensor(s, device_mesh, joins):
    from torch.distributed.tensor import DTensor
    if not isinstance(s, PT.Struct):
        return s
    local = torch.empty(s.local_shape, dtype=s.dtype, device="meta")
    return DTensor.from_local(
        local, device_mesh, PT.placements(s.spec, device_mesh, joins),
        run_check=False, shape=torch.Size(s.shape),
        stride=torch.empty(s.shape, device="meta").stride())


def _to_moment_layout(grads, mu):
    """Each gradient redistributed to its moment's placements: the
    gradient reduction of a sharded step (an all-reduce, or a
    reduce-scatter where the moment is ZeRO-sharded)."""
    return tree_map(lambda g, m: g.redistribute(m.device_mesh,
                                                m.placements), grads, mu)


def _measure_collectives(cfg: ModelConfig, shape: InputShape, mesh, dtype,
                         device_mesh, joins) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.perf_counter()
    args = tuple(tree_map(lambda s: _dtensor(s, device_mesh, joins), st)
                 for st in _structs(cfg, shape, mesh, dtype))
    with implicit_replication(), warnings.catch_warnings():
        # the port's 1-element position offsets, replicated as meant
        warnings.filterwarnings("ignore", message="Found a non-scalar")
        coll, counts = count_collectives(
            _step(cfg, shape, _to_moment_layout), *args)
    return {"coll": coll, "counts": counts,
            "wall_s": round(time.perf_counter() - t0, 2)}


@contextlib.contextmanager
def _fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks (this one rank 0):
    collectives are recorded, nothing is sent.  Torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run makes a fake one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------
def _argument_bytes(cfg, shape, mesh, dtype) -> int:
    return sum(s.local_nbytes for st in _structs(cfg, shape, mesh, dtype)
               for s in leaves(st))


def _collectives(cfg, shape, mesh, dtype, plan, variants) -> tuple:
    """(per-variant collective measurements, or None; what the counts
    are, or why there are none)."""
    n = int(mesh.devices.size)
    zero = {"coll": {**dict.fromkeys(COLLECTIVE_OPS, 0.0), "total": 0.0},
            "counts": dict.fromkeys(COLLECTIVE_OPS, 0), "wall_s": 0.0}
    if n == 1:
        return ({tag: zero for tag in variants},
                "a one-device mesh issues no collectives (no pass run)")
    over = {t: m["ops"] for t, m in variants.items()
            if m["ops"] > COLLECTIVE_OP_BUDGET}
    if over:
        return None, (f"not counted: the plain pass of variants {over} "
                      f"dispatches more aten ops than the DTensor pass's "
                      f"budget of {COLLECTIVE_OP_BUDGET}")
    out = {}
    with _fake_group(n):
        device_mesh, joins = _device_mesh(mesh)
        where = (f"DTensor pass on a {tuple(device_mesh.shape)} "
                 f"{device_mesh.mesh_dim_names} CPU DeviceMesh")
        for tag, vcfg in plan:
            try:
                out[tag] = _measure_collectives(vcfg, shape, mesh, dtype,
                                                device_mesh, joins)
            except Exception as e:   # noqa: BLE001 -- recorded as the why
                msg = (str(e).strip().splitlines() or [""])[0]
                print(f"collectives {cfg.name} {shape.name} {tag}: "
                      f"{type(e).__name__}: {msg}", file=sys.stderr)
                return None, (f"not counted: the {where} raised at "
                              f"variant {tag}: {type(e).__name__}: "
                              f"{msg[:300]}")
    return out, (f"{where} under a fake process group of {n} ranks, "
                 f"extrapolated over the variants")


def lower_cell(cfg: ModelConfig, shape: InputShape, mesh, mesh_name: str,
               *, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Count the real cell and the two depth variants; return the record
    (module docstring for each key)."""
    cfg = cell_config(cfg, shape)
    real = _measure(cfg, shape, mesh, dtype)
    plan = _variant_plan(cfg)
    variants = {tag: _measure(vcfg, shape, mesh, dtype)
                for tag, vcfg in plan}
    coll, why = _collectives(cfg, shape, mesh, dtype, plan, variants)
    n = int(mesh.devices.size)

    def extract(ms, key, sub=None):
        vals = {t: (m[key] if sub is None else m[key][sub])
                for t, m in ms.items()}
        return _extrapolate(vals, cfg)

    coll_true = coll_counts = None
    if coll is not None:
        coll_true = {kind: extract(coll, "coll", kind)
                     for kind in COLLECTIVE_OPS}
        coll_true["total"] = sum(coll_true.values())
        coll_counts = {kind: int(round(extract(coll, "counts", kind)))
                       for kind in COLLECTIVE_OPS}
    ep = os.environ.get("REPRO_MOE_EP", "1") == "1"
    cost = {"flops": real["flops"] / n, "bytes accessed": real["bytes"] / n}
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "num_devices": n, "mode": shape.mode,
        "sliding_window": cfg.sliding_window,
        "dtype": DTYPE_NAMES[dtype],
        "cost": cost,
        "cost_scan_raw": dict(cost),
        "cost_extrapolated": {"flops": extract(variants, "flops") / n,
                              "bytes accessed": extract(variants, "bytes")
                              / n},
        "memory": {"argument_size_in_bytes":
                   _argument_bytes(cfg, shape, mesh, dtype),
                   "output_size_in_bytes": None,
                   "temp_size_in_bytes": None,
                   "alias_size_in_bytes": None,
                   "generated_code_size_in_bytes": None},
        "memory_note": "meta tensors have no allocator: only the "
                       "arguments' per-device bytes (from their specs) "
                       "are known; nothing the step allocates is measured",
        "collective_bytes": coll_true,
        "collective_counts": coll_counts,
        "collectives": why,
        "moe_ep_requested": bool(ep and cfg.num_experts),
        "moe_ep_in_counts": False,
        "model_flops": cfg.model_flops(
            seq_len=shape.seq_len, batch=shape.global_batch,
            mode=shape.mode),
        "aten_ops": real["ops"],
        "compile_s": real["wall_s"],
        "variant_wall_s": {t: m["wall_s"] for t, m in variants.items()},
        "collective_wall_s": None if coll is None
        else {t: m["wall_s"] for t, m in coll.items()},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="directory the records are written to")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single16x16", M.make_debug_mesh(
            *M.PRODUCTION_MESHES[False], device="meta")))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi2x16x16", M.make_debug_mesh(
            *M.PRODUCTION_MESHES[True], device="meta")))

    cfgs = all_configs()
    archs = [args.arch] if args.arch else sorted(cfgs)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)

    n_ok = n_skip = n_fail = 0
    for mesh_name, mesh in meshes:
        for arch in archs:
            cfg = cfgs[arch]
            for shape_name in shapes:
                shape = INPUT_SHAPES[shape_name]
                tag = f"{mesh_name}.{arch}.{shape_name}"
                path = os.path.join(args.out, f"{tag}.json")
                skip = shape_skips(cfg, shape)
                if skip:
                    print(f"SKIP {tag}: {skip}", flush=True)
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape_name,
                                   "mesh": mesh_name, "skipped": skip}, f)
                    n_skip += 1
                    continue
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        if "error" not in json.load(f):
                            print(f"CACHED {tag}", flush=True)
                            n_ok += 1
                            continue
                try:
                    rec = lower_cell(cfg, shape, mesh, mesh_name)
                except Exception as e:   # noqa: BLE001 -- record, go on
                    n_fail += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {e}",
                          flush=True)
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape_name,
                                   "mesh": mesh_name, "error": str(e)}, f)
                    continue
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                coll = rec["collective_bytes"]
                print(f"OK {tag}: flops/dev={rec['cost']['flops']:.3e} "
                      f"coll=" + (f"{coll['total']:.3e}B" if coll
                                  else "not counted")
                      + f" wall={rec['compile_s']}s", flush=True)
                n_ok += 1
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
