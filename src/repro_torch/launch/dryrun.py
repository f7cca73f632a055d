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
  eager counts over the number of devices (RWKV6's train and prefill:
  at the two sequence lengths of ``SEQ_POINTS``, taken affinely to the
  cell's, below).  Eager PyTorch runs every
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
  step's sharded arguments, from their specs.  ``temp``, ``output`` and
  ``alias_size_in_bytes``: the step's own memory on one device, from
  ``analysis/hlo.py``'s ``LiveBytes`` -- temp the peak of the bytes the
  step allocates less its new outputs, output the bytes it returns,
  alias those of them that share storage with an argument (train
  updates the parameters and moments in place; decode writes its cache
  out of place, so its alias is 0).  Counted on the plain meta pass of
  a one-device mesh, else on the DTensor pass's local tensors: at the
  real depth where its plain pass fits ``COLLECTIVE_OP_BUDGET``, else
  extrapolated over the variants (``memory_note`` says which).
  ``memory_stages`` -- the temp of each stage the step marks
  (``transformer``'s units forward and backward, the head and loss, the
  embedding's backward, the gradient reduction, AdamW), where counted;
  temp is the largest.  ``generated_code_size_in_bytes`` is ``null``:
  nothing is compiled.
* ``collective_bytes`` / ``collective_counts`` -- from a second pass on
  DTensors under a fake process group of ``num_devices`` ranks (no data
  moves), extrapolated over the variants.  The pass runs on a 2-D
  (pod x data, model) DeviceMesh: every rule shards pod and data
  together (``mesh.data_axes``), so the layout is the same as on the
  3-D mesh, whose redistribution planner stalled (minutes for one
  layer).  The specs compared with the JAX package stay the 3-D ones.
  The model's communicating layers run ``models/sharded.py``'s per-rank
  bodies there (vocab-parallel embedding and loss, head-sharded
  attention, the cache kept where it lies, tensor-parallel SwiGLU,
  expert-parallel or local MoE, head-local RWKV6 and Mamba2 mixers on
  their head-sharded states), and the gradients are reduced to their
  moments' layout (``_to_moment_layout``); the rest is DTensor's own
  propagation.  A Shard-to-Shard move counts as one all-to-all
  (``hlo.alltoall_as_alltoall``).  RWKV6's train and prefill cells --
  their costs, collectives and memory -- are counted at the two
  sequence lengths of ``SEQ_POINTS`` and taken affinely to the cell's,
  as the JAX package takes its token scan's trips (its variant C): the
  token loop dispatches ~46 aten ops a token and layer, hours of passes
  at the cells' lengths.  Their costs and collectives are affine in S
  (the mixer's body gathers no token, and its backward stacks the
  tokens' gradients once), so that fit is exact.  Their peak memory is
  not: which stage peaks, and which moment within a stage, moves with S
  (``_seq_points``).  So the memory is fit moment by moment: each
  moment's live bytes -- keyed alike at every S, a token loop's by its
  first and last iterations (``hlo.LiveBytes``) -- are affine in S, and
  the temp is the largest at the cell's S (``_fit_memory``).
  ``extrapolation`` says which extrapolation a record used.  A variant
  whose plain pass dispatches more than ``COLLECTIVE_OP_BUDGET`` aten
  ops, or whose DTensor pass raises, gets
  ``collective_bytes: null`` and a ``collectives`` key that says why; a
  one-device mesh issues no collectives, so its counts are 0 with no
  pass.
* ``redistributions`` -- every explicit move of one pass (the real
  depth's, or the deepest variant's: ``redistributions_of``), each
  (where, from, to, kind) once with its count and its result bytes on a
  device, summed.
* ``moe_ep_in_counts`` -- whether that pass dispatched the MoE expert-
  parallel: under ``REPRO_MOE_EP=1`` (the default) wherever
  ``moe_ep.ep_enabled``'s conditions hold on the mesh, as the JAX
  package does.

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

from repro_torch.analysis import hlo
from repro_torch.analysis.hlo import (COLLECTIVE_OPS, count_collectives,
                                      count_cost)
from repro_torch.configs import INPUT_SHAPES, all_configs, shape_skips
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import partition as PT
from repro_torch.models import layers as L
from repro_torch.models import sharded
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, tree_map

LONG_WINDOW = 8192
# the most aten ops a variant's plain pass may dispatch for its DTensor
# pass to run: DTensor propagates each op's sharding in Python (~0.5 ms
# an op once cached, on a CPU core), so this bounds a pass at ~30 s
COLLECTIVE_OP_BUDGET = 60_000
# the sequence lengths RWKV6's train and prefill cells are counted at
# (``_seq_points``); their costs, collectives and memory moments are
# affine in S
SEQ_POINTS = (64, 128)
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


def _marked(reduce_grads):
    """``reduce_grads`` (None: the grads as they are) between the stage
    marks of the gradient reduction and AdamW (``hlo.mark``): the same
    ops either way."""
    def run(grads, mu):
        hlo.mark("gradient reduction")
        if reduce_grads is not None:
            grads = reduce_grads(grads, mu)
        hlo.mark("optimizer")
        return grads
    return run


def _step(cfg: ModelConfig, shape: InputShape, reduce_grads=None):
    if shape.mode == "train":
        return PT.make_train_step(cfg, reduce_grads=_marked(reduce_grads))
    if shape.mode == "prefill":
        return PT.make_encode_step(cfg) if cfg.is_encoder \
            else PT.make_prefill_step(cfg)
    return PT.make_decode_step(cfg)


def _measure(cfg: ModelConfig, shape: InputShape, mesh, dtype,
             memory: bool = False) -> dict:
    """The step on plain meta tensors of the global shapes: global flops,
    bytes and aten ops, the wall seconds, and with ``memory`` the step's
    memory sizes, stage temps and moments (``hlo.LiveBytes``; one
    device's where the mesh has one)."""
    t0 = time.perf_counter()
    args = tuple(PT.tensors(s) for s in _structs(cfg, shape, mesh, dtype))
    with _token_loops():
        cost = count_cost(_step(cfg, shape), *args, memory=memory)
    out = {"flops": cost["flops"], "bytes": cost["bytes accessed"],
           "ops": cost["ops"], "wall_s": round(time.perf_counter() - t0, 2)}
    if memory:
        out.update({k: cost[k] for k in ("memory", "stage_temps",
                                         "moments")})
    return out


def _token_loops():
    """RWKV6's token step as a loop body (``hlo.loop_body``): its memory
    moments keyed by their place from the loop's ends."""
    return hlo.loop_body(L, "rwkv6_step")


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
    reduce-scatter where the moment is ZeRO-sharded), each move
    recorded."""
    return tree_map(lambda g, m: sharded.move(g, m.placements,
                                              "gradient reduction"),
                    grads, mu)


def _measure_collectives(cfg: ModelConfig, shape: InputShape, mesh, dtype,
                         device_mesh, joins, ep: bool) -> dict:
    """The step on DTensors: its collectives (``count_collectives``), one
    device's memory sizes, the moves the sharded bodies made and the MoE
    dispatches they chose."""
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.perf_counter()
    args = tuple(tree_map(lambda s: _dtensor(s, device_mesh, joins), st)
                 for st in _structs(cfg, shape, mesh, dtype))
    with implicit_replication(), warnings.catch_warnings(), \
            sharded.counting(ep) as run, _token_loops():
        # the port's 1-element position offsets, replicated as meant
        warnings.filterwarnings("ignore", message="Found a non-scalar")
        res = count_collectives(_step(cfg, shape, _to_moment_layout),
                                *args)
    res.update(moves=run.moves, ep_layers=run.ep_layers,
               wall_s=round(time.perf_counter() - t0, 2))
    return res


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


def _seq_points(cfg: ModelConfig, shape: InputShape):
    """The two sequence lengths RWKV6's train and prefill cells are
    counted at (its token loop dispatches ~46 aten ops a token and
    layer), or None: the JAX package's variant C (``_inner_trips``),
    where the scan's trips are extrapolated.  A cell's costs and
    collectives are affine in S, so their fit from the two is the cell's
    count (``tests/test_torch_dryrun_sharded.py`` holds it at S 256).
    Its peak memory is not: it is the largest of the step's stages'
    peaks, and in train AdamW's (every gradient alive) peaks at short S,
    a block's backward (its tokens' saved states) or the head later (2
    RWKV6-7B layers at batch 2: 5.17 GB of temp at S 64, 128 and 256,
    6.33 GB at 512); within a stage, which moment peaks moves with S too
    (the head's unembedding gradient against a logits-sized buffer).
    Each moment's live bytes are affine in S (``hlo.LiveBytes`` keys
    them alike at every S), so ``_fit_memory`` fits each and takes the
    largest at the cell's S."""
    if cfg.pattern == "rwkv" and shape.mode != "decode" \
            and shape.seq_len > SEQ_POINTS[1]:
        return SEQ_POINTS
    return None


def _affine(a, b, s1: int, s2: int, s: int):
    """Nested numbers a (at s1) and b (at s2) taken affinely to s."""
    if isinstance(a, dict):
        return {k: _affine(a[k], b[k], s1, s2, s) for k in a}
    return a + (b - a) * (s - s1) / (s2 - s1)


def _measure_at(cfg, shape, mesh, dtype, points, memory=False) -> dict:
    """``_measure`` of the cell, or where ``points`` are given, of the
    cell at those two sequence lengths (kept under ``"points"``), its
    costs taken affinely to its own (its memory: ``_fit_memory``)."""
    if points is None:
        return _measure(cfg, shape, mesh, dtype, memory)
    at = {s: _measure(cfg, dataclasses.replace(shape, seq_len=s), mesh,
                      dtype, memory) for s in points}
    s1, s2 = points
    out = {k: _affine(at[s1][k], at[s2][k], s1, s2, shape.seq_len)
           for k in ("flops", "bytes", "ops")}
    return {**out, "wall_s": round(at[s1]["wall_s"] + at[s2]["wall_s"], 2),
            "points": at}


def _collectives(cfg, shape, mesh, dtype, plan, variants, real,
                 points) -> tuple:
    """(per-variant DTensor measurements or None, what the counts are or
    why there are none, the real depth's pass or None)."""
    n = int(mesh.devices.size)
    if n == 1:
        zero = {"coll": {**dict.fromkeys(COLLECTIVE_OPS, 0.0), "total": 0.0},
                "counts": dict.fromkeys(COLLECTIVE_OPS, 0), "wall_s": 0.0}
        return ({tag: zero for tag in variants},
                "a one-device mesh issues no collectives (no pass run)",
                None)
    runs = [(tag, vcfg, shape) for tag, vcfg in plan] if points is None \
        else [(tag, vcfg, dataclasses.replace(shape, seq_len=s))
              for tag, vcfg in plan for s in points]
    ops = {t: variants[t]["ops"] for t, _, _ in runs} if points is None \
        else {(t, sh.seq_len): variants[t]["points"][sh.seq_len]["ops"]
              for t, _, sh in runs}
    over = {str(t): o for t, o in ops.items() if o > COLLECTIVE_OP_BUDGET}
    if over:
        return None, (f"not counted: the plain pass of variants {over} "
                      f"dispatches more aten ops than the DTensor pass's "
                      f"budget of {COLLECTIVE_OP_BUDGET}"), None
    ep = os.environ.get("REPRO_MOE_EP", "1") == "1"
    out, whole = {}, None
    with _fake_group(n):
        device_mesh, joins = _device_mesh(mesh)
        where = (f"DTensor pass on a {tuple(device_mesh.shape)} "
                 f"{device_mesh.mesh_dim_names} CPU DeviceMesh")
        todo = list(runs)
        if points is None and real["ops"] <= COLLECTIVE_OP_BUDGET:
            todo.append(("real", cfg, shape))
        for tag, vcfg, sh in todo:
            try:
                res = _measure_collectives(vcfg, sh, mesh, dtype,
                                           device_mesh, joins, ep)
            except Exception as e:   # noqa: BLE001 -- recorded as the why
                msg = (str(e).strip().splitlines() or [""])[0]
                print(f"collectives {cfg.name} {shape.name} {tag}: "
                      f"{type(e).__name__}: {msg}", file=sys.stderr)
                return None, (f"not counted: the {where} raised at "
                              f"variant {tag}: {type(e).__name__}: "
                              f"{msg[:300]}"), None
            if tag == "real":
                whole = res
            else:
                out.setdefault(tag, {})[sh.seq_len] = res
    if points is None:
        out = {tag: v[shape.seq_len] for tag, v in out.items()}
    else:
        s1, s2 = points
        out = {tag: {**v[s2], "points": v,
                     **{k: _affine(v[s1][k], v[s2][k], s1, s2,
                                   shape.seq_len)
                        for k in ("coll", "counts")}}
               for tag, v in out.items()}
    return out, (f"{where} under a fake process group of {n} ranks, "
                 f"extrapolated over the variants"), whole


def _redistributions(moves: list[dict]) -> list[dict]:
    """The moves of one pass, each (where, from, to, kind) once with its
    count and its bytes summed."""
    agg: dict[tuple, dict] = {}
    for mv in moves:
        key = (mv["where"], mv["from"], mv["to"], mv["kind"])
        row = agg.setdefault(key, {"where": key[0], "from": key[1],
                                   "to": key[2], "kind": key[3],
                                   "times": 0, "bytes": 0})
        row["times"] += 1
        row["bytes"] += mv["bytes"]
    return list(agg.values())


MEMORY_KEYS = ("output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes")


def _units(cfg: ModelConfig) -> int:
    """The remat units ``transformer`` marks: Zamba2 segments, else
    layers."""
    if cfg.pattern == "mamba" and cfg.attn_every:
        return T._zamba_segments(cfg)[0]
    return cfg.num_layers


def _stage_kind(stage: str, n: int, n_real: int):
    """A stage of a variant with n units, named as at the real depth's
    n_real: unit 0 and the last unit keep their place, and a unit between
    is None.  A unit's moments differ from unit to unit only by what the
    units before it saved and the units after it left (their inputs,
    their gradients), affine in its index, so each peaks at unit 0 or
    the last."""
    head, sep, i = stage.rpartition(": unit ")
    if not sep or int(i) == 0:
        return stage
    return f"{head}: unit {n_real - 1}" if int(i) == n - 1 else None


def _fit_memory(runs: dict, cfg: ModelConfig, plan, s: int) -> tuple:
    """One device's memory sizes and temp by stage at sequence length s,
    from ``runs`` {(variant tag, S): a memory count} at the two lengths
    of ``SEQ_POINTS`` -- of the real depth (tag ``"real"``) or of both
    depth variants of ``plan``.  Each moment's live bytes (and the new
    outputs') are fit affinely in S, then over the variants
    (``_extrapolate``): a + b L + c S + e L S, which the 2 x 2 grid
    determines; the temp is the largest less the new outputs.  A stage
    whose moments differ in number between the variants -- the gradient
    reduction and AdamW walk the parameters one at a time, so theirs
    grow with the depth (never with S) -- is fit by its peak.  Raises
    where two lengths' moments do not match one to one, or where a run's
    peak lies in no moment it kept (a loop iteration between the kept
    ones)."""
    n_real = _units(cfg)
    units = {tag: _units(vcfg) for tag, vcfg in plan}
    s1, s2 = sorted({p for _, p in runs})
    stages: dict = {}                 # run -> stage -> {moment: live}
    for (tag, p), run in runs.items():
        live = run["moments"]["live"]
        peak = max(live.values(), default=0) - run["moments"]["new"]
        if max(peak, 0) != run["memory"]["temp_size_in_bytes"]:
            raise ValueError(f"memory fit: the peak of variant {tag} at S "
                             f"{p} lies in no kept moment")
        by = stages[(tag, p)] = {}
        for key, v in live.items():
            kind = key[0] if tag == "real" \
                else _stage_kind(key[0], units[tag], n_real)
            if kind is not None:
                m = by.setdefault(kind, {})
                m[key[1:]] = max(m.get(key[1:], v), v)
    for tag in {t for t, _ in runs}:
        a, b = stages[(tag, s1)], stages[(tag, s2)]
        if {k: set(v) for k, v in a.items()} \
                != {k: set(v) for k, v in b.items()}:
            raise ValueError(f"memory fit: variant {tag}'s moments at S "
                             f"{s1} and {s2} do not match one to one")

    def fit(vals):
        per = {tag: _affine(vals[(tag, s1)], vals[(tag, s2)], s1, s2, s)
               for tag, _ in runs}
        return per["real"] if "real" in per else _extrapolate(per, cfg)
    new = fit({r: run["moments"]["new"] for r, run in runs.items()})
    temps = {}
    for kind in next(iter(stages.values())):
        each = [by[kind] for by in stages.values()]
        if all(set(m) == set(each[0]) for m in each):
            temps[kind] = max(fit({r: by[kind][k]
                                   for r, by in stages.items()})
                              for k in each[0]) - new
        else:
            temps[kind] = fit({r: max(by[kind].values())
                               for r, by in stages.items()}) - new
    sizes = {k: int(round(fit({r: run["memory"][k]
                                for r, run in runs.items()})))
             for k in ("output_size_in_bytes", "alias_size_in_bytes")}
    sizes["temp_size_in_bytes"] = max(int(round(max(temps.values()))), 0)
    return sizes, {k: int(round(v)) for k, v in temps.items()}


def lower_cell(cfg: ModelConfig, shape: InputShape, mesh, mesh_name: str,
               *, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Count the real cell and the two depth variants; return the record
    (module docstring for each key)."""
    cfg = cell_config(cfg, shape)
    n = int(mesh.devices.size)
    points = _seq_points(cfg, shape)
    real = _measure_at(cfg, shape, mesh, dtype, points, memory=n == 1)
    plan = _variant_plan(cfg)
    variants = {tag: _measure_at(vcfg, shape, mesh, dtype, points)
                for tag, vcfg in plan}
    coll, why, whole = _collectives(cfg, shape, mesh, dtype, plan,
                                    variants, real, points)

    def extract(ms, key, sub=None):
        vals = {t: (m[key] if sub is None else m[key][sub])
                for t, m in ms.items()}
        return _extrapolate(vals, cfg)

    coll_true = coll_counts = stages = None
    memory = dict.fromkeys(MEMORY_KEYS)
    depth = [tag for tag, _ in plan]
    fit = (f"the largest of the step's stage peaks, each fit in S from "
           f"{list(points)} moment by moment") if points else ""
    if n == 1 and points:
        sizes, stages = _fit_memory(
            {("real", p): m for p, m in real["points"].items()}, cfg,
            plan, shape.seq_len)
        memory.update(sizes)
        note = f"the real depth's plain meta pass (one device): {fit}"
    elif n == 1:
        memory.update(real["memory"])
        stages = real["stage_temps"]
        note = "the real depth's plain meta pass (one device)"
    elif whole is not None:
        memory.update(whole["memory"])
        stages = whole["stage_temps"]
        note = "the real depth's DTensor pass (one device's local tensors)"
    elif coll is not None and points:
        sizes, stages = _fit_memory(
            {(tag, p): m for tag, v in coll.items()
             for p, m in v["points"].items()}, cfg, plan, shape.seq_len)
        memory.update(sizes)
        note = (f"{fit} and over the depth variants {depth} (one device's "
                f"local tensors)")
    elif coll is not None:
        memory.update({k: int(round(extract(coll, "memory", k)))
                       for k in MEMORY_KEYS})
        note = (f"extrapolated over the depth variants {depth} (one "
                f"device's local tensors)")
    else:
        note = "not counted: the DTensor pass did not run (collectives)"
    if coll is not None:
        coll_true = {kind: extract(coll, "coll", kind)
                     for kind in COLLECTIVE_OPS}
        coll_true["total"] = sum(coll_true.values())
        coll_counts = {kind: int(round(extract(coll, "counts", kind)))
                       for kind in COLLECTIVE_OPS}
    passes = [whole] if whole is not None else \
        [coll[depth[-1]]] if coll is not None and n > 1 else []
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
        "extrapolation": {"depth": depth,
                          "seq_len": list(points) if points else None},
        "memory": {"argument_size_in_bytes":
                   _argument_bytes(cfg, shape, mesh, dtype),
                   **memory, "generated_code_size_in_bytes": None},
        "memory_note": f"{note}; generated code: none, nothing is "
                       f"compiled",
        "memory_stages": stages,
        "collective_bytes": coll_true,
        "collective_counts": coll_counts,
        "collectives": why,
        "redistributions": _redistributions(passes[0]["moves"])
        if passes else None,
        "redistributions_of": None if not passes
        else "the real depth" if whole is not None
        else f"variant {depth[-1]}"
        + (f" at seq_len {points[1]}" if points else ""),
        "moe_ep_requested": bool(ep and cfg.num_experts),
        "moe_ep_in_counts": any(p["ep_layers"] for p in passes),
        "model_flops": cfg.model_flops(
            seq_len=shape.seq_len, batch=shape.global_batch,
            mode=shape.mode),
        "aten_ops": int(round(real["ops"])),
        "compile_s": real["wall_s"],
        "variant_wall_s": {t: m["wall_s"] for t, m in variants.items()},
        "collective_wall_s": None if coll is None
        else {**{t: m["wall_s"] for t, m in coll.items()},
              **({"real": whole["wall_s"]} if whole else {})},
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
