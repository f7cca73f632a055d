"""The per-rank bodies of ``models/sharded.py`` compute the plain layers.

The dry-run runs the bodies under a fake process group, where this
process is rank 0 of every mesh dim and nothing is sent.  Here they run
for real: two CPU processes under gloo, a (1, 2) ("data", "model")
DeviceMesh, seeded fp32 weights and inputs distributed in the
placements of the port's specs (``partition.param_struct`` and
``cache_struct``).  Each result's ``full_tensor()`` -- the layer's
output, each new state, and the parameters' gradients of a fixed linear
function of the output -- is held to the plain layer on the whole
tensors, within 1e-5 of the plain result's largest |value|; so is the
loss of the whole reduced RWKV6-7B and Zamba2-7B.  On rank 1 the shares
differ from rank 0's: its heads, the columns of ``in_proj`` it sends and
receives, its slice of each replicated parameter.  The "uneven" configs
have 3 heads over the 2 ranks (2 and 1, attention's ceil rule), a state
and weights that the specs leave whole or shard against the heads, and
Mamba2 groups that both ranks read.  The "wide" RWKV6 (d 1152) has
``ww`` and ``cr`` large enough for the specs to shard them over model,
as at full width, where the reduced ones are replicated.

All cases run in one spawn of the two processes (about 20 s on 8 CPU
cores); a rank that hangs fails the test after ``TIMEOUT`` seconds, and
a free port is picked at run time.
"""
import dataclasses
import datetime
import json
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

WORLD = 2
TOL = 1e-5
TIMEOUT = 240
CASES = ["rwkv6", "rwkv6-state", "rwkv6-uneven", "rwkv6-wide", "mamba2",
         "mamba2-state",
         "mamba2-uneven", "mamba2_step", "mamba2_step-uneven",
         "loss-rwkv6-7b", "loss-zamba2-7b"]


def _cfg(case):
    from repro_torch.configs import all_configs
    if case.startswith("rwkv6"):
        cfg = all_configs()["rwkv6-7b"].reduced()
        if case.endswith("uneven"):
            cfg = dataclasses.replace(cfg, d_model=192)        # 3 heads
        if case.endswith("wide"):   # ww and cr column-sharded, as at 4096
            cfg = dataclasses.replace(cfg, d_model=1152)
        return cfg
    cfg = all_configs()["zamba2-7b"].reduced()
    if case.endswith("uneven"):    # inner 384: 3 heads of 128, 1 group
        cfg = dataclasses.replace(cfg, d_model=192, ssm_heads=3,
                                  ssm_groups=1)
    return cfg


def _seeded(shape, seed, scale=1.0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


def _params(cfg):
    """Seeded fp32 weights; every small leaf (norm scales, mixes, decay
    biases, A_log, D, dt_bias, u) perturbed, so that a body that slices
    one wrongly disagrees."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    params = T.init_params(cfg, 0, torch.float32, device="cpu")
    seed = iter(range(1000, 10_000))
    return tree_map(lambda t: t + _seeded(t.shape, next(seed), 0.1)
                    if t.ndim <= 2 and t.shape[-1] != cfg.padded_vocab
                    else t, params)


class _World:
    """The (1, 2) DeviceMesh and the spec placements of the port."""

    def __init__(self, cfg):
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.launch import mesh as M
        self.cfg = cfg
        self.mesh = M.make_debug_mesh((1, WORLD), ("data", "model"),
                                      device="meta")
        self.dmesh = init_device_mesh("cpu", (1, WORLD),
                                      mesh_dim_names=("data", "model"))

    def put(self, tree, structs):
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.launch import partition as PT
        from repro_torch.tree import tree_map

        return tree_map(lambda t, s: distribute_tensor(
            t, self.dmesh, PT.placements(s.spec, self.dmesh)), tree, structs)

    def rep(self, t):
        from torch.distributed.tensor import Replicate, distribute_tensor
        return distribute_tensor(t, self.dmesh, (Replicate(), Replicate()))


def _err(got, want) -> float:
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    got, want = got.detach(), want.detach()
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _layer_case(case):
    """One mixer on DTensors against the plain layer: output, new
    states, and the gradients of sum(y * c) for a seeded c."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import InputShape
    from repro_torch.launch import partition as PT
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map
    cfg = _cfg(case)
    W = _World(cfg)
    kind, step = case.split("-")[0], "step" in case
    block = "rwkv" if kind == "rwkv6" else "mamba"
    S = 1 if step else 10
    params = _params(cfg)
    structs = PT.param_struct(cfg, W.mesh, torch.float32)
    p = T._layer(params["blocks"], 0)[block]
    x = _seeded((2, S, cfg.d_model), 1)
    c = _seeded((2, S, cfg.d_model), 2)
    with_state = step or case.endswith("state") or "uneven" in case
    state = st_dt = None
    if with_state:
        which = "rwkv" if block == "rwkv" else "ssm"
        seed = iter(range(50, 99))
        full = tree_map(lambda t: _seeded(t.shape, next(seed), 0.3),
                        getattr(T.init_cache(cfg, 2, 16, torch.float32,
                                             device="cpu"), which))
        specs = getattr(PT.cache_struct(
            cfg, InputShape("c", 16, 2, "decode"), W.mesh, torch.float32),
            which)
        state = T._layer(full, 0)
        st_dt = T._layer(W.put(full, specs), 0)
    p_dt = {k: v.detach().requires_grad_(True) for k, v in T._layer(
        W.put(params["blocks"], structs["blocks"]), 0)[block].items()}

    def run(fn_p, fn_x, fn_st):
        if kind == "rwkv6":
            return L.rwkv6(cfg, fn_p, fn_x, fn_st)
        if step:
            return L.mamba2_step(cfg, fn_p, fn_x, fn_st)
        return L.mamba2(cfg, fn_p, fn_x, fn_st, chunk=4)
    pp = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    y, new = run(pp, x, state)
    (y * c).sum().backward()
    with implicit_replication():
        y_dt, new_dt = run(p_dt, W.rep(x), st_dt)
        (y_dt * W.rep(c)).sum().full_tensor().backward()
    errs = {"y": _err(y_dt, y)}
    for name, a, b in zip(new._fields, new_dt, new):
        errs[f"state {name}"] = _err(a, b)
    for name, t in pp.items():
        errs[f"grad {name}"] = _err(p_dt[name].grad, t.grad)
    assert len(leaves(new_dt)) == len(leaves(new))
    return errs


def _loss_case(case):
    """The whole reduced model's loss on DTensors against the plain
    ``loss_fn``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import all_configs
    from repro_torch.launch import partition as PT
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(all_configs()[case[5:]].reduced(),
                              num_layers=4)
    W = _World(cfg)
    params = _params(cfg)
    g = np.random.default_rng(7)
    batch = {k: torch.from_numpy(g.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    want, _ = T.loss_fn(cfg, params, batch)
    with implicit_replication():
        got, _ = T.loss_fn(cfg, W.put(params, PT.param_struct(
            cfg, W.mesh, torch.float32)),
            {k: W.rep(v) for k, v in batch.items()})
    return {"loss": _err(got, want)}


def _worker(rank, port, out):
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        torch.manual_seed(0)
        res = {case: (_loss_case(case) if case.startswith("loss")
                      else _layer_case(case)) for case in CASES}
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def errors(tmp_path_factory):
    import torch.multiprocessing as mp
    out = str(tmp_path_factory.mktemp("sharded_numeric") / "errs")
    ctx = mp.start_processes(_worker, args=(_free_port(), out),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        deadline = datetime.datetime.now() \
            + datetime.timedelta(seconds=2 * TIMEOUT)
        while not ctx.join(timeout=5):
            if datetime.datetime.now() > deadline:
                raise AssertionError(f"the {WORLD} ranks did not finish in "
                                     f"{2 * TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    res = [json.load(open(f"{out}.{r}")) for r in range(WORLD)]
    assert res[0] == res[1], "the ranks disagree on the full tensors"
    return res[0]


@pytest.mark.parametrize("case", CASES)
def test_sharded_body_computes_the_plain_layer(errors, case):
    errs = errors[case]
    assert errs and all(v <= TOL for v in errs.values()), errs
