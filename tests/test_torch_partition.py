"""The port's sharding rules and structs (``repro_torch.launch.partition``)
against the JAX package's, leaf for leaf.

JAX runs once, in a subprocess with 512 host devices (the production
meshes need them, and the device count is fixed at jax's first use), on
meshes with ``AxisType.Auto`` axes, as ``repro.launch.dryrun`` builds
them; it writes every struct's ``PartitionSpec`` normalised to the leaf's
rank.  The port computes its specs on meta meshes of the same shapes.
Both run every config, on the (16, 16) and (2, 16, 16) meshes, with
``REPRO_FSDP`` at 1 and at 0: params (train and serve), AdamW state,
batches of every input shape and caches of the decode shapes."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import INPUT_SHAPES, all_configs  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import partition as PT  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = sorted(all_configs())

JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from jax.sharding import AxisType
    from repro.configs import INPUT_SHAPES, all_configs
    from repro.launch import partition as PT

    def norm(leaf):
        if leaf is None:
            return None
        sharding = getattr(leaf, "sharding", None)
        spec = tuple(sharding.spec) if sharding is not None else ()
        spec += (None,) * (len(leaf.shape) - len(spec))
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def flat(tree):
        return {k: norm(v) for k, v in PT._tree_paths(tree).items()}

    out = {}
    for fsdp in ("1", "0"):
        os.environ["REPRO_FSDP"] = fsdp
        for multi in (False, True):
            shape = (2, 16, 16) if multi else (16, 16)
            axes = ("pod", "data", "model") if multi else ("data", "model")
            mesh = jax.make_mesh(shape, axes,
                                 axis_types=(AxisType.Auto,) * len(shape))
            for name, cfg in all_configs().items():
                r = {}
                for mode in ("train", "prefill"):
                    r["params_" + mode] = flat(
                        PT.param_struct(cfg, mesh, mode=mode))
                r["opt"] = flat(PT.opt_state_struct(
                    PT.param_struct(cfg, mesh, mode="train")))
                for sn, sh in INPUT_SHAPES.items():
                    r["batch_" + sn] = flat(PT.batch_struct(cfg, sh, mesh))
                    if sh.mode == "decode" and not cfg.is_encoder:
                        r["cache_" + sn] = flat(
                            PT.cache_struct(cfg, sh, mesh))
                out[f"{fsdp}/{int(multi)}/{name}"] = r
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "jax.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "REPRO_FSDP")}
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(path.read_text())


def _norm(s):
    return None if s is None else [list(e) if isinstance(e, tuple) else e
                                   for e in s.spec]


def _flat(tree):
    return {k: _norm(v) for k, v in PT._tree_paths(tree).items()}


def _port_specs(cfg, mesh) -> dict:
    r = {}
    for mode in ("train", "prefill"):
        r["params_" + mode] = _flat(PT.param_struct(cfg, mesh, mode=mode))
    r["opt"] = _flat(PT.opt_state_struct(PT.param_struct(cfg, mesh,
                                                         mode="train")))
    for sn, sh in INPUT_SHAPES.items():
        r["batch_" + sn] = _flat(PT.batch_struct(cfg, sh, mesh))
        if sh.mode == "decode" and not cfg.is_encoder:
            r["cache_" + sn] = _flat(PT.cache_struct(cfg, sh, mesh))
    return r


@pytest.mark.parametrize("fsdp", ["1", "0"])
@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax_leaf_for_leaf(jax_specs, monkeypatch, arch, multi,
                                       fsdp):
    monkeypatch.setenv("REPRO_FSDP", fsdp)
    mesh = M.make_debug_mesh(*M.PRODUCTION_MESHES[multi], device="meta")
    want = jax_specs[f"{fsdp}/{int(multi)}/{arch}"]
    got = _port_specs(all_configs()[arch], mesh)
    assert sorted(got) == sorted(want)
    for kind in want:
        # JAX's AdamW step has no sharding: replicated, as the port's ()
        assert got[kind] == want[kind], kind


def test_fsdp_changes_what_it_should(monkeypatch):
    """REPRO_FSDP=0 leaves the moments as the params; at 1 a big dense
    moment takes the data axes (so the parametrised test above compares
    two different layouts)."""
    mesh = M.make_debug_mesh(*M.PRODUCTION_MESHES[True], device="meta")
    cfg = all_configs()["qwen3-4b"]
    on = PT.opt_state_struct(PT.param_struct(cfg, mesh)).mu["blocks"]
    monkeypatch.setenv("REPRO_FSDP", "0")
    off = PT.opt_state_struct(PT.param_struct(cfg, mesh)).mu["blocks"]
    assert off["mlp"]["wg"].spec == (None, None, "model")
    assert on["mlp"]["wg"].spec == (None, ("pod", "data"), "model")


def test_structs_are_meta_and_allocate_nothing():
    """Kimi-K2's 1 T parameters as structs: meta tensors of the global
    shapes and ``init_params``' dtypes (bf16 but the fp32 routers); the
    opt state's moments fp32."""
    mesh = M.make_debug_mesh(*M.PRODUCTION_MESHES[True], device="meta")
    cfg = all_configs()["kimi-k2-1t-a32b"]
    params = PT.param_struct(cfg, mesh)
    flat = leaves(params)
    assert all(s.tensor.is_meta for s in flat)
    assert {p: s.dtype for p, s in PT._tree_paths(params).items()
            if s.dtype != torch.bfloat16} == {
        "blocks/moe/router": torch.float32}
    n = sum(s.tensor.numel() for s in flat)
    assert n > 1e12
    assert all(s.dtype == torch.float32 and s.tensor.is_meta
               for s in leaves(PT.opt_state_struct(params).mu))


def test_placements_rebuild_each_leafs_local_shape():
    """Under a fake process group of 512 ranks, distributing each leaf
    by ``placements`` on the 3-D mesh and on the dry-run's 2-D (pod x
    data, model) mesh gives the struct's local shape."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    mesh = M.make_debug_mesh(*M.PRODUCTION_MESHES[True], device="meta")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        dm3 = init_device_mesh("cpu", (2, 16, 16),
                               mesh_dim_names=("pod", "data", "model"))
        dm2 = init_device_mesh("cpu", (32, 16),
                               mesh_dim_names=("data", "model"))
        n = 0
        for name in ("qwen3-4b", "granite-moe-3b-a800m", "zamba2-7b"):
            cfg = all_configs()[name]
            ps = PT.param_struct(cfg, mesh)
            structs = leaves(ps) + leaves(PT.opt_state_struct(ps)) \
                + leaves(PT.batch_struct(cfg, INPUT_SHAPES["train_4k"],
                                         mesh)) \
                + leaves(PT.cache_struct(cfg, INPUT_SHAPES["decode_32k"],
                                         mesh))
            for s in structs:
                for dm, joins in ((dm3, None),
                                  (dm2, {"data": ("pod", "data")})):
                    dt = distribute_tensor(
                        torch.empty(s.shape, dtype=s.dtype, device="meta"),
                        dm, PT.placements(s.spec, dm, joins))
                    assert tuple(dt.to_local().shape) == s.local_shape, \
                        (name, s.spec)
                    n += 1
        assert n > 200
    finally:
        dist.destroy_process_group()


def test_placements_refuse_a_split_joined_dim():
    class DM:
        mesh_dim_names = ("data", "model")
    joins = {"data": ("pod", "data")}
    from torch.distributed.tensor import Replicate, Shard
    assert PT.placements((("pod", "data"), "model"), DM(), joins) == \
        (Shard(0), Shard(1))
    assert PT.placements((None, None), DM(), joins) == \
        (Replicate(), Replicate())
    with pytest.raises(ValueError, match="joined"):
        PT.placements(("data", None), DM(), joins)
