"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, and against itself at the real depth.

JAX's ``lower_cell`` runs in one subprocess with 8 host devices, on a
(2, 2, 2) mesh with ``AxisType.Auto`` axes (jax 0.9's default Explicit
axes make ``repro/models/transformer.py``'s embedding gather raise
``ShardingTypeError``), for the reduced decode cell of one arch of each
loop depth; the port lowers the same cells on a meta mesh of that shape.

The flop ratio port / JAX was measured before the bound was set: 0.392
(qwen3-4b), 0.308 (rwkv6-7b) and 0.328 (zamba2-7b) on these cells.  The
port counts matmul flops of the whole (global) step over the 8 devices;
XLA's per-device ``cost_analysis`` also counts every elementwise op and
the work each device repeats on replicated tensors, which at these toy
widths (d 256, 2 to 4 heads) is most of it.  The bound, 0.25-0.5, holds
the ratio to that measurement's band and fails if either count changes
its nature (a matmul missed, or elementwise ops counted)."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_configs as jax_configs  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, all_configs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DEPTHS = ["qwen3-4b", "rwkv6-7b", "zamba2-7b"]     # loop depth 1, 2, 3
FLOP_RATIO = (0.25, 0.5)

JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from jax.sharding import AxisType
    from repro.configs import all_configs
    from repro.configs.base import InputShape
    from repro.launch import dryrun as DR

    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    out = {}
    for arch in sys.argv[2].split(","):
        cfg0 = all_configs()[arch]
        cfg = dataclasses.replace(cfg0.reduced(), num_layers=4,
                                  attn_every=2 if cfg0.attn_every else 0,
                                  name=arch)
        out[arch] = DR.lower_cell(cfg, InputShape("t", 64, 8, "decode"),
                                  mesh, "test-mesh")
    json.dump(out, open(sys.argv[1], "w"))
""")


def reduced(arch):
    cfg0 = all_configs()[arch]
    return dataclasses.replace(cfg0.reduced(), num_layers=4,
                               attn_every=2 if cfg0.attn_every else 0,
                               name=arch)


def _mesh():
    return M.make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                             device="meta")


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "jax.json"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path),
                          ",".join(DEPTHS)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def port_records():
    shape = InputShape("t", 64, 8, "decode")
    return {arch: DR.lower_cell(reduced(arch), shape, _mesh(),
                                "test-mesh") for arch in DEPTHS}


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_model_flops_equal_jax(arch):
    """The record's ``model_flops``, for every config and input shape,
    equals the JAX package's."""
    for shape in INPUT_SHAPES.values():
        kw = dict(seq_len=shape.seq_len, batch=shape.global_batch,
                  mode=shape.mode)
        got = DR.cell_config(all_configs()[arch], shape).model_flops(**kw)
        assert got == jax_configs()[arch].model_flops(**kw)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", DEPTHS)
def test_extrapolation_equals_the_real_depth_count(monkeypatch, arch, mode):
    """Eager PyTorch counts every layer and every inner trip, so the
    B2/B4 (Z1/Z2) extrapolation -- the slope the collectives are
    extrapolated by -- reproduces the real depth's own count exactly,
    flops and bytes.  (The collective pass is kept out with an op budget
    of 0, which the record must then say.)"""
    monkeypatch.setattr(DR, "COLLECTIVE_OP_BUDGET", 0)
    rec = DR.lower_cell(reduced(arch), InputShape("t", 64, 8, mode),
                        _mesh(), "test-mesh")
    assert rec["cost_extrapolated"] == rec["cost"] == rec["cost_scan_raw"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    want = {"Z1", "Z2"} if arch == "zamba2-7b" else {"B2", "B4"}
    assert set(rec["variant_wall_s"]) >= want
    assert rec["collective_bytes"] is None
    assert rec["collective_counts"] is None
    assert "budget" in rec["collectives"]


def matmul_flops(cfg, shape):
    """The matmul flops of a dense attention + gated-MLP step, counted by
    hand: 2 x tokens x each projection's weights, QK^T and PV over every
    key slot (the port masks, it does not skip), and the unembedding.  A
    train step adds the backward (twice the forward: each product's two
    operand gradients) and block remat's recompute of each block, less
    its last product (w_d's): torch's non-reentrant checkpoint stops
    recomputing once it has rebuilt what the backward reads, and no
    gradient reads w_d's output."""
    B, S = shape.global_batch, shape.seq_len
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = 1 if shape.mode == "decode" else S        # keys: S either way
    tok = B * q
    layer = 2 * tok * (2 * d * h * hd + 2 * d * kv * hd + 3 * d * cfg.d_ff) \
        + 2 * 2 * B * h * q * S * hd
    unembed = 2 * tok * d * cfg.padded_vocab
    if shape.mode != "train":
        return cfg.num_layers * layer + unembed
    assert cfg.remat == "block"
    recompute = layer - 2 * tok * cfg.d_ff * d
    return cfg.num_layers * (3 * layer + recompute) + 3 * unembed


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3-mini-3.8b"])
def test_flops_equal_the_matmul_count_by_hand(arch, mode):
    """The record's flops -- the compute term of every roofline bound --
    equal a count of the step's matmuls made by hand, exactly: a class of
    products left out (the unembedding, the attention einsums, a share of
    the backward) or an elementwise op counted would show."""
    mesh = M.make_debug_mesh((1,), ("data",), device="meta")
    shape = InputShape("t", 64, 8, mode)
    cfg = reduced(arch)
    rec = DR.lower_cell(cfg, shape, mesh, "one", dtype=torch.float32)
    assert rec["cost"]["flops"] == matmul_flops(cfg, shape)


@pytest.mark.parametrize("arch", DEPTHS)
def test_argument_bytes_equal_jax_memory_analysis(jax_records,
                                                  port_records, arch):
    """The arguments' bytes equal JAX's ``memory_analysis``; the step's
    own sizes are counted (``analysis/hlo.py``'s ``LiveBytes`` on the
    DTensor pass), as numbers; nothing is compiled, so no code size."""
    mem = port_records[arch]["memory"]
    assert mem["argument_size_in_bytes"] == \
        jax_records[arch]["memory"]["argument_size_in_bytes"]
    for key in ("temp_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes"):
        assert isinstance(mem[key], int) and mem[key] >= 0, (key, mem)
    assert mem["temp_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] > 0
    assert mem["generated_code_size_in_bytes"] is None
    assert "nothing is compiled" in port_records[arch]["memory_note"]


@pytest.mark.parametrize("arch", DEPTHS)
def test_flop_ratio_to_jax_cost(jax_records, port_records, arch):
    ratio = port_records[arch]["cost"]["flops"] \
        / jax_records[arch]["cost"]["flops"]
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1], ratio
    assert port_records[arch]["model_flops"] == \
        jax_records[arch]["model_flops"]


@pytest.mark.parametrize("arch", DEPTHS)
def test_collectives_counted_on_the_joined_mesh(jax_records, port_records,
                                                arch):
    """The pass ran on the (pod x data, model) mesh; the port all-gathers
    in decode exactly where XLA does (Qwen3-4B's and Zamba2-7B's
    attention; RWKV6-7B moves only all-reduces)."""
    rec = port_records[arch]
    assert rec["collectives"].startswith("DTensor pass on a (4, 2)")
    coll, counts = rec["collective_bytes"], rec["collective_counts"]
    assert set(coll) == set(DR.COLLECTIVE_OPS) | {"total"}
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    gathers = jax_records[arch]["collective_bytes"].get("all-gather", 0) > 0
    assert (coll["all-gather"] > 0) == gathers == (counts["all-gather"] > 0)
    assert coll["all-reduce"] > 0 and counts["all-reduce"] > 0
    assert coll["collective-permute"] == 0
    assert rec["moe_ep_in_counts"] is False


def test_a_cell_whose_collective_pass_raises_records_why(monkeypatch):
    """A DTensor pass that raises -- here the sharded attention body,
    made to raise; the plain passes never call it -- leaves the record
    its flops and says why it has no collectives; the fake group is torn
    down."""
    import torch.distributed as dist

    from repro_torch.models import sharded

    def refuse(*args, **kwargs):
        raise RuntimeError("no head-aligned layout")
    monkeypatch.setattr(sharded, "attention", refuse)
    rec = DR.lower_cell(reduced("qwen3-4b"), InputShape("t", 64, 8,
                                                        "decode"),
                        _mesh(), "test-mesh")
    assert rec["collective_bytes"] is None
    assert rec["collective_counts"] is None
    assert "raised" in rec["collectives"]
    assert "no head-aligned layout" in rec["collectives"]
    assert rec["cost"]["flops"] > 0
    assert not dist.is_initialized()


def test_one_device_mesh_has_no_collectives():
    mesh = M.make_debug_mesh((1,), ("data",), device="meta")
    rec = DR.lower_cell(reduced("qwen3-4b"), InputShape("t", 64, 2,
                                                        "decode"),
                        mesh, "one", dtype=torch.float32)
    assert rec["dtype"] == "fp32"
    assert rec["collective_bytes"]["total"] == 0
    assert "one-device" in rec["collectives"]


def test_cli_writes_to_the_directory_it_is_given(tmp_path):
    """``main`` writes one record a cell under ``--out`` and nothing
    under ``benchmarks/out``, and leaves no process group."""
    import torch.distributed as dist
    before = sorted((REPO / "benchmarks" / "out").rglob("*"))
    DR.main(["--out", str(tmp_path), "--arch", "hubert-xlarge",
             "--shape", "decode_32k", "--mesh", "multi"])
    DR.main(["--out", str(tmp_path), "--arch", "phi3-mini-3.8b",
             "--shape", "long_500k", "--mesh", "single"])
    skipped = json.loads((tmp_path / "multi2x16x16.hubert-xlarge."
                          "decode_32k.json").read_text())
    assert "encoder-only" in skipped["skipped"]
    rec = json.loads((tmp_path / "single16x16.phi3-mini-3.8b."
                      "long_500k.json").read_text())
    assert rec["num_devices"] == 256 and rec["dtype"] == "bf16"
    assert rec["sliding_window"] == DR.LONG_WINDOW
    assert sorted((REPO / "benchmarks" / "out").rglob("*")) == before
    assert not dist.is_initialized()


def test_import_sets_no_global_state():
    """Importing the dry-run changes no environment variable and starts
    no process group (the JAX module sets ``XLA_FLAGS`` on import)."""
    code = ("import os; before = dict(os.environ); "
            "import repro_torch.launch.dryrun; "
            "import torch.distributed as d; "
            "assert dict(os.environ) == before; "
            "assert not d.is_initialized(); print('CLEAN')")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and "CLEAN" in run.stdout, run.stderr[-2000:]
