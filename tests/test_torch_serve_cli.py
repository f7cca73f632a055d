"""The port's serving launcher (``repro_torch.launch.serve.main``) on the
CPU, on every path the JAX launcher has: the CNN stream (``--concurrency``,
``--no-pipeline``, ``--tier-faults``, ``--drop``, the int8 wire) and the
transformer decode path (``--arch --plan-split``, which plans on the
H100 pods where the JAX launcher plans on a TPU's).

The stream path's printed summary -- served counts, batches, virtual span,
virtual req/s and p50/p99, repicks, tier and breaker counters, per-hop
bytes, goodput and drops -- equals ``repro.launch.serve.serve_cnn_stream``'s
on the same arguments line for line; only the wall seconds and the port's
line of kernel launch counts differ.  On the reference's TPU tiers the
port's planner prints the JAX launcher's SmartSplit line exactly."""
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

WALL = re.compile(r"in [0-9.]+s wall")


def _virtual_lines(text: str) -> list[str]:
    return [WALL.sub("in <wall> wall", ln) for ln in text.splitlines()
            if ln and "kernel launches" not in ln]


@pytest.mark.parametrize("extra", [
    ["--tiers", "3"],
    ["--tiers", "3", "--no-pipeline"],
    ["--tiers", "3", "--tier-faults", "crash"],
    ["--tiers", "3", "--drop", "0.3", "--wire-dtype", "int8"],
], ids=["pipelined", "sequential", "crash", "drop30-int8"])
def test_stream_summary_equals_jax(extra, capsys):
    n = 6 if "--drop" in extra else 4
    argv = ["--cnn", "alexnet", "--concurrency", str(n), "--max-batch", "2",
            *extra]
    tserve.main([*argv, "--device", "cpu"])
    port = capsys.readouterr().out
    jserve.serve_cnn_stream(tserve.parse_args([*argv, "--device", "cpu"]))
    jax_out = capsys.readouterr().out
    assert _virtual_lines(port) == _virtual_lines(jax_out)
    assert f"served {n}/{n} requests" in port
    assert "on cpu, kernel launches: conv2d_dense=0" in port
    if "--tier-faults" in extra:
        assert "crashes=" in port and "breaker=" in port
        assert re.search(r"crashes=[1-9]", port)
    if "--drop" in extra:
        assert sum(map(int, re.findall(r"(\d+) dropped", port))) > 0


def test_stream_returns_engine_and_logits():
    """``serve_cnn_stream`` hands back its engine and requests; in
    pipelined mode each request's logits are the port's single-sample
    ``apply_cnn`` of its input, bitwise."""
    from repro_torch.models import cnn as tcnn
    args = tserve.parse_args(["--cnn", "alexnet", "--concurrency", "3",
                              "--tiers", "3", "--device", "cpu"])
    params = tcnn.init_cnn(tcnn.CNN_MODELS["alexnet"], device="cpu")
    out = tserve.serve_cnn_stream(args, params=params, quiet=True)
    s = out["engine"].stats()
    assert s["served"] == 3 and s["pipelined"]
    assert out["seconds"] > 0
    for req in out["requests"]:
        want = tcnn.apply_cnn(tcnn.CNN_MODELS["alexnet"], params,
                              req.x[None])[0]
        assert torch.equal(req.logits, want)


def _split_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("SmartSplit:")]


def test_arch_plan_split_equals_jax(capsys, monkeypatch):
    """JAX's ``SmartSplit:`` line is the one the port's CLI prints when it
    plans on the reference's ``TPU_EDGE_CLOUD`` carried into the port's
    dataclasses; both launchers serve the same requests."""
    from repro.core.hardware import TPU_EDGE_CLOUD
    from test_torch_hardware import port_hardware
    argv = ["--arch", "qwen3-4b", "--plan-split", "--requests", "3",
            "--max-new-tokens", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    jax_out = capsys.readouterr().out
    out = tserve.main([*argv, "--device", "cpu"])
    port = capsys.readouterr().out
    assert out is None
    monkeypatch.setattr(tserve, "h100_edge_cloud",
                        lambda dtype: port_hardware(TPU_EDGE_CLOUD))
    tserve.main([*argv, "--device", "cpu"])
    on_tpu_tiers = capsys.readouterr().out
    assert _split_lines(on_tpu_tiers) == _split_lines(jax_out)
    assert len(_split_lines(jax_out)) == 1
    head = re.compile(r"served \d+ requests / \d+ tokens")
    assert head.search(port).group(0) == head.search(jax_out).group(0) \
        == "served 3 requests / 12 tokens"
    assert "on cpu" in port


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_arch_plan_split_plans_on_the_h100_pods(dtype, capsys):
    """The CLI's ``SmartSplit:`` line is ``smartsplit`` of the prefill
    profile on the H100 edge + cloud pods of the policy's dtype, and
    JAX's planner, given those pods field by field, makes the same plan
    with the same objectives, bitwise."""
    import dataclasses

    from repro.configs import all_configs as jall
    from repro.core.smartsplit import smartsplit as jsmartsplit
    from repro.models.profiles import transformer_profile as jprofile
    from repro_torch.core import H100_EDGE_CLOUD, h100_edge_cloud
    from repro_torch.launch.partition import split_boundary_struct
    from repro_torch.models.profiles import transformer_profile
    from test_torch_hardware import jax_hardware, plan_fields
    argv = ["--arch", "qwen3-4b", "--plan-split", "--requests", "1",
            "--max-new-tokens", "2", "--dtype", dtype, "--device", "cpu"]
    tserve.main(argv)
    port = capsys.readouterr().out
    cfg = tserve.all_configs()["qwen3-4b"].reduced()
    cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512))
    kw = dict(seq_len=64, batch=4, mode="prefill",
              dtype_bytes={"fp32": 4, "bf16": 2}[dtype])
    prof = transformer_profile(cfg, **kw)
    hw = h100_edge_cloud(dtype)
    assert (hw == H100_EDGE_CLOUD) == (dtype == "fp32")
    plan = tserve.smartsplit(prof, hw)
    lat, en, mem = plan.objectives
    _, link_bytes = split_boundary_struct(cfg, 4, 64, dtype=dtype)
    assert _split_lines(port) == [
        f"SmartSplit: l1={plan.split_index}/{cfg.num_layers} "
        f"latency={lat:.2e}s energy={en:.2e}J "
        f"edge-mem={mem / 2**20:.1f}MiB boundary={link_bytes}B ({dtype})"]
    jcfg = jall()["qwen3-4b"].reduced()
    jcfg = dataclasses.replace(jcfg, vocab_size=min(jcfg.vocab_size, 512))
    jplan = jsmartsplit(jprofile(jcfg, **kw), jax_hardware(hw))
    assert plan_fields(plan) == plan_fields(jplan)


def test_arch_path_returns_engine():
    args = tserve.parse_args(["--arch", "rwkv6-7b", "--requests", "2",
                              "--max-new-tokens", "3", "--device", "cpu"])
    out = tserve.serve_arch(args, quiet=True)
    assert out["config"].vocab_size <= 512
    assert [len(r.output) for r in out["requests"]] == [3, 3]
    assert all(0 <= t < out["config"].padded_vocab
               for r in out["requests"] for t in r.output)
    assert out["engine"].stats["batches"] >= 1


def test_arch_path_refuses_encoders():
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_cli_defaults_match_jax():
    args = tserve.parse_args([])
    assert (args.arch, args.cnn, args.device, args.max_batch,
            args.max_new_tokens, args.requests, args.concurrency) == \
        ("qwen3-4b", None, "cuda", 4, 8, 12, None)


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--cnn", "alexnet", "--concurrency", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen3-4b", "--requests", "1"])


def test_stream_inputs_are_seeded():
    """Two runs of the stream path serve the same samples and logits."""
    from repro_torch.models import cnn as tcnn
    args = tserve.parse_args(["--cnn", "mobilenetv2", "--concurrency", "2",
                              "--tiers", "2", "--device", "cpu"])
    params = tcnn.init_cnn(tcnn.CNN_MODELS["mobilenetv2"], device="cpu")
    a = tserve.serve_cnn_stream(args, params=params, quiet=True)
    b = tserve.serve_cnn_stream(args, params=params, quiet=True)
    for ra, rb in zip(a["requests"], b["requests"]):
        assert torch.equal(ra.x, rb.x)
        assert torch.equal(ra.logits, rb.logits)
    assert np.isfinite(a["requests"][0].logits.numpy()).all()
