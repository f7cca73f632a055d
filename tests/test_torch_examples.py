"""Smoke-execute the port's examples on the CPU (``--device cpu``), as
``tests/test_examples.py`` does the JAX package's: each is a subprocess
with PYTHONPATH=src, as the README tells a user to run it.  Without
``--device cpu`` they need a card and raise here."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]


def run(script, *args, extra_env=None, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.pop("REPRO_WIRE_DTYPE", None)
    env.update(extra_env or {})
    return subprocess.run([sys.executable, str(REPO / "examples" / script),
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.fixture(scope="module")
def batch_serving():
    return run("torch_batch_serving.py", "--device", "cpu")


def test_batch_serving_example_runs(batch_serving):
    proc = batch_serving
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "served 12/12 mixed-resolution requests" in out
    assert "backpressure" in out
    assert "engine stats" in out


def test_batch_serving_prints_what_the_jax_example_prints(batch_serving):
    """The stream runs on the virtual clock from the same seeds: the
    port's output equals the JAX example's line for line."""
    jax_run = subprocess.run(
        [sys.executable, str(REPO / "examples" / "batch_serving.py")],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 JAX_PLATFORMS="cpu"))
    assert jax_run.returncode == 0, jax_run.stderr[-2000:]
    assert batch_serving.stdout == jax_run.stdout


@pytest.mark.parametrize("wire", ["follow", "int8"])
def test_quickstart_example_runs(wire):
    proc = run("torch_quickstart.py", "--device", "cpu",
               extra_env={"REPRO_WIRE_DTYPE": wire})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "SmartSplit split index l1 = 3 (paper Table I: 3)" in out
    if wire == "follow":
        assert "split execution matches monolithic network: OK" in out
        assert "boundary payload (fp32): runtime 186624 B == model " \
            "186624 B" in out
    else:
        assert "split execution matches monolithic top-1 (int8 wire" in out
        assert "boundary payload (int8): runtime 46932 B == model " \
            "46932 B" in out


def test_examples_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = run("torch_quickstart.py", timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
