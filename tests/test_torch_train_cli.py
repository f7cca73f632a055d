"""The port's training launcher (``python -m repro_torch.launch.train``)
on the CPU.

* It runs as a module with ``--device cpu`` and prints JAX's ``final
  loss ... in ...s`` line; from JAX's initial weights (``init_params``
  replaced by JAX's, carried across) the printed loss equals what
  ``python -m repro.launch.train`` prints on the same arguments, within
  1e-4 relative.
* Without ``--device cpu`` on a machine with no card it raises; it does
  not run on the CPU.
* ``--ckpt-dir`` writes the final checkpoint in JAX's format."""
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL = re.compile(r"^final loss (\S+) in (\S+)s$", re.M)
ENV = {**os.environ,
       "PYTHONPATH": os.pathsep.join(
           [os.path.join(REPO, "src")]
           + [p for p in [os.environ.get("PYTHONPATH")] if p])}


def _run(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=300)


def test_module_runs_on_the_cpu():
    r = _run("--arch", "qwen3-4b", "--steps", "3", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    m = FINAL.search(r.stdout)
    assert m and np.isfinite(float(m.group(1)))
    steps = re.findall(r"^step\s+(\d+) loss", r.stdout, re.M)
    assert steps == ["0", "2"]


def test_module_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run("--arch", "qwen3-4b", "--steps", "1")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "final loss" not in r.stdout


def test_final_loss_equals_repro(monkeypatch, capsys):
    """Both launchers at ``--arch qwen3-4b --steps 3``; the port's
    ``init_params`` returns JAX's weights for the config and seed it is
    asked for, so both start from the same point."""
    def jax_weights(cfg, seed, dtype, device):
        jcfg = JModelConfig(**dataclasses.asdict(cfg))
        jp = JT.init_params(jcfg, jax.random.PRNGKey(seed),
                            getattr(jax.numpy, str(dtype).split(".")[-1]))
        return TT.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device=device)
    monkeypatch.setattr(loop.T, "init_params", jax_weights)
    ttrain.main(["--arch", "qwen3-4b", "--steps", "3", "--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen3-4b",
                                      "--steps", "3"])
    jtrain.main()
    ref = capsys.readouterr().out
    [(tl, _)], [(jl, _)] = FINAL.findall(port), FINAL.findall(ref)
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), (tl, jl)
    strip = re.compile(r"\(\d+\.\ds\)")
    assert [strip.sub("", ln) for ln in port.splitlines()[:-1]] == \
        [strip.sub("", ln) for ln in ref.splitlines()[:-1]]


def test_ckpt_dir_writes_the_final_checkpoint(tmp_path):
    out = ttrain.main(["--arch", "rwkv6-7b", "--steps", "2", "--batch", "2",
                       "--seq-len", "8", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["step"] == 2
    assert manifest["meta"] == {"opt_state/__namedtuple__": "AdamWState"}
    assert manifest["arrays"]["opt_state/step"] == {"shape": [],
                                                    "dtype": "int32"}
    n = sum(1 for _ in leaves(out["params"]))
    assert len(manifest["arrays"]) == 3 * n + 1
