"""The port stands alone: no file under ``src/repro_torch/``, no
``examples/torch_*.py`` and not ``chip_smoke.py`` imports JAX or the
``repro`` package -- by an import statement, or by a string given to
``__import__`` or ``importlib.import_module`` -- and without a CUDA
device its entry points raise unless the caller asks for the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
SRC_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
PORT_FILES = SRC_FILES + EXAMPLES + [REPO / "chip_smoke.py"]


def _dynamic(node) -> str | None:
    """The module a call ``__import__("m")`` / ``importlib.import_module(
    "m")`` names by a string constant, else None."""
    if not isinstance(node, ast.Call) or not node.args:
        return None
    f = node.func
    name = f.id if isinstance(f, ast.Name) else \
        f.attr if isinstance(f, ast.Attribute) else None
    arg = node.args[0]
    if name in ("__import__", "import_module") \
            and isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif _dynamic(node) is not None:
            names.append(_dynamic(node))
    return names


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro") or name.startswith("jax")


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_walk_covers_every_module_of_the_port():
    names = {str(p.relative_to(REPO / "src")) for p in SRC_FILES}
    for module in ("configs/__init__.py", "configs/base.py",
                   "configs/qwen3_4b.py", "configs/rwkv6_7b.py",
                   "configs/zamba2_7b.py", "kernels/ops.py",
                   "kernels/flash_attention.py", "kernels/rwkv6_wkv.py",
                   "kernels/mamba2_ssd.py", "data/pipeline.py",
                   "training/optimizer.py", "training/checkpoint.py",
                   "training/train_loop.py", "launch/train.py",
                   "launch/partition.py", "launch/dryrun.py",
                   "models/sharded.py",
                   "analysis/hlo.py", "analysis/roofline.py",
                   "core/knobs.py", "tree.py"):
        assert f"repro_torch/{module}" in names
    assert [p.name for p in EXAMPLES] == [
        "torch_batch_serving.py", "torch_quickstart.py",
        "torch_split_serving.py", "torch_train_small.py"]


@pytest.mark.parametrize("code, found", [
    ('__import__("repro.models.transformer", fromlist=["x"])', True),
    ('importlib.import_module("jax.numpy")', True),
    ('import_module("repro")', True),
    ('__import__("repro_torch.models")', False),
    ('importlib.import_module(name)', False),
])
def test_the_walk_sees_dynamic_imports(tmp_path, code, found):
    path = tmp_path / "m.py"
    path.write_text(f"import importlib\n{code}\n")
    assert any(_forbidden(n) for n in _imports(path)) == found


def test_every_kernel_source_is_in_the_package():
    csrc = REPO / "src" / "repro_torch" / "csrc"
    from repro_torch.kernels import _build
    assert sorted(p.stem for p in csrc.glob("*.cu")) == \
        sorted(_build.SOURCES)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_entry_points_raise_without_cuda():
    _no_cuda()
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    layers = [cnn.conv(4, 3, 1, 1), cnn.relu()]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn.init_cnn(layers, (3, 8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn.params_from_numpy([{}])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--cnn", "alexnet", "--requests", "1"])
    assert cnn.init_cnn(layers, (3, 8, 8), device="cpu")[0]["w"].is_cpu


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card: the script exits non-zero and prints no result.  Alone in
    a directory, without the package beside it: the same."""
    _no_cuda()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", script)
        run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout and '"kernels"' not in run.stdout
