"""The port's checkpoints (``repro_torch.training.checkpoint``) against
the JAX package's format, on the CPU.

* Round trip with namedtuples (``AdamWState``); a shape mismatch raises
  ``ValueError`` and a missing array ``KeyError`` (as
  ``tests/test_substrate.py`` holds ``repro``'s).
* A checkpoint that JAX's ``train()`` wrote restores into the port's
  params and ``AdamWState`` bitwise, and one more train step from it in
  each package gives the same loss within 1e-4 relative.
* A port-written checkpoint's ``manifest.json`` equals JAX's and every
  ``.npy`` member of ``arrays.npz`` equals JAX's byte for byte, bf16
  leaves included (two-byte records, descriptor ``'<V2'``).
* A JAX-written bf16 checkpoint restores into the port bitwise, through
  the manifest's ``"bfloat16"`` (``repro.training.checkpoint.restore``
  itself raises ``TypeError`` on such a leaf)."""
import dataclasses
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_configs as jall  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch.partition import make_train_step as jmake_train_step  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jloop  # noqa: E402
from repro_torch.configs import all_configs as tall  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.partition import make_train_step  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402


def _reduced(pkg_all, arch):
    cfg = pkg_all()[arch].reduced()
    return dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512))


def _carry(tree):
    return TT.params_from_numpy(jax.tree.map(np.asarray, tree),
                                device="cpu")


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy().tobytes() \
            if t.dim() else t.reshape(1).view(torch.uint8).numpy().tobytes()
    a = np.asarray(t)
    return a.tobytes()


def _template(params):
    return {"params": params, "opt_state": opt.init_state(params)}


def test_checkpoint_roundtrip_with_namedtuples(tmp_path):
    cfg = _reduced(tall, "qwen3-4b")
    params = TT.init_params(cfg, 0, torch.float32, "cpu")
    state = opt.init_state(params)
    state = state._replace(step=torch.tensor(7, dtype=torch.int32),
                           mu=tree_map(lambda t: t + 1, state.mu))
    ckpt.save(str(tmp_path), 7, params, state, extra={"note": "x"})
    step, restored = ckpt.restore(
        str(tmp_path), _template(TT.init_params(cfg, 1, torch.float32,
                                                "cpu")))
    assert step == 7
    assert isinstance(restored["opt_state"], opt.AdamWState)
    want = leaves({"params": params, "opt_state": state})
    got = leaves(restored)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["extra"] == {"note": "x"}
    assert manifest["meta"] == {"opt_state/__namedtuple__": "AdamWState"}


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 0, {"w": torch.ones((2, 3))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"params": {"w": torch.ones((3, 2))}})


def test_checkpoint_missing_array_rejected(tmp_path):
    ckpt.save(str(tmp_path), 0, {"w": torch.ones(2)})
    with pytest.raises(KeyError, match="params/v"):
        ckpt.restore(str(tmp_path), {"params": {"w": torch.ones(2),
                                                "v": torch.ones(2)}})


def test_sequences_and_none_round_trip(tmp_path):
    tree = {"a": [torch.arange(3), (torch.ones(2), None)],
            "b": torch.tensor(2.5)}
    ckpt.save(str(tmp_path), 1, tree)
    _, got = ckpt.restore(str(tmp_path), {"params": tree})
    assert isinstance(got["params"]["a"], list)
    assert isinstance(got["params"]["a"][1], tuple)
    assert got["params"]["a"][1][1] is None
    assert torch.equal(got["params"]["a"][0], tree["a"][0])
    assert torch.equal(got["params"]["b"], tree["b"])


def test_repro_train_checkpoint_restores_and_continues(tmp_path):
    """JAX's ``train()`` writes its final checkpoint (3 steps); the port
    restores it bitwise and both packages take step 3 from it."""
    arch = "qwen3-4b"
    jcfg, tcfg = _reduced(jall, arch), _reduced(tall, arch)
    jt = jloop.TrainConfig(steps=3, batch=2, seq_len=16, log_every=1,
                           ckpt_dir=str(tmp_path))
    jout = jloop.train(jcfg, jt, log=lambda s: None)
    params0 = TT.init_params(tcfg, 1, torch.float32, "cpu")
    step, tree = ckpt.restore(str(tmp_path), _template(params0))
    assert step == 3
    jtree = {"params": jout["params"], "opt_state": jout["opt_state"]}
    tl, jl = leaves(tree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        assert _bits(a) == _bits(b)
    assert tree["opt_state"].step.dtype == torch.int32

    batch = JSyntheticLM(jcfg, 2, 16, seed=0).batch_at(3)
    tb = SyntheticLM(tcfg, 2, 16, seed=0).batch_at(3)
    _, _, jm = jax.jit(jmake_train_step(jcfg, jt.adamw))(
        jout["params"], jout["opt_state"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, tm = make_train_step(tcfg, loop.TrainConfig().adamw)(
        tree["params"], tree["opt_state"],
        {k: torch.from_numpy(v) for k, v in tb.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-4 * abs(float(jm["loss"]))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_port_writes_repro_bytes(tmp_path, dtype):
    """The same tree saved by both packages: manifests equal, every
    ``.npy`` member byte for byte (bf16 params, fp32 moments, int32
    step)."""
    cfg = _reduced(jall, "granite-moe-3b-a800m")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0),
                        jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    js = jopt.init_state(jp)
    js = js._replace(step=jnp.asarray(5, jnp.int32),
                     nu=jax.tree.map(lambda t: t + 0.5, js.nu))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(jdir), 5, jp, js, extra={"k": 1})
    ts = opt.AdamWState(torch.tensor(5, dtype=torch.int32),
                        _carry(js.mu), _carry(js.nu))
    ckpt.save(str(tdir), 5, _carry(jp), ts, extra={"k": 1})
    assert json.loads((tdir / "manifest.json").read_text()) == \
        json.loads((jdir / "manifest.json").read_text())
    assert (tdir / "manifest.json").read_bytes() == \
        (jdir / "manifest.json").read_bytes()
    with zipfile.ZipFile(jdir / "arrays.npz") as jz, \
            zipfile.ZipFile(tdir / "arrays.npz") as tz:
        assert tz.namelist() == jz.namelist()
        for name in jz.namelist():
            assert tz.read(name) == jz.read(name), name
    if dtype == "bf16":
        m = json.loads((tdir / "manifest.json").read_text())
        assert m["arrays"]["params/embed"]["dtype"] == "bfloat16"


def test_repro_bf16_checkpoint_restores_bitwise(tmp_path):
    cfg = _reduced(jall, "zamba2-7b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(3), jnp.bfloat16)
    js = jopt.init_state(jp)
    jckpt.save(str(tmp_path), 2, jp, js)
    with pytest.raises(TypeError):       # the reference cannot read it
        jckpt.restore(str(tmp_path), {"params": jp, "opt_state": js})
    tcfg = _reduced(tall, "zamba2-7b")
    step, tree = ckpt.restore(str(tmp_path), _template(
        TT.init_params(tcfg, 0, torch.bfloat16, "cpu")))
    assert step == 2
    want = jax.tree.leaves({"params": jp, "opt_state": js})
    got = leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _bits(a) == _bits(b)
    assert tree["params"]["embed"].dtype == torch.bfloat16
    # and into fp32 params: bf16 widened exactly
    _, wide = ckpt.restore(str(tmp_path), {"params": TT.init_params(
        tcfg, 0, torch.float32, "cpu")})
    np.testing.assert_array_equal(
        wide["params"]["embed"].numpy(),
        np.asarray(jp["embed"], np.float32))
    assert os.path.exists(tmp_path / "arrays.npz")
