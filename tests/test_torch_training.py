"""The port's training path against the JAX package, on the CPU: the
synthetic data pipeline (``repro_torch.data.pipeline``), AdamW
(``repro_torch.training.optimizer``), block remat and the training loop
(``repro_torch.training.train_loop.train``).

* ``SyntheticLM.batch_at`` is ``repro``'s, array for array and bitwise;
  the prefetcher delivers in order (``tests/test_substrate.py``'s checks).
* One and five ``apply_updates`` from the same params, grads and state
  give params, ``mu`` and ``nu`` within 1e-6 of each leaf's scale of
  JAX's, ``lr`` and ``grad_norm`` within 1e-6 relative, fp32 and bf16
  params (measured: fp32 leaves equal but one at 3.3e-9, bf16 leaves
  within 9.9e-8 and ``lr`` / ``grad_norm`` within 6.5e-8).
* Remat changes nothing: grads with ``remat="block"`` equal grads with
  ``remat="none"``, bitwise, for a plain stack and Zamba2's segments.
* ``train()`` from JAX's initial weights logs JAX's ``train()`` losses
  within 1e-4 relative, 5 steps, every step logged."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_configs as jall  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import partition as jpartition  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jloop  # noqa: E402
from repro_torch.configs import all_configs as tall  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.launch import partition  # noqa: E402
from repro_torch.launch.partition import loss_and_grads  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

OPT_TOL = 1e-6
TRAIN_TOL = 1e-4


def _reduced(pkg_all, arch, **kw):
    cfg = pkg_all()[arch].reduced()
    return dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512),
                               **kw)


def _carry(jp):
    return TT.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "hubert-xlarge"])
@pytest.mark.parametrize("step", [0, 5])
def test_batch_at_equals_repro_bitwise(arch, step):
    jb = JSyntheticLM(_reduced(jall, arch), 4, 32, seed=1).batch_at(step)
    tb = SyntheticLM(_reduced(tall, arch), 4, 32, seed=1).batch_at(step)
    assert sorted(tb) == sorted(jb)
    if arch == "hubert-xlarge":
        assert "prefix_embeds" in tb and "tokens" not in tb
    for k in jb:
        assert tb[k].dtype == jb[k].dtype and tb[k].shape == jb[k].shape
        assert tb[k].tobytes() == jb[k].tobytes(), k


def test_synthetic_lm_deterministic_and_learnable():
    cfg = _reduced(tall, "phi3-mini-3.8b")
    ds1 = SyntheticLM(cfg, batch=4, seq_len=32, seed=1)
    ds2 = SyntheticLM(cfg, batch=4, seq_len=32, seed=1)
    b1, b2 = ds1.batch_at(5), ds2.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    match = (ds1.perm[b1["tokens"]] == b1["labels"]).mean()
    assert 0.5 < match < 0.95


def test_prefetcher_delivers_in_order_and_places():
    cfg = _reduced(tall, "phi3-mini-3.8b")
    ds = SyntheticLM(cfg, batch=2, seq_len=8, seed=0)
    pf = Prefetcher(iter(ds), depth=2,
                    place=loop.placer(torch.device("cpu")))
    got = [next(pf) for _ in range(3)]
    pf.close()
    for i, b in enumerate(got):
        want = ds.batch_at(i)
        assert sorted(b) == sorted(want)
        for k in want:
            assert isinstance(b[k], torch.Tensor)
            np.testing.assert_array_equal(b[k].numpy(), want[k])


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------
def _opt_tree(rng, dtype):
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 4, 3)}, "e": ()}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.normal(size=s).astype(np.float32)
    p, g = draw(shapes), draw(shapes)
    mu, nu = draw(shapes), draw(shapes)
    nu = jax.tree.map(np.abs, nu)
    cast = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))) \
        if dtype == "bf16" else (lambda a: a)
    return jax.tree.map(cast, p), jax.tree.map(cast, g), mu, nu


def _t(tree):
    return TT.params_from_numpy(tree, device="cpu")


def _leaf_err(got, want) -> float:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n_steps", [1, 5])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_apply_updates_matches_repro(dtype, n_steps, clip):
    """Same params, grads and state (step 3, so the bias corrections and
    the warmup are mid-way); ``grads`` are scratch for the port, so each
    step gets a fresh copy."""
    p, g, mu, nu = _opt_tree(np.random.default_rng(0), dtype)
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=4, total_steps=12,
                           grad_clip=clip)
    tcfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    jp, js = jax.tree.map(jnp.asarray, p), jopt.AdamWState(
        jnp.asarray(3, jnp.int32), jax.tree.map(jnp.asarray, mu),
        jax.tree.map(jnp.asarray, nu))
    tp, ts = _t(p), opt.AdamWState(torch.tensor(3, dtype=torch.int32),
                                   _t(mu), _t(nu))
    for _ in range(n_steps):
        jp, js, jm = jopt.apply_updates(cfg, jp, jax.tree.map(jnp.asarray, g),
                                        js)
        tp, ts, tm = opt.apply_updates(tcfg, tp, _t(g), ts)
    assert int(ts.step) == int(js.step) == 3 + n_steps
    assert ts.step.dtype == torch.int32
    for k in ("lr", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= OPT_TOL * abs(float(jm[k]))
    for tree_t, tree_j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in zip(leaves(tree_t), jax.tree.leaves(tree_j),
                        strict=True):
            assert a.dtype == (torch.bfloat16 if dtype == "bf16"
                               and tree_t is tp else torch.float32)
            assert _leaf_err(a, b) <= OPT_TOL


def test_schedule_matches_repro_at_every_step():
    cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=200)
    tcfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, 230, dtype=np.int32)
    j = np.asarray(jopt.schedule(cfg, jnp.asarray(steps)))
    t = opt.schedule(tcfg, torch.from_numpy(steps)).numpy()
    assert t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=OPT_TOL, atol=0)


def test_adamw_converges_on_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                          total_steps=200, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_grad_clip_and_schedule():
    cfg = opt.AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=10,
                          total_steps=100)
    params = {"w": torch.ones(4)}
    state = opt.init_state(params)
    _, state, m = opt.apply_updates(cfg, params, {"w": torch.full((4,), 100.0)},
                                    state)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(m["lr"]) == pytest.approx(cfg.lr / 10, rel=0.01)
    end = opt.schedule(cfg, torch.tensor(100, dtype=torch.int32))
    assert float(end) == pytest.approx(cfg.lr * cfg.min_lr_ratio, rel=0.01)


def test_init_state_moments_are_fp32_zeros():
    params = {"a": torch.ones(3, dtype=torch.bfloat16),
              "b": {"c": torch.ones(2, 2)}}
    s = opt.init_state(params)
    assert s.step.dtype == torch.int32 and int(s.step) == 0
    for m in leaves(s.mu) + leaves(s.nu):
        assert m.dtype == torch.float32 and not m.any()


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-7b"])
def test_block_remat_grads_equal_no_remat_bitwise(arch):
    jcfg = _reduced(jall, arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(_reduced(tall, arch), 2, 16, seed=1)
             .batch_at(0).items()}
    out = {}
    for remat in ("block", "none"):
        cfg = _reduced(tall, arch, remat=remat)
        loss, _, _, grads = loss_and_grads(cfg, _carry(jp), batch)
        out[remat] = (loss, leaves(grads))
    assert torch.equal(out["block"][0], out["none"][0])
    assert len(out["block"][1]) == len(out["none"][1])
    for a, b in zip(out["block"][1], out["none"][1]):
        assert torch.equal(a, b)


def test_remat_wraps_each_block_in_train_mode_only(monkeypatch):
    """One ``checkpoint`` call a block (a segment for Zamba2) in train
    mode with ``remat="block"``; none under ``"none"`` or in prefill."""
    calls = []
    real = TT.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)
    monkeypatch.setattr(TT, "checkpoint", counting)
    for arch in ("qwen3-4b", "zamba2-7b"):
        cfg = _reduced(tall, arch)
        want = TT._zamba_segments(cfg)[0] if cfg.attn_every \
            else cfg.num_layers
        params = TT.init_params(cfg, 0, torch.float32, "cpu")
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
        for mode, remat, n in (("train", "block", want),
                               ("train", "none", 0), ("prefill", "block", 0)):
            calls.clear()
            TT.forward(dataclasses.replace(cfg, remat=remat), params, batch,
                       mode=mode)
            assert calls == [False] * n, (arch, mode, remat)


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m",
                                  "rwkv6-7b"])
def test_train_logs_repro_losses(arch, monkeypatch):
    """JAX's ``train()`` and the port's from the same initial weights
    (the port's ``init_params`` replaced by JAX's at the seed, carried
    across), 5 steps, every step logged: the losses within 1e-4
    relative."""
    jcfg, tcfg = _reduced(jall, arch), _reduced(tall, arch)
    jt = jloop.TrainConfig(steps=5, batch=2, seq_len=16, log_every=1)
    tt = loop.TrainConfig(steps=5, batch=2, seq_len=16, log_every=1)
    jlines, tlines = [], []
    jout = jloop.train(jcfg, jt, log=jlines.append)
    jp0 = JT.init_params(jcfg, jax.random.PRNGKey(jt.seed), jnp.float32)

    def jax_weights(cfg, seed, dtype, device):
        assert (cfg, seed, dtype, str(device)) == \
            (tcfg, tt.seed, torch.float32, "cpu")
        return _carry(jp0)
    monkeypatch.setattr(loop.T, "init_params", jax_weights)
    tout = loop.train(tcfg, tt, log=tlines.append, device="cpu")
    assert [s for s, _ in tout["losses"]] == list(range(5))
    assert len(tlines) == len(jlines) == 5
    for (_, tl), (_, jl) in zip(tout["losses"], jout["losses"]):
        assert abs(tl - jl) <= TRAIN_TOL * abs(jl), (tl, jl)
    assert tlines[0].split()[:2] == ["step", "0"]
    assert int(tout["opt_state"].step) == 5
    # the params moved, and the moments are the trained params' shapes
    p0 = _carry(jp0)
    moved = [not torch.equal(a, b) for a, b in
             zip(leaves(tout["params"]), leaves(p0))]
    assert all(moved)
    for a, b in zip(leaves(tout["params"]),
                    leaves(tout["opt_state"].mu)):
        assert a.shape == b.shape and b.dtype == torch.float32


def test_train_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _reduced(tall, "qwen3-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(cfg, loop.TrainConfig(steps=1))


def test_train_config_defaults_equal_repro():
    assert dataclasses.asdict(loop.TrainConfig()) == \
        dataclasses.asdict(jloop.TrainConfig())
    assert dataclasses.asdict(opt.AdamWConfig()) == \
        dataclasses.asdict(jopt.AdamWConfig())


# ---------------------------------------------------------------------------
# The serving step makers
# ---------------------------------------------------------------------------
def _row_err(got, want) -> float:
    got, want = got.astype(np.float64), want.astype(np.float64)
    scale = np.maximum(np.abs(want).max(-1, keepdims=True),
                       np.sqrt((want ** 2).mean()))
    return float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("maker", ["prefill", "encode", "decode"])
def test_step_makers_match_repro(maker):
    """``make_prefill_step`` (last position's logits and the cache),
    ``make_encode_step`` (HuBERT, every position) and
    ``make_decode_step`` against JAX's on the same weights and inputs:
    logits within 1e-4 of a row's scale."""
    arch = "hubert-xlarge" if maker == "encode" else "qwen3-4b"
    jcfg, tcfg = _reduced(jall, arch), _reduced(tall, arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = _carry(jp)
    rng = np.random.default_rng(4)
    if maker == "encode":
        frames = (rng.normal(size=(2, 12, jcfg.d_model)) * 0.02) \
            .astype(np.float32)
        want = jpartition.make_encode_step(jcfg)(
            jp, {"prefix_embeds": jnp.asarray(frames)})
        got = partition.make_encode_step(tcfg)(
            tp, {"prefix_embeds": torch.from_numpy(frames)})
        assert got.shape == want.shape == (2, 12, jcfg.padded_vocab)
        assert _row_err(got.numpy(), np.asarray(want)) <= 1e-4
        return
    toks = rng.integers(0, jcfg.vocab_size, (2, 12))
    jlast, jcache = jpartition.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)},
        JT.init_cache(jcfg, 2, 32, jnp.float32))
    tlast, tcache = partition.make_prefill_step(tcfg)(
        tp, {"tokens": torch.from_numpy(toks)},
        TT.init_cache(tcfg, 2, 32, torch.float32, "cpu"))
    assert tlast.shape == jlast.shape == (2, 1, jcfg.padded_vocab)
    if maker == "prefill":
        assert tcache.pos == int(jcache.pos) == 12
        assert _row_err(tlast.numpy(), np.asarray(jlast)) <= 1e-4
        return
    nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
    jl, _ = jpartition.make_decode_step(jcfg)(
        jp, jnp.asarray(nxt, jnp.int32), jcache)
    tl, tcache = partition.make_decode_step(tcfg)(
        tp, torch.from_numpy(nxt), tcache)
    assert tcache.pos == 13
    assert _row_err(tl.numpy(), np.asarray(jl)) <= 1e-4
