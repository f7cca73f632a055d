"""The port's transformer substrate (``repro_torch.models.{layers,
transformer}``, ``serving.engine``, ``launch.partition``) and its numpy
copies (``configs``, ``transformer_profile``, ``core.baselines``) against
the JAX package, on the CPU, over all ten configs' ``.reduced()`` variants
(vocab <= 512).

* Configs and profiles are equal field for field and array for array.
* Prefill logits are within 1e-4 of each row's scale (fp32; 2e-2 bf16) of
  ``repro.models.transformer.forward`` on JAX params carried across by
  ``params_from_numpy``; prefill + decode steps likewise against JAX's
  ``decode_step``.
* Within the port, prefill then decode equals a full forward, the
  sliding-window ring buffer equals the windowed full forward, and
  ``moe`` equals a dense per-expert reference with bounded drops (the
  checks of ``tests/test_arch_smoke.py``).
* The port's ``Engine`` emits JAX's ``Engine``'s greedy tokens for the
  nine decoder configs; every step's top-2 margin must exceed the
  tolerance, so a near-tie fails loudly instead of flaking.
* ``core.baselines`` picks ``repro``'s splits for the five paper CNNs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.configs import all_configs as jall  # noqa: E402
from repro.launch.partition import split_boundary_struct as jboundary  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.profiles import cnn_profile as jcnn_profile  # noqa: E402
from repro.models.profiles import transformer_profile as jprofile  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs import all_configs as tall  # noqa: E402
from repro_torch.launch.partition import split_boundary_struct as tboundary  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.profiles import cnn_profile as tcnn_profile  # noqa: E402
from repro_torch.models.profiles import transformer_profile as tprofile  # noqa: E402
from repro_torch.serving.engine import BucketScheduler, Engine  # noqa: E402

ARCHS = sorted(jall())
DECODERS = [a for a in ARCHS if not jall()[a].is_encoder]
TOL = {"fp32": 1e-4, "bf16": 2e-2}
SMOKE_TOL = 2e-3          # tests/test_arch_smoke.py's rtol/atol
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _reduced(pkg_all, arch, **kw):
    cfg = pkg_all()[arch].reduced()
    return dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512),
                               **kw)


@pytest.fixture(scope="module")
def models():
    """(jcfg, tcfg, jax params, port params) per (arch, dtype), the
    port's params carried across from JAX's ``init_params`` at seed 0."""
    cache = {}

    def get(arch, dtype="fp32", **kw):
        key = (arch, dtype, tuple(sorted(kw.items())))
        if key not in cache:
            jcfg, tcfg = _reduced(jall, arch, **kw), _reduced(tall, arch, **kw)
            jp = JT.init_params(jcfg, jax.random.PRNGKey(0),
                                DTYPES[dtype][0])
            tp = TT.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jp), device="cpu")
            cache[key] = (jcfg, tcfg, jp, tp)
        return cache[key]
    return get


def _batch(cfg, rng, B=2, S=12, P=4):
    """Seeded numpy inputs: tokens, or frames / patches for the stub
    frontends (as tests/test_arch_smoke.py builds them)."""
    b = {}
    if cfg.frontend == "audio":
        b["prefix_embeds"] = (rng.normal(size=(B, S, cfg.d_model))
                              * 0.02).astype(np.float32)
    elif cfg.frontend == "vision":
        b["prefix_embeds"] = (rng.normal(size=(B, P, cfg.d_model))
                              * 0.02).astype(np.float32)
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S - P))
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    return b


def _jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
            for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in b.items()}


def _row_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| over each row's scale (its largest |value|,
    at least the RMS of the whole tensor)."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    scale = np.maximum(np.abs(want).max(-1, keepdims=True),
                       np.sqrt((want ** 2).mean()))
    return float((np.abs(got - want) / scale).max())


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# Numpy copies
# ---------------------------------------------------------------------------
def test_all_configs_have_repro_names():
    assert sorted(tall()) == ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_repro_field_for_field(arch):
    jc, tc = jall()[arch], tall()[arch]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    assert (tc.hd, tc.padded_vocab, tc.e_ff, tc.n_mamba_heads,
            tc.block_kinds(), tc.total_params(), tc.active_params()) == \
        (jc.hd, jc.padded_vocab, jc.e_ff, jc.n_mamba_heads,
         jc.block_kinds(), jc.total_params(), jc.active_params())


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_profile_equals_repro(arch, mode):
    for cfg_of, kw in ((lambda a: a, dict(seq_len=4096, batch=8)),
                       (lambda a: a.reduced(), dict(seq_len=64, batch=2))):
        jp = jprofile(cfg_of(jall()[arch]), mode=mode, dtype_bytes=2, **kw)
        tp = tprofile(cfg_of(tall()[arch]), mode=mode, dtype_bytes=2, **kw)
        assert [dataclasses.asdict(x) for x in tp.layers] == \
            [dataclasses.asdict(x) for x in jp.layers]
        assert (tp.name, tp.input_bytes, tp.dtype, tp.input_follows_dtype) \
            == (jp.name, jp.input_bytes, jp.dtype, jp.input_follows_dtype)
        for fn in ("cum_flops", "cum_mem"):
            np.testing.assert_array_equal(getattr(tp, fn)(),
                                          getattr(jp, fn)())


@pytest.mark.parametrize("env", ["PAPER_ENV_J6", "PAPER_ENV_NOTE8"])
@pytest.mark.parametrize("model", sorted(jcnn.CNN_MODELS))
def test_baselines_pick_repros_split(model, env):
    jhw = getattr(jcore, env)
    from repro_torch.core import hardware as thw
    thw_env = getattr(thw, env)
    jprof, tprof = jcnn_profile(model), tcnn_profile(model)
    assert sorted(tcore.ALGORITHMS) == sorted(jcore.ALGORITHMS)
    for name, fn in tcore.ALGORITHMS.items():
        jfn = jcore.ALGORITHMS[name]
        if name == "RS":
            got = fn(tprof, thw_env, np.random.default_rng(3))
            want = jfn(jprof, jhw, np.random.default_rng(3))
        else:
            got, want = fn(tprof, thw_env), jfn(jprof, jhw)
        assert got == want, name


@pytest.mark.parametrize("dtype", [None, "fp32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-7b"])
def test_split_boundary_struct_equals_repro(arch, dtype):
    cfg = jall()[arch]
    jstruct, jbytes = jboundary(cfg, 4, 64, dtype=dtype)
    tstruct, tbytes = tboundary(tall()[arch], 4, 64, dtype=dtype)
    assert tbytes == jbytes
    assert tstruct.shape == tuple(jstruct.shape)
    assert str(tstruct.dtype).split(".")[-1] == str(jstruct.dtype)


# ---------------------------------------------------------------------------
# Forward and decode against repro
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_repro(arch, dtype, models):
    jcfg, tcfg, jp, tp = models(arch, dtype)
    b = _batch(jcfg, np.random.default_rng(1))
    jl, _, jaux = JT.forward(jcfg, jp, _jax_batch(b), mode="prefill")
    tl, _, taux = TT.forward(tcfg, tp, _torch_batch(b), mode="prefill")
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert np.isfinite(tl.numpy()).all()
    assert _row_err(_np(tl), _np(jl)) <= TOL[dtype]
    assert abs(float(taux) - float(jaux)) <= TOL[dtype] * max(
        1.0, abs(float(jaux)))


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_steps_match_repro(arch, models):
    """A cached prefill, then three decode steps, in both packages: each
    step's logits within 1e-4 of the row's scale."""
    jcfg, tcfg, jp, tp = models(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 10))
    jc = JT.init_cache(jcfg, 2, 16, jnp.float32)
    tc = TT.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    jl, jc, _ = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks[:, :7],
                                                            jnp.int32)},
                           mode="prefill", cache=jc)
    tl, tc, _ = TT.forward(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :7])},
                           mode="prefill", cache=tc)
    assert _row_err(_np(tl), _np(jl)) <= TOL["fp32"]
    for t in range(7, 10):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t:t + 1],
                                                      jnp.int32), jc)
        tl, tc = TT.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]),
                                tc)
        assert _row_err(_np(tl), _np(jl)) <= TOL["fp32"], t
    assert tc.pos == int(jc.pos) == 10


def test_zamba_padded_segments_match_repro(models):
    """Zamba2 with a layer count that leaves a padded slot and a segment
    without its shared block: the skipped slots give JAX's masked result,
    in prefill and in decode."""
    jcfg, tcfg, jp, tp = models("zamba2-7b", num_layers=3)
    assert JT._zamba_segments(jcfg) == (2, 4)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9))
    jl, _, _ = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _, _ = TT.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert _row_err(_np(tl), _np(jl)) <= TOL["fp32"]
    tc = TT.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    _, tc, _ = TT.forward(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :8])},
                          mode="prefill", cache=tc)
    step, _ = TT.decode_step(tcfg, tp, torch.from_numpy(toks[:, 8:]), tc)
    assert _row_err(_np(step)[:, 0], _np(jl)[:, 8]) <= TOL["fp32"]


def test_params_from_numpy_carries_bf16_bits(models):
    _, _, jp, tp = models("granite-moe-3b-a800m", "bf16")
    jw = np.asarray(jp["blocks"]["moe"]["wg"])
    tw = tp["blocks"]["moe"]["wg"]
    assert tw.dtype == torch.bfloat16 and tuple(tw.shape) == jw.shape
    np.testing.assert_array_equal(tw.view(torch.int16).numpy(),
                                  jw.view(np.int16))
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Within the port (tests/test_arch_smoke.py's checks)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_matches_full_forward(arch):
    cfg = _reduced(tall, arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=16.0)
    params = TT.init_params(cfg, 0, torch.float32, "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)))
    full, _, _ = TT.forward(cfg, params, {"tokens": toks}, mode="train")
    n_pre = S // 2
    cache = TT.init_cache(cfg, B, max_len=S, dtype=torch.float32,
                          device="cpu")
    pre, cache, _ = TT.forward(cfg, params, {"tokens": toks[:, :n_pre]},
                               mode="prefill", cache=cache)
    torch.testing.assert_close(pre, full[:, :n_pre], rtol=SMOKE_TOL,
                               atol=SMOKE_TOL)
    steps = []
    for t in range(n_pre, S):
        lg, cache = TT.decode_step(cfg, params, toks[:, t:t + 1], cache)
        steps.append(lg)
    torch.testing.assert_close(torch.cat(steps, 1), full[:, n_pre:],
                               rtol=SMOKE_TOL, atol=SMOKE_TOL)


@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3-mini-3.8b"])
def test_sliding_window_decode_consistency(arch):
    """Ring-buffer decode of exactly the window equals a full forward
    that applies the same window mask in-sequence."""
    cfg = _reduced(tall, arch, sliding_window=6)
    params = TT.init_params(cfg, 0, torch.float32, "cpu")
    B, S = 1, 14
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S)))
    ref, _, _ = TT.forward(cfg, params, {"tokens": toks}, mode="train")
    cache = TT.init_cache(cfg, B, max_len=S, dtype=torch.float32,
                          device="cpu")
    assert cache.kv.k.shape[2] == 6   # (layers, B, M, kv, hd): M == window
    logits = []
    for t in range(S):
        lg, cache = TT.decode_step(cfg, params, toks[:, t:t + 1], cache)
        logits.append(lg)
    torch.testing.assert_close(torch.cat(logits, 1), ref, rtol=SMOKE_TOL,
                               atol=SMOKE_TOL)


def test_sliding_window_matches_repro(models):
    """The windowed ring buffer against JAX's, step for step."""
    jcfg, tcfg, jp, tp = models("qwen3-4b", sliding_window=6)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (1, 14))
    jc = JT.init_cache(jcfg, 1, 14, jnp.float32)
    tc = TT.init_cache(tcfg, 1, 14, torch.float32, "cpu")
    for t in range(14):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t:t + 1],
                                                      jnp.int32), jc)
        tl, tc = TT.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]),
                                tc)
        assert _row_err(_np(tl), _np(jl)) <= TOL["fp32"], t
    np.testing.assert_array_equal(tc.kv.slot_pos.numpy(),
                                  np.asarray(jc.kv.slot_pos))


def test_moe_capacity_drops_are_bounded():
    cfg = _reduced(tall, "granite-moe-3b-a800m")
    g = torch.Generator().manual_seed(0)
    params = TL.init_moe_params(cfg, g, torch.float32)
    x = torch.randn((4, 64, cfg.d_model), generator=g) * 0.5
    y, aux = TL.moe(cfg, params, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert 0.5 < float(aux) < 4.0


def test_moe_matches_dense_reference():
    """Sort-based dispatch == brute-force per-token expert evaluation when
    nothing drops."""
    cfg = _reduced(tall, "granite-moe-3b-a800m", moe_capacity_factor=8.0)
    g = torch.Generator().manual_seed(0)
    params = TL.init_moe_params(cfg, g, torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=g) * 0.5
    y, _ = TL.moe(cfg, params, x)
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ params["router"], -1)
    gate, eidx = torch.topk(probs, cfg.experts_per_token)
    gate = gate / gate.sum(-1, keepdim=True)
    ref = torch.zeros_like(xt)
    for e in range(cfg.num_experts):
        h = torch.nn.functional.silu(xt @ params["wg"][e]) \
            * (xt @ params["wu"][e])
        w = torch.where(eidx == e, gate, torch.zeros_like(gate)).sum(-1)
        ref = ref + (h @ params["wd"][e]) * w[:, None]
    torch.testing.assert_close(y.reshape(-1, cfg.d_model), ref, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("factor", [1.0, 1.25])
def test_moe_drops_match_repro(factor):
    """Under a tight capacity the port drops the same assignments as the
    JAX package: outputs within 1e-4 of scale, aux equal."""
    jcfg = _reduced(jall, "granite-moe-3b-a800m", moe_capacity_factor=factor)
    tcfg = _reduced(tall, "granite-moe-3b-a800m", moe_capacity_factor=factor)
    jp = JL.init_moe_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = (np.random.default_rng(6).normal(size=(4, 64, jcfg.d_model))
         * 0.5).astype(np.float32)
    jy, jaux = JL.moe(jcfg, jp, jnp.asarray(x))
    ty, taux = TL.moe(tcfg, tp, torch.from_numpy(x))
    assert _row_err(_np(ty), _np(jy)) <= TOL["fp32"]
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    # capacity bites: some token gets less than its full expert sum
    assert TL.moe_capacity(tcfg, 256) < 256 * 2 // 4 * 2


# ---------------------------------------------------------------------------
# The decode engine
# ---------------------------------------------------------------------------
def _recorded(fn, log):
    def wrapped(*a):
        logits, cache = fn(*a)
        log.append(np.asarray(_np(logits)))
        return logits, cache
    return wrapped


@pytest.mark.parametrize("arch", DECODERS)
def test_engine_greedy_tokens_equal_repro(arch, models):
    jcfg, tcfg, jp, tp = models(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (8, 8, 12, 8)]
    jeng = JEngine(jcfg, jp, max_len=32, max_batch=4)
    teng = Engine(tcfg, tp, max_len=32, max_batch=4, device="cpu")
    jlog, tlog = [], []
    jeng._prefill = _recorded(jeng._prefill, jlog)
    jeng._decode = _recorded(jeng._decode, jlog)
    teng._prefill = _recorded(teng._prefill, tlog)
    teng._decode = _recorded(teng._decode, tlog)
    jreqs = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    treqs = [teng.submit(p, max_new_tokens=5) for p in prompts]
    jeng.run_until_idle()
    teng.run_until_idle()
    assert len(tlog) == len(jlog) == 2 * 5
    for jl, tl in zip(jlog, tlog):
        assert _row_err(tl, jl) <= TOL["fp32"]
        top2 = np.sort(jl, axis=-1)[:, -2:]
        scale = np.abs(jl).max(-1)
        margin = (top2[:, 1] - top2[:, 0]) / scale
        assert (margin > TOL["fp32"]).all(), \
            f"near-tie in the greedy pick: margins {margin}"
    for jr, tr in zip(jreqs, treqs):
        assert tr.output == jr.output and len(tr.output) == 5
    assert teng.stats["tokens"] == jeng.stats["tokens"] == 20
    assert teng.stats["batches"] == jeng.stats["batches"] == 2


def test_bucket_scheduler_packs_like_repro():
    from repro.serving.engine import BucketScheduler as JSched
    from repro.serving.engine import Request as JReq
    from repro_torch.serving.engine import Request
    js, ts = JSched(max_batch=2), BucketScheduler(max_batch=2)
    for i, n in enumerate([3, 5, 3, 3, 5, 7]):
        js.add(JReq(rid=i, prompt=[0] * n))
        ts.add(Request(rid=i, prompt=[0] * n))
    while True:
        jb, tb = js.next_batch(), ts.next_batch()
        assert (jb is None) == (tb is None)
        if jb is None:
            break
        assert [r.rid for r in tb] == [r.rid for r in jb]
    assert ts.n_pending == 0


def test_temperature_sampling_is_seeded_by_request_id():
    cfg = _reduced(tall, "qwen3-4b")
    params = TT.init_params(cfg, 0, torch.float32, "cpu")
    outs = []
    for _ in range(2):
        eng = Engine(cfg, params, max_len=32, max_batch=2, device="cpu")
        reqs = [eng.submit([1, 2, 3, 4], max_new_tokens=6, temperature=t)
                for t in (1.0, 0.0)]
        eng.run_until_idle()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == 6 for o in outs[0])


def test_engine_refuses_encoders_and_defaults_to_the_card():
    cfg = _reduced(tall, "hubert-xlarge")
    with pytest.raises(ValueError, match="decoder"):
        Engine(cfg, {}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(_reduced(tall, "qwen3-4b"), {})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.init_params(_reduced(tall, "qwen3-4b"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.init_cache(_reduced(tall, "qwen3-4b"), 1, 8)
