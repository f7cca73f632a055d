"""The language-model cell on the CPU: a run's ``correct`` is true for the
program as it is and false for the control and for each fault planted
under the timed path; the program's spans nest under the batch's; the
counts behind ``flash_roofline.lm`` and ``mfu.lm`` are the model's work;
the readers read what they say.  The cell is sized down to a tiny
granite-shaped model (``run_cell``'s overrides): every width cut, the
traffic's lengths and tokens shortened, the rest its own path.  The tiny
model's limit on ``logit_err`` is its own, 0.05: over 11 seeds its bf16
program read 0.005-0.028, the control 0.071-0.094 and the planted RoPE
0.074-0.153 (the cell's limit is set at published widths, where the
program reads far less)."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from chipbench import control, lm_counts, lm_limits, manifest, tracing
from chipbench.drivers import lm_engine
from chipbench.run import run_cell

CELL = "granite-4.0-h-small-bf16.lm-open-b16"
TINY = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 6,
        "layer_types": ["mamba", "attention", "mamba"] * 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 32, "shared_intermediate_size": 48,
        "num_local_experts": 8, "num_experts_per_tok": 2,
        "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16}
SMALL = {"config": dict(TINY, limits={"logit_err": 0.05}),
         "mix": {"rate_per_s": 20.0, "max_batch": 4,
                 "prompt_lengths": [8, 16, 24], "new_tokens": 5}}
BENCH = manifest.load()
LIMIT = SMALL["config"]["limits"]["logit_err"]


def _run(seed=2**31 + 17, **kw):
    return run_cell(BENCH, CELL, seed=seed, seconds=0.5, trace=False,
                    device="cpu", overrides=SMALL, **kw)


def test_the_program_as_it_is_runs_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] == 10 and out["failed"] == 0
    assert out["reference"]["prompt_lengths"] == [8, 8, 16, 16, 24, 24]
    assert out["reference"]["rows"] == 6 * 5
    assert {k: c["value"] for k, c in out["checks"].items()
            if k != "logit_err"} == dict.fromkeys(
        ["dropped_assignments", "tokens_short", "bucket_lengths_differ",
         "unserved"], 0)
    # no card: the peak memory reads nothing
    assert set(out["metrics"]) == {"p95_ms", "setup_s"}


def test_the_control_fails_the_limit_the_program_meets():
    (row,) = lm_limits.readings(CELL, [2**31 + 3], 0.5, device="cpu",
                                overrides=SMALL)
    assert row["exact_ok"] and row["program"] <= LIMIT < row["control"]
    (row,) = control.readings(CELL, [5], 0.5, device="cpu",
                              overrides=SMALL)
    assert row["program_correct"] and not row["control_correct"]
    assert row["batch_sizes"] and row["rows"] == 6 * 5


def _capacity_dropped(monkeypatch):
    """An expert holds at most half the call's largest load: assignments
    dropped, as a capacity factor drops them."""
    from repro_torch.models import granite_hybrid as G
    monkeypatch.setattr(G, "capacity",
                        lambda counts: max(1, int(counts.max()) // 2))


def _residual_one(monkeypatch):
    """The residual multiplier left at 1 in the model."""
    from repro_torch.models import granite_hybrid as G
    init = G.GraniteHybrid.__init__

    def planted(self, cfg, params, **kw):
        init(self, dataclasses.replace(cfg, residual_multiplier=1.0), params,
             **kw)
    monkeypatch.setattr(G.GraniteHybrid, "__init__", planted)


def _rope_on(monkeypatch):
    """RoPE on q and k, prefill and decode alike."""
    from repro_torch.models import granite_hybrid as G
    from repro_torch.models import layers as L

    def planted(cfg, p, x, state, pos):
        B, S, _ = x.shape
        H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
            cfg.head_dim
        at = (pos + torch.arange(S))[None].expand(B, S)
        q = L.rope((x @ p["wq"]).view(B, S, H, hd), at)
        state.k[:, pos:pos + S] = L.rope((x @ p["wk"]).view(B, S, KV, hd), at)
        state.v[:, pos:pos + S] = (x @ p["wv"]).view(B, S, KV, hd)
        o = G.fa.attention_plain(q, state.k[:, :pos + S],
                                 state.v[:, :pos + S], causal=True,
                                 scale=cfg.attention_multiplier)
        return o.reshape(B, S, H * hd) @ p["wo"], state
    monkeypatch.setattr(G, "attention_mixer", planted)


@pytest.mark.parametrize("fault", [_capacity_dropped, _residual_one,
                                   _rope_on], ids=lambda f: f.__name__)
def test_a_planted_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["checks"]


def test_every_program_span_nests_under_the_batch():
    config = {**manifest.config("granite-4.0-h-small-bf16"), **TINY}
    mix = {**manifest.mix("lm-open-b16"), **SMALL["mix"]}
    sut = lm_engine.System(config, mix, 5, torch.device("cpu"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        win = sut.window(0.3, span=lambda: torch.profiler.record_function(
            tracing.WINDOW))
    t = tracing.read(prof)
    spans = [s for g in t._by_tid.values() for s in g]
    names = {s[2] for s in spans}
    assert names >= {"lm/batch", "lm/prefill", "lm/decode", "lm/sample",
                     "model/mamba", "model/attention", "model/moe",
                     "model/head"}
    batches = [s for s in spans if s[2] == "lm/batch"]
    assert len(batches) == win["batches"] == t.count["lm/batch"]
    for a, b, name, _ in spans:
        if name != "lm/batch":
            assert any(a >= a0 and b <= b0 for a0, b0, *_ in batches), name
    decodes = [s for s in spans if s[2] == "lm/decode"]
    assert len(decodes) == win["engine"]["decode_steps"]
    # a decode step opens each layer's sublayers; a prefill opens none
    per_step = len(TINY["layer_types"])
    assert t.count["model/moe"] == per_step * len(decodes)
    assert t.count["model/head"] == len(decodes)
    for a, b, name, _ in spans:
        if name.startswith("model/"):
            assert any(a >= a0 and b <= b0 for a0, b0, *_ in decodes), name


def test_flash_counts_are_the_causal_pairs_and_the_tensors():
    cfg = {**manifest.config("granite-4.0-h-small-bf16"), **TINY}
    B, S, H, KV, hd = 2, 5, 4, 2, 16
    mask = np.tril(np.ones((S, S)))
    want = B * H * mask.sum() * (2 * hd + 2 * hd)       # QK^T, then PV
    call = lm_counts.flash_call(cfg, B, S)
    assert call["flops"] == want
    assert call["bytes"] == 2 * B * S * hd * (H + KV + KV + H)


def test_model_flops_count_the_weights_a_token_multiplies_by():
    from repro_torch.models import granite_hybrid as G
    file = manifest.config("granite-4.0-h-small-bf16")
    cfg = G.GraniteHybridConfig.from_dict(file)
    E, K = cfg.num_local_experts, cfg.num_experts_per_tok
    per_kind = {}
    for kind in ("mamba", "attention"):
        n = 0
        for name, shape, _ in G.layer_leaves(cfg, kind):
            if name in ("wg", "wu", "wo_e"):
                n += K * np.prod(shape[1:])
            elif len(shape) == 2 and name != "conv_w":
                n += np.prod(shape)
        per_kind[kind] = n
    t = lm_counts.token_flops(file)
    ssd = 2 * cfg.mamba_n_heads * cfg.mamba_d_head * cfg.mamba_d_state
    conv = cfg.mamba_d_conv * cfg.conv_dim
    assert t["mamba"] == 2 * (per_kind["mamba"] + conv + ssd)
    assert t["attention"] == 2 * per_kind["attention"]
    active = sum(per_kind[k] for k in cfg.layers) \
        + cfg.vocab_size * cfg.hidden_size
    assert 4.55e9 < active < 4.65e9           # 4.61 B a token
    one = lm_counts.model_flops(file, [], [(1, 0)])
    assert one == sum(t[k] for k in cfg.layers) + t["head"] \
        + 2 * lm_counts.attention_score_flops(file, 0)


@pytest.mark.parametrize("n", [3, 10, 51])
def test_every_seed_offers_the_same_prompt_lengths(n):
    mix = manifest.mix("lm-open-b16")
    a, b = (lm_engine.prompt_lengths(mix, n, s) for s in (1, 2**31 + 5))
    assert sorted(a) == sorted(b) and len(a) == n
    counts = [int((a == L).sum()) for L in mix["prompt_lengths"]]
    share = np.asarray(mix["length_weights"]) * n
    assert all(abs(c - w) < 1 for c, w in zip(counts, share))


def _trace(spans, kernels):
    """A synthetic trace: a 1,000 us window; ``spans`` (name, start, end)
    and ``kernels`` (name, start, end, launched at) in us."""
    ev = [dict(ph="X", cat="user_annotation", name=tracing.WINDOW, ts=0,
               dur=1000, tid=1, args={})]
    ev += [dict(ph="X", cat="user_annotation", name=n, ts=a, dur=b - a,
                tid=1, args={}) for n, a, b in spans]
    for i, (n, a, b, at) in enumerate(kernels):
        ev += [dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                    ts=at, dur=1, tid=1, args={"correlation": i}),
               dict(ph="X", cat="kernel", name=n, ts=a, dur=b - a, tid=7,
                    args={"correlation": i})]
    return tracing.Trace(ev)


def test_the_readers_read_the_phases_apart():
    t = _trace([("lm/batch", 10, 900), ("lm/prefill", 10, 200),
                ("lm/decode", 300, 400), ("model/moe", 320, 380),
                ("model/mamba", 305, 318), ("lm/decode", 500, 600),
                ("model/moe", 520, 580)],
               [("gemm", 20, 100, 15), ("flash_kernel<bf16>", 100, 180, 20),
                ("rmsnorm", 400, 410, 302), ("ssd", 410, 420, 306),
                ("bmm", 420, 460, 330), ("bmm", 600, 640, 530)])
    win = {"engine": {"prefill_tokens": 2000, "decode_steps": 2},
           "flash_least_s": 40e-6, "model_flops": 1e6, "elapsed_s": 1e-3,
           "images": 1}
    run = {"trace": t, "window": win}

    def read(name):
        return manifest.reader(name).read(run)
    assert read("prefill_ms_per_ktok.lm") == pytest.approx(160e-3 / 2)
    assert read("decode_ms_per_step.lm") == pytest.approx(100e-3 / 2)
    assert read("moe_ms_per_step.lm") == pytest.approx(80e-3 / 2)
    assert read("mamba_ms_per_step.lm") == pytest.approx(10e-3 / 2)
    assert read("flash_roofline.lm") == pytest.approx(50.0)
    assert read("mfu.lm") == pytest.approx(100 * 1e9 / 989e12)
    assert read("idle_share.lm") == pytest.approx(100 * (1 - 0.26))
    # a program without the spans (the parent's) reads nothing
    bare = {"trace": _trace([], [("gemm", 20, 100, 15)]), "window": win}
    for name in ("prefill_ms_per_ktok.lm", "decode_ms_per_step.lm",
                 "moe_ms_per_step.lm", "mamba_ms_per_step.lm",
                 "flash_roofline.lm"):
        assert manifest.reader(name).read(bare) is None, name
        assert manifest.reader(name).read({"trace": None,
                                           "window": win}) is None


def test_a_program_without_the_model_fails_at_once(monkeypatch):
    """A tree whose port has no hybrid model (the parent's) stops at the
    set-up's first line, before any weight is drawn."""
    import repro_torch.models
    monkeypatch.setitem(sys.modules, "repro_torch.models.granite_hybrid",
                        None)
    monkeypatch.delattr(repro_torch.models, "granite_hybrid",
                        raising=False)
    config = {**manifest.config("granite-4.0-h-small-bf16"), **TINY}
    with pytest.raises(ImportError):
        lm_engine.System(config, manifest.mix("lm-open-b16"), 1,
                         torch.device("cpu"))
