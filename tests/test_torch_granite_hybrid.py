"""The hybrid language model (``repro_torch.models.granite_hybrid``)
against its plain reference (``chipbench.reference.granite_hybrid``, the
benchmark's) on
seeded weights, on the CPU, at a granite-shaped size: d 64, two periods of
(mamba, attention, mamba), 8 experts top-2 and a shared expert, vocab 256.

* The weights the model draws are the reference's, bit for bit.
* Prefill logits and decode through the cache match the reference's full
  forward: fp32 to 1e-5 of a row's largest logit; bf16 to 5e-2, as the
  benchmark's tiny cell (at d 64 one bf16 rounding weighs more than at
  published widths: the tiny program read up to 0.028 over 11 seeds, the
  float8 control 0.071 at least).
* A routing skewed onto few experts drops nothing (dropless capacity),
  where the capacity-factor dispatch of ``layers.moe_local`` would.
* A decode step dispatches with T slots an expert and no host sync,
  dropless and with the logits of the data-dependent capacity; it writes
  the cache in place; the loads it reports are the real ones; a step
  past the cache's length is refused.
* On a card (``-m card``): decode steps replayed from CUDA graphs give
  the eager steps' logits bit for bit, one capture a batch.
* Each multiplier is applied where the published model applies it, and
  attention carries no positional encoding.
* ``layer_types`` decides each layer's mixer, in order.
* The engine serves the model, and every registered decoder config
  exactly as it did before the engine took model objects."""
import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chipbench.reference import granite_hybrid as R  # noqa: E402
from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import attention_plain, attention_scale  # noqa: E402
from repro_torch.models import granite_hybrid as G  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import Engine, TransformerLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 7
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _tokens(B=2, S=70, seed=0, vocab=256):
    """Token ids; 70 of them span two chunks of the SSD (64 a chunk)."""
    return torch.randint(0, vocab, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _err(got, want) -> float:
    """The worst row's widest gap over its largest reference logit."""
    return float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1)).max())


def _reference(cfg, toks, dtype=torch.float32, seed=SEED):
    out, _ = R.forward(dataclasses.asdict(cfg), seed, list(toks),
                       device="cpu", store=R.store_as(dtype))
    return torch.stack(out)


@pytest.fixture(scope="module")
def fp32():
    cfg = G.tiny()
    return cfg, G.GraniteHybrid(cfg, G.init_params(cfg, SEED, "cpu",
                                                   torch.float32))


def test_the_drawn_weights_are_the_references_bit_for_bit():
    cfg = G.tiny()
    p = G.init_params(cfg, SEED, "cpu", torch.bfloat16)
    d = dataclasses.asdict(cfg)
    store = R.store_as(torch.bfloat16)
    head = R.draw_head(d, SEED, "cpu", store)
    assert torch.equal(p["embed"].float(), head["embed"])
    assert torch.equal(p["final_norm"].float(), head["final_norm"])
    for i in range(cfg.num_hidden_layers):
        want = R.draw_layer(d, i, SEED, "cpu", store)
        assert p["layers"][i].keys() == want.keys()
        for name, t in p["layers"][i].items():
            assert t.dtype == (torch.float32 if name in G.FP32_LEAVES
                               else torch.bfloat16), name
            assert torch.equal(t.float(), want[name]), (i, name)
    # layer i alone: another layer's stream is untouched by it
    again = G.init_layer(cfg, 3, SEED, "cpu")
    assert all(torch.equal(again[k], p["layers"][3][k]) for k in again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_prefill_logits_match_the_reference(dtype):
    cfg = G.tiny()
    model = G.GraniteHybrid(cfg, G.init_params(cfg, SEED, "cpu", dtype))
    toks = _tokens()
    want = _reference(cfg, toks, dtype)
    assert _err(model.forward(toks), want) <= TOL[dtype]
    last, cache = model.prefill(toks, model.init_cache(2, 70, dtype))
    assert _err(last, want[:, -1]) <= TOL[dtype]
    assert cache.pos == toks.shape[1]


def test_decode_through_the_cache_matches_the_full_forward(fp32):
    cfg, model = fp32
    toks = _tokens(S=78, seed=3)
    want = _reference(cfg, toks)
    cache = model.init_cache(2, 78, torch.float32)
    logits, cache = model.prefill(toks[:, :67], cache)
    rows = [logits]
    for j in range(67, 78):
        logits, cache = model.decode(toks[:, j:j + 1], cache)
        rows.append(logits)
    assert cache.pos == 78
    assert _err(torch.stack(rows, 1), want[:, 66:]) <= TOL[torch.float32]


def test_a_skewed_routing_drops_nothing(fp32):
    """Inputs near the all-ones direction and a router whose experts 1 and
    6 point along it: every token picks those two, so each holds all 33
    tokens, four times the mean, and nothing is dropped."""
    cfg, model = fp32
    p = dict(model.params["layers"][0])
    p["router"] = p["router"].clone()
    p["router"][:, [1, 6]] = 5.0 / cfg.hidden_size ** 0.5
    x = 1.0 + 0.1 * torch.randn(3, 11, cfg.hidden_size,
                                generator=torch.Generator().manual_seed(5))
    m = G.GraniteHybrid(cfg, model.params)
    got = m._moe(p, x)
    stats = m.load_stats()
    assert stats["dropped"] == 0
    assert stats["largest"] == 3 * 11
    assert stats["mean_mean"] == 3 * 11 * 2 / 8
    d = dataclasses.asdict(cfg)
    for b in range(3):
        want, _ = R.moe(d, p, x[b], R.store_as(torch.float32))
        assert _err(got[b], want) <= TOL[torch.float32]
    # the capacity-factor dispatch would have dropped most of the pairs
    eidx = torch.topk(x.reshape(33, -1) @ p["router"], 2, dim=-1).indices
    c = L.moe_capacity(all_configs()["granite-moe-3b-a800m"], 33)
    assert not L.moe_dispatch(eidx, 8, c)[3].all()


def _no_capacity(counts):
    raise AssertionError("a decode step took the data-dependent capacity")


def test_decode_never_calls_capacity(fp32, monkeypatch):
    cfg, model = fp32
    toks = _tokens(S=20, seed=11)
    cache = model.init_cache(2, 20, torch.float32)
    _, cache = model.prefill(toks[:, :10], cache)
    monkeypatch.setattr(G, "capacity", _no_capacity)
    for j in range(10, 20):
        logits, cache = model.decode(toks[:, j:j + 1], cache)
        assert torch.isfinite(logits).all()
    assert cache.pos == 20 and model.dropped() == 0


def test_a_skewed_routing_drops_nothing_at_decode(fp32, monkeypatch):
    """The router of ``test_a_skewed_routing_drops_nothing`` on decode
    steps of 16 tokens: every token picks experts 1 and 6, so each holds
    T = 16 pairs, all its T slots, and nothing is dropped."""
    cfg, model = fp32
    monkeypatch.setattr(G, "capacity", _no_capacity)
    p = dict(model.params["layers"][0])
    p["router"] = p["router"].clone()
    p["router"][:, [1, 6]] = 5.0 / cfg.hidden_size ** 0.5
    m = G.GraniteHybrid(cfg, model.params)
    g = torch.Generator().manual_seed(6)
    d = dataclasses.asdict(cfg)
    for _ in range(4):
        x = 1.0 + 0.1 * torch.randn(16, 1, cfg.hidden_size, generator=g)
        got = m._moe(p, x)
        want, _ = R.moe(d, p, x[:, 0], R.store_as(torch.float32))
        assert _err(got[:, 0], want) <= TOL[torch.float32]
    eidx = torch.topk(x[:, 0] @ p["router"], 2, dim=-1).indices
    assert sorted(eidx.unique().tolist()) == [1, 6]
    stats = m.load_stats()
    assert stats["dropped"] == 0 and m.dropped() == 0
    assert stats["largest"] == 16 and stats["max_mean"] == 16
    assert stats["calls"] == 4 and stats["mean_mean"] == 16 * 2 / 8


def test_decode_logits_equal_those_of_the_data_dependent_capacity(
        fp32, monkeypatch):
    """The same decode steps with each expert given the call's largest
    load (the steps' tokens as one call of B positions) instead of T
    slots: the same logits at fp32."""
    cfg, model = fp32
    toks = _tokens(B=3, S=24, seed=12)
    moe = G.GraniteHybrid._moe

    def data_dependent(self, p, x):
        if x.shape[1] != 1:
            return moe(self, p, x)
        return moe(self, p, x.transpose(0, 1)).transpose(0, 1)
    rows = []
    for m in (G.GraniteHybrid(cfg, model.params),
              G.GraniteHybrid(cfg, model.params)):
        cache = m.init_cache(3, 24, torch.float32)
        logits, cache = m.prefill(toks[:, :12], cache)
        out = [logits]
        for j in range(12, 24):
            logits, cache = m.decode(toks[:, j:j + 1], cache)
            out.append(logits)
        rows.append(torch.stack(out, 1))
        monkeypatch.setattr(G.GraniteHybrid, "_moe", data_dependent)
    assert _err(rows[0], rows[1]) <= 1e-6
    assert torch.equal(rows[0][:, 0], rows[1][:, 0])     # the prefill's


def _recording_dispatch(monkeypatch):
    """``layers.moe_dispatch`` patched to note each call's capacity C and
    largest load."""
    dispatch, calls = L.moe_dispatch, []

    def recorded(eidx, E, C):
        out = dispatch(eidx, E, C)
        calls.append((C, int(out[2].max())))
        return out
    monkeypatch.setattr(L, "moe_dispatch", recorded)
    return calls


@pytest.mark.parametrize("T", [1, 5, 16])
def test_a_decode_step_dispatches_at_t_slots(fp32, monkeypatch, T):
    """One position of T tokens: ``layers.moe_dispatch`` is given C = T,
    keeps every pair, and the output is the reference's experts."""
    cfg, model = fp32
    monkeypatch.setattr(G, "capacity", _no_capacity)
    calls = _recording_dispatch(monkeypatch)
    p = model.params["layers"][1]
    x = torch.randn(T, 1, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(20 + T))
    m = G.GraniteHybrid(cfg, model.params)
    got = m._moe(p, x)
    assert [c for c, _ in calls] == [T] and calls[0][1] <= T
    assert m.dropped() == 0
    want, _ = R.moe(dataclasses.asdict(cfg), p, x[:, 0],
                    R.store_as(torch.float32))
    assert _err(got[:, 0], want) <= TOL[torch.float32]


def test_decode_writes_the_cache_in_place(fp32):
    cfg, model = fp32
    toks = _tokens(S=14, seed=13)
    cache = model.init_cache(2, 16, torch.float32)
    _, cache = model.prefill(toks[:, :12], cache)
    ptrs = [t.data_ptr() for st in cache.states for t in st]
    before = [t.clone() for st in cache.states for t in st]
    for j in (12, 13):
        states, pos = cache.states, cache.pos
        _, cache = model.decode(toks[:, j:j + 1], cache)
        assert cache.states is states and cache.pos == pos + 1
    assert [t.data_ptr() for st in cache.states for t in st] == ptrs
    after = [t for st in cache.states for t in st]
    assert all(not torch.equal(a, b) for a, b in zip(after, before))
    # on the CPU every step runs eagerly: nothing captured
    assert model.stats["graph_captures"] == 0
    assert model.stats["decode_graph_steps"] == 0


def test_a_decode_step_past_the_cache_raises(fp32):
    """A cache of 12 positions, all used: the next step is refused on the
    host before it writes anything."""
    cfg, model = fp32
    toks = _tokens(S=13, seed=15)
    cache = model.init_cache(2, 12, torch.float32)
    _, cache = model.prefill(toks[:, :11], cache)
    _, cache = model.decode(toks[:, 11:12], cache)
    before = [t.clone() for st in cache.states for t in st]
    with pytest.raises(ValueError, match="12 positions"):
        model.decode(toks[:, 12:13], cache)
    after = [t for st in cache.states for t in st]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_load_stats_report_the_real_loads_of_decode_steps(fp32, monkeypatch):
    """Six decode steps of 5 tokens from an empty cache: the largest load
    and the mean of each call's largest are the dispatch's own counts,
    not the T slots."""
    cfg, model = fp32
    calls = _recording_dispatch(monkeypatch)
    m = G.GraniteHybrid(cfg, model.params)
    cache = m.init_cache(5, 6, torch.float32)
    toks = _tokens(B=5, S=6, seed=14)
    for j in range(6):
        _, cache = m.decode(toks[:, j:j + 1], cache)
    stats = m.load_stats()
    assert all(c == 5 for c, _ in calls)
    loads = [load for _, load in calls]
    assert len(loads) == stats["calls"] == 6 * cfg.num_hidden_layers
    assert stats["largest"] == max(loads) <= 5
    assert stats["max_mean"] == pytest.approx(sum(loads) / len(loads))
    assert stats["max_mean"] < 5 and stats["dropped"] == 0
    assert m.stats["decode_eager_steps"] == 6


def test_a_planted_capacity_drop_is_counted(fp32, monkeypatch):
    cfg, model = fp32
    monkeypatch.setattr(G, "capacity", lambda counts: 1)
    m = G.GraniteHybrid(cfg, model.params)
    m.forward(_tokens(B=2, S=9))
    assert m.dropped() > 0


@pytest.mark.parametrize("field,value", [
    ("embedding_multiplier", 3.0), ("residual_multiplier", 1.0),
    ("attention_multiplier", 1 / 128 ** 0.5), ("logits_scaling", 1.0)])
def test_each_multiplier_is_applied_as_published(fp32, field, value):
    cfg, model = fp32
    toks = _tokens(seed=9)
    base = model.forward(toks)
    other = dataclasses.replace(cfg, **{field: value})
    drawn = G.init_params(other, SEED, "cpu", torch.float32)
    got = G.GraniteHybrid(other, drawn).forward(toks)
    assert _err(got, _reference(other, toks)) <= TOL[torch.float32]
    # the same weights under the other multiplier: another model
    same = G.GraniteHybrid(other, model.params).forward(toks)
    assert _err(same, base) > 1e-3
    if field == "logits_scaling":
        assert torch.allclose(same, base * cfg.logits_scaling, rtol=1e-6)


def test_attention_carries_no_positional_encoding(fp32, monkeypatch):
    """The last query's output is the same whatever order the keys before
    it come in: nothing in the attention tells positions apart.  With
    RoPE planted on q and k the order shows."""
    cfg, model = fp32
    p = model.params["layers"][1]
    x = torch.randn(1, 9, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(2))
    perm = torch.cat([torch.randperm(8, generator=torch.Generator()
                                     .manual_seed(1)), torch.tensor([8])])

    def last(x):
        st = G.KVState(*(torch.zeros(1, 9, cfg.num_key_value_heads,
                                     cfg.head_dim) for _ in range(2)))
        return G.attention_mixer(cfg, p, x, st, 0)[0][0, -1]
    assert torch.allclose(last(x), last(x[:, perm]), atol=1e-5)
    flash = kfa.flash_attention
    pos = torch.arange(9)[None]
    monkeypatch.setattr(G.fa, "flash_attention", lambda q, k, v, **kw: flash(
        L.rope(q, pos), L.rope(k, pos), v, **kw))
    assert not torch.allclose(last(x), last(x[:, perm]), atol=1e-3)


def test_layer_types_decide_each_layers_mixer_in_order(fp32):
    cfg, model = fp32
    cache = model.init_cache(1, 4)
    assert [type(s).__name__ for s in cache.states] == \
        ["MambaState" if k == "mamba" else "KVState" for k in cfg.layers]
    assert cfg.layers == ("mamba", "attention", "mamba") * 2
    full = G.GRANITE_4_0_H_SMALL
    assert [i for i, k in enumerate(full.layer_types)
            if k == "attention"] == [5, 15, 25, 35]
    cut = dataclasses.replace(full, num_hidden_layers=20)
    assert cut.layers.count("mamba") == 18 and cut.layers[5] == \
        cut.layers[15] == "attention"
    # another order of the same layers is another model
    swapped = dataclasses.replace(
        cfg, layer_types=("attention", "mamba", "mamba") * 2)
    toks = _tokens(seed=4)
    with pytest.raises(KeyError):            # layer 0's weights are Mamba's
        G.GraniteHybrid(swapped, model.params).forward(toks)
    other = G.GraniteHybrid(swapped, G.init_params(swapped, SEED, "cpu",
                                                   torch.float32))
    assert _err(other.forward(toks), _reference(swapped, toks)) \
        <= TOL[torch.float32]


def test_the_published_configuration_is_the_benchmarks():
    with open(ROOT / "chipbench" / "configs"
              / "granite-4.0-h-small-bf16.json") as f:
        file = json.load(f)
    cfg = G.GraniteHybridConfig.from_dict(file)
    assert cfg == dataclasses.replace(G.GRANITE_4_0_H_SMALL,
                                      num_hidden_layers=20)
    assert file["reduced"] == ["num_hidden_layers"]
    assert file["published"] == {"num_hidden_layers": 40}
    assert (cfg.hidden_size, cfg.head_dim, cfg.mamba_inner, cfg.conv_dim) \
        == (4096, 128, 8192, 8448)
    params = sum(np.prod(s) for kind in cfg.layers
                 for _, s, _ in G.layer_leaves(cfg, kind)) \
        + cfg.vocab_size * cfg.hidden_size + cfg.hidden_size
    assert 16.2e9 < params < 16.4e9          # 32.6 GB at bf16


def test_the_benchmarks_reference_is_the_repos():
    """The tests hold the model to the benchmark's reference, the one
    copy in the repo, and it imports nothing but torch: the port under
    test cannot bend it."""
    assert Path(R.__file__).resolve() == \
        (ROOT / "chipbench" / "reference" / "granite_hybrid.py").resolve()
    assert not list((ROOT / "src" / "repro_torch").rglob("reference/*.py"))
    tree = ast.parse(Path(R.__file__).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert roots == {"__future__", "contextlib", "math", "torch"}


# ---------------------------------------------------------------------------
# The flash kernel's softmax scale
# ---------------------------------------------------------------------------
def _qkv(S=16, H=4, KV=2, hd=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, S, H, hd, generator=g),
            torch.randn(2, S, KV, hd, generator=g),
            torch.randn(2, S, KV, hd, generator=g))


def test_flash_scale_defaults_to_one_over_sqrt_hd():
    q, k, v = _qkv()
    base = kfa.flash_attention(q, k, v, causal=True)
    assert torch.equal(kfa.flash_attention(q, k, v, causal=True,
                                           scale=attention_scale(32)), base)
    assert torch.equal(attention_plain(q, k, v, causal=True), base)
    assert torch.equal(ops.flash_attention_gqa(q, k, v, block_q=16,
                                               block_k=16), base)


@pytest.mark.parametrize("scale", [1 / 128, 0.3])
def test_flash_scale_matches_the_plain_version(scale):
    q, k, v = _qkv(seed=1)
    want = torch.softmax(
        (q.transpose(1, 2) @ k.repeat_interleave(2, 2).permute(0, 2, 3, 1))
        * scale + torch.triu(torch.full((16, 16), -torch.inf), 1), -1) \
        @ v.repeat_interleave(2, 2).transpose(1, 2)
    for got in (kfa.flash_attention(q, k, v, causal=True, scale=scale),
                ops.flash_attention_gqa(q, k, v, block_q=16, block_k=16,
                                        scale=scale)):
        assert torch.allclose(got, want.transpose(1, 2), atol=1e-5)
    assert not torch.allclose(kfa.flash_attention(q, k, v, causal=True),
                              want.transpose(1, 2), atol=1e-3)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
def test_the_engine_serves_the_hybrid_model(fp32):
    cfg, model = fp32
    eng = Engine(model, max_len=24, max_batch=4, device="cpu")
    prompts = [_tokens(B=1, S=n, seed=n)[0].tolist() for n in (8, 8, 12)]
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    reqs[0].logits = []
    while eng.step():
        pass
    assert all(r.done and len(r.output) == 5 for r in reqs)
    assert eng.stats["decode_steps"] == 2 * 4
    assert eng.stats["prefill_tokens"] == 28 and eng.stats["tokens"] == 15
    # the collected rows are the full forward's on the served tokens
    seq = torch.tensor([prompts[0] + reqs[0].output[:-1]])
    want = model.forward(seq)[0, 7:]
    got = torch.from_numpy(np.stack(reqs[0].logits))
    assert _err(got, want) <= TOL[torch.float32]
    assert reqs[0].output == want.argmax(-1).tolist()
    assert model.dropped() == 0


def test_the_oldest_first_schedule_serves_buckets_in_arrival_order():
    from repro_torch.serving.engine import BucketScheduler, Request
    order = {}
    for policy in BucketScheduler.POLICIES:
        s = BucketScheduler(max_batch=2, policy=policy)
        for i, n in enumerate([7, 3, 5, 3, 3, 5, 3]):
            s.add(Request(rid=i, prompt=[0] * n))
        order[policy] = [[r.rid for r in b] for b in iter(s.next_batch,
                                                           None)]
    assert order["largest"] == [[1, 3], [4, 6], [2, 5], [0]]
    assert order["oldest"] == [[0], [1, 3], [2, 5], [4, 6]]
    with pytest.raises(ValueError, match="policy"):
        BucketScheduler(policy="shortest")


def _old_engine_tokens(cfg, params, prompts, max_new, max_len):
    """What the engine computed before it took model objects: prefill by
    ``transformer.forward``, greedy steps by ``decode_step``, from a fresh
    cache a batch (the batch here is one bucket of equal lengths)."""
    toks = torch.tensor(prompts)
    cache = T.init_cache(cfg, len(prompts), max_len, torch.float32, "cpu")
    logits, cache, _ = T.forward(cfg, params, {"tokens": toks},
                                 mode="prefill", cache=cache)
    rows = [logits[:, -1].numpy()]
    cur = rows[-1].argmax(-1)
    out = [[int(c)] for c in cur]
    for _ in range(1, max_new):
        logits, cache = T.decode_step(
            cfg, params, torch.as_tensor(cur)[:, None], cache)
        rows.append(logits[:, -1].numpy())
        cur = rows[-1].argmax(-1)
        for o, c in zip(out, cur):
            o.append(int(c))
    return out, rows


@pytest.mark.parametrize("arch", sorted(
    a for a, c in all_configs().items() if not c.is_encoder))
def test_every_registered_decoder_serves_as_before(arch):
    cfg = all_configs()[arch].reduced()
    cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512))
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist()
               for _ in range(3)]
    want, want_rows = _old_engine_tokens(cfg, params, prompts, 4, 32)
    eng = Engine(cfg, params, max_len=32, max_batch=4, device="cpu")
    assert isinstance(eng.model, TransformerLM)
    assert eng.cfg is cfg and eng.params is params
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
    for r in reqs:
        r.logits = []
    eng.run_until_idle()
    assert [r.output for r in reqs] == want
    for i, r in enumerate(reqs):
        for got, rows in zip(r.logits, want_rows):
            assert np.array_equal(got, rows[i])
    assert eng.stats["decode_steps"] == 3


# ---------------------------------------------------------------------------
# On a card: the decode step replayed from CUDA graphs
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs replay only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 3, 16])
def test_replayed_decode_steps_give_the_eager_logits_bitwise(card, B):
    """Two batches of a 64-token prefill and 127 decode steps, each on a
    new cache: the graphed model's logits equal those of the same model
    kept eager (its capture a no-op) bit for bit, and each batch reads 1
    eager step, 1 capture and 126 replays, the second capturing afresh."""
    cfg = G.tiny()
    params = G.init_params(cfg, SEED, card, torch.bfloat16)
    graphed, eager = G.GraniteHybrid(cfg, params), \
        G.GraniteHybrid(cfg, params)
    eager._capture = lambda step: None
    gen = torch.Generator().manual_seed(B)
    for batch in (1, 2):
        toks = torch.randint(0, cfg.vocab_size, (B, 64 + 127),
                             generator=gen).to(card)
        rows = []
        for m in (graphed, eager):
            cache = m.init_cache(B, 64 + 128)
            logits, cache = m.prefill(toks[:, :64], cache)
            out = [logits]
            for j in range(64, 64 + 127):
                logits, cache = m.decode(toks[:, j:j + 1], cache)
                out.append(logits)
            rows.append(torch.stack(out, 1))
            assert m._step.states is cache.states
        assert torch.equal(rows[0], rows[1]), _err(rows[0], rows[1])
        assert [graphed.stats[k] for k in (
            "graph_captures", "decode_graph_steps", "decode_eager_steps")] \
            == [batch, 126 * batch, batch]
        assert graphed.stats["moe_calls"] == eager.stats["moe_calls"]
    assert eager.stats["graph_captures"] == 0
    assert eager.stats["decode_eager_steps"] == 2 * 127
    assert graphed.load_stats() == eager.load_stats()
    assert graphed.dropped() == 0
