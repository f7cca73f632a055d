"""The port's batched CNN split-serving engine
(``repro_torch.serving.cnn_engine``) on the CPU: the twelve tests of
``tests/test_cnn_engine.py`` on the port, and the same request streams
through the JAX package's engine and the port's.

* ``stats()`` equal key for key -- counts, virtual-clock times and
  latencies, hop bytes, link and tier counters, event counts -- for
  pipelined and sequential engines, clean, under 30% drops, and under the
  ``crash`` tier-fault profile (the clock prices the profile, not the
  tensors, so the schedules are exact).
* In pipelined mode every request's logits equal the port's own
  single-sample ``apply_cnn`` bitwise, and JAX's engine's logits to 1e-4
  of their scale (2e-2 under the bf16 storage policy).
* The serving bench's clean cell (alexnet 64x64, 3 tiers, 16 requests)
  comes out of the port as the JSON the JAX engine wrote."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.serving import cnn_engine as jeng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.profiles import cnn_profile  # noqa: E402
from repro_torch.runtime import (ChainRuntime, FaultSpec,  # noqa: E402
                                 RetryPolicy, events)
from repro_torch.serving.cnn_engine import (CnnRequest,  # noqa: E402
                                            CnnServingEngine,
                                            QueueFullError)

REPO = Path(__file__).resolve().parents[1]
TINY_LAYERS = [tcnn.conv(8, 3, 1, 1), tcnn.relu(), tcnn.maxpool(2, 2),
               tcnn.conv(16, 3, 1, 1), tcnn.relu(), tcnn.avgpool(2),
               tcnn.linear(10)]
JTINY = [jcnn.conv(8, 3, 1, 1), jcnn.relu(), jcnn.maxpool(2, 2),
         jcnn.conv(16, 3, 1, 1), jcnn.relu(), jcnn.avgpool(2),
         jcnn.linear(10)]
TINY_SHAPE = (3, 16, 16)
TINY_SHAPE_B = (3, 24, 24)
JAX_TOL = {"fp32": 1e-4, "bf16": 2e-2}
TEST_POLICY = dict(max_attempts=2, timeout_s=0.05, backoff_base_s=0.005)


@pytest.fixture(scope="module")
def tiny():
    """JAX's TINY_LAYERS weights, carried across to the port bit for bit,
    and 16 seeded samples."""
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), JTINY, TINY_SHAPE)
    tp = tcnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    rng = np.random.default_rng(0)
    xs = [np.asarray(rng.normal(size=TINY_SHAPE), np.float32)
          for _ in range(16)]
    return jp, tp, xs


def _engine(params, *, tiers=3, links=None, **kw):
    kw.setdefault("policy", RetryPolicy(**TEST_POLICY))
    return CnnServingEngine({"tiny": (TINY_LAYERS, params)},
                            hw=tcore.paper_chain(tiers), links=links,
                            device="cpu", **kw)


def _links(rt_mod, hw, seed=0, fault_hop=None, spec=None, every=None):
    clock = rt_mod.VirtualClock()
    return [rt_mod.FaultyLink(
        link.bandwidth, clock=clock, seed=seed + k,
        faults=every if every is not None
        else spec if k == fault_hop else rt_mod.FaultSpec())
        for k, link in enumerate(hw.links)]


def _ref(params, x1, dtype=None):
    """Single-sample single-device reference (split placement cannot
    change numerics, so this is the apply_split reference too)."""
    return tcnn.apply_cnn(TINY_LAYERS, params, torch.as_tensor(x1)[None],
                          dtype=dtype)[0]


# ---------------------------------------------------------------------------
# The twelve tests of tests/test_cnn_engine.py, on the port
# ---------------------------------------------------------------------------
def test_single_request_bitwise_equals_chain_runtime(tiny):
    """One submitted request == a direct two-tier ChainRuntime run,
    bitwise."""
    _, params, xs = tiny
    eng = _engine(params, tiers=2)
    req = eng.submit(xs[0])
    eng.run_until_idle()
    assert req.status == "served"

    prof = cnn_profile("tiny", in_shape=TINY_SHAPE, layers=TINY_LAYERS)
    hw = tcore.paper_chain(2)
    plan = tcore.smartsplit_chain(prof, hw)
    crt = ChainRuntime(TINY_LAYERS, params, plan, prof, hw)
    direct = crt.infer(torch.from_numpy(xs[0])[None])
    assert direct.cuts == req.result.cuts
    assert torch.equal(req.logits, direct.logits[0])
    assert torch.equal(req.logits, _ref(params, xs[0]))


def test_batched_requests_each_bit_identical(tiny):
    """Requests packed into one batch still match the single-sample
    reference bit for bit (one request = one microbatch = batch 1)."""
    _, params, xs = tiny
    eng = _engine(params, max_batch=4)
    reqs = [eng.submit(x, at=0.0) for x in xs[:4]]
    eng.run_until_idle()
    s = eng.stats()
    assert s["batches"] == 1 and s["avg_batch_size"] == 4.0
    for req, x in zip(reqs, xs):
        assert req.status == "served"
        assert torch.equal(req.logits, _ref(params, x))


def test_mixed_resolution_buckets(tiny):
    """Two resolutions bucket separately (own plans), one weight set;
    every request still matches its own single-sample reference."""
    _, params, _ = tiny
    rng = np.random.default_rng(1)
    eng = _engine(params, max_batch=4)
    reqs = []
    for i in range(8):
        shape = TINY_SHAPE if i % 2 else TINY_SHAPE_B
        reqs.append(eng.submit(
            np.asarray(rng.normal(size=shape), np.float32), at=0.0))
    eng.run_until_idle()
    s = eng.stats()
    assert len(s["buckets"]) == 2
    assert {tuple(b["in_shape"]) for b in s["buckets"]} \
        == {TINY_SHAPE, TINY_SHAPE_B}
    for req in reqs:
        assert req.status == "served"
        assert torch.equal(req.logits, _ref(params, req.x))


def test_queue_full_sheds_with_named_error(tiny):
    _, params, xs = tiny
    eng = _engine(params, max_queue=3)
    for x in xs[:3]:
        eng.submit(x, at=0.0)
    with pytest.raises(QueueFullError) as ei:
        eng.submit(xs[3], at=0.0)
    assert isinstance(ei.value.request, CnnRequest)
    assert ei.value.request.status == "shed"
    s = eng.stats()
    assert s["shed"] == 1 and s["submitted"] == 4
    assert s["events"].get(events.QUEUE_SHED) == 1
    eng.run_until_idle()
    assert eng.stats()["served"] == 3       # shed request never served


def test_deadline_expired_before_dispatch(tiny):
    """A queued request whose earliest start already misses its deadline
    is expired without burning compute."""
    _, params, xs = tiny
    eng = _engine(params, max_batch=1)
    first = eng.submit(xs[0], at=0.0)
    late = eng.submit(xs[1], at=0.0, deadline_s=1e-9)
    eng.run_until_idle()
    assert first.status == "served"
    assert late.status == "expired"
    assert late.logits is None              # never dispatched
    assert eng.stats()["deadline_expired"] == 1
    assert eng.stats()["events"].get(events.DEADLINE_EXPIRED) == 1


def test_deadline_expired_mid_flight_keeps_result(tiny):
    """A request that starts in time but finishes late is flagged
    expired -- and the (late) result is kept, not destroyed."""
    _, params, xs = tiny
    eng = _engine(params)
    req = eng.submit(xs[0], at=0.0, deadline_s=1e-9)
    eng.run_until_idle()
    assert req.status == "expired"
    assert req.logits is not None           # computed, just late
    assert req.latency_s > req.deadline_s
    assert torch.equal(req.logits, _ref(params, xs[0]))
    assert eng.stats()["served"] == 0


def test_repick_mid_stream_no_cross_batch_corruption(tiny):
    """Hop 1 is down for a window covering the first batch's transfer:
    the runtime re-picks a different cut while later batches sit queued,
    and every request still matches its single-sample reference."""
    _, params, xs = tiny
    hw = tcore.paper_chain(3)
    links = _links(trt, hw, fault_hop=1,
                   spec=FaultSpec(outages=((0.0, 0.012),)))
    eng = _engine(params, links=links, max_batch=2, merge_fallback=False,
                  policy=RetryPolicy(max_attempts=1, timeout_s=0.01,
                                     backoff_base_s=0.005))
    reqs = [eng.submit(x, at=0.0) for x in xs[:6]]
    eng.run_until_idle()
    s = eng.stats()
    assert s["repicks"] >= 1
    assert s["served"] == 6 and s["failed"] == 0
    assert s["events"].get(events.REPICK, 0) >= 1
    for req, x in zip(reqs, xs):
        assert torch.equal(req.logits, _ref(params, x))


def test_unrecoverable_batch_marked_failed_later_batches_survive(tiny):
    """A permanently dead hop with merges disabled fails every batch; the
    engine keeps statuses consistent -- nothing is silently wrong."""
    _, params, xs = tiny
    hw = tcore.paper_chain(3)
    links = _links(trt, hw, fault_hop=1,
                   spec=FaultSpec(outages=((0.0, 1e9),)))
    eng = _engine(params, links=links, max_batch=2, merge_fallback=False,
                  policy=RetryPolicy(max_attempts=1, timeout_s=0.01,
                                     backoff_base_s=0.005))
    reqs = [eng.submit(x, at=0.0) for x in xs[:4]]
    eng.run_until_idle()
    s = eng.stats()
    assert s["failed"] == 4 and s["served"] == 0
    assert all(r.status == "failed" for r in reqs)
    assert s["events"].get(events.UNRECOVERABLE, 0) >= 1


def _alexnet64():
    shape = (3, 64, 64)
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), jcnn.CNN_MODELS["alexnet"],
                       in_shape=shape)
    tp = tcnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return shape, jp, tp


def test_pipelined_beats_sequential_throughput():
    """Cross-request pipelining on the 3-tier clean chain: >= 1.3x
    requests/sec over the sequential whole-batch baseline, alexnet."""
    shape, _, params = _alexnet64()
    rng = np.random.default_rng(0)
    xs = [np.asarray(rng.normal(size=shape), np.float32) for _ in range(16)]

    def run(pipelined):
        eng = CnnServingEngine({"alexnet": params},
                               hw=tcore.paper_chain(3), max_batch=4,
                               pipelined=pipelined, device="cpu")
        for x in xs:
            eng.submit(x, at=0.0)
        eng.run_until_idle()
        return eng.stats()

    sp, sq = run(True), run(False)
    assert sp["served"] == sq["served"] == len(xs)
    assert sp["requests_per_s"] >= 1.3 * sq["requests_per_s"]
    assert sp["virtual_span_s"] < sq["virtual_span_s"]


def test_no_clairvoyant_batching(tiny):
    """A request that arrives after a batch's launch time rides the
    NEXT batch, even when the first had spare capacity."""
    _, params, xs = tiny
    eng = _engine(params, max_batch=4)
    eng.submit(xs[0], at=0.0)
    eng.submit(xs[1], at=1e9)               # far future
    assert eng.step()                       # dispatches only request 0
    assert eng.stats()["batches"] == 1
    assert eng.stats()["avg_batch_size"] == 1.0


def test_stats_hops_schema_matches_chain_runtime(tiny):
    _, params, xs = tiny
    eng = _engine(params)
    eng.submit(xs[0])
    eng.run_until_idle()
    s = eng.stats()
    rt = next(iter(eng._buckets.values())).rt
    chain_keys = set(rt.stats()["hops"][0])
    for hop in s["hops"]:
        assert chain_keys <= set(hop)
        assert "goodput_Bps" in hop
    assert {"submitted", "queued", "served", "shed", "deadline_expired",
            "failed", "latency_p50_s", "latency_p99_s",
            "requests_per_s", "buckets", "hops", "events"} <= set(s)


@pytest.mark.parametrize("bad", ["links", "tier_faults", "breakers"])
def test_engine_and_runtime_refuse_the_same_chain(tiny, bad):
    """A chain of 3 tiers handed 2 of something it needs 1 or 3 of: the
    engine refuses it as its bucket runtimes would, word for word (both
    check through one helper of the runtime module)."""
    _, params, _ = tiny
    hw = tcore.paper_chain(3)
    two = {"links": lambda: _links(trt, tcore.paper_chain(2)),
           "tier_faults": lambda: [trt.FaultyTier(t.name)
                                   for t in hw.tiers[:2]],
           "breakers": lambda: [trt.CircuitBreaker(t.name)
                                for t in hw.tiers[:2]]}[bad]
    prof = cnn_profile("tiny", in_shape=TINY_SHAPE, layers=TINY_LAYERS)
    plan = tcore.smartsplit_chain(prof, hw)
    with pytest.raises(ValueError) as by_runtime:
        ChainRuntime(TINY_LAYERS, params, plan, prof, hw, **{bad: two()})
    with pytest.raises(ValueError) as by_engine:
        CnnServingEngine({"tiny": (TINY_LAYERS, params)}, hw=hw,
                         device="cpu", **{bad: two()})
    assert str(by_engine.value) == str(by_runtime.value)
    assert "3 tiers need" in str(by_runtime.value)


def test_submit_validation(tiny):
    _, params, xs = tiny
    eng = _engine(params)
    with pytest.raises(ValueError):
        eng.submit(xs[0], "nope")
    with pytest.raises(ValueError):
        eng.submit(xs[0], deadline_s=0.0)
    with pytest.raises(ValueError):
        CnnServingEngine({"tiny": (TINY_LAYERS, params)}, max_batch=0,
                         device="cpu")
    with pytest.raises(ValueError):
        CnnServingEngine({"tiny": (TINY_LAYERS, params)}, max_queue=0,
                         device="cpu")


# ---------------------------------------------------------------------------
# The same stream through both packages' engines
# ---------------------------------------------------------------------------
def _stream_pair(tiny, *, pipelined, profile, wire=None, n=12,
                 dtype="fp32"):
    """The same arrivals, the same seeded links and tier models, through
    JAX's engine and the port's at the storage policy ``dtype``.  Returns
    ((engine, requests), ...)."""
    jp, tp, xs = tiny
    arrivals = [0.002 * (i // 3) for i in range(n)]
    out = []
    for pkg, core, rt_mod, eng_mod, serve, layers, params in (
            ("jax", jcore, jrt, jeng, jserve, JTINY, jp),
            ("torch", tcore, trt, None, tserve, TINY_LAYERS, tp)):
        hw = core.paper_chain(3)
        drop = rt_mod.FaultSpec(drop_rate=0.3) if profile == "drop30" \
            else None
        links = _links(rt_mod, hw, seed=5, every=drop)
        tiers = serve._tier_fault_models(
            "crash" if profile == "crash" else None, hw, links[0]._clock)
        kw = dict(hw=hw, max_batch=4, pipelined=pipelined, wire=wire,
                  dtype=dtype, links=links, tier_faults=tiers, jitter_seed=3,
                  policy=rt_mod.RetryPolicy(**TEST_POLICY))
        if pkg == "jax":
            eng = eng_mod.CnnServingEngine({"tiny": (layers, params)}, **kw)
        else:
            eng = CnnServingEngine({"tiny": (layers, params)},
                                   device="cpu", **kw)
        reqs = [eng.submit(x, at=a) for x, a in zip(xs[:n], arrivals)]
        eng.run_until_idle()
        out.append((eng, reqs))
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("profile", ["clean", "drop30", "crash"])
@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "sequential"])
def test_stream_stats_and_logits_match_jax(tiny, pipelined, profile, dtype):
    (je, jreqs), (te, treqs) = _stream_pair(tiny, pipelined=pipelined,
                                            profile=profile, dtype=dtype)
    js, ts = je.stats(), te.stats()
    assert set(ts) == set(js)
    for key in js:
        assert ts[key] == js[key], key
    if profile == "drop30":
        assert sum(h["link"]["dropped"] for h in ts["hops"]) > 0
    if profile == "crash":
        assert ts["failovers"] >= 1 or ts["failed"] > 0
    _, tp, _ = tiny
    served = 0
    for jr, tr in zip(jreqs, treqs):
        assert (tr.status, tr.start_s, tr.finish_s, tr.latency_s) == \
            (jr.status, jr.start_s, jr.finish_s, jr.latency_s)
        if tr.logits is None:
            assert jr.logits is None
            continue
        served += 1
        want = np.asarray(jr.logits.astype(np.float32))
        assert tr.logits.dtype == (torch.bfloat16 if dtype == "bf16"
                                   else torch.float32)
        scale = max(float(np.max(np.abs(want))), 1e-30)
        assert float(np.max(np.abs(tr.logits.float().numpy() - want))) \
            <= JAX_TOL[dtype] * scale
        if pipelined:
            assert torch.equal(tr.logits, _ref(tp, tr.x, dtype))
    assert served > 0


def test_int8_wire_stream_matches_jax(tiny):
    """The int8 wire on the stream: the same hop bytes (the port's payload
    is the JAX package's byte for byte) and the same schedule."""
    (je, _), (te, treqs) = _stream_pair(tiny, pipelined=True,
                                        profile="clean", wire="int8")
    js, ts = je.stats(), te.stats()
    assert ts == js
    assert {h["wire_dtype"] for h in ts["hops"]} == {"int8"}
    assert all(r.status == "served" for r in treqs)


def test_serving_bench_clean_cell_reproduced():
    """``benchmarks/serving_bench.py``'s smoke clean cell (alexnet 64x64,
    3 tiers, 16 seeded Poisson arrivals at the batch-4 service rate,
    pipelined and sequential) from the port's engine: the JAX engine's
    numbers, the >= 1.3x pipelining win among them."""
    want = json.loads((REPO / "benchmarks" / "out"
                       / "BENCH_serving_smoke.json").read_text())
    cell = next(c for c in want["cells"] if c["profile"] == "clean")
    shape, _, params = _alexnet64()
    policy = RetryPolicy(max_attempts=5, timeout_s=0.25,
                         backoff_base_s=0.01)
    hw = tcore.paper_chain(3)

    rate_eng = CnnServingEngine({"alexnet": params}, hw=hw, max_batch=4,
                                pipelined=True, policy=policy, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(4):
        rate_eng.submit(rng.normal(size=shape).astype(np.float32), at=0.0)
    rate_eng.run_until_idle()
    base = rate_eng.stats()["requests_per_s"]
    assert base == pytest.approx(want["base_service_rate_rps"], rel=1e-12)

    got = {}
    for mode, pipelined in (("pipelined", True), ("sequential", False)):
        eng = CnnServingEngine(
            {"alexnet": params}, hw=hw, max_batch=4, max_queue=64,
            pipelined=pipelined, links=_links(trt, hw, seed=0),
            policy=policy, jitter_seed=0, device="cpu")
        rng = np.random.default_rng(0)
        t, arrivals = 0.0, []
        for _ in range(cell["n_requests"]):
            t += rng.exponential(1.0 / base)
            arrivals.append(t)
        xs = [rng.normal(size=shape).astype(np.float32)
              for _ in range(cell["n_requests"])]
        for x, a in zip(xs, arrivals):
            eng.submit(x, at=a)
        eng.run_until_idle()
        s = eng.stats()
        ref = cell[mode]
        for key in ("served", "failed", "batches", "avg_batch_size",
                    "repicks", "merges", "queue_shed"):
            assert s[key] == ref[key], (mode, key)
        for key in ("requests_per_s", "latency_p50_s", "latency_p99_s"):
            assert s[key] == pytest.approx(ref[key], rel=1e-12), (mode, key)
        assert [h["goodput_Bps"] for h in s["hops"]] == \
            pytest.approx(ref["hop_goodput_Bps"], rel=1e-12)
        got[mode] = s["requests_per_s"]
    speedup = got["pipelined"] / got["sequential"]
    assert speedup == pytest.approx(cell["pipeline_speedup"], rel=1e-12)
    assert speedup >= 1.3


def test_engine_defaults_to_the_card(tiny):
    """Without a card the engine raises unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, params, _ = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CnnServingEngine({"tiny": (TINY_LAYERS, params)})
