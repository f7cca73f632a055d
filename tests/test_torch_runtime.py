"""The port's planner, chain runtime and serving entry point against the
JAX package's, on the CPU.

* The planner (verbatim numpy copies) gives the same cuts, objectives
  and Pareto fronts, bitwise, for all five models at K=2 and K=3.
* ``ChainRuntime`` on the tiny CNN of ``tests/test_chain_runtime.py``:
  the event log, the virtual-clock times and ``stats()["hops"]`` equal
  the JAX runtime's exactly (the clock prices the profile, not the
  tensors), and the logits agree to 1e-3 (2e-2 of scale under the bf16
  storage policy) -- over K, M, wire formats, both storage policies,
  30% drops on three seeds at K=2 and K=3 (K=2 is the paper's two-tier
  split), and the tier-fault crash-window ladder.
* VGG16 at 224 px on the paper's two-tier chain with the int8 wire: the
  same cut and the same hop bytes as the JAX package's run.
* ``serve.main`` runs the synchronous ``--cnn`` path on the CPU."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.profiles import cnn_profile as jprofile  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.profiles import cnn_profile as tprofile  # noqa: E402

TINY = [tcnn.conv(8, 3, 1, 1), tcnn.relu(), tcnn.maxpool(2, 2),
        tcnn.conv(16, 3, 1, 1), tcnn.relu(), tcnn.avgpool(2),
        tcnn.linear(10)]
JTINY = [jcnn.conv(8, 3, 1, 1), jcnn.relu(), jcnn.maxpool(2, 2),
         jcnn.conv(16, 3, 1, 1), jcnn.relu(), jcnn.avgpool(2),
         jcnn.linear(10)]
TINY_SHAPE = (3, 16, 16)
LOGIT_TOL = {"fp32": 1e-3, "bf16": 2e-2}


@pytest.fixture(scope="module")
def tiny():
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), JTINY, TINY_SHAPE)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = tcnn.params_from_numpy(tree, device="cpu")
    x = np.asarray(np.random.default_rng(0).normal(size=(4,) + TINY_SHAPE),
                   np.float32)
    return jp, tp, x


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("model", sorted(jcnn.CNN_MODELS))
def test_planner_matches_jax(model, K):
    jplan = jcore.smartsplit_chain(jprofile(model), jcore.paper_chain(K))
    tplan = tcore.smartsplit_chain(tprofile(model), tcore.paper_chain(K))
    assert tplan.cuts == jplan.cuts
    assert tplan.tiers == jplan.tiers
    assert tplan.wire_dtypes == jplan.wire_dtypes
    np.testing.assert_array_equal(np.asarray(tplan.objectives),
                                  np.asarray(jplan.objectives))
    np.testing.assert_array_equal(tplan.pareto_cuts, jplan.pareto_cuts)
    np.testing.assert_array_equal(tplan.pareto_F, jplan.pareto_F)


def _events(log):
    return [(e.t, e.kind, e.detail) for e in log.events]


def _run_pair(tiny, K, M=1, wire=None, drop=0.0, seed=0, requests=1,
              tier_spec=None, merge_fallback=None, dtype="fp32",
              model="tiny", in_shape=TINY_SHAPE):
    """The same request stream through the JAX and the port runtime,
    built from each package's own planner (on the profile of the
    storage policy ``dtype``), links and tier models.  ``tiny`` is
    (JAX params, port params, input batch) of ``model`` (its layers: the
    tiny net's, or a paper model's by name)."""
    jp, tp, x = tiny
    out = []
    paper = model in jcnn.CNN_MODELS
    for pkg, rt_mod, core, prof, layers, params, xin in (
            ("jax", jrt, jcore, jprofile, JTINY, jp, x),
            ("torch", trt, tcore, tprofile, TINY, tp, torch.from_numpy(x))):
        if paper:
            layers = model
            profile = prof(model, batch=x.shape[0], dtype=dtype)
        else:
            profile = prof("tiny", in_shape=in_shape, layers=layers,
                           dtype=dtype)
        hw = core.paper_chain(K)
        plan = core.smartsplit_chain(profile, hw, microbatches=M, wire=wire)
        clock = rt_mod.VirtualClock()
        links = [rt_mod.FaultyLink(
            link.bandwidth, clock=clock, seed=seed + k,
            faults=rt_mod.FaultSpec(drop_rate=drop))
            for k, link in enumerate(hw.links)]
        tiers = None
        if tier_spec is not None:
            tiers = [rt_mod.FaultyTier(
                t.name, faults=rt_mod.TierFaultSpec(**tier_spec)
                if k == 1 else rt_mod.TierFaultSpec(),
                seed=seed + k, clock=clock) for k, t in enumerate(hw.tiers)]
        rt = rt_mod.ChainRuntime(layers, params, plan, profile, hw,
                                 links=links, wire=wire, microbatches=M,
                                 tier_faults=tiers, dtype=dtype,
                                 merge_fallback=merge_fallback)
        results = [rt.infer(xin) for _ in range(requests)]
        out.append((plan, rt, results))
    return out


def _assert_same_run(pair, dtype="fp32"):
    (jplan, jrt_, jres), (tplan, trt_, tres) = pair
    assert tplan.cuts == jplan.cuts
    assert _events(trt_.log) == _events(jrt_.log)
    js, ts = jrt_.stats(), trt_.stats()
    assert ts["hops"] == js["hops"]
    for key in ("requests", "recovered", "merges", "repicks", "failovers",
                "fallback_device", "active_cuts", "active_tiers", "tiers",
                "breakers", "events"):
        assert ts[key] == js[key], key
    for jr, tr in zip(jres, tres):
        assert tr.chain_elapsed_s == jr.chain_elapsed_s
        assert tr.microbatch_finish_s == jr.microbatch_finish_s
        assert (tr.cuts, tr.attempts, tr.wire_bytes, tr.goodput_bytes,
                tr.merged_hops, tr.degraded) == \
            (jr.cuts, jr.attempts, jr.wire_bytes, jr.goodput_bytes,
             jr.merged_hops, jr.degraded)
        want = np.asarray(jr.logits.astype(np.float32))
        assert tr.logits.dtype == (torch.bfloat16 if dtype == "bf16"
                                   else torch.float32)
        err = float(np.max(np.abs(tr.logits.float().numpy() - want)))
        assert err <= LOGIT_TOL[dtype] * max(1.0, float(np.max(np.abs(want))))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("wire", ["follow", "int8"])
@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("K", [2, 3])
def test_chain_runtime_matches_jax(tiny, K, M, wire, dtype):
    pair = _run_pair(tiny, K, M, wire=wire, requests=2, dtype=dtype)
    _assert_same_run(pair, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K", [2, 3])
def test_chain_runtime_drops_match_jax(tiny, K, seed, dtype):
    pair = _run_pair(tiny, K, 4, wire="int8", drop=0.3, seed=seed,
                     requests=3, dtype=dtype)
    assert pair[1][1].stats()["hops"][0]["link"]["dropped"] > 0
    _assert_same_run(pair, dtype)


def test_tier_fault_crash_window_ladder_matches_jax(tiny):
    """Merge disabled, the middle tier in a crash window: the breaker
    trips and the request fails over to the standby tier, in both
    packages, event for event."""
    pair = _run_pair(tiny, 3, 1, tier_spec=dict(crash_windows=((0.0, 1e9),)),
                     merge_fallback=False, requests=2)
    _assert_same_run(pair)
    rt = pair[1][1]
    assert rt.n_failovers == 1
    kinds = [e.kind for e in rt.log.events]
    assert trt.events.TIER_CRASH in kinds
    assert trt.events.TIER_FAILOVER in kinds


def _numpy_init(layers, shape, seed=0):
    """JAX ``init_cnn``'s tree (structure, shapes, dtypes from
    ``jax.eval_shape``) filled He-normal from numpy: a paper model's
    weights without JAX's draw and its compiles."""
    rng = np.random.default_rng(seed)
    spec = jax.eval_shape(lambda k: jcnn.init_cnn(k, layers, shape),
                          jax.random.PRNGKey(0))

    def fill(leaf):
        if len(leaf.shape) == 1:
            return np.zeros(leaf.shape, leaf.dtype)
        fan_in = leaf.shape[0] if len(leaf.shape) == 2 \
            else int(np.prod(leaf.shape[1:]))
        return (rng.standard_normal(leaf.shape, np.float32)
                * np.float32(np.sqrt(2.0 / fan_in))).astype(leaf.dtype)

    return jax.tree_util.tree_map(fill, spec)


def test_vgg16_int8_two_tier_cut_and_bytes_match_jax():
    """VGG16 at 224 px, batch 1, on the paper's two-tier chain with the
    int8 wire: both packages plan the cut after pool3 and ship the
    (256, 28, 28) boundary as the same int8 payload of 201,748 bytes
    (802,816 in fp32), in one frame of the transfer layer, event for
    event."""
    layers = jcnn.CNN_MODELS["vgg16"]
    tree = _numpy_init(layers, jcnn.INPUT_SHAPE)
    x = np.asarray(np.random.default_rng(0).normal(
        size=(1,) + jcnn.INPUT_SHAPE), np.float32)
    pair = _run_pair((tree, tcnn.params_from_numpy(tree, device="cpu"), x),
                     2, wire="int8", model="vgg16")
    _assert_same_run(pair)
    (jplan, _, _), (tplan, trt_, tres) = pair
    assert tplan.cuts == jplan.cuts == (17,)
    hop = trt_.stats()["hops"][0]
    sent = 201_748 + trt.transfer.HEADER_BYTES
    assert (hop["wire_dtype"], hop["raw_bytes"], hop["wire_bytes"]) == \
        ("int8", 802_816, sent)
    assert tres[0].wire_bytes == sent


def test_chain_split_equals_monolithic_bitwise(tiny):
    """Within the port, a clean follow-wire chain run is bit-identical to
    the monolithic run sliced into the same microbatches."""
    _, tp, x = tiny
    xt = torch.from_numpy(x)
    pair = _run_pair(tiny, 3, 4, wire="follow")
    res = pair[1][2][0]
    want = torch.cat([tcnn.apply_cnn(TINY, tp, xt[a:b])
                      for a, b in trt.microbatch_slices(4, 4)])
    assert torch.equal(res.logits, want)


def test_serve_main_on_cpu(capsys):
    tserve.main(["--cnn", "alexnet", "--device", "cpu", "--requests", "2",
                 "--batch", "1"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "on cpu" in out
    assert "conv2d_dense=0" in out          # the CPU runs the plain path
