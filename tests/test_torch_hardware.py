"""The port's hardware profiles (``repro_torch.core.hardware``) and its
planners on them.

The port's pod tiers are the H100's; the JAX package's are a TPU's.  The
cost model and the planners are verbatim copies, so on the reference's
TPU tiers, carried field by field into the port's dataclasses
(``port_hardware``), the port's ``smartsplit``, ``evaluate_objectives``
and ``smartsplit_multicut`` equal JAX's bitwise."""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import all_configs as jall  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core import multicut as jmulti  # noqa: E402
from repro.core.smartsplit import smartsplit as jsmartsplit  # noqa: E402
from repro.models.profiles import cnn_profile as jcnn_profile  # noqa: E402
from repro.models.profiles import \
    transformer_profile as jprofile  # noqa: E402
from repro_torch.analysis import energy  # noqa: E402
from repro_torch.configs import all_configs as tall  # noqa: E402
from repro_torch.core import costs as tcosts  # noqa: E402
from repro_torch.core import hardware as thw  # noqa: E402
from repro_torch.core import multicut as tmulti  # noqa: E402
from repro_torch.core.smartsplit import smartsplit as tsmartsplit  # noqa: E402
from repro_torch.models.profiles import \
    cnn_profile as tcnn_profile  # noqa: E402
from repro_torch.models.profiles import \
    transformer_profile as tprofile  # noqa: E402

ARCHS = sorted(jall())
REFERENCE_ENVS = ("TPU_EDGE_CLOUD", "TPU_TWO_POD")


def port_hardware(obj):
    """A ``repro.core.hardware`` dataclass (tier, link, two-tier or
    chain hardware) as the port's class of the same name, field by
    field."""
    if isinstance(obj, tuple):
        return tuple(port_hardware(o) for o in obj)
    if not dataclasses.is_dataclass(obj):
        return obj
    cls = getattr(thw, type(obj).__name__)
    return cls(**{f.name: port_hardware(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


def jax_hardware(obj):
    """The port's hardware dataclass as ``repro.core.hardware``'s class
    of the same name, field by field: the reverse of ``port_hardware``."""
    if isinstance(obj, tuple):
        return tuple(jax_hardware(o) for o in obj)
    if not dataclasses.is_dataclass(obj):
        return obj
    cls = getattr(jhw, type(obj).__name__)
    return cls(**{f.name: jax_hardware(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


def plan_fields(plan) -> tuple:
    """Everything a plan holds, comparable across the two packages."""
    return (plan.model, plan.num_layers, plan.cuts, plan.objectives,
            plan.pareto_cuts.tolist(), plan.pareto_F.tolist(),
            [dataclasses.asdict(link) for link in plan.links], plan.tiers,
            plan.microbatches, plan.wire_dtypes)


@pytest.mark.parametrize("env", REFERENCE_ENVS)
def test_port_hardware_carries_every_field(env):
    ref = getattr(jhw, env)
    got = port_hardware(ref)
    assert type(got) is thw.TwoTierHardware
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("env", ["H100_EDGE_CLOUD", "H100_TWO_POD"])
def test_jax_hardware_carries_every_field(env):
    ours = getattr(thw, env)
    got = jax_hardware(ours)
    assert type(got) is jhw.TwoTierHardware
    assert dataclasses.asdict(got) == dataclasses.asdict(ours)
    assert port_hardware(got) == ours


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("env", REFERENCE_ENVS)
def test_planner_on_reference_tiers_equals_jax(env, arch, mode):
    jenv = getattr(jhw, env)
    tenv = port_hardware(jenv)
    kw = dict(seq_len=64, batch=2, mode=mode, dtype_bytes=4)
    jp = jprofile(jall()[arch].reduced(), **kw)
    tp = tprofile(tall()[arch].reduced(), **kw)
    np.testing.assert_array_equal(tcosts.evaluate_objectives(tp, tenv),
                                  jcosts.evaluate_objectives(jp, jenv))
    assert plan_fields(tsmartsplit(tp, tenv)) == \
        plan_fields(jsmartsplit(jp, jenv))


def _reference_chain(K: int):
    """The chain ``tests/test_multicut.py`` builds."""
    tiers = tuple(jhw.tpu_pod_tier(f"tier{k}", chips=4 * (k + 1))
                  for k in range(K))
    return jmulti.ChainHardware(tiers=tiers,
                                links=tuple([jhw.DCN_LINK] * (K - 1)))


@pytest.mark.parametrize("model,K", [("alexnet", 3), ("vgg11", 4)])
def test_multicut_on_reference_tiers_equals_jax(model, K):
    jchain = _reference_chain(K)
    tchain = port_hardware(jchain)
    jp, tp = jcnn_profile(model), tcnn_profile(model)
    cands = np.array([(a, b) for a in range(1, 6) for b in range(a + 1, 7)]
                     if K == 3 else [(1, 3, 5), (2, 4, 6), (1, 2, 3)],
                     np.int64)
    np.testing.assert_array_equal(
        tmulti.evaluate_multicut(tp, tchain, cands),
        jmulti.evaluate_multicut(jp, jchain, cands))
    assert plan_fields(tmulti.smartsplit_multicut(tp, tchain)) == \
        plan_fields(jmulti.smartsplit_multicut(jp, jchain))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_h100_pod_tier_fields(dtype):
    t = thw.h100_pod_tier("pod", 16, dtype)
    assert (t.name, t.cores, t.speed_hz, t.chips) == ("pod", 16, 0.0, 16)
    assert t.memory_budget == 16 * 80e9
    assert t.peak_flops == 16 * {"fp32": 67e12, "bf16": 989e12}[dtype]
    assert t.hbm_bw == 16 * 3.35e12
    assert t.pj_per_flop == thw.H100_PJ_PER_FLOP[dtype]
    assert t.pj_per_hbm_byte == thw.H100_PJ_PER_HBM_BYTE
    assert (t.energy_k, t.is_roofline) == (0.0, True)
    assert thw.h100_pod_tier("pod", 16) == thw.h100_pod_tier("pod", 16,
                                                             "fp32")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_h100_environments(dtype):
    ec, tp = thw.h100_edge_cloud(dtype), thw.H100_TWO_POD
    assert (ec.client.chips, ec.server.chips) == (16, 256)
    assert (tp.client.chips, tp.server.chips) == (256, 256)
    for env in (ec, tp):
        assert env.link == thw.IB_NDR_LINK
        assert env.link.bandwidth == 50e9          # 400 Gb/s
    assert {ec.client.pj_per_flop, ec.server.pj_per_flop} == \
        {thw.H100_PJ_PER_FLOP[dtype]}
    assert {tp.client.pj_per_flop, tp.server.pj_per_flop} == \
        {thw.H100_PJ_PER_FLOP["fp32"]}
    assert thw.H100_EDGE_CLOUD == thw.h100_edge_cloud("fp32")


def test_profiles_keys_and_no_tpu_names():
    assert sorted(thw.PROFILES) == ["h100-edge-cloud", "h100-two-pod",
                                    "paper-j6", "paper-note8"]
    assert thw.PROFILES["h100-edge-cloud"] is thw.H100_EDGE_CLOUD
    assert thw.PROFILES["h100-two-pod"] is thw.H100_TWO_POD
    for name in dir(thw):
        assert not name.startswith(("V5E", "TPU", "ICI", "DCN", "tpu")), name


def test_measured_constants_are_plausible():
    """The stated energy constants lie in the calibration's ranges (a
    unit slip fails here before it reaches the card)."""
    stated = {"idle_w": thw.H100_IDLE_W,
              "pj_per_flop_fp32": thw.H100_PJ_PER_FLOP["fp32"],
              "pj_per_flop_bf16": thw.H100_PJ_PER_FLOP["bf16"],
              "pj_per_hbm_byte": thw.H100_PJ_PER_HBM_BYTE}
    assert set(stated) == set(energy.PLAUSIBLE)
    for name, (lo, hi) in energy.PLAUSIBLE.items():
        assert lo <= stated[name] <= hi and math.isfinite(stated[name])
    assert thw.H100_PJ_PER_FLOP["fp32"] > thw.H100_PJ_PER_FLOP["bf16"]


def test_h100_plan_on_qwen_prefill_is_a_valid_split():
    """The planner runs on the H100 tier at phase 12's full-size profile:
    a cut inside the model and finite objectives."""
    cfg = tall()["qwen3-4b"]
    prof = tprofile(cfg, seq_len=128, batch=4, mode="prefill",
                    dtype_bytes=4)
    plan = tsmartsplit(prof, thw.H100_EDGE_CLOUD)
    assert 1 <= plan.split_index <= cfg.num_layers - 1
    assert all(math.isfinite(v) and v > 0 for v in plan.objectives[:2])
