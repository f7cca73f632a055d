"""The port's kernel module against the JAX package, on the CPU.

* ``conv2d_plain`` (and the ``conv2d`` wrapper, which takes it for CPU
  tensors) against ``repro.models.cnn._conv2d(backend="xla")`` over dense,
  grouped, depthwise and pointwise convs, fused activations and pools,
  with remainder rows and columns: fp32 to 1e-4, bf16 to 2e-2 of scale.
* The int8 codec against the JAX package's jitted ``quantize_boundary`` /
  ``dequantize_boundary`` (what its wire ships), bitwise; CPU walks of the
  codec kernels' plans (``plan_quantize``'s cluster slices and chunks,
  ``plan_dequantize``'s warp segments) cover every element once and
  reproduce the plain version bitwise.
* The CUDA launch geometry (``plan_conv``): on every conv of the main
  path the tiles cover the output exactly, every shared-memory read stays
  inside the staged tile, the stage ring fits in 227 KB, 16-byte copies
  are chosen only where aligned, and the K decomposition is the same at
  batch 1 and 4, fused and unfused; CPU walks of the dense kernel's CTAs
  (im2col by the kernel's own index formulas, k-steps and segments in
  order) and of the depthwise kernel's strips reproduce the conv.
* The wrappers raise on what the kernels do not take."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels.quant import dequantize_boundary as jdequantize  # noqa
from repro.kernels.quant import quantize_boundary as jquantize  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels import quant as kquant  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ref import (activate, conv2d_plain,  # noqa: E402
                                     dequantize_plain, quantize_plain)
from repro_torch.models import cnn as tcnn  # noqa: E402

FP32_TOL = 1e-4
BF16_TOL = 2e-2

# (N, Cin, H, W, Cout, K, stride, pad, groups, act, pool_k, pool_s)
CONV_CASES = {
    "k11s4_pool32": (2, 3, 31, 29, 8, 11, 4, 2, 1, "relu", 3, 2),
    "k5s1p2_pool32": (2, 6, 13, 11, 10, 5, 1, 2, 1, "relu", 3, 2),
    "k3_relu6": (1, 8, 9, 10, 12, 3, 1, 1, 1, "relu6", 0, 0),
    "pointwise": (2, 8, 7, 9, 16, 1, 1, 0, 1, None, 0, 0),
    "grouped": (2, 8, 10, 10, 12, 3, 1, 1, 2, "relu", 0, 0),
    "depthwise_s2": (2, 12, 11, 9, 12, 3, 2, 1, 12, "relu6", 0, 0),
    "depthwise_s1": (1, 16, 8, 8, 16, 3, 1, 1, 16, "relu6", 0, 0),
    "depthwise_pool32": (2, 8, 11, 10, 8, 3, 1, 1, 8, "relu6", 3, 2),
    "k3s2p0_pool22_rem": (1, 4, 13, 15, 6, 3, 2, 0, 1, None, 2, 2),
    "k3_pool22_rem": (2, 5, 17, 16, 7, 3, 1, 1, 1, "relu", 2, 2),
}


def _conv_inputs(case, seed=0):
    n, cin, h, w, cout, k, _, _, groups, _, _, _ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cin, h, w)).astype(np.float32)
    fan_in = cin // groups * k * k
    wt = (rng.normal(size=(cout, cin // groups, k, k))
          / np.sqrt(fan_in)).astype(np.float32)
    b = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    return x, wt, b


def _assert_close(got, want, tol):
    """Max-abs error within ``tol`` in units of the output scale."""
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv2d_plain_matches_jax_xla(name, dtype):
    case = CONV_CASES[name]
    _, _, _, _, _, _, s, p, groups, act, pk, ps = case
    x, w, b = _conv_inputs(case)
    want = jcnn._conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), s,
                        p, groups=groups, activation=act, pool_k=pk,
                        pool_s=ps, backend="xla", dtype=dtype)
    want = np.asarray(want.astype(jnp.float32))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    bt = torch.from_numpy(b)
    got = conv2d_plain(xt, wt, stride=s, pad=p, bias=bt, activation=act,
                       groups=groups, pool_k=pk, pool_s=ps)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = BF16_TOL if dtype == "bf16" else FP32_TOL
    _assert_close(_f32(got), want, tol)
    # the wrapper takes the plain version for CPU tensors, and the model
    # layer's _conv2d applies the same storage policy
    before = launches.snapshot()
    via = kconv.conv2d(xt, wt, stride=s, pad=p, bias=bt, activation=act,
                       groups=groups, pool_k=pk, pool_s=ps)
    layer = tcnn._conv2d(torch.from_numpy(x), torch.from_numpy(w), bt, s, p,
                         groups=groups, activation=act, pool_k=pk,
                         pool_s=ps, dtype=dtype)
    assert torch.equal(via, got) and torch.equal(layer, got)
    assert launches.snapshot() == before        # the CPU never counts


# ---------------------------------------------------------------------------
# int8 codec: bitwise against the jitted JAX codec
# ---------------------------------------------------------------------------
def _codec_cases():
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(2, 6, 5, 5)).astype(np.float32) * 3
    zero = feat.copy()
    zero[:, 2] = 0.0
    ties = np.zeros((1, 2, 2, 6), np.float32)
    ties[0, 0, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]   # scale exactly 1
    ties[0, 0, 1] = [-3.5, 4.5, 126.5, -126.5, 0.0, 1.0]
    ties[0, 1] = rng.normal(size=(2, 6))
    flat = rng.normal(size=(4, 33)).astype(np.float32)
    wide = rng.normal(size=(3, 4, 2, 3, 2)).astype(np.float32)
    # ROADMAP queue 3 fault 1's seed 2: channel 5's true quotient
    # absmax / 127 is one ulp off the jitted scale
    fault = (np.random.default_rng(2).normal(size=(2, 6, 5, 5))
             * 4).astype(np.float32)
    return {"feature": feat, "zero_channel": zero, "half_ties": ties,
            "per_tensor_2d": flat, "ndim5": wide, "fault1_seed2": fault,
            "all_zero": np.zeros((2, 3, 4), np.float32)}


CODEC = _codec_cases()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(CODEC))
def test_codec_bitwise_matches_jnp(name, dtype):
    x = CODEC[name]
    axis = kquant.default_channel_axis(x.ndim)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    # both frameworks round fp32 -> bf16 to nearest even: same input bits
    np.testing.assert_array_equal(np.asarray(jx.astype(jnp.float32)),
                                  _f32(tx))
    jq, js = jquantize(jx, axis, backend="xla")
    tq, ts = kquant.quantize_boundary(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    pq, ps = quantize_plain(tx, axis)
    assert torch.equal(pq, tq) and torch.equal(ps, ts)
    for out in ("fp32", "bf16"):
        jo = jnp.bfloat16 if out == "bf16" else jnp.float32
        to = torch.bfloat16 if out == "bf16" else torch.float32
        jd = jdequantize(jq, js, axis, out_dtype=jo, backend="xla")
        td = kquant.dequantize_boundary(tq, ts, out_dtype=to)
        assert td.dtype == to
        np.testing.assert_array_equal(_f32(td),
                                      np.asarray(jd.astype(jnp.float32)))
        assert torch.equal(dequantize_plain(tq, ts, axis, to), td)
    # and the round trip the wire performs
    rt = kquant.boundary_roundtrip(tx, "int8")
    assert rt.dtype == tdt
    np.testing.assert_array_equal(
        _f32(rt), np.asarray(jdequantize(jq, js, axis, out_dtype=jdt,
                                         backend="xla")
                             .astype(jnp.float32)))


def test_codec_half_ties_round_to_even():
    q, s = kquant.quantize_boundary(torch.from_numpy(CODEC["half_ties"]))
    assert float(s[0]) == 1.0
    assert q[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2]
    assert q[0, 0, 1].tolist() == [-4, 4, 126, -126, 0, 1]


def test_codec_zero_channel_scale_is_one():
    x = torch.from_numpy(CODEC["zero_channel"])
    q, s = kquant.quantize_boundary(x)
    assert float(s[2]) == 1.0 and not q[:, 2].any()
    back = kquant.dequantize_boundary(q, s)
    assert not back[:, 2].any()


# ---------------------------------------------------------------------------
# Codec launch geometry, checked on the CPU
# ---------------------------------------------------------------------------
# (B, C, S) views: one group (C = 1, a flatten; 1000 leaves a short last
# chunk), ragged rows (S 49, 36, 25, 7), batch 1 and 4, 16-aligned rows;
# and the transformer split's per-feature boundary (B*S, d, 1), each
# group's elements d apart, as the CPU tests' split ships it (tokens 4 x
# 16 at d 256, whole and in 2 microbatches)
WALK_SHAPES = [(1, 1, 16384), (1, 1, 1000), (4, 1, 49), (1, 160, 49),
               (4, 160, 49), (1, 256, 36), (4, 256, 36), (1, 32, 784),
               (4, 32, 784), (4, 64, 144), (2, 6, 25), (1, 3, 7),
               (64, 256, 1), (32, 256, 1)]
_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _codec_input(bcs, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=bcs).astype(np.float32) * 3
    if bcs[1] > 1:
        x[:, 0] = 0.0                          # an all-zero group
    return torch.from_numpy(x).to(_DT[dtype])


def _plan_at(bcs, dtype, k):
    """The quantize plan of a (B, C, S) view at cluster size k."""
    base = kquant.plan_quantize(*bcs, dtype)
    return kquant._quant_plan(base.B, base.C, base.S, dtype, base.vec, k)


def _group_index(plan, c):
    """Where each element j of group c lies in x, as the kernel finds it."""
    return torch.from_numpy(np.asarray(plan.index(c, np.arange(plan.n))))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("bcs", WALK_SHAPES, ids=str)
def test_quantize_plan_covers_every_element_once(bcs, k):
    """Every element is in exactly one chunk of one thread of one CTA of
    its group's cluster; every chunk is whole, starts vec-aligned and stays
    in one row; the plan fits the kernel and each thread holds at most
    ``held`` elements."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = _plan_at(bcs, dtype, k)
        assert plan.k == k and plan.grid == plan.C * k
        assert plan.slice % plan.vec == 0 and plan.slice * k >= plan.n
        assert plan.threads % 32 == 0 and plan.threads <= 512
        assert plan.resident
        seen = np.zeros(math.prod(bcs), np.int64)
        for c in range(plan.C):
            for r in range(k):
                lo, hi = plan.bounds(r)
                for t in range(plan.threads):
                    chunks = plan.chunks(r, t)
                    assert len(chunks) * plan.vec <= plan.held
                    for j, length in chunks:
                        assert lo <= j and j + length <= hi
                        assert (j - lo) % plan.vec == 0
                        assert length == plan.vec
                        at = plan.index(c, j)
                        assert plan.index(c, j + length - 1) == \
                            at + length - 1
                        assert at % plan.vec == 0
                        seen[at:at + length] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("bcs", WALK_SHAPES, ids=str)
def test_quantize_cluster_walk_reproduces_plain(bcs, k, dtype):
    """A torch emulation of the kernel: each CTA's partial absmax over its
    slice, the cluster's maximum of the k partials, the scale as one fp32
    multiply by fl32(1/127), each slice quantized with it -- bitwise
    ``quantize_plain``, for every cluster size."""
    x = _codec_input(bcs, dtype, seed=k)
    plan = _plan_at(bcs, x.dtype, k)
    flat = x.reshape(-1).float()
    q = torch.empty(flat.numel(), dtype=torch.int8)
    scales = torch.empty(plan.C)
    inv = torch.tensor(ref.INV127, dtype=torch.float32)
    for c in range(plan.C):
        idx = _group_index(plan, c)
        parts = [flat[idx[lo:hi]].abs().amax() if hi > lo
                 else torch.tensor(0.0)
                 for lo, hi in map(plan.bounds, range(k))]
        m = torch.stack(parts).amax()
        scale = m * inv if m > 0 else torch.tensor(1.0)
        scales[c] = scale
        for lo, hi in map(plan.bounds, range(k)):
            v = torch.round(flat[idx[lo:hi]] / scale).clamp(-127, 127)
            q[idx[lo:hi]] = v.to(torch.int8)
    pq, ps = quantize_plain(x, 1)
    assert torch.equal(q.reshape(bcs), pq) and torch.equal(scales, ps)


DEQUANT_SHAPES = WALK_SHAPES + [(4, 1280, 1), (2, 5, 3), (4, 128, 3136)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bcs", DEQUANT_SHAPES, ids=str)
def test_dequantize_plan_walk_reproduces_plain(bcs, dtype):
    """Every value is taken by exactly one chunk of one thread; the place
    in its row and the channel that the kernel steps to for each chunk are
    the chunk's own, and where a row ends inside a chunk the rest takes
    the next row's scale; writing q * scale so gives ``dequantize_plain``
    bitwise."""
    _dequantize_walk(bcs, dtype)


@pytest.mark.parametrize("bcs", DEQUANT_SHAPES[:-1], ids=str)
def test_dequantize_walk_steps_many_chunks_a_thread(bcs, monkeypatch):
    """The same with one block of threads, so each thread steps (s, c)
    through many chunks, across rows and channels."""
    kquant.plan_dequantize.cache_clear()     # plans of the real target
    monkeypatch.setattr(kquant, "DQ_TARGET_THREADS", kquant.DQ_THREADS)
    try:
        assert kquant.plan_dequantize(*bcs).blocks == 1
        _dequantize_walk(bcs, "fp32")
    finally:
        kquant.plan_dequantize.cache_clear()


def _dequantize_walk(bcs, dtype):
    x = _codec_input(bcs, "fp32")
    q, scales = quantize_plain(x, 1)
    plan = kquant.plan_dequantize(*bcs, _DT[dtype])
    assert plan.n % plan.vec == 0 and (plan.vec == 1 or plan.S >= 4)
    assert plan.blocks * kquant.DQ_THREADS <= max(
        kquant.DQ_TARGET_THREADS, kquant.DQ_THREADS)
    starts, chans = [], []
    for t in range(plan.blocks * kquant.DQ_THREADS):
        for p, s, c in plan.walk(t):
            row = p // plan.S
            assert (s, c) == (p - row * plan.S, row % plan.C)
            for e in range(plan.vec):
                starts.append(p + e)
                chans.append(c if s + e < plan.S else (c + 1) % plan.C)
    at = torch.tensor(starts)
    assert bool((torch.bincount(at, minlength=q.numel()) == 1).all())
    out = torch.empty(q.numel(), dtype=_DT[dtype])
    out[at] = (q.reshape(-1)[at].float()
               * scales[torch.tensor(chans)]).to(_DT[dtype])
    assert torch.equal(out.reshape(bcs),
                       dequantize_plain(q, scales, 1, _DT[dtype]))


def test_codec_plans_at_the_served_boundaries():
    """Quantize holds every served boundary in registers (x read once from
    HBM), with one CTA a group where the groups cover half the SMs, a
    cluster of more than one CTA for a flatten (C = 1) and (4, 32, 28,
    28), and each cluster size somewhere; a group too large to hold at k =
    8 is read twice; dequantize takes 4 values a thread at a time."""
    want = {(4, 128, 3136): 1, (4, 256, 784): 1, (4, 512, 49): 1,
            (4, 32, 784): 2, (4, 160, 49): 1, (4, 256, 36): 1,
            (1, 32, 784): 1, (1, 160, 49): 1, (1, 256, 36): 1,
            (1, 1, 16384): 8, (1, 1, 36864): 8, (4, 32, 3136): 4}
    for dtype in (torch.float32, torch.bfloat16):
        for bcs, k in want.items():
            plan = kquant.plan_quantize(*bcs, dtype)
            assert plan.k == k and plan.resident, (bcs, dtype, plan)
            assert plan.vec == (16 if bcs[2] % 16 == 0 else
                                4 if bcs[2] % 4 == 0 else 1)
            d = kquant.plan_dequantize(*bcs, dtype)
            assert d.vec == (4 if bcs[2] >= 4 else 1)
        big = kquant.plan_quantize(1, 1, 2**21, dtype)
        assert big.k == 8 and not big.resident


def test_codec_plans_at_the_split_boundaries():
    """The Qwen3-4B split's boundary, (4 x 128, 2560, 1) whole and (128,
    2560, 1) a microbatch of 4: one CTA a group of B*S elements d apart,
    one element a chunk, held in registers; dequantize one value a
    thread at a time."""
    for dtype in (torch.float32, torch.bfloat16):
        for bcs in ((512, 2560, 1), (128, 2560, 1)):
            plan = kquant.plan_quantize(*bcs, dtype)
            assert (plan.k, plan.vec, plan.C, plan.S) == (1, 1, 2560, 1)
            assert plan.resident and plan.threads == max(32, bcs[0])
            assert plan.index(7, 3) == 3 * 2560 + 7
            d = kquant.plan_dequantize(*bcs, dtype)
            assert d.vec == 1 and d.n == bcs[0] * 2560


def test_codec_plans_narrow_their_copies_to_the_alignment():
    """A view whose address is not 16-byte aligned gets narrower copies,
    never a misaligned one."""
    assert kquant.plan_quantize(1, 8, 64, torch.float32, align=8).vec == 1
    assert kquant.plan_quantize(1, 8, 64, torch.bfloat16, align=8).vec == 4
    assert kquant.plan_quantize(1, 8, 64, torch.float32, align=16).vec == 16
    assert kquant.plan_dequantize(1, 8, 64, align=4).vec == 4
    assert kquant.plan_dequantize(1, 8, 64, align=2).vec == 1
    assert kquant.plan_dequantize(4, 1280, 1).vec == 1
    with pytest.raises(ValueError):
        kquant.plan_quantize(2**16, 2**8, 2**8)


@pytest.mark.parametrize("function", ["quantize_launch",
                                      "dequantize_launch"])
def test_codec_ctypes_signatures_match_the_cuda_entry_points(function):
    """The wrapper declares as many arguments as the C entry point takes
    (the source is read here; nothing is compiled)."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "quant.cu").read_text()
    decl = re.search(rf"\bint {function}\(([^)]*)\)", src)
    argtypes, _ = kquant._SIGNATURES[function]
    assert decl is not None and len(argtypes) == len(decl.group(1).split(","))


def test_codec_constants_are_the_kernels():
    """The planner's block sizes and window, and the scale's constant, are
    those of ``csrc/quant.cu``; the constant is fl32(1/127) and 127 times
    it rounds to 1.0 (a group of absmax 127 keeps scale 1)."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "quant.cu").read_text()
    for name in ("Q_MAX_THREADS", "DQ_THREADS"):
        got = re.search(rf"constexpr int {name} = (\d+);", src)
        assert int(got.group(1)) == getattr(kquant, name), name
    held = re.search(r"held_chunks\(int v\) \{\s*return v == 16 \? (\d+) "
                     r": v == 4 \? (\d+) : (\d+);", src)
    assert tuple(map(int, held.groups())) == tuple(
        kquant.HELD_CHUNKS[v] for v in (16, 4, 1))
    lit = re.search(r"constexpr float INV127 = (0x[0-9a-f.p+-]+)f;", src)
    assert float.fromhex(lit.group(1)) == ref.INV127 \
        == float(np.float32(1 / 127))
    assert np.float32(127) * np.float32(ref.INV127) == np.float32(1)


# ---------------------------------------------------------------------------
# CUDA launch geometry, checked on the CPU
# ---------------------------------------------------------------------------
def _main_path_launches():
    """Every conv call of AlexNet, VGG16 and MobileNetV2 at 224 px, as the
    fusion walk hands it to the kernel (fused triples, unfused convs at
    every split a plan can pick, invres expand/depthwise/project)."""
    calls = []
    for name in ("alexnet", "vgg16", "mobilenetv2"):
        layers = tcnn.CNN_MODELS[name]
        calls += tcnn.conv_launches(layers, batch=4)
        for cut in range(1, len(layers)):      # unfused ends of a split
            calls += tcnn.conv_launches(layers, batch=1, stop=cut)[-1:]
    uniq = {tuple(sorted((k, str(v)) for k, v in c.items()
                         if k != "layer")): c for c in calls}
    return list(uniq.values())


MAIN_PATH = _main_path_launches()


def _geometry(call, dtype=torch.float32):
    return kconv.plan_conv(call["x_shape"], call["w_shape"],
                           stride=call["stride"], pad=call["pad"],
                           groups=call["groups"],
                           activation=call["activation"],
                           pool_k=call["pool_k"], pool_s=call["pool_s"],
                           dtype=dtype)


E16 = {0: 4, 1: 8}                  # elements of a 16-byte copy


def _check_tiles(g):
    """Tiles cover the output exactly: none starts past the end, together
    they reach it, and the conv tile feeds exactly its output tile."""
    ps = g.pool_s if g.pool_k else 1
    pk = g.pool_k or 1
    assert g.Po >= 1 and g.Pw >= 1
    assert (g.tiles_h - 1) * g.tile_oh < g.Po <= g.tiles_h * g.tile_oh
    assert (g.tiles_w - 1) * g.tile_ow < g.Pw <= g.tiles_w * g.tile_ow
    assert g.conv_th == (g.tile_oh - 1) * ps + pk
    assert g.conv_tw == (g.tile_ow - 1) * ps + pk
    assert g.in_th == (g.conv_th - 1) * g.stride + g.K
    assert g.in_tw == (g.conv_tw - 1) * g.stride + g.K
    if g.pool_k:
        # a valid pooled output reads only valid conv outputs
        assert (g.Po - 1) * ps + pk <= g.Ho and (g.Pw - 1) * ps + pk <= g.Wo
    assert g.grid[1] <= kconv.GRID_YZ_MAX and g.grid[2] <= kconv.GRID_YZ_MAX
    assert len(g.params()) == len(kconv._PARAM_FIELDS)


def _check_dense(g):
    _check_tiles(g)
    es = kconv.ESIZE[g.dtype]
    npix = g.conv_th * g.conv_tw
    assert npix <= kconv.BM <= kconv.EPI_PITCH
    assert g.conv_tw <= kconv.MAX_TILE_W and g.bn in kconv.BNS
    assert g.co_blocks * g.bn >= g.cout_pg
    kd = kconv.k_decomposition(g.cin_pg, g.K, g.dtype)
    assert (g.ktot, g.bk, g.stages) == (kd.ktot, kd.bk, kd.stages)
    assert kd.bk % kd.kstep == 0 and kd.kpad % kd.kstep == 0
    assert kd.kpad - kd.ktot < kd.kstep <= kd.bk
    assert (kd.stages - 1) * kd.bk < kd.kpad <= kd.stages * kd.bk
    assert max(c1 - c0 for c0, c1 in map(kd.stage_channels,
                                         range(kd.stages))) == g.chmax
    # every shared-memory read stays inside the staged planes: the
    # farthest window row/col plus the farthest tap of the last plane
    assert g.in_plane <= g.pitch
    if g.vec_x == 2:                 # whole images, planes back to back
        assert g.pitch == g.in_plane == g.H * g.W
    else:
        assert (g.pitch * es) % 128 == 32
    far_pix = (g.conv_th - 1) * g.stride * g.in_tw \
        + (g.conv_tw - 1) * g.stride
    far_tap = (g.chmax - 1) * g.pitch + (g.K - 1) * g.in_tw + g.K - 1
    assert far_pix + far_tap < g.chmax * g.pitch
    assert g.chmax * g.pitch + 8 * kconv.THREADS < kconv.MAGIC_LIMIT
    # the slot: planes, B (big), B (small, fp32), tap table; the ring,
    # the pixel table and the epilogue tile fit in 227 KB
    assert g.off_b >= g.chmax * g.pitch * es and g.off_b % 128 == 0
    assert g.off_bs == g.off_b + g.bn * g.bk * es
    assert g.off_tab == g.off_bs + (g.bn * g.bk * 4 if g.dtype == 0 else 0)
    assert g.slot == g.off_tab + 4 * g.bk and g.slot % 128 == 0
    assert g.nstage in kconv.NSTAGES and g.off_px == g.nstage * g.slot
    assert g.off_toff >= g.off_px + 4 * g.in_plane
    assert g.smem >= g.off_toff + 4 * g.K ** 2
    kk = g.K * g.K
    assert (g.kq, g.kr, g.ci_last) == (g.bk // kk, g.bk % kk,
                                       (g.ktot - 1) // kk)
    assert g.smem >= 4 * g.bn * kconv.EPI_PITCH
    assert g.smem <= kconv.SMEM_MAX
    # the deepest ring within the per-CTA budget
    assert g.nstage <= max(g.stages + 1, min(kconv.NSTAGES))
    for n in kconv.NSTAGES:
        if g.nstage < n <= g.stages + 1:
            assert max(n * g.slot + g.off_toff - g.off_px + 4 * kk,
                       4 * g.bn * kconv.EPI_PITCH) > kconv.RING_BUDGET
    # 16-byte copies only where rows, planes and weights are aligned
    e = E16[g.dtype]
    if g.vec_x:
        assert g.K == 1 and g.stride == 1 and g.pad == 0
        assert g.conv_tw == g.W and g.in_tw == g.W
        assert g.vec_x in (1, 2, 3)
    if g.vec_x in (1, 3):
        n = e if g.vec_x == 1 else 8 // es     # elements of one copy
        assert (g.conv_th * g.W) % n == 0 and (g.H * g.W) % n == 0
        assert g.pitch % n == 0 and g.in_plane % n == 0
    if g.vec_x == 2:
        # every stage's run starts 16-byte aligned: whole images, a group's
        # and an image's channels a multiple of 16 bytes
        assert g.conv_th == g.H and not g.pool_k and g.tiles_h == 1
        assert (g.cin_pg * g.H * g.W) % e == 0 and (g.Cin * g.H * g.W) % e == 0
        kd = kconv.k_decomposition(g.cin_pg, g.K, g.dtype)
        for s in range(kd.stages):
            assert kd.stage_channels(s)[0] * g.in_plane % e == 0
    if g.vec_b:
        assert g.ktot % e == 0 and g.bk % e == 0 and g.off_b % 16 == 0


def _check_depthwise(g):
    _check_tiles(g)
    assert g.K <= kconv.DW_MAX_K and g.kt in (0, 3)
    assert g.kt == 0 or (g.K == 3 and g.stride in (1, 2))
    assert 1 <= g.cb <= g.Cout and g.co_blocks * g.cb >= g.Cout
    nstrip = -(-g.conv_tw // kconv.DW_VEC)
    win = (kconv.DW_VEC - 1) * g.stride + g.K
    # a strip's window (read as whole float4s) stays inside its row
    assert g.pitch_w % 4 == 0 and g.in_tw <= g.pitch_w
    assert (nstrip - 1) * kconv.DW_VEC * g.stride + -(-win // 4) * 4 \
        <= g.pitch_w
    assert g.off_w >= 4 * g.cb * g.in_th * g.pitch_w
    assert g.off_ct >= g.off_w + 4 * g.cb * g.K ** 2
    assert g.smem >= g.off_ct + (4 * g.cb * g.conv_th * g.conv_tw
                                 if g.pool_k else 0)
    assert g.smem <= kconv.DW_SMEM_MAX
    # the staging and strip loops divide by multiply-shift
    per_ch = g.conv_th * nstrip
    assert (g.magic, g.magic_w, g.magic_pc, g.magic_ns) == tuple(
        kconv.magic_div(d) for d in (g.in_plane, g.in_tw, per_ch, nstrip))
    assert g.cb * g.in_plane + 4 * kconv.DW_THREADS < kconv.MAGIC_LIMIT
    assert g.cb * per_ch < kconv.MAGIC_LIMIT


def _check_geometry(g):
    (_check_depthwise if g.depthwise else _check_dense)(g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geometry_of_every_main_path_conv(dtype):
    assert len(MAIN_PATH) > 40
    kinds = {bool(_geometry(c).depthwise) for c in MAIN_PATH}
    assert kinds == {True, False}
    for call in MAIN_PATH:
        _check_geometry(_geometry(call, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k_decomposition_depends_on_the_weights_alone(dtype):
    """k-steps, stage boundaries and split-K segments are the same at
    batch 1 and 4, fused and unfused, for every main-path conv."""
    for call in MAIN_PATH:
        base = _geometry(call, dtype)
        if base.depthwise:
            continue
        want = kconv.k_decomposition(base.cin_pg, base.K, base.dtype)
        assert want.segments == ((0, want.kpad),)
        for batch in (1, 4):
            for fused in (True, False):
                c = dict(call, x_shape=(batch,) + tuple(call["x_shape"][1:]))
                if not fused:
                    c.update(activation=None, pool_k=0, pool_s=0)
                g = _geometry(c, dtype)
                assert (g.ktot, g.bk, g.stages) == \
                    (want.ktot, want.bk, want.stages)
                got = kconv.k_decomposition(g.cin_pg, g.K, g.dtype)
                assert got == want
                assert got.kstep_bounds == want.kstep_bounds
                assert [got.stage_taps(s) for s in range(got.stages)] == \
                    [want.stage_taps(s) for s in range(want.stages)]


def _tap_walk(g):
    """csrc/conv2d.cu::TapWalk in Python: each stage's (c_lo, c_hi) and
    thread j's (channel, tap) stepped by (kq, kr), with no division."""
    kk = g.K * g.K
    c_lo, r_lo = 0, 0
    c_hi, r_hi = (g.bk - 1) // kk, (g.bk - 1) % kk
    cj = [j // kk for j in range(g.bk)]
    rj = [j % kk for j in range(g.bk)]

    def step(c, r):
        c, r = c + g.kq, r + g.kr
        return (c + 1, r - kk) if r >= kk else (c, r)
    for s in range(g.stages):
        yield c_lo, min(c_hi, g.ci_last) + 1, list(zip(cj, rj))
        c_lo, r_lo = step(c_lo, r_lo)
        c_hi, r_hi = step(c_hi, r_hi)
        cj, rj = map(list, zip(*(step(c, r) for c, r in zip(cj, rj))))


def test_tap_walk_matches_the_divisions():
    for call in MAIN_PATH + [dict(x_shape=(1, 7, 30, 30),
                                  w_shape=(8, 7, 11, 11), stride=4, pad=2,
                                  groups=1, activation=None, pool_k=0,
                                  pool_s=0)]:
        g = _geometry(call)
        if g.depthwise:
            continue
        kd = kconv.k_decomposition(g.cin_pg, g.K, g.dtype)
        kk = g.K * g.K
        for s, (c_lo, c_hi, taps) in enumerate(_tap_walk(g)):
            assert (c_lo, c_hi) == kd.stage_channels(s)
            k0 = s * g.bk
            assert taps == [((k0 + j) // kk, (k0 + j) % kk)
                            for j in range(g.bk)]


def test_param_fields_match_the_cuda_enum():
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "conv2d.cu").read_text()
    body = re.search(r"enum Param \{([^}]*)\}", src).group(1)
    names = [t.strip() for t in body.split(",") if t.strip()]
    assert names == [f"P_{f.upper()}" for f in kconv._PARAM_FIELDS] \
        + ["P_COUNT"]


def test_magic_division_is_exact_below_the_limit():
    i = np.arange(kconv.MAGIC_LIMIT, dtype=np.uint64)
    planes = {g.in_plane for g in map(_geometry, MAIN_PATH)} \
        | {1, 2, 3, 7, 49, 169, 1729, 4095, 65535}
    for d in sorted(planes):
        m = np.uint64(kconv.magic_div(d) % (1 << 32))
        q = i if d == 1 else (i * m) >> np.uint64(32)
        np.testing.assert_array_equal(q, i // np.uint64(d))
        for v in (0, d - 1, d, 3 * d + 1, kconv.MAGIC_LIMIT - 1):
            assert umulhi_div(v, d) == v // d


def umulhi_div(i, d):
    """The kernels' ``i / d``: ``__umulhi(i, magic_div(d))``."""
    m = kconv.magic_div(d) % (1 << 32)
    return i if d == 1 else (i * m) >> 32


def _b_off(n, k, bn, dtype_code):
    """csrc/conv2d.cu::b_off: byte offset of B element (n, k) in a slot."""
    es = kconv.ESIZE[dtype_code]
    e, kstep = 16 // es, kconv.KSTEP[dtype_code]
    return ((k // kstep) * bn * 32 + (n >> 3) * 256
            + ((k % kstep) // e) * 128 + (n & 7) * 16 + (k % e) * es)


@pytest.mark.parametrize("dtype_code", [0, 1])
@pytest.mark.parametrize("bn", kconv.BNS)
def test_b_layout_is_wgmma_no_swizzle_k_major(bn, dtype_code):
    """The weight slice fills its buffer exactly once, and element (n, k)
    sits where the descriptor (start of its k-step, LBO 128, SBO 256)
    and the 8-row x 16-byte core matrix put it."""
    es = kconv.ESIZE[dtype_code]
    e, kstep = 16 // es, kconv.KSTEP[dtype_code]
    offs = sorted(_b_off(n, k, bn, dtype_code)
                  for n in range(bn) for k in range(kconv.BK))
    assert offs == list(range(0, bn * kconv.BK * es, es))
    for n in range(bn):
        for k in range(kconv.BK):
            start = (k // kstep) * bn * kstep * es
            core = (n // 8) * 256 + ((k % kstep) // e) * 128
            assert _b_off(n, k, bn, dtype_code) == \
                start + core + (n % 8) * 16 + (k % e) * es


def _walk_dense(x, w, bias, g, activation):
    """Walk the dense kernel's CTAs with torch ops, by the kernel's own
    index formulas: the pixel table, each stage's planes (the magic
    division included) and tap table, the im2col gather of A through
    pix + tap, the k-steps in order, the segments summed in order, then
    bias, activation, pool and the tile's stores.  Every output element
    must be written exactly once and every read stay in the slot."""
    kd = kconv.k_decomposition(g.cin_pg, g.K, g.dtype)
    KK, ps = g.K * g.K, (g.pool_s if g.pool_k else 1)
    npix = g.conv_th * g.conv_tw
    out = torch.full((g.N, g.Cout, g.Po, g.Pw), float("nan"))
    m = torch.arange(kconv.BM)
    r, c = m // g.conv_tw, m % g.conv_tw
    pix = torch.where(m < npix, r * g.stride * g.in_tw + c * g.stride, 0)
    e = torch.arange(g.in_plane)
    for th in range(g.tiles_h):
        for tw in range(g.tiles_w):
            oh0, ow0 = th * g.tile_oh, tw * g.tile_ow
            ih = oh0 * ps * g.stride - g.pad + e // g.in_tw
            iw = ow0 * ps * g.stride - g.pad + e % g.in_tw
            inside = (ih >= 0) & (ih < g.H) & (iw >= 0) & (iw < g.W)
            pxtab = torch.where(inside, ih * g.W + iw, -1)
            for grp in range(g.groups):
                xg = x[:, grp * g.cin_pg:(grp + 1) * g.cin_pg].reshape(
                    g.N, g.cin_pg, -1)
                for cb in range(g.co_blocks):
                    co0 = cb * g.bn
                    rows = torch.arange(co0, co0 + g.bn)
                    total = torch.zeros(g.N, kconv.BM, g.bn)
                    for seg0, seg1 in kd.segments:
                        acc = torch.zeros(g.N, kconv.BM, g.bn)
                        walk = _tap_walk(g)
                        for s in range(kd.stages):
                            k0, k1 = kd.stage_taps(s)
                            c_lo, c_hi, taps = next(walk)
                            if not seg0 <= k0 < seg1:
                                continue
                            nch = c_hi - c_lo
                            assert nch <= g.chmax
                            slot = torch.zeros(g.N, g.chmax * g.pitch)
                            i = torch.arange(nch * g.in_plane)
                            cl = torch.tensor([umulhi_div(int(v),
                                                          g.in_plane)
                                               for v in i])
                            ee = i - cl * g.in_plane
                            go = pxtab[ee]
                            vals = xg[:, c_lo + cl, go.clamp(min=0)]
                            slot[:, cl * g.pitch + ee] = torch.where(
                                go >= 0, vals, 0.0)
                            k = torch.arange(k0, k0 + kconv.BK)
                            ci = torch.tensor([c for c, _ in taps])
                            rr = torch.tensor([r for _, r in taps])
                            toff = (rr // g.K) * g.in_tw + rr % g.K
                            tab = torch.where(
                                k < kd.ktot, (ci - c_lo) * g.pitch + toff, -1)
                            wrow = torch.zeros(g.bn, kconv.BK)
                            ok_r = rows < g.cout_pg
                            ok_k = k < kd.ktot
                            wflat = w[grp * g.cout_pg:(grp + 1) * g.cout_pg
                                      ].reshape(g.cout_pg, -1)
                            wrow[ok_r[:, None] & ok_k[None, :]] = wflat[
                                rows[ok_r]][:, k[ok_k]].reshape(-1)
                            for j in range((k1 - k0) // kd.kstep):
                                kl = torch.arange(j * kd.kstep,
                                                  (j + 1) * kd.kstep)
                                off = tab[kl]
                                idx = pix[:, None] + off.clamp(min=0)[None]
                                assert int(idx.max()) < g.chmax * g.pitch
                                a = torch.where(off[None] >= 0,
                                                slot[:, idx], 0.0)
                                acc = acc + a @ wrow[:, kl].T
                        total = total + acc
                    co = grp * g.cout_pg + rows.clamp(max=g.cout_pg - 1)
                    y = activate(total + bias[co][None, None], activation)
                    y = y[:, :npix].transpose(1, 2).reshape(
                        g.N, g.bn, g.conv_th, g.conv_tw)
                    if g.pool_k:
                        y = F.max_pool2d(y, g.pool_k, g.pool_s)
                    assert tuple(y.shape[2:]) == (g.tile_oh, g.tile_ow)
                    h = min(g.tile_oh, g.Po - oh0)
                    wd = min(g.tile_ow, g.Pw - ow0)
                    nco = min(g.bn, g.cout_pg - co0)
                    cs = slice(grp * g.cout_pg + co0,
                               grp * g.cout_pg + co0 + nco)
                    region = out[:, cs, oh0:oh0 + h, ow0:ow0 + wd]
                    assert torch.isnan(region).all(), "tiles overlap"
                    out[:, cs, oh0:oh0 + h, ow0:ow0 + wd] = \
                        y[:, :nco, :h, :wd]
    assert not torch.isnan(out).any(), "tiles leave a gap"
    return out


# (case, bn): bn=None lets the planner pick
EMULATED = {
    "k11s4_pool32": ((1, 3, 67, 83, 8, 11, 4, 2, 1, "relu", 3, 2), None),
    "k3_wide_rem": ((1, 4, 19, 75, 6, 3, 1, 1, 1, "relu6", 0, 0), None),
    "k3_pool22_wide": ((2, 3, 21, 70, 5, 3, 1, 1, 1, "relu", 2, 2), None),
    "k5_pool32": ((1, 4, 27, 31, 4, 5, 1, 2, 1, "relu", 3, 2), None),
    "grouped_s2": ((1, 6, 45, 77, 6, 3, 2, 1, 3, None, 0, 0), None),
    "k3_deep_bn16": ((2, 24, 9, 11, 40, 3, 1, 1, 1, "relu", 0, 0), 16),
    "pointwise_images": ((2, 72, 8, 8, 20, 1, 1, 0, 1, "relu6", 0, 0), 16),
    "pointwise_rows": ((2, 16, 12, 16, 8, 1, 1, 0, 1, None, 0, 0), None),
    "pointwise_rows_14": ((1, 24, 14, 14, 16, 1, 1, 0, 1, "relu", 0, 0),
                          None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(EMULATED))
def test_tile_walk_reproduces_the_conv(name, dtype):
    case, bn = EMULATED[name]
    _, _, _, _, _, _, s, p, groups, act, pk, ps = case
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(case, seed=1))
    g = _plan(case, bn, dtype)
    _check_geometry(g)
    assert g.tiles_h * g.tiles_w * g.co_blocks > 1  # really several CTAs
    got = _walk_dense(x, w, b, g, act)
    want = conv2d_plain(x, w, stride=s, pad=p, bias=b, activation=act,
                        groups=groups, pool_k=pk, pool_s=ps)
    _assert_close(got.numpy(), want.numpy(), FP32_TOL)


def _plan(case, bn=None, dtype=torch.float32):
    """``plan_conv`` of a case, the dense kernel's BN narrowed to ``bn``
    when given (the planner's only per-launch choice)."""
    n, cin, h, w, cout, k, s, p, groups, act, pk, ps = case
    saved = kconv.BNS
    kconv.plan_conv.cache_clear()
    try:
        if bn is not None:
            kconv.BNS = (bn,)
        return kconv.plan_conv((n, cin, h, w), (cout, cin // groups, k, k),
                               stride=s, pad=p, groups=groups,
                               activation=act, pool_k=pk, pool_s=ps,
                               dtype=dtype)
    finally:
        kconv.BNS = saved
        kconv.plan_conv.cache_clear()


def test_walked_plans_cover_the_16_byte_paths_and_several_stages():
    plans = {n: _plan(*EMULATED[n]) for n in EMULATED}
    assert plans["pointwise_images"].vec_x == 2
    assert plans["pointwise_rows"].vec_x == 1
    assert _plan(*EMULATED["pointwise_rows_14"], torch.bfloat16).vec_x == 3
    assert plans["pointwise_rows"].vec_b and plans["pointwise_images"].vec_b
    assert not plans["k11s4_pool32"].vec_b     # 363-tap rows: 4-byte copies
    assert plans["k3_deep_bn16"].stages > 1
    assert plans["k11s4_pool32"].stages > 1


def _walk_depthwise(x, w, bias, g, activation):
    """Walk the depthwise kernel's CTAs: stage each channel's haloed tile
    (zero outside the image) in rows of pitch_w, compute every strip of
    DW_VEC outputs from its window (fp32, kh then kw), then bias,
    activation and the pool from the conv tile."""
    KK, ps, V = g.K * g.K, (g.pool_s if g.pool_k else 1), kconv.DW_VEC
    nstrip = -(-g.conv_tw // V)
    out = torch.full((g.N, g.Cout, g.Po, g.Pw), float("nan"))
    for th in range(g.tiles_h):
        for tw in range(g.tiles_w):
            oh0, ow0 = th * g.tile_oh, tw * g.tile_ow
            ih0 = oh0 * ps * g.stride - g.pad
            iw0 = ow0 * ps * g.stride - g.pad
            for blk in range(g.co_blocks):
                c0 = blk * g.cb
                nc = min(g.cb, g.Cout - c0)
                xs = torch.zeros(g.N, nc, g.in_th, g.pitch_w)
                r0, r1 = max(ih0, 0), min(ih0 + g.in_th, g.H)
                q0, q1 = max(iw0, 0), min(iw0 + g.in_tw, g.W)
                if r1 > r0 and q1 > q0:
                    xs[:, :, r0 - ih0:r1 - ih0, q0 - iw0:q1 - iw0] = \
                        x[:, c0:c0 + nc, r0:r1, q0:q1]
                conv = torch.zeros(g.N, nc, g.conv_th, nstrip * V)
                cols = torch.arange(nstrip * V)       # strip sc, lane v
                for kh in range(g.K):
                    for kw in range(g.K):
                        rows = torch.arange(g.conv_th) * g.stride + kh
                        cidx = cols * g.stride + kw
                        assert int(cidx.max()) < g.pitch_w
                        win = xs[:, :, rows][:, :, :, cidx]
                        wk = w[c0:c0 + nc, 0, kh, kw]
                        conv = conv + wk[None, :, None, None] * win
                conv = conv[..., :g.conv_tw] \
                    + bias[c0:c0 + nc][None, :, None, None]
                y = activate(conv, activation)
                if g.pool_k:
                    y = F.max_pool2d(y, g.pool_k, g.pool_s)
                h, wd = min(g.tile_oh, g.Po - oh0), min(g.tile_ow,
                                                        g.Pw - ow0)
                region = out[:, c0:c0 + nc, oh0:oh0 + h, ow0:ow0 + wd]
                assert torch.isnan(region).all(), "tiles overlap"
                out[:, c0:c0 + nc, oh0:oh0 + h, ow0:ow0 + wd] = \
                    y[:, :, :h, :wd]
    assert not torch.isnan(out).any(), "tiles leave a gap"
    assert KK == g.K ** 2
    return out


DW_EMULATED = {
    "s1_wide": (2, 6, 19, 75, 6, 3, 1, 1, 6, "relu6", 0, 0),
    "s2": (1, 5, 37, 41, 5, 3, 2, 1, 5, "relu6", 0, 0),
    "pool32": (1, 4, 40, 45, 4, 3, 1, 1, 4, "relu", 3, 2),
    "k5_generic": (1, 3, 21, 70, 3, 5, 1, 2, 3, None, 0, 0),
    "k3s3_pool22": (2, 3, 50, 38, 3, 3, 3, 0, 3, "relu", 2, 2),
}


@pytest.mark.parametrize("name", sorted(DW_EMULATED))
def test_depthwise_tile_walk_reproduces_the_conv(name):
    case = DW_EMULATED[name]
    _, _, _, _, _, _, s, p, groups, act, pk, ps = case
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(case, seed=2))
    g = _plan(case)
    assert g.depthwise
    _check_geometry(g)
    assert g.tiles_h * g.tiles_w > 1 or g.co_blocks > 1
    got = _walk_depthwise(x, w, b, g, act)
    want = conv2d_plain(x, w, stride=s, pad=p, bias=b, activation=act,
                        groups=groups, pool_k=pk, pool_s=ps)
    _assert_close(got.numpy(), want.numpy(), FP32_TOL)


def test_geometry_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        kconv.plan_conv((1, 8, 9, 9), (8, 1, 9, 9), groups=8)  # dw K=9
    with pytest.raises(ValueError):
        kconv.plan_conv((1, 6, 9, 9), (8, 3, 3, 3), groups=4)
    with pytest.raises(ValueError):
        kconv.plan_conv((1, 3, 4, 4), (8, 3, 5, 5))            # empty out
    with pytest.raises(ValueError):
        kconv.plan_conv((1, 3, 9, 9), (8, 3, 3, 3), activation="gelu")


# ---------------------------------------------------------------------------
# Wrappers raise on inputs the kernels do not take
# ---------------------------------------------------------------------------
def test_conv_wrapper_rejects_bad_inputs():
    x = torch.zeros(1, 3, 8, 8)
    w = torch.zeros(4, 3, 3, 3)
    with pytest.raises(TypeError):
        kconv.conv2d(x.double(), w.double())
    with pytest.raises(TypeError):
        kconv.conv2d(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError):
        kconv.conv2d(x[0], w)
    with pytest.raises(ValueError):
        kconv.conv2d(x, w, bias=torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        kconv.conv2d(x, w, bias=torch.zeros(5))
    with pytest.raises(ValueError):
        kconv.conv2d(x.transpose(2, 3), w)
    with pytest.raises(ValueError):
        kconv.conv2d(torch.zeros(1, 3, 8, 8, device="meta"),
                     torch.zeros(4, 3, 3, 3, device="meta"))


def test_codec_wrappers_reject_bad_inputs():
    x = torch.ones(2, 3, 4, 4)
    with pytest.raises(TypeError):
        kquant.quantize_boundary(x.double())
    with pytest.raises(ValueError):
        kquant.quantize_boundary(x.transpose(2, 3))
    with pytest.raises(ValueError):
        kquant.quantize_boundary(torch.ones(2, 3, 4, 4, device="meta"))
    q, s = kquant.quantize_boundary(x)
    with pytest.raises(TypeError):
        kquant.dequantize_boundary(q.float(), s)
    with pytest.raises(ValueError):
        kquant.dequantize_boundary(q, s[:2])
    with pytest.raises(ValueError):
        kquant.dequantize_boundary(q.transpose(2, 3), s)
    with pytest.raises(TypeError):
        kquant.dequantize_boundary(q, s, out_dtype=torch.float16)
