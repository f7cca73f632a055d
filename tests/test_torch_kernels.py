"""The port's kernel module against the JAX package, on the CPU.

* ``conv2d_plain`` (and the ``conv2d`` wrapper, which takes it for CPU
  tensors) against ``repro.models.cnn._conv2d(backend="xla")`` over dense,
  grouped, depthwise and pointwise convs, fused activations and pools,
  with remainder rows and columns: fp32 to 1e-4, bf16 to 2e-2 of scale.
* The int8 codec against ``quantize_jnp`` / ``dequantize_jnp``, bitwise.
* The CUDA launch geometry (``plan_conv``): on every conv of the main
  path the tiles cover the output exactly and every shared-memory read
  stays inside the staged tile; a CPU walk of the same tiles with torch
  ops reproduces the conv.
* The wrappers raise on what the kernels do not take."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels.quant import dequantize_jnp, quantize_jnp  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels import quant as kquant  # noqa: E402
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
# int8 codec: bitwise against the jnp codec
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
    return {"feature": feat, "zero_channel": zero, "half_ties": ties,
            "per_tensor_2d": flat, "ndim5": wide,
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
    jq, js = quantize_jnp(jx, axis)
    tq, ts = kquant.quantize_boundary(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    pq, ps = quantize_plain(tx, axis)
    assert torch.equal(pq, tq) and torch.equal(ps, ts)
    for out in ("fp32", "bf16"):
        jo = jnp.bfloat16 if out == "bf16" else jnp.float32
        to = torch.bfloat16 if out == "bf16" else torch.float32
        jd = dequantize_jnp(jq, js, axis, out_dtype=jo)
        td = kquant.dequantize_boundary(tq, ts, out_dtype=to)
        assert td.dtype == to
        np.testing.assert_array_equal(_f32(td),
                                      np.asarray(jd.astype(jnp.float32)))
        assert torch.equal(dequantize_plain(tq, ts, axis, to), td)
    # and the round trip the wire performs
    rt = kquant.boundary_roundtrip(tx, "int8")
    assert rt.dtype == tdt
    np.testing.assert_array_equal(
        _f32(rt), np.asarray(dequantize_jnp(jq, js, axis, out_dtype=jdt)
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


def _check_geometry(g):
    assert g.Po >= 1 and g.Pw >= 1
    if g.depthwise:
        assert g.grid[0] * g.threads >= g.N * g.Cout * g.Po * g.Pw
        assert g.K <= kconv.DW_MAX_K
        return
    ps = g.pool_s if g.pool_k else 1
    pk = g.pool_k or 1
    # tiles cover the output exactly: no tile starts past the end, and
    # together they reach it
    assert (g.tiles_h - 1) * g.tile_oh < g.Po <= g.tiles_h * g.tile_oh
    assert (g.tiles_w - 1) * g.tile_ow < g.Pw <= g.tiles_w * g.tile_ow
    # the conv tile feeds exactly the output tile, pooled windows included
    assert g.conv_th == (g.tile_oh - 1) * ps + pk
    assert g.conv_tw == (g.tile_ow - 1) * ps + pk
    assert (g.cot, g.pt) in kconv.BLOCKINGS
    npix = g.conv_th * g.conv_tw
    assert npix <= g.max_pix and g.conv_tw <= kconv.MAX_TILE_W
    # every thread's shared-memory reads stay inside the staged tile
    assert (g.conv_th - 1) * g.stride + g.K <= g.in_th
    assert (g.conv_tw - 1) * g.stride + g.K <= g.in_tw
    staged = kconv.staged_bytes(g.ci_chunk, g.in_th * g.in_tw, g.co_blk,
                                g.K)
    assert staged >= 4 * g.ci_chunk * (g.in_th * g.in_tw
                                       + g.co_blk * g.K ** 2)
    assert staged <= g.smem <= kconv.SMEM_MAX
    if g.pool_k:
        assert 4 * g.co_blk * npix <= g.smem
        # a valid pooled output reads only valid conv outputs
        assert (g.Po - 1) * ps + pk <= g.Ho and (g.Pw - 1) * ps + pk <= g.Wo
    assert 1 <= g.ci_chunk <= g.cin_pg
    assert g.co_blocks * g.co_blk >= g.cout_pg
    assert g.grid[1] <= kconv.GRID_YZ_MAX and g.grid[2] <= kconv.GRID_YZ_MAX
    assert len(g.params()) == len(kconv._PARAM_FIELDS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geometry_of_every_main_path_conv(dtype):
    assert len(MAIN_PATH) > 40
    kinds = {bool(_geometry(c).depthwise) for c in MAIN_PATH}
    assert kinds == {True, False}
    for call in MAIN_PATH:
        _check_geometry(_geometry(call, dtype))


def _emulate_tiles(x, w, bias, g, activation):
    """Walk the dense kernel's CTAs with torch ops: stage each haloed,
    zero-masked input tile, conv it, apply bias/act/pool, and write the
    valid part of the output tile.  Every output element must be written
    exactly once."""
    out = torch.full((g.N, g.Cout, g.Po, g.Pw), float("nan"))
    ps = g.pool_s if g.pool_k else 1
    for th in range(g.tiles_h):
        for tw in range(g.tiles_w):
            oh0, ow0 = th * g.tile_oh, tw * g.tile_ow
            ih0 = oh0 * ps * g.stride - g.pad
            iw0 = ow0 * ps * g.stride - g.pad
            tile = torch.zeros(g.N, g.Cin, g.in_th, g.in_tw)
            r0, r1 = max(ih0, 0), min(ih0 + g.in_th, g.H)
            c0, c1 = max(iw0, 0), min(iw0 + g.in_tw, g.W)
            if r1 > r0 and c1 > c0:
                tile[:, :, r0 - ih0:r1 - ih0, c0 - iw0:c1 - iw0] = \
                    x[:, :, r0:r1, c0:c1]
            y = F.conv2d(tile, w, stride=g.stride, groups=g.groups)
            assert tuple(y.shape[2:]) == (g.conv_th, g.conv_tw)
            y = activate(y + bias[None, :, None, None], activation)
            if g.pool_k:
                y = F.max_pool2d(y, g.pool_k, g.pool_s)
            assert tuple(y.shape[2:]) == (g.tile_oh, g.tile_ow)
            h, wd = min(g.tile_oh, g.Po - oh0), min(g.tile_ow, g.Pw - ow0)
            region = out[:, :, oh0:oh0 + h, ow0:ow0 + wd]
            assert torch.isnan(region).all(), "tiles overlap"
            out[:, :, oh0:oh0 + h, ow0:ow0 + wd] = y[:, :, :h, :wd]
    assert not torch.isnan(out).any(), "tiles leave a gap"
    return out


EMULATED = {
    "k11s4_pool32": (1, 3, 67, 83, 8, 11, 4, 2, 1, "relu", 3, 2),
    "k3_wide_rem": (1, 4, 19, 75, 6, 3, 1, 1, 1, "relu6", 0, 0),
    "k3_pool22_wide": (2, 3, 21, 70, 5, 3, 1, 1, 1, "relu", 2, 2),
    "k5_pool32": (1, 4, 27, 31, 4, 5, 1, 2, 1, "relu", 3, 2),
    "grouped_s2": (1, 6, 45, 77, 6, 3, 2, 1, 3, None, 0, 0),
}


@pytest.mark.parametrize("name", sorted(EMULATED))
def test_tile_walk_reproduces_the_conv(name):
    case = EMULATED[name]
    _, _, _, _, _, _, s, p, groups, act, pk, ps = case
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(case, seed=1))
    g = kconv.plan_conv(x.shape, w.shape, stride=s, pad=p, groups=groups,
                        activation=act, pool_k=pk, pool_s=ps)
    _check_geometry(g)
    assert g.tiles_h * g.tiles_w > 1           # really several tiles
    got = _emulate_tiles(x, w, b, g, act)
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
