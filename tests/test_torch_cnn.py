"""The port's CNN models against the JAX package, on the CPU.

JAX ``init_cnn`` parameters cross over through ``params_from_numpy``;
inputs are made from a seed with numpy.  The JAX side runs the XLA path
(``backend="xla"``).  Logits agree to 1e-3 (fp32) and 2e-2 of scale
(bf16); within the port, split and monolithic runs agree bitwise."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.cnn import (avgpool, conv, dropout,  # noqa: E402
                                    gap_linear, invres, linear, maxpool,
                                    relu, relu6)

# every layer kind: a conv->relu->maxpool(3,2) triple, invres with expand,
# stride 2 and a residual, invres without expand, a conv->relu6 pair, an
# adaptive avgpool with H % out_hw != 0, and gap_linear + linear heads
SYNTH = [conv(8, 3, 1, 1), relu(), maxpool(3, 2),
         invres(12, 2, 6), invres(12, 1, 6), invres(16, 1, 1),
         conv(16, 1, 1, 0), relu6(), avgpool(3), dropout(),
         gap_linear(12), relu(), linear(10)]
SYNTH_SHAPE = (3, 19, 19)

MODELS = {
    "synthetic": (SYNTH, SYNTH_SHAPE, 2),
    "mobilenetv2": (jcnn.CNN_MODELS["mobilenetv2"], (3, 32, 32), 2),
    "alexnet": (jcnn.CNN_MODELS["alexnet"], (3, 64, 64), 2),
    # VGG's classifier is full width at any resolution (the adaptive
    # avgpool to 7x7 feeds a (25088, 4096) linear); its features at the
    # smallest sizes its five pools take
    "vgg11": (jcnn.CNN_MODELS["vgg11"], (3, 32, 32), 2),
    "vgg16": (jcnn.CNN_MODELS["vgg16"], (3, 48, 48), 2),
}
FP32_TOL = 1e-3
BF16_TOL = 2e-2


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy_init(layers, shape, seed=0):
    """The JAX ``init_cnn`` parameter tree (structure, shapes, dtypes from
    ``jax.eval_shape``) filled He-normal from numpy, in a fraction of the
    time JAX's own draw and its compiles take on a CPU."""
    rng = np.random.default_rng(seed)
    spec = jax.eval_shape(
        lambda k: jcnn.init_cnn(k, layers, shape), jax.random.PRNGKey(0))

    def fill(leaf):
        if len(leaf.shape) == 1:
            return np.zeros(leaf.shape, leaf.dtype)
        fan_in = leaf.shape[0] if len(leaf.shape) == 2 \
            else int(np.prod(leaf.shape[1:]))
        return (rng.standard_normal(leaf.shape, np.float32)
                * np.float32(np.sqrt(2.0 / fan_in))).astype(leaf.dtype)

    return jax.tree_util.tree_map(fill, spec)


@pytest.fixture(scope="module")
def nets():
    """One init per model (JAX's own for the synthetic net, the numpy
    fill of its tree for the others), its numpy tree, the port's params,
    and a seeded input batch."""
    out = {}
    for name, (layers, shape, batch) in MODELS.items():
        if name == "synthetic":
            jp = jax.jit(lambda k: jcnn.init_cnn(k, layers, shape))(
                jax.random.PRNGKey(0))
            tree = _to_numpy(jp)
        else:
            tree = _numpy_init(layers, shape)
            jp = tree
        tp = tcnn.params_from_numpy(tree, device="cpu")
        rng = np.random.default_rng(0)
        x = rng.normal(size=(batch,) + shape).astype(np.float32)
        out[name] = (layers, shape, jp, tree, tp, x)
    return out


def _assert_close(got, want, tol):
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bridge_round_trips_bitwise(nets, name):
    _, _, _, tree, tp, _ = nets[name]
    flat_np = jax.tree_util.tree_leaves(tree)
    flat_t = jax.tree_util.tree_leaves(
        tp, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert len(flat_np) == len(flat_t) > 0
    for a, t in zip(flat_np, flat_t):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), a)
        assert t.numpy().dtype == a.dtype and t.shape == a.shape
    # the port's own init has the same structure, shapes and scheme
    layers, shape = MODELS[name][:2]
    own = tcnn.init_cnn(layers, shape, device="cpu")
    own_flat = jax.tree_util.tree_leaves(
        own, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert [tuple(t.shape) for t in own_flat] == \
        [a.shape for a in flat_np]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_apply_cnn_matches_jax(nets, name, dtype):
    layers, _, jp, _, tp, x = nets[name]
    want = jcnn.apply_cnn(layers, jp, x, backend="xla", dtype=dtype)
    want = np.asarray(want.astype(np.float32))
    got = tcnn.apply_cnn(layers, tp, torch.from_numpy(x), dtype=dtype)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16"
                         else torch.float32)
    assert tuple(got.shape) == want.shape
    _assert_close(got.float().numpy(), want,
                  BF16_TOL if dtype == "bf16" else FP32_TOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_split_sweep_synthetic(nets, dtype):
    """Every split of the synthetic net: follow-wire split == monolithic
    bitwise inside the port, and the int8 wire matches JAX's
    ``apply_split(wire="int8")``."""
    layers, _, jp, _, tp, x = nets["synthetic"]
    xt = torch.from_numpy(x)
    mono = tcnn.apply_cnn(layers, tp, xt, dtype=dtype)
    tol = BF16_TOL if dtype == "bf16" else FP32_TOL
    for l1 in range(len(layers) + 1):
        logits, boundary = tcnn.apply_split(layers, tp, xt, l1, dtype=dtype,
                                            wire="follow")
        assert torch.equal(logits, mono), f"split {l1} != monolithic"
        want_b = jcnn.apply_cnn(layers, jp, x, stop=l1, backend="xla",
                                dtype=dtype)
        _assert_close(boundary.float().numpy(),
                      np.asarray(want_b.astype(np.float32)), tol)
        if l1 == len(layers):
            continue
        got, _ = tcnn.apply_split(layers, tp, xt, l1, dtype=dtype,
                                  wire="int8")
        want, _ = jcnn.apply_split(layers, jp, x, l1, backend="xla",
                                   dtype=dtype, wire="int8")
        _assert_close(got.float().numpy(),
                      np.asarray(want.astype(np.float32)), tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vgg11_split_sweep_equals_monolithic(nets, dtype):
    """Every split of VGG11, a cut between each conv and its relu and
    between each relu and its pool among them: the follow-wire split
    equals the monolithic forward bitwise in the port (under bf16 the
    boundary is stored in bf16 either way, and rounding commutes with
    relu and max-pool)."""
    layers, _, _, _, tp, x = nets["vgg11"]
    xt = torch.from_numpy(x)
    mono = tcnn.apply_cnn(layers, tp, xt, dtype=dtype)
    for l1 in range(len(layers) + 1):
        logits, _ = tcnn.apply_split(layers, tp, xt, l1, dtype=dtype,
                                     wire="follow")
        assert torch.equal(logits, mono), f"split {l1} != monolithic"


def test_alexnet_split_one_boundary_is_pre_activation(nets):
    """Split 1 cuts between conv1 and relu1: the conv must not fuse its
    activation across the boundary, so the payload holds negatives."""
    layers, _, _, _, tp, x = nets["alexnet"]
    xt = torch.from_numpy(x)
    logits, boundary = tcnn.apply_split(layers, tp, xt, 1)
    assert float(boundary.min()) < 0.0
    assert torch.equal(logits, tcnn.apply_cnn(layers, tp, xt))


def test_fusion_walk_respects_split_bounds():
    steps = list(tcnn.fusion_walk(jcnn.CNN_MODELS["alexnet"], 0, 21))
    assert steps[0] == (0, 3, "relu", 3, 2)
    assert list(tcnn.fusion_walk(jcnn.CNN_MODELS["alexnet"], 0, 2)) == \
        [(0, 2, "relu", 0, 0)]
    assert list(tcnn.fusion_walk(jcnn.CNN_MODELS["alexnet"], 0, 1)) == \
        [(0, 1, None, 0, 0)]
    calls = tcnn.conv_launches(SYNTH, SYNTH_SHAPE, batch=3)
    # conv triple, 2 invres with expand (3 convs), 1 without (2), conv pair
    assert len(calls) == 1 + 3 + 3 + 2 + 1
    assert calls[0]["pool_k"] == 3 and calls[0]["x_shape"] == (3, 3, 19, 19)
    dw = [c for c in calls if c["groups"] > 1]
    assert len(dw) == 3 and dw[0]["stride"] == 2


def test_pure_python_parts_match_jax():
    for name, layers in jcnn.CNN_MODELS.items():
        tl = tcnn.CNN_MODELS[name]
        assert [dataclasses_tuple(a) for a in tl] == \
            [dataclasses_tuple(a) for a in layers]
        assert tcnn.shapes_through(tl) == jcnn.shapes_through(layers)
        assert tcnn.conv_pool_triples(tl) == jcnn.conv_pool_triples(layers)
        for layer, shape in zip(tl, [tcnn.INPUT_SHAPE]
                                + tcnn.shapes_through(tl)[:-1]):
            assert tcnn.layer_flops_params(layer, shape) == \
                jcnn.layer_flops_params(layer, shape)


def dataclasses_tuple(layer):
    import dataclasses
    return dataclasses.astuple(layer)
