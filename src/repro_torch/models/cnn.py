"""The paper's CNN models as splittable PyTorch networks.

The counterpart of ``repro.models.cnn``.  Layer granularity matches the
paper: one entry per *PyTorch module* (AlexNet 21, VGG11 29, VGG13 33,
VGG16 39, MobileNetV2 21).  Each layer knows how to infer its output
shape, init its parameters, apply itself, and report analytic
FLOPs/params for ``models/profiles.py``.

Tensors are NCHW; conv weights are OIHW and linear weights ``(fin,
fout)`` used as ``x @ w``, the JAX package's layouts, so its parameters
cross over through ``params_from_numpy`` unchanged.  Every conv runs
through ``kernels.conv2d``: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU -- the tensor's device picks, there
is no backend switch.  ``apply_split`` executes the network with an
explicit client/server handoff, returning the boundary payload."""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.dtype_policy import conv_dtype, policy_torch_dtype
from repro_torch.device import resolve_device
from repro_torch.kernels import conv2d as kconv
from repro_torch.spans import span


@dataclasses.dataclass(frozen=True)
class Layer:
    """One paper-granularity layer."""

    kind: str                    # conv/relu/relu6/maxpool/avgpool/dropout/
                                 # linear/invres
    name: str = ""
    # conv / linear / invres hyper-params (unused fields stay 0)
    cout: int = 0
    ksize: int = 0
    stride: int = 1
    pad: int = 0
    features: int = 0            # linear out features
    expand: int = 0              # invres expansion ratio
    out_hw: int = 0              # adaptive avgpool target


def conv(cout, k, s=1, p=0):
    return Layer(kind="conv", cout=cout, ksize=k, stride=s, pad=p)


def relu():
    return Layer(kind="relu")


def relu6():
    return Layer(kind="relu6")


def maxpool(k, s):
    return Layer(kind="maxpool", ksize=k, stride=s)


def avgpool(out_hw):
    return Layer(kind="avgpool", out_hw=out_hw)


def dropout():
    return Layer(kind="dropout")


def linear(features):
    return Layer(kind="linear", features=features)


def invres(cout, stride, expand):
    return Layer(kind="invres", cout=cout, stride=stride, expand=expand)


def gap_linear(features):
    """Global-average-pool + linear (MobileNetV2 classifier head: the pool
    is functional in torchvision's forward(), not a module, so it shares a
    paper-layer with the Linear)."""
    return Layer(kind="gap_linear", features=features)


# ---------------------------------------------------------------------------
# Shape / cost inference
# ---------------------------------------------------------------------------
def _conv_out(h, k, s, p):
    return (h + 2 * p - k) // s + 1


def _check_spatial(layer: Layer, in_shape: tuple, oh: int, ow: int) -> None:
    """Reject degenerate geometry with a layer-naming error instead of an
    opaque shape failure deep inside the conv or pool."""
    if oh < 1 or ow < 1:
        label = layer.name or layer.kind
        raise ValueError(
            f"layer {label!r} (ksize={layer.ksize}, stride={layer.stride}, "
            f"pad={layer.pad}) produces empty output {oh}x{ow} from input "
            f"(H, W)=({in_shape[1]}, {in_shape[2]}): input too small for "
            f"this kernel/stride")


def layer_out_shape(layer: Layer, in_shape: tuple) -> tuple:
    """in_shape: (C, H, W) or (F,) -- batch handled outside."""
    if layer.kind == "conv":
        c, h, w = in_shape
        oh = _conv_out(h, layer.ksize, layer.stride, layer.pad)
        ow = _conv_out(w, layer.ksize, layer.stride, layer.pad)
        _check_spatial(layer, in_shape, oh, ow)
        return (layer.cout, oh, ow)
    if layer.kind in ("relu", "relu6", "dropout"):
        return in_shape
    if layer.kind == "maxpool":
        c, h, w = in_shape
        oh = _conv_out(h, layer.ksize, layer.stride, 0)
        ow = _conv_out(w, layer.ksize, layer.stride, 0)
        _check_spatial(layer, in_shape, oh, ow)
        return (c, oh, ow)
    if layer.kind == "avgpool":
        c, h, w = in_shape
        if layer.out_hw < 1 or h < 1 or w < 1:
            raise ValueError(
                f"layer {layer.name or layer.kind!r}: adaptive avgpool "
                f"needs out_hw >= 1 and a non-empty input, got "
                f"out_hw={layer.out_hw}, (H, W)=({h}, {w})")
        return (c, layer.out_hw, layer.out_hw)
    if layer.kind in ("linear", "gap_linear"):
        return (layer.features,)
    if layer.kind == "invres":
        c, h, w = in_shape
        oh = -(-h // layer.stride)  # stride with SAME padding
        ow = -(-w // layer.stride)
        return (layer.cout, oh, ow)
    raise ValueError(layer.kind)


def layer_flops_params(layer: Layer, in_shape: tuple) -> tuple[float, float]:
    """(FLOPs, param count) for one inference at batch 1."""
    out = layer_out_shape(layer, in_shape)
    n_out = float(np.prod(out))
    if layer.kind == "conv":
        cin = in_shape[0]
        macs = layer.ksize**2 * cin * n_out
        params = layer.ksize**2 * cin * layer.cout + layer.cout
        return 2 * macs, params
    if layer.kind in ("relu", "relu6"):
        return n_out, 0.0
    if layer.kind == "dropout":
        return 0.0, 0.0
    if layer.kind == "maxpool":
        return layer.ksize**2 * n_out, 0.0
    if layer.kind == "avgpool":
        n_in = float(np.prod(in_shape))
        return n_in, 0.0
    if layer.kind == "linear":
        fin = float(np.prod(in_shape))
        return 2 * fin * layer.features, fin * layer.features + layer.features
    if layer.kind == "gap_linear":
        fin = float(in_shape[0])
        pool = float(np.prod(in_shape))
        return pool + 2 * fin * layer.features, \
            fin * layer.features + layer.features
    if layer.kind == "invres":
        cin, h, w = in_shape
        hidden = cin * layer.expand
        oh, ow = out[1], out[2]
        f = p = 0.0
        if layer.expand != 1:                       # expand 1x1
            f += 2 * cin * hidden * h * w
            p += cin * hidden + 2 * hidden          # conv + bn
            f += hidden * h * w                     # relu6
        f += 2 * 9 * hidden * oh * ow               # depthwise 3x3
        p += 9 * hidden + 2 * hidden
        f += hidden * oh * ow                       # relu6
        f += 2 * hidden * layer.cout * oh * ow      # project 1x1
        p += hidden * layer.cout + 2 * layer.cout
        if layer.stride == 1 and cin == layer.cout:
            f += layer.cout * oh * ow               # residual add
        return f, p
    raise ValueError(layer.kind)


# ---------------------------------------------------------------------------
# Parameter init + apply
# ---------------------------------------------------------------------------
def _init_conv(g: torch.Generator, cin: int, cout: int, k: int) -> dict:
    fan_in = cin * k * k
    w = torch.randn((cout, cin, k, k), generator=g) * math.sqrt(2 / fan_in)
    return {"w": w, "b": torch.zeros((cout,), dtype=torch.float32)}


def _init_linear(g: torch.Generator, fin: int, fout: int) -> dict:
    w = torch.randn((fin, fout), generator=g) * math.sqrt(2 / fin)
    return {"w": w, "b": torch.zeros((fout,), dtype=torch.float32)}


def init_layer(g: torch.Generator, layer: Layer, in_shape: tuple) -> Any:
    """He-normal weights and zero biases, as ``repro.models.cnn``."""
    if layer.kind == "conv":
        return _init_conv(g, in_shape[0], layer.cout, layer.ksize)
    if layer.kind == "linear":
        return _init_linear(g, int(np.prod(in_shape)), layer.features)
    if layer.kind == "gap_linear":
        return _init_linear(g, int(in_shape[0]), layer.features)
    if layer.kind == "invres":
        cin = in_shape[0]
        hidden = cin * layer.expand
        p = {}
        if layer.expand != 1:
            p["expand"] = _init_conv(g, cin, hidden, 1)
        p["dw"] = {"w": torch.randn((hidden, 1, 3, 3), generator=g)
                   * math.sqrt(2 / 9),
                   "b": torch.zeros((hidden,), dtype=torch.float32)}
        p["project"] = _init_conv(g, hidden, layer.cout, 1)
        return p
    return {}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaf(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """The weight bridge: a JAX parameter tree (``repro.models.cnn.
    init_cnn``'s list, ``repro.models.transformer.init_params``' dicts),
    its leaves passed through ``np.asarray``, as the port's parameters,
    bit for bit (bf16 included), in the same layouts, on ``device``."""
    dev = resolve_device(device)
    return _tree_map(lambda a: _leaf(a, dev), tree)


def _conv2d(x, w, b, stride, pad, groups=1, activation=None,
            pool_k=0, pool_s=0, dtype=None):
    """conv(+bias)(+act)(+maxpool) through the fused kernel.

    ``dtype`` is the storage policy: under bf16 the input and weights are
    stored in bfloat16 and the output comes back in bfloat16, while the
    kernel accumulates in fp32."""
    tdt = policy_torch_dtype(conv_dtype(dtype))
    if tdt != torch.float32 and x.dtype != tdt:
        x = x.to(tdt)
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    return kconv.conv2d(x, w, stride=stride, pad=pad, bias=b,
                        activation=activation, groups=groups,
                        pool_k=pool_k, pool_s=pool_s or pool_k)


def apply_layer(layer: Layer, params: Any, x: torch.Tensor,
                dtype: str | None = None) -> torch.Tensor:
    if layer.kind in ("conv", "maxpool", "avgpool"):
        layer_out_shape(layer, tuple(x.shape[1:]))   # fail with a named layer
    if layer.kind == "conv":
        return _conv2d(x, params["w"], params["b"], layer.stride, layer.pad,
                       dtype=dtype)
    if layer.kind == "relu":
        return torch.relu(x)
    if layer.kind == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if layer.kind == "dropout":
        return x                      # inference: identity
    if layer.kind == "maxpool":
        return F.max_pool2d(x, layer.ksize, layer.stride)
    if layer.kind == "avgpool":
        # torchvision's AdaptiveAvgPool2d: output index i averages input
        # [floor(i*n/out), ceil((i+1)*n/out)) -- variable windows, every
        # input element covered when n % out != 0
        return F.adaptive_avg_pool2d(x, layer.out_hw)
    if layer.kind in ("linear", "gap_linear"):
        with span("model/linear"):
            if layer.kind == "linear" and x.ndim > 2:
                x = x.reshape(x.shape[0], -1)
            if layer.kind == "gap_linear" and x.ndim == 4:
                x = x.mean(dim=(2, 3))
            # weights and activations stored in the policy dtype, matmul
            # in fp32 (TF32 stays off: device.strict_fp32)
            tdt = policy_torch_dtype(conv_dtype(dtype))
            w = params["w"].to(tdt).float()
            y = torch.matmul(x.float(), w) + params["b"]
            return y.to(tdt)
    if layer.kind == "invres":
        y = x
        if "expand" in params:
            y = _conv2d(y, params["expand"]["w"], params["expand"]["b"], 1, 0,
                        activation="relu6", dtype=dtype)
        y = _conv2d(y, params["dw"]["w"], params["dw"]["b"], layer.stride, 1,
                    groups=y.shape[1], activation="relu6", dtype=dtype)
        y = _conv2d(y, params["project"]["w"], params["project"]["b"], 1, 0,
                    dtype=dtype)
        if layer.stride == 1 and x.shape == y.shape:
            y = y + x.to(y.dtype)
        return y
    raise ValueError(layer.kind)


# ---------------------------------------------------------------------------
# Model definitions (module lists match torchvision; counts match the paper)
# ---------------------------------------------------------------------------
def _vgg_features(cfg: list) -> list[Layer]:
    layers = []
    for v in cfg:
        if v == "M":
            layers.append(maxpool(2, 2))
        else:
            layers += [conv(v, 3, 1, 1), relu()]
    return layers


_CLASSIFIER_VGG = [linear(4096), relu(), dropout(),
                   linear(4096), relu(), dropout(), linear(1000)]

ALEXNET = [
    conv(64, 11, 4, 2), relu(), maxpool(3, 2),
    conv(192, 5, 1, 2), relu(), maxpool(3, 2),
    conv(384, 3, 1, 1), relu(),
    conv(256, 3, 1, 1), relu(),
    conv(256, 3, 1, 1), relu(), maxpool(3, 2),
    avgpool(6),
    dropout(), linear(4096), relu(),
    dropout(), linear(4096), relu(), linear(1000),
]                                                     # 21 layers

VGG11 = _vgg_features([64, "M", 128, "M", 256, 256, "M",
                       512, 512, "M", 512, 512, "M"]) \
    + [avgpool(7)] + _CLASSIFIER_VGG                  # 29 layers

VGG13 = _vgg_features([64, 64, "M", 128, 128, "M", 256, 256, "M",
                       512, 512, "M", 512, 512, "M"]) \
    + [avgpool(7)] + _CLASSIFIER_VGG                  # 33 layers

VGG16 = _vgg_features([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                       512, 512, 512, "M", 512, 512, 512, "M"]) \
    + [avgpool(7)] + _CLASSIFIER_VGG                  # 39 layers

_MBV2_SETTING = [  # (expand, cout, repeats, stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def _mobilenet_v2() -> list[Layer]:
    layers: list[Layer] = [conv(32, 3, 2, 1)]         # ConvBNReLU stem
    cin = 32
    for t, c, n, s in _MBV2_SETTING:
        for i in range(n):
            layers.append(invres(c, s if i == 0 else 1, t))
            cin = c
    layers.append(conv(1280, 1, 1, 0))                # last ConvBNReLU
    layers.append(dropout())
    layers.append(gap_linear(1000))
    return layers                                     # 21 layers


MOBILENET_V2 = _mobilenet_v2()

CNN_MODELS: dict[str, list[Layer]] = {
    "alexnet": ALEXNET,        # 21
    "vgg11": VGG11,            # 29
    "vgg13": VGG13,            # 33
    "vgg16": VGG16,            # 39
    "mobilenetv2": MOBILENET_V2,  # 21
}

INPUT_SHAPE = (3, 224, 224)


# ---------------------------------------------------------------------------
# Whole-network helpers
# ---------------------------------------------------------------------------
def shapes_through(layers: list[Layer],
                   in_shape: tuple = INPUT_SHAPE) -> list[tuple]:
    """Per-layer output shapes (len == len(layers))."""
    out = []
    shape = in_shape
    for l in layers:
        shape = layer_out_shape(l, shape)
        out.append(shape)
    return out


def conv_pool_triples(layers: list[Layer],
                      in_shape: tuple = INPUT_SHAPE) -> list[tuple]:
    """(layer_index, cin, hw, cout, ksize, stride, pad, act, pool_k, pool_s)
    for every conv->relu/relu6->maxpool triple ``apply_cnn`` fuses when
    wholly on one side of the split (the condition of ``fusion_walk``)."""
    shape = in_shape
    out = []
    for i, l in enumerate(layers):
        if (l.kind == "conv" and i + 2 < len(layers)
                and layers[i + 1].kind in ("relu", "relu6")
                and layers[i + 2].kind == "maxpool"):
            mp = layers[i + 2]
            out.append((i, shape[0], shape[1], l.cout, l.ksize, l.stride,
                        l.pad, layers[i + 1].kind, mp.ksize, mp.stride))
        shape = layer_out_shape(l, shape)
    return out



def fusion_walk(layers: list[Layer], start: int = 0, stop: int | None = None):
    """The steps of ``apply_cnn`` over layers [start, stop):
    ``(index, n_layers, activation, pool_k, pool_s)``.

    A conv immediately followed by relu/relu6 is one fused step (the
    activation runs in the kernel's epilogue); if a maxpool follows the
    activation, the whole conv->act->maxpool triple is one step with the
    pool on the fp32 accumulator.  Fusion happens only when every member
    lies inside [start, stop), so a split boundary is bit-identical to the
    unfused walk.  Every other layer is a step of its own (``n_layers``
    1, no activation)."""
    stop = len(layers) if stop is None else stop
    i = start
    while i < stop:
        layer = layers[i]
        if (layer.kind == "conv" and i + 1 < stop
                and layers[i + 1].kind in ("relu", "relu6")):
            act = layers[i + 1].kind
            if i + 2 < stop and layers[i + 2].kind == "maxpool":
                mp = layers[i + 2]
                yield i, 3, act, mp.ksize, mp.stride
                i += 3
            else:
                yield i, 2, act, 0, 0
                i += 2
            continue
        yield i, 1, None, 0, 0
        i += 1


def conv_launches(layers: list[Layer], in_shape: tuple = INPUT_SHAPE, *,
                  batch: int = 1, start: int = 0,
                  stop: int | None = None) -> list[dict]:
    """Every ``kernels.conv2d`` call ``apply_cnn`` makes over [start,
    stop) at ``batch``, in order: input and weight shapes, stride, pad,
    groups, activation and fused pool -- the shapes the main path hands
    the conv kernel (invres blocks give expand, depthwise and project)."""
    shapes = [in_shape] + shapes_through(layers, in_shape)
    out = []

    def call(i, cin, hw, cout, k, s, p, groups=1, act=None, pk=0, ps=0):
        out.append(dict(layer=i, x_shape=(batch, cin) + tuple(hw),
                        w_shape=(cout, cin // groups, k, k), stride=s,
                        pad=p, groups=groups, activation=act, pool_k=pk,
                        pool_s=ps))

    for i, _, act, pk, ps in fusion_walk(layers, start, stop):
        layer = layers[i]
        if layer.kind == "conv":
            c, *hw = shapes[i]
            call(i, c, hw, layer.cout, layer.ksize, layer.stride, layer.pad,
                 act=act, pk=pk, ps=ps)
        elif layer.kind == "invres":
            c, *hw = shapes[i]
            hidden = c * layer.expand
            if layer.expand != 1:
                call(i, c, hw, hidden, 1, 1, 0, act="relu6")
            call(i, hidden, hw, hidden, 3, layer.stride, 1, groups=hidden,
                 act="relu6")
            call(i, hidden, shapes[i + 1][1:], layer.cout, 1, 1, 0)
    return out


def init_cnn(layers: list[Layer], in_shape: tuple = INPUT_SHAPE, *,
             generator: torch.Generator | None = None,
             device: str | torch.device = "cuda"):
    """He-normal conv/linear weights and zero biases (the JAX package's
    scheme), drawn on the CPU from ``generator`` (default: seed 0) and
    moved to ``device`` -- so one seed gives the same weights on the CPU
    and on the card."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = []
    shape = in_shape
    for layer in layers:
        params.append(init_layer(generator, layer, shape))
        shape = layer_out_shape(layer, shape)
    return _tree_map(lambda t: t.to(dev), params)


def apply_cnn(layers: list[Layer], params, x: torch.Tensor, *,
              start: int = 0, stop: int | None = None,
              dtype: str | None = None) -> torch.Tensor:
    """Run layers [start, stop) -- the split runtime building block.

    Convs fuse with a following activation (and maxpool) as
    ``fusion_walk`` says; all layers are still *counted*, so split
    indices keep paper-layer semantics.  ``dtype`` is the storage policy
    (``conv_dtype``; env ``REPRO_CONV_DTYPE``): under ``bf16`` weights
    and activations are stored in bfloat16 (fp32 accumulate), including
    the split-boundary payload, from the input onwards."""
    stop = len(layers) if stop is None else stop
    if not 0 <= start <= stop <= len(layers):
        raise ValueError(
            f"apply_cnn: need 0 <= start <= stop <= {len(layers)} "
            f"(L), got start={start}, stop={stop}")
    dt = conv_dtype(dtype)
    if dt != "fp32":
        tdt = policy_torch_dtype(dt)
        x = x if x.dtype == tdt else x.to(tdt)
    for i, n, act, pool_k, pool_s in fusion_walk(layers, start, stop):
        layer = layers[i]
        if layer.kind not in ("conv", "invres"):
            x = apply_layer(layer, params[i], x, dtype=dt)
            continue
        # around the call into the conv kernel, never inside it: a
        # profiler credits each launch to the innermost range open
        with span("model/conv"):
            if n == 1:
                x = apply_layer(layer, params[i], x, dtype=dt)
                continue
            conv_out = layer_out_shape(layer, tuple(x.shape[1:]))
            if pool_k:
                layer_out_shape(layers[i + 2], conv_out)  # named geom check
            x = _conv2d(x, params[i]["w"], params[i]["b"], layer.stride,
                        layer.pad, activation=act, pool_k=pool_k,
                        pool_s=pool_s, dtype=dt)
    return x


def apply_split(layers: list[Layer], params, x: torch.Tensor,
                split_index: int, dtype: str | None = None,
                wire: str | None = None):
    """Client runs [0, l1), payload crosses the link, server runs [l1, L).

    Returns (logits, boundary_payload).  ``wire`` (``fp32``/``bf16``/
    ``int8``/``follow``; None resolves ``REPRO_WIRE_DTYPE``) applies the
    wire-format round-trip to the boundary the server stage consumes --
    ``kernels.quant.boundary_roundtrip``, the same math the runtime codec
    performs -- so this is the bit-exact fault-free reference for a
    quantized-wire runtime run.  The returned boundary is the client's
    (pre-encode) activation either way."""
    from repro_torch.core.dtype_policy import resolve_wire_dtype
    from repro_torch.kernels.quant import boundary_roundtrip
    if not 0 <= split_index <= len(layers):
        raise ValueError(
            f"apply_split: split_index must be in [0, {len(layers)}] "
            f"(L={len(layers)} layers), got {split_index}")
    boundary = apply_cnn(layers, params, x, start=0, stop=split_index,
                         dtype=dtype)
    w = resolve_wire_dtype(wire, storage=conv_dtype(dtype))
    received = boundary if w == conv_dtype(dtype) \
        else boundary_roundtrip(boundary, w)
    logits = apply_cnn(layers, params, received, start=split_index,
                       dtype=dtype)
    return logits, boundary
