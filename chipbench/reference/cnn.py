"""The paper's CNNs in plain PyTorch, split at the cuts with the int8
wire: the reference that decides ``correct``.

A configuration's ``arch`` gives the network (VGG's feature list and
classifier, or MobileNetV2's inverted-residual table); ``layers`` turns
it into the paper's layers, one per torchvision module (VGG16 39,
MobileNetV2 21), so a cut means the same layer here as in the served
system.  ``forward`` computes in fp32 with TF32 off and rounds every
layer's output to the storage type through ``store``: bf16 storage with
fp32 accumulation is ``store = to bf16 and back``, and a lower storage
type (the control) is another ``store``.  Batch norm is folded into each
conv's bias."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from chipbench.reference import codec

FP8_MAX = 448.0      # float8_e4m3fn's largest finite value


def layers(arch: dict) -> list[dict]:
    """The paper-granularity layers of ``arch``."""
    def conv(cout, k, s=1, p=0):
        return dict(kind="conv", cout=cout, k=k, stride=s, pad=p)

    if arch["family"] == "vgg":
        out = []
        for v in arch["features"]:
            out += [dict(kind="maxpool", k=2, stride=2)] if v == "M" \
                else [conv(v, 3, 1, 1), dict(kind="relu")]
        out.append(dict(kind="avgpool", out_hw=arch["avgpool"]))
        *hidden, classes = arch["classifier"]
        for f in hidden:
            out += [dict(kind="linear", features=f), dict(kind="relu"),
                    dict(kind="dropout")]
        out.append(dict(kind="linear", features=classes))
        return out
    if arch["family"] == "mobilenetv2":
        out = [conv(arch["stem"], 3, 2, 1)]
        for t, c, n, s in arch["blocks"]:
            for i in range(n):
                out.append(dict(kind="invres", cout=c,
                                stride=s if i == 0 else 1, expand=t))
        out += [conv(arch["last"], 1), dict(kind="dropout"),
                dict(kind="gap_linear", features=arch["classes"])]
        return out
    raise ValueError(f"no reference for family {arch['family']!r}")


def out_shape(layer: dict, shape: tuple) -> tuple:
    """A layer's output shape (no batch axis) from its input's."""
    kind = layer["kind"]
    if kind == "conv":
        c, h, w = shape
        k, s, p = layer["k"], layer["stride"], layer["pad"]
        return (layer["cout"], (h + 2 * p - k) // s + 1,
                (w + 2 * p - k) // s + 1)
    if kind == "maxpool":
        c, h, w = shape
        k, s = layer["k"], layer["stride"]
        return (c, (h - k) // s + 1, (w - k) // s + 1)
    if kind == "avgpool":
        return (shape[0], layer["out_hw"], layer["out_hw"])
    if kind in ("linear", "gap_linear"):
        return (layer["features"],)
    if kind == "invres":
        c, h, w = shape
        s = layer["stride"]
        return (layer["cout"], -(-h // s), -(-w // s))
    return shape


def shapes(net: list[dict], in_shape: tuple) -> list[tuple]:
    """Each layer's input shape, then the network's output shape."""
    out = [tuple(in_shape)]
    for layer in net:
        out.append(out_shape(layer, out[-1]))
    return out


def param_shapes(net: list[dict], in_shape: tuple) -> list[dict]:
    """Per layer, ``{leaf path: (weight shape, fan in)}``: conv weights
    OIHW, linear weights (in, out) used as ``x @ w``; each weight has a
    bias of its output width."""
    out = []
    for layer, shape in zip(net, shapes(net, in_shape)):
        kind, leaves = layer["kind"], {}
        if kind == "conv":
            cin, k = shape[0], layer["k"]
            leaves[""] = ((layer["cout"], cin, k, k), cin * k * k)
        elif kind == "linear":
            fin = math.prod(shape)
            leaves[""] = ((fin, layer["features"]), fin)
        elif kind == "gap_linear":
            leaves[""] = ((shape[0], layer["features"]), shape[0])
        elif kind == "invres":
            cin = shape[0]
            hidden = cin * layer["expand"]
            if layer["expand"] != 1:
                leaves["expand"] = ((hidden, cin, 1, 1), cin)
            leaves["dw"] = ((hidden, 1, 3, 3), 9)
            leaves["project"] = ((layer["cout"], hidden, 1, 1), hidden)
        out.append(leaves)
    return out


def store_as(dtype: torch.dtype):
    """Round fp32 values to ``dtype`` and back.  float8_e4m3fn has no
    infinity, so its values saturate at +-448 first."""
    if dtype == torch.float32:
        return lambda t: t
    if dtype == torch.float8_e4m3fn:
        return lambda t: t.clamp(-FP8_MAX, FP8_MAX).to(dtype).float()
    return lambda t: t.to(dtype).float()


@contextlib.contextmanager
def strict_fp32():
    """fp32 matmuls and convs in full fp32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _conv(x, p, stride, pad, store, groups=1):
    y = F.conv2d(x, store(p["w"].float()), stride=stride, padding=pad,
                 groups=groups)
    return y + p["b"].float()[None, :, None, None]


def apply_layer(layer: dict, p: dict, x: torch.Tensor, store) -> torch.Tensor:
    """One layer on fp32 storage values; the output rounded by ``store``."""
    kind = layer["kind"]
    if kind == "conv":
        return store(_conv(x, p, layer["stride"], layer["pad"], store))
    if kind == "relu":
        return torch.relu(x)
    if kind == "dropout":
        return x
    if kind == "maxpool":
        return F.max_pool2d(x, layer["k"], layer["stride"])
    if kind == "avgpool":
        return store(F.adaptive_avg_pool2d(x, layer["out_hw"]))
    if kind in ("linear", "gap_linear"):
        x = x.reshape(x.shape[0], -1) if kind == "linear" \
            else store(x.mean(dim=(2, 3)))
        return store(x @ store(p["w"].float()) + p["b"].float())
    if kind == "invres":
        y = x
        if "expand" in p:
            y = store(_conv(y, p["expand"], 1, 0, store).clamp(0.0, 6.0))
        y = store(_conv(y, p["dw"], layer["stride"], 1, store,
                        groups=y.shape[1]).clamp(0.0, 6.0))
        y = store(_conv(y, p["project"], 1, 0, store))
        if layer["stride"] == 1 and x.shape == y.shape:
            y = store(y + x)
        return y
    raise ValueError(kind)


def forward(net: list[dict], params: list[dict], x: torch.Tensor, *,
            cuts: tuple[int, ...], store) -> torch.Tensor:
    """Logits (fp32) of the images ``x`` (N, C, H, W): the stages between
    the cuts in turn, each boundary through the int8 codec."""
    with torch.no_grad(), strict_fp32():
        x = store(x.float())
        edges = [0, *cuts, len(net)]
        for s, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
            if s:
                x = codec.roundtrip(x, store)
            for i in range(a, b):
                x = apply_layer(net[i], params[i], x, store)
        return x
