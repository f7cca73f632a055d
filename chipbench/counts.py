"""Work and bytes from layer shapes, and the card's peaks: the yardstick
of the roofline and MFU metrics.

The counts come from the configuration's layers (``reference.cnn``),
never from the program, so a later kernel that computes a layer in
another way is held to the same work."""
from __future__ import annotations

import math

from chipbench.reference import cnn as ref

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
STORAGE_BYTES = {"bf16": 2, "fp32": 4}
BIAS_BYTES = 4


def conv_calls(net: list[dict], in_shape: tuple, *, cuts=(), batch: int = 1,
               storage: str = "bf16") -> list[dict]:
    """Every conv of one batch, in order, with its FLOPs (2 a multiply-add)
    and its bytes (input, weights, fp32 bias and output, each once).  A
    conv followed by its activation, and then by a max-pool, inside one
    stage writes the pooled output, as one fused call does."""
    esz = STORAGE_BYTES[storage]
    shp = ref.shapes(net, in_shape)
    stops = sorted({*cuts, len(net)})
    out = []

    def call(i, cin, hw, cout, k, stride, pad, groups=1, pool=None):
        ho = (hw[0] + 2 * pad - k) // stride + 1
        wo = (hw[1] + 2 * pad - k) // stride + 1
        flops = 2.0 * batch * k * k * (cin // groups) * cout * ho * wo
        if pool is not None:
            pk, ps = pool
            ho, wo = (ho - pk) // ps + 1, (wo - pk) // ps + 1
        nbytes = esz * batch * (cin * hw[0] * hw[1] + cout * ho * wo) \
            + esz * cout * (cin // groups) * k * k + BIAS_BYTES * cout
        out.append(dict(layer=i, flops=flops, bytes=float(nbytes),
                        groups=groups))

    for i, layer in enumerate(net):
        c, *hw = shp[i] if len(shp[i]) == 3 else (0, 0, 0)
        if layer["kind"] == "conv":
            stop = min(s for s in stops if s > i)
            pool = None
            if (i + 2 < stop and net[i + 1]["kind"] == "relu"
                    and net[i + 2]["kind"] == "maxpool"):
                pool = (net[i + 2]["k"], net[i + 2]["stride"])
            call(i, c, hw, layer["cout"], layer["k"], layer["stride"],
                 layer["pad"], pool=pool)
        elif layer["kind"] == "invres":
            hidden = c * layer["expand"]
            if layer["expand"] != 1:
                call(i, c, hw, hidden, 1, 1, 0)
            call(i, hidden, hw, hidden, 3, layer["stride"], 1, groups=hidden)
            call(i, hidden, shp[i + 1][1:], layer["cout"], 1, 1, 0)
    return out


def least_seconds(call: dict) -> float:
    """The least time one call could take on the card: the larger of its
    FLOPs at the bf16 peak and its bytes at the HBM peak."""
    return max(call["flops"] / PEAK_FLOPS, call["bytes"] / PEAK_BYTES)


def model_flops(net: list[dict], in_shape: tuple) -> float:
    """FLOPs of one image through the convs and linear layers."""
    total = sum(c["flops"] for c in conv_calls(net, in_shape))
    for layer, shape in zip(net, ref.shapes(net, in_shape)):
        if layer["kind"] == "linear":
            total += 2.0 * math.prod(shape) * layer["features"]
        elif layer["kind"] == "gap_linear":
            total += 2.0 * shape[0] * layer["features"]
    return total


def parameter_count(net: list[dict], in_shape: tuple) -> int:
    return sum(math.prod(shape) + shape[0 if len(shape) == 4 else 1]
               for leaves in ref.param_shapes(net, in_shape)
               for shape, _ in leaves.values())
