"""Plain PyTorch versions of every CUDA kernel in this package.

These are the semantics contracts.  The kernel wrappers take them for
tensors that lie on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  On the card they must run with TF32 off
(``torch.backends.cudnn.allow_tf32 = False``), or the fp32 conv drops to
TF32 inside cuDNN.

The codec versions are bitwise equal to ``quantize_jnp`` /
``dequantize_jnp`` of the JAX package: the absmax, a true division by
127 (a tensor divisor, never a Python scalar: PyTorch's CUDA division by
a host scalar multiplies by its reciprocal), round-half-even, clip."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = (None, "relu", "relu6")


def activate(y: torch.Tensor, activation: str | None) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(y)
    if activation == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y


def conv2d_plain(x, w, *, stride: int = 1, pad: int = 0, bias=None,
                 activation: str | None = None, groups: int = 1,
                 pool_k: int = 0, pool_s: int = 0) -> torch.Tensor:
    """Conv(+bias)(+relu/relu6)(+VALID maxpool) in fp32, returned in the
    storage dtype of ``x``.  x: (N, Cin, H, W); w: (Cout, Cin/groups,
    K, K) OIHW; bias: (Cout,) fp32."""
    y = F.conv2d(x.float(), w.float(), stride=stride, padding=pad,
                 groups=groups)
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    y = activate(y, activation)
    if pool_k:
        y = F.max_pool2d(y, pool_k, pool_s or pool_k)
    return y.to(x.dtype)


def quantize_plain(x, axis: int | None = None):
    """Per-channel (``axis``) or per-tensor (None) symmetric int8.

    Returns ``(values int8 like x, scales fp32 (C,))``, C = 1 per-tensor."""
    x32 = x.float()
    if axis is None:
        absmax = x32.abs().amax().reshape(1)
        sb = absmax
    else:
        axis = axis % x.ndim
        red = tuple(a for a in range(x.ndim) if a != axis)
        absmax = x32.abs().amax(dim=red) if red else x32.abs()
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        sb = absmax.reshape(shape)
    scale = _scale_of(absmax)
    q = torch.clamp(torch.round(x32 / _scale_of(sb)), -127.0, 127.0)
    return q.to(torch.int8), scale


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    d = torch.full_like(absmax, 127.0)
    return torch.where(absmax > 0.0, absmax / d, torch.ones_like(absmax))


def dequantize_plain(values, scales, axis: int | None = None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Invert ``quantize_plain``: values * scale, cast to ``out_dtype``."""
    if axis is None:
        sb = scales.reshape(())
    else:
        axis = axis % values.ndim
        shape = [1] * values.ndim
        shape[axis] = values.shape[axis]
        sb = scales.reshape(shape)
    return (values.float() * sb).to(out_dtype)
