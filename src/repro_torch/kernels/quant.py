"""Per-channel symmetric int8 boundary quantization (wire-dtype tier).

The counterpart of ``repro.kernels.quant``, with the same contract:

    absmax_c = max(|x_c|)                    per channel c
    scale_c  = absmax_c / 127   (1.0 when the channel is all-zero)
    q        = clip(round(x / scale_c), -127, 127)  as int8
    dequant  = q * scale_c                   (error <= scale_c / 2)

Feature maps (ndim >= 3, (B, C, H, W)) quantize per channel axis 1; flat
tensors (ndim <= 2) per tensor, one scale (``default_channel_axis``).

On a CUDA tensor ``quantize_boundary`` / ``dequantize_boundary`` launch
the kernels of ``csrc/quant.cu``, which read the tensor in its own layout
as (B, C, S) -- B the axes before the channel axis, S those after it.  On
a CPU tensor they run ``ref.quantize_plain`` / ``ref.dequantize_plain``.
Kernel and plain version agree bitwise, and both agree bitwise with the
JAX package's ``quantize_jnp`` / ``dequantize_jnp``."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.dtype_policy import policy_torch_dtype
from repro_torch.kernels import _build, launches
from repro_torch.kernels.ref import dequantize_plain, quantize_plain

_V, _I, _LL = _build.VOIDP, _build.INT, ctypes.c_longlong
_SIGNATURES = {
    "quantize_launch": ([_V, _V, _V, _I, _I, _LL, _I, _V], ctypes.c_int),
    "dequantize_launch": ([_V, _V, _V, _I, _LL, _LL, _I, _V], ctypes.c_int),
}


def default_channel_axis(ndim: int) -> int | None:
    """Quantization-group axis: channels for feature maps, whole-tensor
    (None) for flat activations."""
    return 1 if ndim >= 3 else None


def _bcs(shape: tuple[int, ...], axis: int | None) -> tuple[int, int, int]:
    """The (B, C, S) view of ``shape`` around the scale-group axis."""
    if axis is None:
        return 1, 1, math.prod(shape)
    axis = axis % len(shape)
    return (math.prod(shape[:axis]), int(shape[axis]),
            math.prod(shape[axis + 1:]))


def _contiguous(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def quantize_boundary(x: torch.Tensor, axis: int | None = None):
    """Fused absmax + scale + round/clip quantize of a boundary activation.

    ``axis`` defaults to the channel convention for ``x.ndim``.  Returns
    ``(values int8 like x, scales fp32 (C,))``."""
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"quantize_boundary: x must be float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("quantize_boundary: empty tensor")
    _contiguous(x, "quantize_boundary")
    if axis is None:
        axis = default_channel_axis(x.ndim)
    if x.device.type == "cpu":
        return quantize_plain(x, axis)
    _cuda(x, "quantize_boundary")
    B, C, S = _bcs(tuple(x.shape), axis)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((C,), dtype=torch.float32, device=x.device)
    lib = _build.library("quant", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.quantize_launch(
            _build.ptr(x), _build.ptr(q), _build.ptr(scales), B, C, S,
            _build.DTYPE_CODE[x.dtype], _build.stream_of(x))
    _build.check(lib, rc, "quantize_boundary")
    launches.add("quantize")
    return q, scales


def dequantize_boundary(values: torch.Tensor, scales: torch.Tensor,
                        axis: int | None = None, *,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """Invert ``quantize_boundary`` (values must carry its dtype/shape)."""
    out_dtype = out_dtype or torch.float32
    if values.dtype != torch.int8:
        raise TypeError(f"dequantize_boundary: values must be int8, "
                        f"got {values.dtype}")
    if scales.dtype != torch.float32 or scales.device != values.device:
        raise TypeError("dequantize_boundary: scales must be float32 on "
                        "the values' device")
    if out_dtype not in _build.DTYPE_CODE:
        raise TypeError(f"dequantize_boundary: out_dtype must be float32 "
                        f"or bfloat16, got {out_dtype}")
    if axis is None:
        axis = default_channel_axis(values.ndim)
    B, C, S = _bcs(tuple(values.shape), axis)
    if scales.numel() != C:
        raise ValueError(f"dequantize_boundary: {scales.numel()} scales "
                         f"for {C} groups")
    _contiguous(values, "dequantize_boundary")
    _contiguous(scales, "dequantize_boundary")
    if values.device.type == "cpu":
        return dequantize_plain(values, scales, axis, out_dtype)
    _cuda(values, "dequantize_boundary")
    out = torch.empty(values.shape, dtype=out_dtype, device=values.device)
    total = values.numel()
    if total == 0:
        return out
    lib = _build.library("quant", _SIGNATURES)
    with torch.cuda.device(values.device):
        rc = lib.dequantize_launch(
            _build.ptr(values), _build.ptr(scales), _build.ptr(out), C, S,
            total, _build.DTYPE_CODE[out_dtype], _build.stream_of(values))
    _build.check(lib, rc, "dequantize_boundary")
    launches.add("dequantize")
    return out


def boundary_roundtrip(x: torch.Tensor, wire: str, *,
                       axis: int | None = None) -> torch.Tensor:
    """What the receiver decodes when ``x`` ships under wire format
    ``wire``: quantize->dequantize for int8, downcast->upcast for a float
    wire format, back in ``x.dtype`` either way -- the exact math the
    runtime codec performs."""
    if wire == "int8":
        if axis is None:
            axis = default_channel_axis(x.ndim)
        q, scales = quantize_boundary(x, axis)
        return dequantize_boundary(q, scales, axis, out_dtype=x.dtype)
    tdt = policy_torch_dtype(wire)
    if x.dtype == tdt:
        return x
    return x.to(tdt).to(x.dtype)
