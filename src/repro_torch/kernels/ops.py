"""Public wrappers around the port's kernels: the counterpart of
``repro.kernels.ops``, with the same signatures.

They do what the JAX package's wrappers do around its Pallas kernels --
refuse sequence lengths that are not block multiples (flash attention),
pad T with zeros (SSD) and slice the result back; WKV needs no padding,
since its kernel takes any T -- and hand the work to the kernel modules,
which launch the CUDA kernel for a CUDA tensor and run the plain PyTorch
version for a CPU tensor.
There is no execution-mode knob: the tensor's device decides.  GQA needs
no repeat here: the flash kernel reads K/V head ``h // (H // KV)``.

The conv and the int8 boundary codec are re-exported, so callers reach
every kernel through one surface."""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_ssd as _ssd
from repro_torch.kernels import rwkv6_wkv as _wkv
from repro_torch.kernels.conv2d import conv2d  # noqa: F401
from repro_torch.kernels.quant import (boundary_roundtrip,  # noqa: F401
                                       dequantize_boundary, quantize_boundary)
from repro_torch.kernels.ref import pad_time


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, block_q: int = 128,
                        block_k: int = 128,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0.

    Sq and Sk must be multiples of ``block_q`` and ``block_k``, as the JAX
    wrapper asserts; the kernel then picks its own tiles.  ``scale`` is
    the softmax scale, default ``1 / sqrt(hd)`` as the JAX kernel's."""
    Sq, Sk = q.shape[1], k.shape[1]
    if block_q < 1 or block_k < 1 or Sq % block_q or Sk % block_k:
        raise ValueError(f"flash_attention_gqa: sequence lengths ({Sq}, "
                         f"{Sk}) are not multiples of the blocks ({block_q}, "
                         f"{block_k})")
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale)


def rwkv6_wkv(r, k, v, w, u, *, block_t: int = 64) -> torch.Tensor:
    """r, k, v, w: (B, T, H, hd); u: (H, hd).

    ``block_t`` is the JAX wrapper's time block, kept for its signature
    and its check.  The JAX wrapper pads T to a multiple of it with decay 1
    (and k = v = 0) and slices the output back; those steps come after
    every real one and cannot change an output before T.  The kernel and
    the plain version take any T, so nothing is padded here and the
    result is the one the padding gives."""
    if block_t < 1:
        raise ValueError(f"rwkv6_wkv: block_t must be positive, got "
                         f"{block_t}")
    return _wkv.rwkv6_wkv(r, k, v, w, u)


def mamba2_ssd(x, dt, A, B, C, *, chunk: int = 64) -> torch.Tensor:
    """x: (Bb, T, H, hp); dt: (Bb, T, H); A: (H,); B, C: (Bb, T, H, ds).
    T is zero-padded to a multiple of ``chunk`` and y sliced back to T."""
    if chunk < 1:
        raise ValueError(f"mamba2_ssd: chunk must be positive, got {chunk}")
    T = x.shape[1]
    y = _ssd.mamba2_ssd(pad_time(x, chunk), pad_time(dt, chunk), A,
                        pad_time(B, chunk), pad_time(C, chunk), chunk=chunk)
    return y[:, :T]
