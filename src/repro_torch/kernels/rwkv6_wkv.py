"""RWKV6 WKV recurrence: the CUDA kernel's wrapper.

``rwkv6_wkv`` is the counterpart of the JAX package's Pallas WKV kernel:
r, k, v, w (B, T, H, hd) in fp32 or bf16, u (H, hd), a zero fp32 state,
out in r's dtype.  On a CUDA tensor it launches ``csrc/rwkv6_wkv.cu`` (one
CTA per (b, h), ``hd * hd / 16`` threads); on a CPU tensor it runs
``ref.rwkv6_wkv_plain``.  The kernel takes any T: padding to a time block
is the ops wrapper's, as in the JAX package."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.ref import rwkv6_wkv_plain

RWKV_HD = 64                  # RWKV6's head dim (repro.models.layers.RWKV_HD)
# Head dims the kernel is instantiated for: each thread holds 16 rows of
# one state column, hd / 16 lanes share a column (a power of two that
# divides a warp).
HEAD_DIMS = (16, 32, 64, 128)

_V, _I = _build.VOIDP, _build.INT
_SIGNATURES = {"rwkv6_wkv_launch": ([_V] * 6 + [_I] * 5 + [_V],
                                    ctypes.c_int)}


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w: (B, T, H, hd); u: (H, hd) -> out (B, T, H, hd)."""
    _build.check_inputs("rwkv6_wkv", {"r": r, "k": k, "v": v, "w": w})
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError("rwkv6_wkv: r, k, v, w must share one (B, T, H, hd) "
                         "shape")
    B, T, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"rwkv6_wkv: u is {tuple(u.shape)}, not {(H, hd)}")
    if u.device != r.device or not u.is_floating_point():
        raise TypeError("rwkv6_wkv: u must be floating point on r's device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv: head dim {hd} not in {HEAD_DIMS}")
    if r.device.type == "cpu":
        return rwkv6_wkv_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv: no kernel for device {r.device}")
    u32 = u.float().contiguous()          # exact widening, as the TPU kernel
    out = torch.empty_like(r)
    lib = _build.library("rwkv6_wkv", _SIGNATURES)
    with torch.cuda.device(r.device):
        rc = lib.rwkv6_wkv_launch(
            _build.ptr(r), _build.ptr(k), _build.ptr(v), _build.ptr(w),
            _build.ptr(u32), _build.ptr(out), B, T, H, hd,
            _build.DTYPE_CODE[r.dtype], _build.stream_of(r))
    _build.check(lib, rc, "rwkv6_wkv")
    launches.add("rwkv6_wkv")
    return out
