"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper and its shared-memory
plan.

``mamba2_ssd`` is the counterpart of the JAX package's Pallas SSD kernel:
x (Bb, T, H, hp), dt (Bb, T, H) and B, C (Bb, T, H, ds) in fp32 or bf16,
A (H,), T a multiple of ``chunk``; y in x's dtype, from h0 = 0, no D term.
On a CUDA tensor it launches ``csrc/mamba2_ssd.cu`` (one CTA per (b, h)
walking the chunks); on a CPU tensor it runs ``ref.mamba2_ssd_plain``.

``plan_ssd`` lays out the kernel's shared memory in plain Python, and is
its only copy: the wrapper passes the plan's row stride and byte count
into the launch, so the CPU tests check what the kernel is given."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.ref import mamba2_ssd_plain

SMEM_MAX = 227 * 1024

_V, _I = _build.VOIDP, _build.INT
_SIGNATURES = {"mamba2_ssd_launch": ([_V] * 6 + [_I] * 9 + [_V],
                                     ctypes.c_int)}


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """Shared memory of one CTA, in floats: x [L][hp], B [L][ds+1],
    C [L][ds], h [hp][ds+1], att [L][L], the intra term [L][hp], then
    cs, dt, exp(cs) and w, L each."""

    hp: int
    ds: int
    chunk: int

    @property
    def ld(self) -> int:
        return self.ds + 1            # odd stride: B and h read by column

    @property
    def floats(self) -> int:
        L, hp, ds = self.chunk, self.hp, self.ds
        return L * hp + L * self.ld + L * ds + hp * self.ld + L * L \
            + L * hp + 4 * L

    @property
    def smem(self) -> int:
        return 4 * self.floats


def plan_ssd(hp: int, ds: int, chunk: int) -> SsdPlan:
    if min(hp, ds, chunk) < 1:
        raise ValueError(f"mamba2_ssd: empty hp={hp} ds={ds} chunk={chunk}")
    plan = SsdPlan(hp, ds, chunk)
    if plan.smem > SMEM_MAX:
        raise ValueError(f"mamba2_ssd: hp={hp} ds={ds} chunk={chunk} needs "
                         f"{plan.smem} B of shared memory > {SMEM_MAX}")
    return plan


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, *,
               chunk: int = 64) -> torch.Tensor:
    """x: (Bb, T, H, hp); dt: (Bb, T, H); A: (H,); B, C: (Bb, T, H, ds),
    T a multiple of ``chunk`` -> y (Bb, T, H, hp)."""
    _build.check_inputs("mamba2_ssd", {"x": x, "dt": dt, "B": B, "C": C})
    if x.ndim != 4 or dt.shape != x.shape[:3] or B.ndim != 4 \
            or B.shape[:3] != x.shape[:3] or C.shape != B.shape:
        raise ValueError(
            f"mamba2_ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, B "
            f"{tuple(B.shape)}, C {tuple(C.shape)} are not (Bb, T, H, hp), "
            f"(Bb, T, H), (Bb, T, H, ds), (Bb, T, H, ds)")
    Bb, T, H, hp = x.shape
    ds = B.shape[-1]
    if tuple(A.shape) != (H,) or A.device != x.device \
            or not A.is_floating_point():
        raise ValueError(f"mamba2_ssd: A must be ({H},) floating point on "
                         f"x's device")
    plan = plan_ssd(hp, ds, chunk)
    if T % chunk:
        raise ValueError(f"mamba2_ssd: T={T} is not a multiple of chunk "
                         f"{chunk} (the ops wrapper pads)")
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd: no kernel for device {x.device}")
    A32 = A.float().contiguous()
    y = torch.empty_like(x)
    lib = _build.library("mamba2_ssd", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.mamba2_ssd_launch(
            _build.ptr(x), _build.ptr(dt), _build.ptr(A32), _build.ptr(B),
            _build.ptr(C), _build.ptr(y), Bb, T, H, hp, ds, chunk, plan.ld,
            plan.smem, _build.DTYPE_CODE[x.dtype], _build.stream_of(x))
    _build.check(lib, rc, "mamba2_ssd")
    launches.add("mamba2_ssd")
    return y
