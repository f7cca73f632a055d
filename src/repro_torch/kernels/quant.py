"""Per-channel symmetric int8 boundary quantization (wire-dtype tier).

The counterpart of ``repro.kernels.quant``, with the contract of its
jitted ``quantize_boundary`` / ``dequantize_boundary`` -- what the JAX
package's wire ships:

    absmax_c = max(|x_c|)                    per channel c
    scale_c  = absmax_c * fl32(1/127)  (1.0 when the channel is all-zero)
    q        = clip(round(x / scale_c), -127, 127)  as int8
    dequant  = q * scale_c                   (error <= scale_c / 2)

The JAX source writes ``absmax / 127``; under ``jit`` XLA turns it into one
multiply by the fp32 reciprocal, and so does this package.  The values are
a true division by that scale, rounded half to even.

Feature maps (ndim >= 3, (B, C, H, W)) quantize per channel axis 1; flat
tensors (ndim <= 2) per tensor, one scale (``default_channel_axis``).

``quantize_packed`` writes the scales and the values into one byte buffer,
``[4*C bytes of fp32 scales | padding to a 16-byte boundary | N int8
values]`` (``values_offset``), so the wire moves a boundary across the link
in one copy each way; ``split_packed`` gives its two parts as tensors.
On a CUDA tensor the wrappers launch the kernels of ``csrc/quant.cu``,
which read the tensor in its own layout as (B, C, S) -- B the axes before
the channel axis, S those after it -- with the geometry of
``plan_quantize`` / ``plan_dequantize``, the only copy of it.  On a CPU
tensor they run ``ref.quantize_plain`` / ``ref.dequantize_plain``.  Kernel
and plain version agree bitwise."""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.core.dtype_policy import policy_torch_dtype
from repro_torch.kernels import _build, launches
from repro_torch.kernels.ref import dequantize_plain, quantize_plain

SMS = 132                    # the H100's streaming multiprocessors
CTA_TARGET = SMS // 2        # quantize: C * k CTAs at least, where k allows
CLUSTERS = (1, 2, 4, 8)      # CTAs a group (a portable cluster)
MIN_SLICE = 1024             # quantize: elements a CTA at least, when k > 1
Q_MAX_THREADS = 512          # quantize_kernel's __launch_bounds__
HELD_CHUNKS = {16: 4, 4: 8, 1: 16}   # chunks a quantize thread holds, by vec
DQ_THREADS = 256             # dequantize_kernel's block
DQ_TARGET_THREADS = 2048 * SMS   # dequantize: threads a launch at most
ALIGN = 16                   # bytes: the kernels' widest copies
ESIZE = {torch.float32: 4, torch.bfloat16: 2}

_V, _I = _build.VOIDP, _build.INT
_SIGNATURES = {
    "quantize_launch": ([_V, _V, _V] + [_I] * 8 + [_V], ctypes.c_int),
    "dequantize_launch": ([_V, _V, _V] + [_I] * 6 + [_V], ctypes.c_int),
}


def default_channel_axis(ndim: int) -> int | None:
    """Quantization-group axis: channels for feature maps, whole-tensor
    (None) for flat activations."""
    return 1 if ndim >= 3 else None


def scale_count(shape: tuple[int, ...], axis: int | None) -> int:
    """Number of fp32 scales shipped alongside an int8 payload."""
    return 1 if axis is None else int(shape[axis])


def _bcs(shape: tuple[int, ...], axis: int | None) -> tuple[int, int, int]:
    """The (B, C, S) view of ``shape`` around the scale-group axis."""
    if axis is None:
        return 1, 1, math.prod(shape)
    axis = axis % len(shape)
    return (math.prod(shape[:axis]), int(shape[axis]),
            math.prod(shape[axis + 1:]))


def values_offset(groups: int) -> int:
    """Byte offset of the int8 values in a packed buffer of ``groups``
    scales: the scales' bytes rounded up to 16, so the values start where
    the kernels' 16-byte copies may."""
    return _ceil(4 * groups, ALIGN) * ALIGN


def split_packed(buf: torch.Tensor, shape, groups: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values int8 of shape, scales fp32 (groups,))``: views of a packed
    uint8 buffer."""
    off = values_offset(groups)
    scales = buf[:4 * groups].view(torch.float32)
    values = buf[off:off + math.prod(shape)].view(torch.int8)
    return values.view(tuple(shape)), scales


def _alignment(*addresses: int) -> int:
    """The largest power of two up to ``ALIGN`` dividing every address."""
    a = ALIGN
    while a > 1 and any(p % a for p in addresses):
        a //= 2
    return a


def _flat_groups(B: int, C: int, S: int) -> tuple[int, int, int]:
    """One group (C = 1) is one contiguous run: (1, 1, B*S)."""
    return (1, 1, B * S) if C == 1 else (B, C, S)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _vec(S: int, esize: int, align: int) -> int:
    """Elements a quantize chunk: 16 (16-byte loads and stores) where
    every row starts 16-aligned, else 4 (one 16- or 8-byte load, a 4-byte
    store) where 4-aligned, else 1."""
    for vec, need in ((16, ALIGN), (4, 4 * esize)):
        if S % vec == 0 and align >= need:
            return vec
    return 1


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """One quantize launch: ``grid`` = C*k CTAs in clusters of ``k`` (no
    cluster at k = 1); CTA ``c*k + r`` takes elements ``bounds(r)`` of
    group c's flattened (b, s) range, its threads the ``vec``-element
    chunks from ``lo + vec * t`` in steps of ``vec * threads``.  When the
    slice is ``resident`` each thread holds its chunks in registers (at
    most ``held`` elements), so x is read once from HBM; else the kernel
    reads the slice a second time.  Shared memory holds only the
    warp maxima and the CTA's partial absmax."""

    B: int
    C: int
    S: int
    dtype: torch.dtype
    k: int
    vec: int
    slice: int
    threads: int

    @property
    def n(self) -> int:
        """Elements of a group."""
        return self.B * self.S

    @property
    def grid(self) -> int:
        return self.C * self.k

    @property
    def held(self) -> int:
        """Elements a thread can hold in registers."""
        return HELD_CHUNKS[self.vec] * self.vec

    @property
    def resident(self) -> bool:
        return self.slice <= self.held * self.threads

    def bounds(self, rank: int) -> tuple[int, int]:
        lo = min(rank * self.slice, self.n)
        return lo, min(lo + self.slice, self.n)

    def index(self, c: int, j: int) -> int:
        """Where element j of group c lies in x (and q)."""
        b, s = divmod(j, self.S)
        return (b * self.C + c) * self.S + s

    def chunks(self, rank: int, t: int) -> list[tuple[int, int]]:
        """``(j, length)`` of each chunk thread t of CTA ``rank`` takes."""
        lo, hi = self.bounds(rank)
        return [(j, min(self.vec, hi - j))
                for j in range(lo + self.vec * t, hi, self.vec * self.threads)]


def _cluster(C: int, n: int) -> int:
    """1 where the groups' CTAs alone cover ``CTA_TARGET``; else the
    smallest k whose C*k CTAs do (8 at most), halved while a CTA would
    get fewer than ``MIN_SLICE`` elements."""
    k = next((k for k in CLUSTERS if C * k >= CTA_TARGET), CLUSTERS[-1])
    while k > 1 and n < k * MIN_SLICE:
        k //= 2
    return k


@functools.lru_cache(maxsize=256)
def plan_quantize(B: int, C: int, S: int,
                  dtype: torch.dtype = torch.float32, *,
                  align: int = ALIGN) -> QuantPlan:
    """The launch geometry of one quantize of a (B, C, S) view in storage
    ``dtype``, whose input and output addresses are ``align``-byte
    aligned: the cluster size from ``_cluster``, doubled up to 8 while a
    slice exceeds what a CTA's threads hold.  Raises ``ValueError`` on what
    the kernel does not take."""
    if min(B, C, S) < 1:
        raise ValueError(f"quantize: empty B={B} C={C} S={S}")
    if dtype not in ESIZE:
        raise ValueError(f"quantize: no kernel for {dtype}")
    if B * C * S >= 2**31:
        raise ValueError(f"quantize: {B * C * S} elements exceed 32-bit "
                         f"indices")
    B, C, S = _flat_groups(B, C, S)
    vec = _vec(S, ESIZE[dtype], align)
    k = _cluster(C, B * S)
    plan = _quant_plan(B, C, S, dtype, vec, k)
    while k < CLUSTERS[-1] and not plan.resident:
        k *= 2
        plan = _quant_plan(B, C, S, dtype, vec, k)
    return plan


def _quant_plan(B: int, C: int, S: int, dtype: torch.dtype, vec: int,
                k: int) -> QuantPlan:
    """The geometry at cluster size k: slices of whole chunks, a thread a
    chunk up to ``Q_MAX_THREADS``."""
    sl = _ceil(_ceil(B * S, k), vec) * vec
    threads = min(Q_MAX_THREADS, max(32, _ceil(_ceil(sl, vec), 32) * 32))
    return QuantPlan(B, C, S, dtype, k, vec, sl, threads)


@dataclasses.dataclass(frozen=True)
class DequantPlan:
    """One dequantize launch: the B*C*S values read flat, ``blocks`` of
    ``DQ_THREADS`` threads; thread t takes the ``vec``-element chunks from
    ``vec * t`` in steps of ``stride``, stepping each chunk's place in its
    row (s) and its row's channel (c) by ``(ds, dc)``."""

    B: int
    C: int
    S: int
    dtype: torch.dtype
    vec: int
    blocks: int

    @property
    def n(self) -> int:
        return self.B * self.C * self.S

    @property
    def stride(self) -> int:
        return self.vec * self.blocks * DQ_THREADS

    def walk(self, t: int) -> list[tuple[int, int, int]]:
        """``(p, s, c)`` of each chunk thread t takes, stepped as the
        kernel steps them."""
        p = self.vec * t
        if p >= self.n:
            return []
        ds, dc = self.stride % self.S, self.stride // self.S % self.C
        row = p // self.S
        s, c, out = p - row * self.S, row % self.C, []
        while p < self.n:
            out.append((p, s, c))
            p += self.stride
            s, c = s + ds, c + dc
            c -= self.C if c >= self.C else 0
            if s >= self.S:
                s -= self.S
                c = 0 if c + 1 == self.C else c + 1
        return out


@functools.lru_cache(maxsize=256)
def plan_dequantize(B: int, C: int, S: int,
                    dtype: torch.dtype = torch.float32, *,
                    align: int = ALIGN) -> DequantPlan:
    """The launch geometry of one dequantize of a (B, C, S) view to
    ``dtype``, the values' address ``align``-byte aligned: ``vec`` values
    a thread at a time, 4 (a 4-byte load, a float4 or 8-byte bf16 store)
    where rows hold at least 4 and 4 divides the count, else 1; at most
    ``DQ_TARGET_THREADS`` threads, each taking its chunks in turn."""
    if min(B, C, S) < 1:
        raise ValueError(f"dequantize: empty B={B} C={C} S={S}")
    if dtype not in ESIZE:
        raise ValueError(f"dequantize: no kernel for {dtype}")
    if B * C * S >= 2**30:
        raise ValueError(f"dequantize: {B * C * S} elements exceed 32-bit "
                         f"indices")
    B, C, S = _flat_groups(B, C, S)
    n = B * C * S
    vec = 4 if S >= 4 and n % 4 == 0 and align >= 4 else 1
    chunks = _ceil(n, vec)
    per_thread = _ceil(chunks, DQ_TARGET_THREADS)
    return DequantPlan(B, C, S, dtype, vec,
                       _ceil(chunks, DQ_THREADS * per_thread))


def _contiguous(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def _on(device: torch.device):
    """``torch.cuda.device(device)`` where it is not already current: the
    codec runs a few times a request, so its host work counts."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def quantize_packed(x: torch.Tensor, axis: int | None = None
                    ) -> torch.Tensor:
    """Quantize ``x`` into one uint8 buffer ``[scales | pad | values]``
    on x's device (``split_packed`` views it).  ``axis`` defaults to the
    channel convention for ``x.ndim``."""
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"quantize_boundary: x must be float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("quantize_boundary: empty tensor")
    _contiguous(x, "quantize_boundary")
    if axis is None:
        axis = default_channel_axis(x.ndim)
    B, C, S = _bcs(tuple(x.shape), axis)
    if x.device.type != "cpu":
        _cuda(x, "quantize_boundary")
    off = values_offset(C)
    buf = torch.empty(off + x.numel(), dtype=torch.uint8, device=x.device)
    if x.device.type == "cpu":
        q, scales = split_packed(buf, x.shape, C)
        pq, ps = quantize_plain(x, axis)
        q.copy_(pq)
        scales.copy_(ps)
        return buf
    xp, sp = x.data_ptr(), buf.data_ptr()
    plan = plan_quantize(B, C, S, x.dtype, align=_alignment(xp, sp + off))
    lib = _build.library("quant", _SIGNATURES)
    with _on(x.device):
        rc = lib.quantize_launch(
            xp, sp + off, sp, plan.B, plan.C, plan.S, plan.k, plan.slice,
            plan.vec, plan.threads, _build.DTYPE_CODE[x.dtype],
            _build.stream_of(x))
    _build.check(lib, rc, "quantize_boundary")
    launches.add("quantize")
    return buf


def quantize_boundary(x: torch.Tensor, axis: int | None = None):
    """Fused absmax + scale + round/clip quantize of a boundary activation.

    ``axis`` defaults to the channel convention for ``x.ndim``.  Returns
    ``(values int8 like x, scales fp32 (C,))``, views of one packed
    buffer."""
    if axis is None:
        axis = default_channel_axis(x.ndim)
    buf = quantize_packed(x, axis)
    return split_packed(buf, x.shape, scale_count(tuple(x.shape), axis))


def _dequantize(qp: int, sp: int, shape: tuple[int, ...], axis: int | None,
                out_dtype: torch.dtype, device: torch.device
                ) -> torch.Tensor:
    """The dequantize kernel on int8 values at address ``qp`` and fp32
    scales at ``sp`` on ``device``."""
    out = torch.empty(shape, dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    B, C, S = _bcs(shape, axis)
    plan = plan_dequantize(B, C, S, out_dtype, align=_alignment(qp))
    lib = _build.library("quant", _SIGNATURES)
    with _on(device):
        rc = lib.dequantize_launch(
            qp, sp, out.data_ptr(), plan.B, plan.C, plan.S, plan.vec,
            plan.blocks, _build.DTYPE_CODE[out_dtype], _build.stream_of(out))
    _build.check(lib, rc, "dequantize_boundary")
    launches.add("dequantize")
    return out


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
    if scales.numel() != scale_count(tuple(values.shape), axis):
        raise ValueError(f"dequantize_boundary: {scales.numel()} scales "
                         f"for {_bcs(tuple(values.shape), axis)[1]} groups")
    _contiguous(values, "dequantize_boundary")
    _contiguous(scales, "dequantize_boundary")
    if values.device.type == "cpu":
        return dequantize_plain(values, scales, axis, out_dtype)
    _cuda(values, "dequantize_boundary")
    return _dequantize(values.data_ptr(), scales.data_ptr(),
                       tuple(values.shape), axis, out_dtype, values.device)


def dequantize_packed(buf: torch.Tensor, shape: tuple[int, ...],
                      axis: int | None, out_dtype: torch.dtype
                      ) -> torch.Tensor:
    """``dequantize_boundary`` of the values and scales that a packed buffer
    of ``shape`` holds (``split_packed``), read from the buffer itself."""
    groups = scale_count(shape, axis)
    if buf.device.type == "cpu":
        q, scales = split_packed(buf, shape, groups)
        return dequantize_boundary(q, scales, axis, out_dtype=out_dtype)
    if buf.dtype != torch.uint8 or not buf.is_contiguous() or \
            buf.numel() != values_offset(groups) + math.prod(shape):
        raise ValueError(f"dequantize_packed: a buffer of {buf.numel()} "
                         f"{buf.dtype} for {groups} scales and values "
                         f"{shape}")
    if out_dtype not in _build.DTYPE_CODE:
        raise TypeError(f"dequantize_boundary: out_dtype must be float32 "
                        f"or bfloat16, got {out_dtype}")
    _cuda(buf, "dequantize_boundary")
    sp = buf.data_ptr()
    return _dequantize(sp + values_offset(groups), sp, tuple(shape), axis,
                       out_dtype, buf.device)


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
