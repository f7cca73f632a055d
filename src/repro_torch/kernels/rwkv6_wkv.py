"""RWKV6 WKV recurrence: the CUDA kernel's wrapper and its launch geometry.

``rwkv6_wkv`` is the counterpart of the JAX package's Pallas WKV kernel:
r, k, v, w (B, T, H, hd) in fp32 or bf16, u (H, hd), a zero fp32 state,
out in r's dtype, any T.  On a CPU tensor it runs ``ref.rwkv6_wkv_plain``
at any head dim, as the JAX reference does.  On a CUDA tensor it launches
``csrc/rwkv6_wkv.cu``: each column of the state evolves on its own, so a
CTA scans ``jc`` columns of one (b, h) through all T steps, each thread a
``rows x cols`` tile of the state in registers, fed ``steps`` steps at a
time through a ring of ``stages`` shared-memory slots filled by
``cp.async``.

``plan_wkv`` is that geometry in plain Python and its only copy: the
wrapper passes the plan's numbers into the launch, which refuses shared
bytes other than its own count and a tile other than the one compiled
for the head dim and dtype (``TILES``), so the CPU tests check what the
kernel is given."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.ref import rwkv6_wkv_plain

RWKV_HD = 64                  # RWKV6's head dim (repro.models.layers.RWKV_HD)
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
MAX_THREADS = 256             # the kernel's __launch_bounds__
SMEM_MAX = 227 * 1024         # dynamic shared bytes a CTA may take
SM_SMEM = 228 * 1024          # an SM's, 1 KB of it reserved per CTA
SM_THREADS = 2048
ESIZE = {torch.float32: 4, torch.bfloat16: 2}
ALIGN = 16                    # bytes: the 16-byte copies and stores
_F32, _B16 = torch.float32, torch.bfloat16
# the state tile (rows, cols) a thread holds, per hd and dtype: compiled
# into the kernel, one instantiation each (csrc/rwkv6_wkv.cu's TILES)
TILES = {(16, _F32): (4, 2), (16, _B16): (4, 2),
         (32, _F32): (4, 4), (32, _B16): (8, 2),
         (64, _F32): (4, 4), (64, _B16): (8, 2),
         (128, _F32): (8, 4), (128, _B16): (8, 2)}
# the run-time geometry (jc, steps, stages) per hd and dtype: hd 64's the
# fastest of scripts/wkv_sweep.py's at RWKV6-7B widths (PERF.md §6), the
# others sized alike
DEFAULTS = {(16, _F32): (16, 32, 2), (16, _B16): (16, 32, 2),
            (32, _F32): (32, 32, 2), (32, _B16): (32, 32, 2),
            (64, _F32): (64, 16, 2), (64, _B16): (64, 16, 2),
            (128, _F32): (32, 16, 2), (128, _B16): (32, 16, 2)}

_V, _I = _build.VOIDP, _build.INT
_SIGNATURES = {"rwkv6_wkv_launch": ([_V] * 6 + [_I] * 12 + [_V],
                                    ctypes.c_int)}


@dataclasses.dataclass(frozen=True)
class WkvPlan:
    """One launch: grid ``B*H*(hd/jc)`` CTAs, block x taking columns
    ``j0 .. j0+jc-1`` of head ``(b, h)`` (``block``), so the CTAs of one
    head are adjacent; ``threads = jc / cols * lanes``, thread
    ``q * (jc / cols) + g`` holding rows ``rows_of(q)`` of columns ``j0 + g
    * cols .. j0 + g * cols + cols - 1``.  Shared memory:
    ``stages`` slots of ``steps`` records (r, k, w, then v's jc columns, in
    the stored dtype), bf16's fp32 copy of one slot, the fp32 partial sums
    and bonus terms of ``steps`` steps, two output buffers of ``steps x
    jc``."""

    B: int
    T: int
    H: int
    hd: int
    dtype: torch.dtype
    jc: int
    rows: int
    cols: int
    steps: int
    stages: int

    @property
    def esize(self) -> int:
        return ESIZE[self.dtype]

    @property
    def lanes(self) -> int:
        """Threads sharing a group of ``cols`` columns, each with its own
        rows: their partial sums of an output are added after a stage."""
        return self.hd // self.rows

    @property
    def threads(self) -> int:
        return self.jc // self.cols * self.lanes

    @property
    def col_blocks(self) -> int:
        return self.hd // self.jc

    @property
    def grid(self) -> int:
        return self.B * self.H * self.col_blocks

    @property
    def n_stages(self) -> int:
        """Stages of the scan, the last one partial where steps ∤ T."""
        return -(-self.T // self.steps)

    @property
    def record(self) -> int:
        """Elements of one staged step: r, k, w and the CTA's v columns."""
        return 3 * self.hd + self.jc

    @property
    def part_step(self) -> int:
        """fp32 partial sums of one step: per column group, ``lanes x
        cols`` and 4 floats of padding."""
        return self.jc // self.cols * (self.lanes * self.cols + 4)

    @property
    def smem(self) -> int:
        slot = self.steps * self.record
        work = 4 * slot if self.dtype == torch.bfloat16 else 0
        return (self.stages * slot * self.esize + work
                + 4 * (self.steps * self.part_step + -(-self.steps // 4) * 4)
                + 2 * self.steps * self.jc * self.esize)

    @property
    def ctas_per_sm(self) -> int:
        return min(SM_SMEM // (self.smem + 1024), SM_THREADS // self.threads,
                   32)

    def block(self, x: int) -> tuple[int, int, int]:
        """(b, h, j0) of block x."""
        bh, cb = divmod(x, self.col_blocks)
        return bh // self.H, bh % self.H, cb * self.jc

    def rows_of(self, q: int) -> list[int]:
        """State rows of lane q of a column group: the float4 chunks q,
        q + lanes, q + 2 lanes, ..."""
        return [4 * (q + self.lanes * m) + e for m in range(self.rows // 4)
                for e in range(4)]


def plan_wkv(B: int, T: int, H: int, hd: int,
             dtype: torch.dtype = torch.float32) -> WkvPlan:
    """The launch geometry of one CUDA call in storage ``dtype``: the
    compiled tile and ``DEFAULTS``' columns a CTA, steps and stages;
    raises ``ValueError`` on what the kernel does not take."""
    if min(B, T, H, hd) < 1:
        raise ValueError(f"rwkv6_wkv: empty B={B} T={T} H={H} hd={hd}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv: the CUDA kernel takes head dims "
                         f"{HEAD_DIMS}, not {hd}")
    if dtype not in ESIZE:
        raise ValueError(f"rwkv6_wkv: no kernel for {dtype}")
    rows, cols = TILES[hd, dtype]
    jc, steps, stages = DEFAULTS[hd, dtype]
    plan = WkvPlan(B, T, H, hd, dtype, jc, rows, cols, steps, stages)
    if jc < 1 or hd % jc or jc % cols or jc * plan.esize % ALIGN:
        raise ValueError(f"rwkv6_wkv: {jc} columns a CTA do not divide hd "
                         f"{hd} into {ALIGN}-byte runs of whole tiles")
    if plan.threads % 32 or plan.threads > MAX_THREADS:
        raise ValueError(f"rwkv6_wkv: {plan.threads} threads a CTA is not "
                         f"whole warps up to {MAX_THREADS}")
    if plan.steps < 1 or not 2 <= plan.stages <= 4:
        raise ValueError(f"rwkv6_wkv: {plan.steps} steps a stage, "
                         f"{plan.stages} stages (2-4)")
    if plan.smem > SMEM_MAX or plan.ctas_per_sm < 2:
        raise ValueError(f"rwkv6_wkv: {plan.smem} B of shared memory a CTA "
                         f"leaves fewer than two CTAs an SM")
    if plan.grid >= 2**31:
        raise ValueError(f"rwkv6_wkv: {plan.grid} CTAs exceed the grid")
    return plan


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
    if r.device.type == "cpu":
        return rwkv6_wkv_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv: no kernel for device {r.device}")
    plan = plan_wkv(B, T, H, hd, r.dtype)
    # the kernel widens u (fp32 or bf16) itself, as the TPU kernel does
    uk = u.contiguous() if u.dtype in _build.DTYPE_CODE else u.float()
    out = torch.empty_like(r)
    _build.check_aligned("rwkv6_wkv", {"r": r, "k": k, "v": v, "w": w,
                                       "out": out}, ALIGN)
    lib = _build.library("rwkv6_wkv", _SIGNATURES)
    with torch.cuda.device(r.device):
        rc = lib.rwkv6_wkv_launch(
            _build.ptr(r), _build.ptr(k), _build.ptr(v), _build.ptr(w),
            _build.ptr(uk), _build.ptr(out), B, T, H, hd,
            _build.DTYPE_CODE[r.dtype], _build.DTYPE_CODE[uk.dtype],
            plan.jc, plan.rows, plan.cols, plan.steps, plan.stages,
            plan.smem, _build.stream_of(r))
    _build.check(lib, rc, "rwkv6_wkv")
    launches.add("rwkv6_wkv")
    return out
