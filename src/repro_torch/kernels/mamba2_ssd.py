"""Mamba2 SSD chunked scan: the CUDA kernels' wrapper and their plan.

``mamba2_ssd`` is the counterpart of the JAX package's Pallas SSD kernel:
x (Bb, T, H, hp), dt (Bb, T, H) and B, C (Bb, T, H, ds) in fp32 or bf16,
A (H,), T a multiple of ``chunk``; y in x's dtype, from h0 = 0, no D term.
On a CPU tensor it runs ``ref.mamba2_ssd_plain``.  On a CUDA tensor it
runs ``csrc/mamba2_ssd.cu``'s chunk-parallel form of the same arithmetic,
three launches from one entry point:

1. one CTA per (b, h, chunk) computes the chunk's state contribution
   ``s_c = (x o w)^T B`` and its decay ``exp(cs_L)`` into a scratch;
2. one thread per (b, h, state element) scans the chunks in order,
   ``h_c = h_{c-1} exp(cs_L) + s_c``, leaving in place of each ``s_c`` the
   state that enters chunk c;
3. one CTA per (b, h, chunk) computes y from its chunk and that state.

The scratch (fp32 states ``Bb*H*chunks*hp*ds`` and decays ``Bb*H*chunks``)
comes from ``torch.empty`` here; the kernels allocate nothing.  ``plan_ssd``
lays out each pass's shared memory and grid in plain Python and is their
only copy: the wrapper passes its int array (``PARAM_FIELDS``, mirrored by
the C ``enum Param``) into the launch, so the CPU tests check what the
kernels are given."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.ref import mamba2_ssd_plain

SMEM_MAX = 227 * 1024
THREADS = 128                 # passes 1 and 3: one warpgroup
SCAN_THREADS = 256            # pass 2
M_STEP = 16                   # hp and chunk: whole 16-row mma strips
K_STEP = 8                    # ds: whole 8-deep mma k-steps
ESIZE = {torch.float32: 4, torch.bfloat16: 2}
ALIGN = 16                    # bytes: the 16-byte row loads

# The C side's enum Param / struct SsdArgs, in order.
PARAM_FIELDS = (
    "Bb", "T", "H", "hp", "ds", "L", "nc", "ldx1", "ldb1", "off_b1",
    "off_cs1", "smem1", "ldc3", "ldb3", "ldx3", "lda3", "ldh3", "off_b3",
    "off_x3", "off_a3", "off_h3", "off_cs3", "smem3", "scan_threads",
    "scan_blocks")

_V, _I = _build.VOIDP, _build.INT
_SIGNATURES = {
    "mamba2_ssd_launch": ([_V] * 8 + [ctypes.POINTER(ctypes.c_int), _I, _V],
                          ctypes.c_int),
    "mamba2_ssd_param_count": ([], ctypes.c_int)}


def stride(n: int, es: int, k_fast: bool) -> int:
    """The least row stride >= n elements of ``es`` bytes under which a
    warp's 32 mma fragment reads fall in 32 banks.  Lanes read (row g,
    column t) where k runs along a row (``k_fast``: C, att, and B and h
    read as B^T), else (row t, column g) (x, and B read by rows); rows
    4 resp. 8 words apart, mod 32 words, spread them (two bf16 lanes
    share a word)."""
    words = 4 if k_fast else 8
    return n + (words * 4 // es - n) % (32 * 4 // es)


def _tile(rows: int, ld: int, es: int) -> int:
    return rows * ld * es


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """Shared memory (row strides in elements, offsets and sizes in bytes)
    and grids of the three passes for one call in storage ``dtype``.  Pass
    1: x [L][ldx1] and B [L][ldb1] as stored, read by rows (x as A^T), cs
    and w [L] fp32.  Pass 3: C [L][ldc3], B [L][ldb3] and x [L][ldx3] as
    stored, att [L][lda3] (over B where ``att_over_b``) and h [hp][ldh3]
    fp32, cs, dt and exp(cs) [L] fp32.  Pass 2: one thread per state
    element, ``scan_threads`` a block."""

    Bb: int
    T: int
    H: int
    hp: int
    ds: int
    chunk: int
    dtype: torch.dtype = torch.float32

    @property
    def es(self) -> int:
        return ESIZE[self.dtype]

    @property
    def L(self) -> int:
        return self.chunk

    @property
    def nc(self) -> int:
        return self.T // self.chunk

    @property
    def ldx1(self) -> int:
        return stride(self.hp, self.es, False)

    @property
    def ldb1(self) -> int:
        return stride(self.ds, self.es, False)

    @property
    def off_b1(self) -> int:
        return _tile(self.L, self.ldx1, self.es)

    @property
    def off_cs1(self) -> int:
        return self.off_b1 + _tile(self.L, self.ldb1, self.es)

    @property
    def smem1(self) -> int:
        return self.off_cs1 + 4 * 2 * self.L

    @property
    def ldc3(self) -> int:
        return stride(self.ds, self.es, True)

    @property
    def ldb3(self) -> int:
        return stride(self.ds, self.es, True)

    @property
    def ldx3(self) -> int:
        return stride(self.hp, self.es, False)

    @property
    def lda3(self) -> int:
        return stride(self.L, 4, True)

    @property
    def ldh3(self) -> int:
        return stride(self.ds, 4, True)

    @property
    def off_b3(self) -> int:
        return _tile(self.L, self.ldc3, self.es)

    @property
    def off_x3(self) -> int:
        return self.off_b3 + _tile(self.L, self.ldb3, self.es)

    @property
    def att_over_b(self) -> bool:
        """att (fp32) takes B's place once C B^T is done, where one strip
        and one column group a warp hold all of it (L <= 64) and B's tile
        is as large: a third fp32 CTA fits an SM at Zamba2-7B's widths."""
        return self.L <= 64 and _tile(self.L, self.ldb3, self.es) >= _tile(
            self.L, self.lda3, 4)

    @property
    def off_a3(self) -> int:
        return self.off_b3 if self.att_over_b else self.off_x3 + _tile(
            self.L, self.ldx3, self.es)

    @property
    def off_h3(self) -> int:
        if self.att_over_b:
            return self.off_x3 + _tile(self.L, self.ldx3, self.es)
        return self.off_a3 + _tile(self.L, self.lda3, 4)

    @property
    def off_cs3(self) -> int:
        return self.off_h3 + _tile(self.hp, self.ldh3, 4)

    @property
    def smem3(self) -> int:
        return self.off_cs3 + 4 * 3 * self.L

    @property
    def scan_threads(self) -> int:
        return SCAN_THREADS

    @property
    def scan_blocks(self) -> int:
        return -(-self.hp * self.ds // SCAN_THREADS)

    @property
    def grid(self) -> tuple[int, int]:
        """Passes 1 and 3: (chunks, Bb*H) CTAs of ``THREADS``."""
        return self.nc, self.Bb * self.H

    @property
    def scan_grid(self) -> tuple[int, int]:
        return self.scan_blocks, self.Bb * self.H

    @property
    def state_floats(self) -> int:
        return self.Bb * self.H * self.nc * self.hp * self.ds

    @property
    def state_bytes(self) -> int:
        """The states' fp32 scratch: written by pass 1, read and written by
        pass 2, read by pass 3 (4x this through memory a call)."""
        return 4 * self.state_floats

    def params(self) -> list[int]:
        return [int(getattr(self, f)) for f in PARAM_FIELDS]


def plan_ssd(Bb: int, T: int, H: int, hp: int, ds: int, chunk: int,
             dtype: torch.dtype = torch.float32) -> SsdPlan:
    """The plan of one CUDA call in storage ``dtype``; raises
    ``ValueError`` on a shape the kernels do not take."""
    if min(Bb, T, H, hp, ds, chunk) < 1:
        raise ValueError(f"mamba2_ssd: empty Bb={Bb} T={T} H={H} hp={hp} "
                         f"ds={ds} chunk={chunk}")
    if T % chunk:
        raise ValueError(f"mamba2_ssd: T={T} is not a multiple of chunk "
                         f"{chunk} (the ops wrapper pads)")
    if hp % M_STEP or chunk % M_STEP or ds % K_STEP:
        raise ValueError(
            f"mamba2_ssd: the CUDA kernels need hp and chunk multiples of "
            f"{M_STEP} and ds a multiple of {K_STEP} (whole mma tiles); got "
            f"hp={hp}, chunk={chunk}, ds={ds}")
    if dtype not in ESIZE:
        raise ValueError(f"mamba2_ssd: no kernel for {dtype}")
    plan = SsdPlan(Bb, T, H, hp, ds, chunk, dtype)
    for name, nbytes in (("pass 1", plan.smem1), ("pass 3", plan.smem3)):
        if nbytes > SMEM_MAX:
            raise ValueError(f"mamba2_ssd: hp={hp} ds={ds} chunk={chunk} "
                             f"needs {nbytes} B of shared memory in {name} "
                             f"> {SMEM_MAX}")
    if Bb * H > 65535:
        raise ValueError(f"mamba2_ssd: Bb*H = {Bb * H} exceeds the grid "
                         f"limit 65535")
    return plan


def _library():
    """The kernel library, its parameter count checked against
    ``PARAM_FIELDS``."""
    lib = _build.library("mamba2_ssd", _SIGNATURES)
    if lib.mamba2_ssd_param_count() != len(PARAM_FIELDS):
        raise RuntimeError(
            f"mamba2_ssd: the kernel reads {lib.mamba2_ssd_param_count()} "
            f"parameters, the planner has {len(PARAM_FIELDS)}")
    return lib


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
    if chunk < 1 or T % chunk:
        raise ValueError(f"mamba2_ssd: T={T} is not a multiple of chunk "
                         f"{chunk} (the ops wrapper pads)")
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd: no kernel for device {x.device}")
    plan = plan_ssd(Bb, T, H, hp, ds, chunk, x.dtype)
    A32 = A.float().contiguous()
    y = torch.empty_like(x)
    _build.check_aligned("mamba2_ssd", {"x": x, "B": B, "C": C, "y": y},
                         ALIGN)
    states = torch.empty(plan.state_floats, dtype=torch.float32,
                         device=x.device)
    decay = torch.empty(Bb * H * plan.nc, dtype=torch.float32,
                        device=x.device)
    values = plan.params()
    params = (ctypes.c_int * len(values))(*values)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.mamba2_ssd_launch(
            _build.ptr(x), _build.ptr(dt), _build.ptr(A32), _build.ptr(B),
            _build.ptr(C), _build.ptr(y), _build.ptr(states),
            _build.ptr(decay), params, _build.DTYPE_CODE[x.dtype],
            _build.stream_of(x))
    _build.check(lib, rc, "mamba2_ssd")
    launches.add("mamba2_ssd")
    return y
