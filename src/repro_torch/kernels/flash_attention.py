"""Flash attention: the CUDA kernel's wrapper and its launch geometry.

``flash_attention`` is the counterpart of the JAX package's Pallas flash
kernel behind ``repro.kernels.ops.flash_attention_gqa``: q (B, Sq, H, hd)
and k, v (B, Sk, KV, hd) in fp32 or bf16, online softmax in fp32, causal
masking end-aligned with a finite mask value, output in q's dtype.  On a
CUDA tensor it launches ``csrc/flash_attention.cu``, which reads K/V head
``h // (H // KV)`` for query head h (no repeat is materialised).  On a CPU
tensor it runs ``ref.attention_plain`` at any head dim, as the JAX
reference does; only the CUDA path plans tiles.  There is no fallback
between the two: a CUDA tensor the kernel does not take raises.

``plan_flash`` is the launch geometry in plain Python -- query tiles, key
tiles, how many key tiles each query tile walks, shared memory -- and the
only copy of it: the wrapper passes its grid, its shared-memory size and
its per-tile key-tile counts (a small int32 table on the card) into the
launch, so the CPU tests walk the tiles the kernel walks.  The tile
constants below are compiled into the kernel too; the wrapper checks that
they agree when it first loads the library."""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.ref import attention_plain, attention_scale

# per storage dtype: query rows a CTA (64 a warpgroup, one wgmma M each),
# keys a staged tile, threads a CTA
BQ = {torch.float32: 64, torch.bfloat16: 128}
BK = {torch.float32: 32, torch.bfloat16: 64}
THREADS = {torch.float32: 128, torch.bfloat16: 256}
NKSLOT = {torch.float32: 2, torch.bfloat16: 3}  # K tiles in the ring
NVSLOT = 2                    # V tiles in the ring
VPAD = 4                      # fp32: floats past hd in a staged V row
HD_STEP = 16                  # hd is a multiple of 16 (wgmma N chunks)
MAX_HD = 128
SMEM_MAX = 227 * 1024
GRID_Y_MAX = 65535
ALIGN = 16                    # bytes: the 16-byte cp.async copies

_V, _I = _build.VOIDP, _build.INT
_SIGNATURES = {
    "flash_attention_launch": (
        [_V] * 4 + [_I] * 5 + [ctypes.c_float] + [_I] * 5 + [_V, _V],
        ctypes.c_int),
    "flash_attention_tiles": ([ctypes.POINTER(ctypes.c_int)], None),
    "flash_attention_smem": ([_I, _I], ctypes.c_int)}
_tiles_checked = False


def tile_constants() -> tuple[int, ...]:
    """What ``flash_attention_tiles`` reports when the kernel agrees: BQ,
    BK, THREADS and NKSLOT of fp32 then of bf16, NVSLOT, VPAD."""
    return (*(c[d] for d in (torch.float32, torch.bfloat16)
              for c in (BQ, BK, THREADS, NKSLOT)), NVSLOT, VPAD)


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Shared bytes of one CTA (the kernel's ``Layout``): Q (and its small
    half in fp32), NKSLOT K tiles, NVSLOT V tiles (fp32 rows padded by VPAD
    floats), then fp32's K small half and V^T's two halves, two sets of
    them (one written while P V reads the other)."""
    bq, bk, nk = BQ[dtype], BK[dtype], NKSLOT[dtype]
    if dtype == torch.float32:
        q, kt, vt = bq * hd * 4, bk * hd * 4, bk * (hd + VPAD) * 4
        return 2 * q + nk * kt + NVSLOT * vt + 2 * 3 * kt
    q, kt = bq * hd * 2, bk * hd * 2
    return q + (nk + NVSLOT) * kt


def key_order(bk: int) -> tuple[int, ...]:
    """fp32: the key held at each position of V^T's K dimension: within
    each 8-key k-step the keys 0 2 4 6 1 3 5 7, so that the S accumulator's
    columns (2t, 2t+1) are the tf32 A fragment's (t, t+4)."""
    return tuple(8 * (kl // 8) + (2 * (kl % 8) if kl % 8 < 4
                                  else 2 * (kl % 8) - 7)
                 for kl in range(bk))


@dataclasses.dataclass(frozen=True)
class FlashGeometry:
    """One launch: grid (q_tiles, B*H) of CTAs of ``THREADS[dtype]``
    threads, one warpgroup per 64 of a tile's ``bq`` query rows; block x
    takes query tile q_tiles - 1 - x (the heaviest causal tiles first)."""

    B: int
    Sq: int
    Sk: int
    H: int
    KV: int
    hd: int
    causal: bool
    dtype: torch.dtype = torch.float32

    @property
    def bq(self) -> int:
        return BQ[self.dtype]

    @property
    def bk(self) -> int:
        return BK[self.dtype]

    @property
    def q_tiles(self) -> int:
        return -(-self.Sq // self.bq)

    @property
    def grid(self) -> tuple[int, int]:
        return self.q_tiles, self.B * self.H

    def tile_of_block(self, x: int) -> int:
        return self.q_tiles - 1 - x

    @property
    def smem(self) -> int:
        return smem_bytes(self.hd, self.dtype)

    def kv_head(self, h: int) -> int:
        return h // (self.H // self.KV)

    @property
    def k_tiles(self) -> tuple[int, ...]:
        """Key tiles each query tile walks, the table the kernel reads.  A
        causal tile whose every row sees key 0 stops after its last visible
        key; a tile holding a row with no visible key (Sq > Sk) walks them
        all, since that row averages every key."""
        bq, bk = self.bq, self.bk
        n, diag = -(-self.Sk // bk), self.Sk - self.Sq
        tiles = []
        for q0 in range(0, self.Sq, bq):
            last = min(q0 + bq, self.Sq) - 1 + diag
            causal_stop = self.causal and q0 + diag >= 0
            tiles.append(min(n, last // bk + 1) if causal_stop else n)
        return tuple(tiles)


def check_shapes(q_shape, k_shape) -> tuple[int, ...]:
    """(B, Sq, Sk, H, KV, hd) of q (B, Sq, H, hd) and k (B, Sk, KV, hd);
    raises on shapes the function itself refuses, on any device."""
    B, Sq, H, hd = (int(d) for d in q_shape)
    Bk, Sk, KV, hdk = (int(d) for d in k_shape)
    if Bk != B or hdk != hd:
        raise ValueError(f"flash_attention: q {tuple(q_shape)} and k "
                         f"{tuple(k_shape)} differ in batch or head dim")
    if min(B, Sq, Sk, H, KV) < 1:
        raise ValueError("flash_attention: empty input")
    if H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} kv heads")
    return B, Sq, Sk, H, KV, hd


def plan_flash(q_shape, k_shape, *, causal: bool = True,
               dtype: torch.dtype = torch.float32) -> FlashGeometry:
    """The launch geometry of one call in storage ``dtype``; raises on
    shapes the kernel does not take."""
    B, Sq, Sk, H, KV, hd = check_shapes(q_shape, k_shape)
    if hd % HD_STEP or not HD_STEP <= hd <= MAX_HD:
        raise ValueError(f"flash_attention: head dim {hd} is not a multiple "
                         f"of {HD_STEP} up to {MAX_HD}")
    if B * H > GRID_Y_MAX:
        raise ValueError(f"flash_attention: B*H = {B * H} exceeds the grid "
                         f"limit {GRID_Y_MAX}")
    if dtype not in BK:
        raise ValueError(f"flash_attention: no kernel for {dtype}")
    return FlashGeometry(B, Sq, Sk, H, KV, hd, bool(causal), dtype)


@functools.lru_cache(maxsize=256)
def _k_tile_table(g: FlashGeometry, device: torch.device) -> torch.Tensor:
    """``g.k_tiles`` on the card, made once per geometry (before any CUDA
    graph captures a launch that reads it)."""
    return torch.tensor(g.k_tiles, dtype=torch.int32, device=device)


def _library():
    """The kernel library, its compiled tile constants and shared bytes
    checked against the planner's on first load."""
    global _tiles_checked
    lib = _build.library("flash_attention", _SIGNATURES)
    if not _tiles_checked:
        got = (ctypes.c_int * 10)()
        lib.flash_attention_tiles(got)
        if tuple(got) != tile_constants():
            raise RuntimeError(
                f"flash_attention: the kernel is compiled with (BQ, BK, "
                f"THREADS, NKSLOT of fp32 and of bf16, NVSLOT, VPAD) = "
                f"{tuple(got)}, the planner has {tile_constants()}")
        for dtype, code in _build.DTYPE_CODE.items():
            for hd in range(HD_STEP, MAX_HD + 1, HD_STEP):
                kernel = lib.flash_attention_smem(code, hd)
                if kernel != smem_bytes(hd, dtype):
                    raise RuntimeError(
                        f"flash_attention: the kernel takes {kernel} shared "
                        f"bytes at hd {hd} {dtype}, the planner "
                        f"{smem_bytes(hd, dtype)}")
        _tiles_checked = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).  The
    softmax scale is ``scale``, default ``attention_scale(hd)``; either
    is rounded once, to fp32, where it meets the scores."""
    _build.check_inputs("flash_attention", {"q": q, "k": k, "v": v})
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {n} must be 4-D")
    if v.shape != k.shape:
        raise ValueError(f"flash_attention: v {tuple(v.shape)} != k "
                         f"{tuple(k.shape)}")
    check_shapes(q.shape, k.shape)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    g = plan_flash(q.shape, k.shape, causal=causal, dtype=q.dtype)
    o = torch.empty_like(q)
    _build.check_aligned("flash_attention", {"q": q, "k": k, "v": v, "o": o},
                         ALIGN)
    lib = _library()
    with torch.cuda.device(q.device):
        k_tiles = _k_tile_table(g, q.device)
        rc = lib.flash_attention_launch(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), g.Sq,
            g.Sk, g.H, g.KV, g.hd,
            attention_scale(g.hd) if scale is None else float(scale),
            int(g.causal),
            _build.DTYPE_CODE[q.dtype], *g.grid, g.smem, _build.ptr(k_tiles),
            _build.stream_of(q))
    _build.check(lib, rc, "flash_attention")
    launches.add("flash_attention")
    return o
