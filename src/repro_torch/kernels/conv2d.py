"""Fused conv2d(+bias)(+relu/relu6)(+maxpool): the CUDA kernel's wrapper
and its launch geometry.

``conv2d`` is the counterpart of ``repro.kernels.conv2d.conv2d``: NCHW
input, OIHW weights, an fp32 bias, an optional activation and an
optional VALID maxpool fused after it, fp32 accumulation, output in the
storage dtype (fp32 or bf16).  On a CUDA tensor it launches
``csrc/conv2d.cu``: the dense kernel for dense, grouped and pointwise
convs, the depthwise kernel when ``groups == Cin == Cout``.  On a CPU
tensor it runs ``ref.conv2d_plain``.  There is no fallback between the
two: a CUDA tensor the kernel does not take raises.

``plan_conv`` is the launch geometry in plain Python, so the CPU tests
can check that the tiles cover the output exactly and that every
shared-memory read stays inside the staged tile."""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.ref import ACTIVATIONS, conv2d_plain

# Thread layout of conv2d_dense_kernel (csrc/conv2d.cu): TP pixel lanes x
# TC channel lanes, each thread PT conv-tile pixels x COT output channels,
# so a CTA covers TC * COT channels and up to TP * PT pixels.  BLOCKINGS
# are the (COT, PT) the kernel is instantiated for, most outputs per
# thread first; the planner takes the first that gives TARGET_CTAS CTAs,
# else the one giving the most.  Both were set from
# scripts/conv_blocking_sweep.py on an H100 (every blocking timed at every
# dense conv of the served AlexNet and MobileNetV2): this rule came within
# 7% of the per-shape best over those shapes.
TP, TC = 64, 4
THREADS = TP * TC
BLOCKINGS = ((8, 2), (8, 1), (4, 1), (2, 1))
TARGET_CTAS = 200
MAX_TILE_W = 32                   # conv-tile columns per CTA
DW_THREADS = 256
DW_MAX_K = 7                      # the depthwise kernel's weight registers
STAGING_BUDGET = 64 * 1024        # shared bytes a CTA aims to stage
SMEM_MAX = 227 * 1024             # the H100's per-block limit
GRID_YZ_MAX = 65535

_ACT_CODE = {None: 0, "relu": 1, "relu6": 2}
_SIGNATURES = {"conv2d_launch": (
    [_build.VOIDP] * 4 + [ctypes.POINTER(ctypes.c_int), _build.VOIDP],
    ctypes.c_int)}
# order of the int array conv2d_launch reads (enum Param in conv2d.cu)
_PARAM_FIELDS = (
    "N", "Cin", "H", "W", "Cout", "cin_pg", "cout_pg", "K", "stride", "pad",
    "act", "pool_k", "pool_s", "Po", "Pw", "tile_oh", "tile_ow", "conv_th",
    "conv_tw", "in_th", "in_tw", "ci_chunk", "tiles_h", "tiles_w",
    "co_blocks", "groups", "smem", "dtype", "depthwise", "cot", "pt")


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """One launch: shapes, tiles, chunking, grid and shared memory.

    Tiles are in final-output units (pooled when a pool is fused);
    ``conv_th x conv_tw`` is the conv tile a CTA computes and ``in_th x
    in_tw`` the haloed input tile it stages.  Depthwise launches use one
    thread per output element and no tiles."""

    N: int
    Cin: int
    H: int
    W: int
    Cout: int
    cin_pg: int
    cout_pg: int
    K: int
    stride: int
    pad: int
    act: int
    pool_k: int
    pool_s: int
    Ho: int
    Wo: int
    Po: int
    Pw: int
    tile_oh: int
    tile_ow: int
    conv_th: int
    conv_tw: int
    in_th: int
    in_tw: int
    ci_chunk: int
    tiles_h: int
    tiles_w: int
    co_blocks: int
    groups: int
    smem: int
    dtype: int
    depthwise: int
    cot: int = 0                  # output channels per thread (dense)
    pt: int = 0                   # conv-tile pixels per thread (dense)

    @property
    def co_blk(self) -> int:
        return TC * self.cot

    @property
    def max_pix(self) -> int:
        return TP * self.pt

    @property
    def grid(self) -> tuple[int, int, int]:
        if self.depthwise:
            total = self.N * self.Cout * self.Po * self.Pw
            return (-(-total // DW_THREADS), 1, 1)
        return (self.tiles_h * self.tiles_w, self.groups * self.co_blocks,
                self.N)

    @property
    def ctas(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def threads(self) -> int:
        return DW_THREADS if self.depthwise else THREADS

    def params(self) -> list[int]:
        return [int(getattr(self, f)) for f in _PARAM_FIELDS]

    @functools.cached_property
    def c_params(self):
        """``params()`` as the C int array ``conv2d_launch`` reads, built
        once per (cached) plan: building it costs more host time than
        the rest of a launch's set-up."""
        values = self.params()
        return (ctypes.c_int * len(values))(*values)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


@functools.lru_cache(maxsize=4096)
def plan_conv(x_shape, w_shape, *, stride: int = 1, pad: int = 0,
              groups: int = 1, activation: str | None = None,
              pool_k: int = 0, pool_s: int = 0,
              dtype: torch.dtype = torch.float32) -> ConvGeometry:
    """The launch geometry of one fused conv; raises on a conv the
    kernels do not take.  Cached: a serving loop plans each of its few
    shapes once (the geometry is a frozen dataclass of ints)."""
    N, Cin, H, W = (int(d) for d in x_shape)
    Cout, cin_pg, K, K2 = (int(d) for d in w_shape)
    if K != K2:
        raise ValueError(f"square kernels only, got {K}x{K2}")
    if groups < 1 or Cin != cin_pg * groups or Cout % groups:
        raise ValueError(
            f"groups={groups} does not divide Cin={Cin} (weights take "
            f"{cin_pg} per group) and Cout={Cout}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if stride < 1 or pad < 0 or pool_k < 0:
        raise ValueError(f"bad stride={stride} pad={pad} pool_k={pool_k}")
    pool_s = (pool_s or pool_k) if pool_k else 0
    Ho, Wo = _out(H, K, stride, pad), _out(W, K, stride, pad)
    Po, Pw = (_out(Ho, pool_k, pool_s, 0), _out(Wo, pool_k, pool_s, 0)) \
        if pool_k else (Ho, Wo)
    if min(Ho, Wo, Po, Pw) < 1:
        raise ValueError(
            f"conv K={K} s={stride} p={pad} pool={pool_k}/{pool_s} gives an "
            f"empty output from {H}x{W}")
    if N > GRID_YZ_MAX:
        raise ValueError(f"batch {N} exceeds the grid limit {GRID_YZ_MAX}")
    depthwise = groups > 1 and groups == Cin == Cout
    common = dict(N=N, Cin=Cin, H=H, W=W, Cout=Cout, cin_pg=cin_pg,
                  cout_pg=Cout // groups, K=K, stride=stride, pad=pad,
                  act=_ACT_CODE[activation], pool_k=pool_k, pool_s=pool_s,
                  Ho=Ho, Wo=Wo, Po=Po, Pw=Pw, groups=groups,
                  dtype=_build.DTYPE_CODE[dtype])
    if depthwise:
        if K > DW_MAX_K:
            raise ValueError(f"depthwise kernel takes K <= {DW_MAX_K}, "
                             f"got {K}")
        return ConvGeometry(
            **common, tile_oh=0, tile_ow=0, conv_th=0, conv_tw=0, in_th=0,
            in_tw=0, ci_chunk=1, tiles_h=0, tiles_w=0, co_blocks=Cout,
            smem=0, depthwise=1)
    cands = [g for g in (_dense_geometry(common, cot, pt)
                         for cot, pt in BLOCKINGS) if g is not None]
    if not cands:
        raise ValueError(f"no tiling of the dense kernel takes K={K} "
                         f"pool={pool_k}/{pool_s} from {H}x{W}")
    for g in cands:
        if g.ctas >= TARGET_CTAS:
            return g
    # too few outputs to fill the card: the most CTAs, then the fewest
    # idle accumulator slots
    return max(cands, key=lambda g: (
        g.ctas, N * Cout * Ho * Wo / (g.ctas * THREADS * g.cot * g.pt)))


def staged_bytes(ci_chunk: int, in_plane: int, co_blk: int, K: int) -> int:
    """Shared bytes of one staged chunk: the input tiles, then (from a
    16-byte boundary) the weight slice."""
    return 4 * (-(-ci_chunk * in_plane // 4) * 4 + ci_chunk * co_blk * K * K)


def _dense_geometry(common: dict, cot: int, pt: int) -> ConvGeometry | None:
    """Tiles, chunking and shared memory of the dense kernel at one
    blocking; None when the blocking cannot hold a pool window."""
    K, stride = common["K"], common["stride"]
    pool_k, pool_s = common["pool_k"], common["pool_s"]
    Po, Pw, Ho, Wo = common["Po"], common["Pw"], common["Ho"], common["Wo"]
    co_blk, max_pix = TC * cot, TP * pt
    if pool_k:
        width = min(MAX_TILE_W, max_pix // pool_k)
        if width < pool_k:
            return None
        tile_ow = min(Pw, (width - pool_k) // pool_s + 1)
        conv_tw = (tile_ow - 1) * pool_s + pool_k
        rows = max_pix // conv_tw
        tile_oh = min(Po, (rows - pool_k) // pool_s + 1)
        conv_th = (tile_oh - 1) * pool_s + pool_k
    else:
        tile_ow = conv_tw = min(Wo, MAX_TILE_W)
        tile_oh = conv_th = min(Ho, max_pix // tile_ow)
    in_th = (conv_th - 1) * stride + K
    in_tw = (conv_tw - 1) * stride + K
    per_ci = 4 * (in_th * in_tw + co_blk * K * K)
    ci_chunk = max(1, min(common["cin_pg"], STAGING_BUDGET // per_ci))
    pool_bytes = 4 * co_blk * conv_th * conv_tw if pool_k else 0
    smem = max(staged_bytes(ci_chunk, in_th * in_tw, co_blk, K), pool_bytes)
    if smem > SMEM_MAX:
        return None
    co_blocks = -(-common["cout_pg"] // co_blk)
    if common["groups"] * co_blocks > GRID_YZ_MAX:
        return None
    return ConvGeometry(
        **common, tile_oh=tile_oh, tile_ow=tile_ow, conv_th=conv_th,
        conv_tw=conv_tw, in_th=in_th, in_tw=in_tw, ci_chunk=ci_chunk,
        tiles_h=-(-Po // tile_oh), tiles_w=-(-Pw // tile_ow),
        co_blocks=co_blocks, smem=smem, depthwise=0, cot=cot, pt=pt)


def _check_inputs(x, w, bias) -> None:
    for name, t in (("x", x), ("w", w)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"conv2d: {name} must be a 4-D tensor")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"conv2d: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"conv2d: w is {w.dtype}, x is {x.dtype}")
    if w.device != x.device:
        raise ValueError(f"conv2d: w on {w.device}, x on {x.device}")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (w.shape[0],):
            raise ValueError(f"conv2d: bias must be float32 of shape "
                             f"({w.shape[0]},), got {bias.dtype} "
                             f"{tuple(bias.shape)}")
        if bias.device != x.device:
            raise ValueError(f"conv2d: bias on {bias.device}, "
                             f"x on {x.device}")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"conv2d: {name} must be contiguous")


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           pad: int = 0, bias: torch.Tensor | None = None,
           activation: str | None = None, groups: int = 1,
           pool_k: int = 0, pool_s: int = 0) -> torch.Tensor:
    """x: (N, Cin, H, W); w: (Cout, Cin/groups, K, K) -> (N, Cout, Ho, Wo),
    or the pooled (N, Cout, Po, Pw) when ``pool_k`` > 0 (``pool_s``
    defaults to ``pool_k``)."""
    _check_inputs(x, w, bias)
    geom = plan_conv(tuple(x.shape), tuple(w.shape), stride=stride,
                     pad=pad, groups=groups, activation=activation,
                     pool_k=pool_k, pool_s=pool_s, dtype=x.dtype)
    if x.device.type == "cpu":
        return conv2d_plain(x, w, stride=stride, pad=pad, bias=bias,
                            activation=activation, groups=groups,
                            pool_k=geom.pool_k, pool_s=geom.pool_s)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d: no kernel for device {x.device}")
    y = torch.empty((geom.N, geom.Cout, geom.Po, geom.Pw), dtype=x.dtype,
                    device=x.device)
    lib = _build.library("conv2d", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.conv2d_launch(
            _build.ptr(x), _build.ptr(w),
            None if bias is None else _build.ptr(bias), _build.ptr(y),
            geom.c_params, _build.stream_of(x))
    _build.check(lib, rc, "conv2d")
    launches.add("conv2d_depthwise" if geom.depthwise else "conv2d_dense")
    return y
