"""Fused conv2d(+bias)(+relu/relu6)(+maxpool): the CUDA kernel's wrapper
and its launch geometry.

``conv2d`` is the counterpart of ``repro.kernels.conv2d.conv2d``: NCHW
input, OIHW weights, an fp32 bias, an optional activation and an
optional VALID maxpool fused after it, fp32 accumulation, output in the
storage dtype (fp32 or bf16).  On a CUDA tensor it launches
``csrc/conv2d.cu``: the warp-specialised dense kernel for the bf16 convs
whose tiles fill (VGG's 3x3 convs with Cin >= 64), the one-warpgroup
dense kernel for every other dense, grouped and pointwise conv, the
depthwise kernel when ``groups == Cin == Cout``.  On a CPU tensor it runs
``ref.conv2d_plain``.  There is no fallback between them: a CUDA tensor
the kernels do not take raises.

What bounds them on an H100 (``csrc/conv2d.cu``'s note, ``PERF.md``): the
one-warpgroup kernel runs its staging, barriers, gather and products in
turn, far from the tensor cores' rate; the warp-specialised one moves
the staging to a producer warpgroup (TMA, or cp.async on the 28- and
14-wide layers) and overlaps its consumers' gathers with their wgmma, and
is bound by shared memory (the weight slice read by both consumers, the
gather's 2-byte loads) and, on the narrow layers, the producers' copies.

``plan_conv`` is the launch geometry in plain Python, so the CPU tests
can check that the tiles cover the output exactly and that every
shared-memory read stays inside the staged tile."""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.ref import ACTIVATIONS, conv2d_plain

# Dense kernel (csrc/conv2d.cu::conv2d_dense_kernel): an implicit GEMM on
# wgmma.  One warpgroup (THREADS) per CTA computes a BM-row tile of conv
# pixels (one rectangular conv tile of one image) by BN output channels of
# one group.  K runs over the flat (ci, kh, kw) taps in k-steps of KSTEP
# (the wgmma depth: 8 tf32 or 16 bf16 values) and stages of BK taps, in
# a ring of ``nstage`` shared-memory slots (nstage - 1 stages in flight
# while one is multiplied).  The planner picks BN: the widest of BNS that
# gives TARGET_CTAS CTAs (per dtype), else the one giving the most; then
# the deepest ring of NSTAGES, at most stages + 1 deep, within the shared
# bytes RING_BUDGET leaves each CTA (how many CTAs share an SM), else the
# deepest that fits.  TARGET_CTAS, BNS and RING_BUDGET come from
# scripts/conv_blocking_sweep.py on an H100.
BM = 64
THREADS = 128
BNS = (64, 32, 16)
TARGET_CTAS = {0: 396, 1: 264}    # by dtype code
NSTAGES = (4, 3, 2)
BK = 64                           # taps per stage, both dtypes
KSTEP = {0: 8, 1: 16}             # taps per k-step, by dtype code
ESIZE = {0: 4, 1: 2}
MAX_TILE_W = 64                   # conv-tile columns per CTA
EPI_PITCH = 68                    # floats per channel row of the epilogue tile
SMEM_MAX = 227 * 1024             # the H100's per-block limit
RING_BUDGET = 75 * 1024           # three CTAs' worth of an SM's 228 KB
GRID_YZ_MAX = 65535
MAGIC_LIMIT = 1 << 16             # __umulhi division is exact below this

# Warp-specialised dense kernel (conv2d_dense_ws_kernel), bf16 storage: a
# producer warpgroup brings each stage's weight slice (TMA, 128-byte
# swizzle) and input planes (TMA where image rows are whole 16-byte
# copies, else cp.async) into a ring of ``nstage`` slots; two consumer
# warpgroups gather their rows of the stage's im2col tile (WS_BM pixels
# x BK taps) from the planes into registers and run wgmma m64nBNk16.
# The planner takes it where the weights' rows are whole stages (no
# padding taps), the image rows split into whole 4-byte copies or wider
# (a stage's planes one TMA box, else at most WS_COPIES cp.async copies a
# producer thread: MobileNetV2's 1x1 convs, 64 channels a stage, are not
# taken), and the tiles fill at least WS_MIN_FILL of the products they
# run (AlexNet's 13-wide convs are not taken); BN is
# the one of WS_BNS whose waves of blocks at WS_IMAGES images cost least
# (WS_STAGE_COST: a stage's relative time at each BN, from
# scripts/conv_blocking_sweep.py on an H100); the ring is the deepest of
# WS_NSTAGES that fits.  Nothing of it reads the batch.
WS_BM = 128
WS_THREADS = 384
WS_BNS = (256, 128, 64)
WS_STAGE_COST = {256: 1.5, 128: 1.0, 64: 1.0}
WS_NSTAGES = (6, 5, 4, 3)
WS_COPIES = 8                     # cp.async plane copies a producer a stage
WS_BOX = 256                      # a TMA box's largest side
WS_EPI_PITCH = 132
WS_MIN_FILL = 0.75
WS_IMAGES = 16
SMS = 132                         # the H100's SMs: a wave of one-CTA blocks

# Depthwise kernel (conv2d_depthwise_kernel): a shared-memory stencil.
# One CTA per (spatial tile, block of DW channels, image); each thread
# computes strips of DW_VEC outputs along a row.  K=3 at stride 1 or 2 is
# compiled for its shape (weights and window in registers); any other
# K <= DW_MAX_K takes the generic path.
DW_THREADS = 256
DW_VEC = 4
DW_MAX_K = 7
DW_TILE_H, DW_TILE_W = 16, 32     # conv-tile rows and columns per CTA
DW_ITEMS = 512                    # strips a CTA aims to hold
DW_TARGET_CTAS = 264
DW_SMEM_MAX = 48 * 1024

_ACT_CODE = {None: 0, "relu": 1, "relu6": 2}
_SIGNATURES = {"conv2d_launch": (
    [_build.VOIDP] * 4 + [ctypes.POINTER(ctypes.c_int), _build.VOIDP],
    ctypes.c_int)}
# order of the int array conv2d_launch reads (enum Param in conv2d.cu)
_PARAM_FIELDS = (
    "N", "Cin", "H", "W", "Cout", "cin_pg", "cout_pg", "K", "stride", "pad",
    "act", "pool_k", "pool_s", "Ho", "Wo", "Po", "Pw", "groups", "dtype",
    "depthwise", "tile_oh", "tile_ow", "conv_th", "conv_tw", "in_th", "in_tw",
    "tiles_h", "tiles_w", "co_blocks", "smem", "bn", "ktot", "bk", "stages",
    "nstage", "chmax", "pitch", "magic", "vec_x", "vec_b", "slot", "off_b",
    "off_bs", "off_tab", "off_px", "off_toff", "kq", "kr", "ci_last", "cb",
    "kt", "pitch_w", "off_w", "off_ct", "magic_w", "magic_pc", "magic_ns",
    "ws", "rp", "ec", "rc", "magic_rc", "magic_cr", "off_pl", "pslot",
    "off_bar", "tperiod")


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """One launch: shapes, tiles, the K decomposition, grid and shared
    memory.

    Tiles are in final-output units (pooled when a pool is fused);
    ``conv_th x conv_tw`` is the conv tile a CTA computes and ``in_th x
    in_tw`` the haloed input tile it stages.  Dense launches: ``bn``
    output channels a CTA, K = ``ktot`` taps in ``stages`` stages of
    ``bk`` through a ring of ``nstage`` slots, each stage's input
    channels in ``chmax`` planes of ``pitch`` elements; byte offsets
    inside a slot.  Depthwise launches:
    ``cb`` channels a CTA, ``kt`` the compiled K (0: generic), rows of
    ``pitch_w`` floats.  Warp-specialised launches (``ws``): a stage's
    planes in rows of ``rp`` elements (``rc`` copies of ``ec``) in the
    ring's slots of ``slot`` bytes (the weights, then ``pslot`` bytes of
    planes from ``off_pl``), the mbarriers at ``off_bar``, then the
    ``tperiod`` tap tables at ``off_toff``."""

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
    groups: int
    dtype: int
    depthwise: int
    tile_oh: int
    tile_ow: int
    conv_th: int
    conv_tw: int
    in_th: int
    in_tw: int
    tiles_h: int
    tiles_w: int
    co_blocks: int
    smem: int
    bn: int = 0
    ktot: int = 0
    bk: int = 0
    stages: int = 0
    nstage: int = 0
    chmax: int = 0
    pitch: int = 0
    magic: int = 0
    vec_x: int = 0
    vec_b: int = 0
    slot: int = 0
    off_b: int = 0
    off_bs: int = 0
    off_tab: int = 0
    off_px: int = 0
    off_toff: int = 0
    kq: int = 0
    kr: int = 0
    ci_last: int = 0
    cb: int = 0
    kt: int = 0
    pitch_w: int = 0
    off_w: int = 0
    off_ct: int = 0
    magic_w: int = 0
    magic_pc: int = 0
    magic_ns: int = 0
    ws: int = 0
    rp: int = 0
    ec: int = 0
    rc: int = 0
    magic_rc: int = 0
    magic_cr: int = 0
    off_pl: int = 0
    pslot: int = 0
    off_bar: int = 0
    tperiod: int = 0

    @property
    def grid(self) -> tuple[int, int, int]:
        if self.depthwise:
            return (self.tiles_h * self.tiles_w, self.co_blocks, self.N)
        return (self.tiles_h * self.tiles_w, self.groups * self.co_blocks,
                self.N)

    @property
    def ctas(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def threads(self) -> int:
        if self.ws:
            return WS_THREADS
        return DW_THREADS if self.depthwise else THREADS

    @property
    def kernel(self) -> str:
        """The launch counter's name of the kernel this plan runs."""
        if self.ws:
            return "conv2d_dense_ws"
        return "conv2d_depthwise" if self.depthwise else "conv2d_dense"

    @property
    def in_plane(self) -> int:
        return self.in_th * self.in_tw

    def params(self) -> list[int]:
        return [int(getattr(self, f)) for f in _PARAM_FIELDS]

    @functools.cached_property
    def c_params(self):
        """``params()`` as the C int array ``conv2d_launch`` reads, built
        once per (cached) plan: building it costs more host time than
        the rest of a launch's set-up."""
        values = self.params()
        return (ctypes.c_int * len(values))(*values)


@dataclasses.dataclass(frozen=True)
class KDecomposition:
    """How the dense kernel walks K = cin_pg * K * K taps.  A function of
    the weight shape and the storage dtype alone: never of batch, tile,
    BN, ring depth or pool fusion, so every launch of one weight sums
    each output in the same k-steps.  Stage ``s`` holds taps [s * bk,
    (s+1) * bk), whole k-steps; taps past ``ktot`` are zeros (the kernel
    runs every stage whole, so its last stage's k-steps past ``kpad`` add
    exact zeros).  One segment: there is no split-K."""

    ktot: int
    kstep: int
    kpad: int
    bk: int
    stages: int
    kk: int
    cin_pg: int

    def stage_taps(self, s: int) -> tuple[int, int]:
        return s * self.bk, min((s + 1) * self.bk, self.kpad)

    def stage_channels(self, s: int) -> tuple[int, int]:
        """[c_lo, c_hi): the input channels stage ``s``'s real taps read."""
        k0, k1 = self.stage_taps(s)
        return k0 // self.kk, (min(k1, self.ktot) - 1) // self.kk + 1

    @property
    def kstep_bounds(self) -> tuple[int, ...]:
        return tuple(range(0, self.kpad + 1, self.kstep))

    @property
    def segments(self) -> tuple[tuple[int, int], ...]:
        return ((0, self.kpad),)


def k_decomposition(cin_pg: int, K: int, dtype_code: int) -> KDecomposition:
    kk = K * K
    ktot = cin_pg * kk
    kstep = KSTEP[dtype_code]
    kpad = -(-ktot // kstep) * kstep
    return KDecomposition(ktot=ktot, kstep=kstep, kpad=kpad, bk=BK,
                          stages=-(-kpad // BK), kk=kk, cin_pg=cin_pg)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def plane_pitch(n: int, esize: int) -> int:
    """Elements per staged input plane: at least ``n``, and 32 bytes past
    a multiple of 128, so the 4 taps a warp's lanes read in one k-step
    (4 planes apart in a pointwise conv) fall in distinct banks."""
    unit, off = 128 // esize, 32 // esize
    return n + (off - n) % unit


def magic_div(d: int) -> int:
    """The multiplier m with ``__umulhi(i, m) == i // d`` for i, d < 2^16
    (m = ceil(2^32 / d)), as a signed 32-bit int; 0 for d = 1."""
    if d == 1:
        return 0
    m = -(-(1 << 32) // d)
    return m - (1 << 32) if m >= 1 << 31 else m


def _conv_tile(common: dict, max_pix: int, max_w: int, max_h: int):
    """(tile_oh, tile_ow, conv_th, conv_tw) in final-output and conv units;
    None when a pool window does not fit."""
    pool_k, pool_s = common["pool_k"], common["pool_s"]
    Po, Pw, Ho, Wo = common["Po"], common["Pw"], common["Ho"], common["Wo"]
    if pool_k:
        width = min(max_w, max_pix // pool_k)
        if width < pool_k:
            return None
        tile_ow = min(Pw, (width - pool_k) // pool_s + 1)
        conv_tw = (tile_ow - 1) * pool_s + pool_k
        rows = min(max_h, max_pix // conv_tw)
        if rows < pool_k:
            return None
        tile_oh = min(Po, (rows - pool_k) // pool_s + 1)
        conv_th = (tile_oh - 1) * pool_s + pool_k
    else:
        tile_ow = conv_tw = min(Wo, max_w)
        tile_oh = conv_th = min(Ho, max_pix // tile_ow, max_h)
    return tile_oh, tile_ow, conv_th, conv_tw


@functools.lru_cache(maxsize=4096)
def plan_conv(x_shape, w_shape, *, stride: int = 1, pad: int = 0,
              groups: int = 1, activation: str | None = None,
              pool_k: int = 0, pool_s: int = 0,
              dtype: torch.dtype = torch.float32) -> ConvGeometry:
    """The launch geometry of one fused conv; raises on a conv the
    kernels do not take.  Cached: a serving loop plans each of its few
    shapes once (the geometry is a frozen dataclass of ints).  A dense
    conv takes the warp-specialised kernel where ``_ws_geometry`` plans
    one, else the one-warpgroup kernel."""
    common = _common(x_shape, w_shape, stride, pad, groups, activation,
                     pool_k, pool_s, dtype)
    if not common["depthwise"]:
        g = _ws_geometry(common)
        if g is not None:
            return g
    return _plan(common)


@functools.lru_cache(maxsize=4096)
def plan_conv_dense(x_shape, w_shape, *, stride: int = 1, pad: int = 0,
                    groups: int = 1, activation: str | None = None,
                    pool_k: int = 0, pool_s: int = 0,
                    dtype: torch.dtype = torch.float32) -> ConvGeometry:
    """``plan_conv`` without the warp-specialised kernel: the
    one-warpgroup kernel's geometry at every dense conv, which
    ``chip_smoke.py`` holds the warp-specialised kernel to, bitwise, and
    times it against."""
    return _plan(_common(x_shape, w_shape, stride, pad, groups, activation,
                         pool_k, pool_s, dtype))


def _common(x_shape, w_shape, stride, pad, groups, activation, pool_k,
            pool_s, dtype) -> dict:
    """The conv's shapes and options as the kernels read them; raises on
    a conv they do not take."""
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
    return dict(N=N, Cin=Cin, H=H, W=W, Cout=Cout, cin_pg=cin_pg,
                cout_pg=Cout // groups, K=K, stride=stride, pad=pad,
                act=_ACT_CODE[activation], pool_k=pool_k, pool_s=pool_s,
                Ho=Ho, Wo=Wo, Po=Po, Pw=Pw, groups=groups,
                dtype=_build.DTYPE_CODE[dtype], depthwise=int(depthwise))


def _plan(common: dict) -> ConvGeometry:
    """The depthwise or the one-warpgroup dense kernel's geometry."""
    K, pool_k, pool_s = common["K"], common["pool_k"], common["pool_s"]
    H, W = common["H"], common["W"]
    if common["depthwise"]:
        if K > DW_MAX_K:
            raise ValueError(f"depthwise kernel takes K <= {DW_MAX_K}, "
                             f"got {K}")
        g = _depthwise_geometry(common)
        if g is None:
            raise ValueError(f"no tiling of the depthwise kernel takes "
                             f"pool={pool_k}/{pool_s} from {H}x{W}")
        return g
    cands = [g for g in map(functools.partial(_dense_geometry, common), BNS)
             if g is not None]
    if not cands:
        raise ValueError(f"no tiling of the dense kernel takes K={K} "
                         f"pool={pool_k}/{pool_s} from {H}x{W}")
    for g in cands:
        if g.ctas >= TARGET_CTAS[common["dtype"]]:
            return g
    return max(cands, key=lambda g: (g.ctas, g.bn))


def _dense_geometry(common: dict, bn: int) -> ConvGeometry | None:
    """Tiles, K decomposition and shared memory of the dense kernel at one
    channel block; None when it does not fit."""
    K, stride, dt = common["K"], common["stride"], common["dtype"]
    tile = _conv_tile(common, BM, MAX_TILE_W, BM)
    if tile is None:
        return None
    tile_oh, tile_ow, conv_th, conv_tw = tile
    in_th = (conv_th - 1) * stride + K
    in_tw = (conv_tw - 1) * stride + K
    in_plane = in_th * in_tw
    kd = k_decomposition(common["cin_pg"], K, dt)
    chmax = max(c1 - c0 for c0, c1 in map(kd.stage_channels,
                                            range(kd.stages)))
    es = ESIZE[dt]
    elems = 16 // es              # elements of one 16-byte copy
    H, W = common["H"], common["W"]
    pointwise = K == 1 and stride == 1 and common["pad"] == 0
    # whole images: a stage's planes are one run in memory, kept as one
    # run in the slot (2); whole rows: each plane's part is one run, in
    # 16-byte copies (1) or, where only 8-byte aligned, 8-byte ones (3)
    if (pointwise and not common["pool_k"] and conv_th == H and conv_tw == W
            and (common["cin_pg"] * H * W) % elems == 0
            and (common["Cin"] * H * W) % elems == 0):
        vec_x, pitch = 2, in_plane
    else:
        pitch = plane_pitch(in_plane, es)
        vec_x = 0
        for mode, n in ((1, elems), (3, 8 // es)):
            if (n and pointwise and conv_tw == W and (conv_th * W) % n == 0
                    and (H * W) % n == 0 and pitch % n == 0):
                vec_x = mode
                break
    # the staging loops divide indices up to a slot's planes plus one
    # unrolled pass of the threads by multiply-shift
    if chmax * pitch + 8 * THREADS >= MAGIC_LIMIT:
        return None
    x_bytes = _align(chmax * pitch * es, 128)
    b_bytes = bn * BK * es
    bs_bytes = bn * BK * 4 if dt == 0 else 0
    slot = x_bytes + b_bytes + bs_bytes + BK * 4

    tables = _align(in_plane * 4, 16) + _align(K * K * 4, 16)

    def smem_of(n):
        return max(n * slot + tables, bn * EPI_PITCH * 4)
    # no deeper than the stages it can hold in flight
    fits = [n for n in NSTAGES if smem_of(n) <= SMEM_MAX
            and (n <= kd.stages + 1 or n == NSTAGES[-1])]
    if not fits:
        return None
    nstage = next((n for n in fits if smem_of(n) <= RING_BUDGET), fits[0])
    off_px, smem = nstage * slot, smem_of(nstage)
    co_blocks = -(-common["cout_pg"] // bn)
    if common["groups"] * co_blocks > GRID_YZ_MAX:
        return None
    vec_b = int(kd.ktot % elems == 0)
    return ConvGeometry(
        **common, tile_oh=tile_oh, tile_ow=tile_ow, conv_th=conv_th,
        conv_tw=conv_tw, in_th=in_th, in_tw=in_tw,
        tiles_h=-(-common["Po"] // tile_oh),
        tiles_w=-(-common["Pw"] // tile_ow), co_blocks=co_blocks, smem=smem,
        bn=bn, ktot=kd.ktot, bk=BK, stages=kd.stages,
        nstage=nstage, chmax=chmax,
        pitch=pitch, magic=magic_div(in_plane), vec_x=vec_x, vec_b=vec_b,
        slot=slot, off_b=x_bytes, off_bs=x_bytes + b_bytes,
        off_tab=x_bytes + b_bytes + bs_bytes, off_px=off_px,
        off_toff=off_px + _align(in_plane * 4, 16), kq=BK // (K * K),
        kr=BK % (K * K), ci_last=(kd.ktot - 1) // (K * K))


def ws_fill(common: dict, tile) -> float:
    """The share of a conv tile's WS_BM product rows that feed an output
    of the whole launch: the output's share of its tiles' outputs, times
    the tile's conv pixels over WS_BM."""
    tile_oh, tile_ow, conv_th, conv_tw = tile
    Po, Pw = common["Po"], common["Pw"]
    tiles = -(-Po // tile_oh) * -(-Pw // tile_ow)
    return Po * Pw / (tiles * tile_oh * tile_ow) * conv_th * conv_tw / WS_BM


def _ws_tile(common: dict):
    """(fill, tile) of the fullest conv tile of at most WS_BM pixels, the
    widest among equals; None when no pool window fits."""
    best = None
    for max_w in range(1, min(common["Wo"], WS_BM) + 1):
        tile = _conv_tile(common, WS_BM, max_w, WS_BM)
        if tile is None:
            continue
        key = (ws_fill(common, tile), tile[3])
        if best is None or key > best[0]:
            best = (key, tile)
    return None if best is None else (best[0][0], best[1])


def ws_bn(common: dict, tiles: int, fill_m: float) -> int | None:
    """The warp-specialised kernel's channel block: of the BNs of WS_BNS
    whose tiles fill at least WS_MIN_FILL, the one whose waves of
    one-CTA blocks at WS_IMAGES images cost least (WS_STAGE_COST a
    wave), the widest among equals; None when none fills."""
    cout = common["cout_pg"]
    best = None
    for bn in WS_BNS:
        blocks = -(-cout // bn)
        if fill_m * cout / (blocks * bn) < WS_MIN_FILL:
            continue
        waves = -(-tiles * blocks * WS_IMAGES // SMS)
        cost = waves * WS_STAGE_COST[bn]
        if best is None or cost < best[0]:
            best = (cost, bn)
    return None if best is None else best[1]


def _ws_geometry(common: dict) -> ConvGeometry | None:
    """The warp-specialised kernel's geometry, or None where it does not
    take the conv: bf16 storage, one group, weight rows of whole stages,
    image rows of whole copies of at least 4 bytes, tiles that fill."""
    K, stride, H, W = common["K"], common["stride"], common["H"], common["W"]
    if common["dtype"] != 1 or common["groups"] != 1:
        return None
    kd = k_decomposition(common["cin_pg"], K, 1)
    if kd.ktot % BK:
        return None
    ec = next((e for e in (8, 4, 2) if W % e == 0), 0)
    found = _ws_tile(common)
    if not ec or found is None:
        return None
    fill_m, (tile_oh, tile_ow, conv_th, conv_tw) = found
    tiles_h = -(-common["Po"] // tile_oh)
    tiles_w = -(-common["Pw"] // tile_ow)
    bn = ws_bn(common, tiles_h * tiles_w, fill_m)
    if bn is None:
        return None
    in_th = (conv_th - 1) * stride + K
    in_tw = (conv_tw - 1) * stride + K
    # a staged row starts at a whole copy at most ec - 1 columns left of
    # the tile's window
    rc = -(-(in_tw + ec - 1) // ec)
    rp = rc * ec
    pitch = _align(in_th * rp, 8)
    chmax = max(c1 - c0 for c0, c1 in map(kd.stage_channels,
                                            range(kd.stages)))
    # whole 16-byte copies: one TMA box a stage; else each producer's
    # cp.async copies
    if ec == 8 and max(rp, in_th, chmax) > WS_BOX:
        return None
    if ec < 8 and -(-chmax * in_th * rc // 128) > WS_COPIES:
        return None
    # a ring slot: the weight slice (whole 1024-byte swizzle atoms), then
    # the stage's planes
    off_pl = bn * BK * 2
    pslot = _align(chmax * pitch * 2, 128)
    slot = _align(off_pl + pslot, 1024)
    epi = bn * WS_EPI_PITCH * 4
    # the stages' tap offsets repeat, shifted by whole channels, every
    # tperiod stages: lcm(BK, K * K) taps
    tperiod = K * K // math.gcd(BK, K * K)

    def layout(n):
        off_bar = _align(max(n * slot, epi), 8)
        off_toff = off_bar + 16 * n
        # 1024 bytes to align the ring's swizzle in the kernel
        return off_bar, off_toff, off_toff + 4 * tperiod * BK + 1024
    fits = [n for n in WS_NSTAGES if layout(n)[2] <= SMEM_MAX]
    if not fits:
        return None
    nstage = fits[0]
    off_bar, off_toff, smem = layout(nstage)
    return ConvGeometry(
        **common, tile_oh=tile_oh, tile_ow=tile_ow, conv_th=conv_th,
        conv_tw=conv_tw, in_th=in_th, in_tw=in_tw, tiles_h=tiles_h,
        tiles_w=tiles_w, co_blocks=-(-common["cout_pg"] // bn), smem=smem,
        bn=bn, ktot=kd.ktot, bk=BK, stages=kd.stages, nstage=nstage,
        chmax=chmax, pitch=pitch, slot=slot,
        kq=BK // (K * K), kr=BK % (K * K), ci_last=(kd.ktot - 1) // (K * K),
        ws=1, rp=rp, ec=ec, rc=rc, magic_rc=magic_div(rc),
        magic_cr=magic_div(in_th * rc), off_pl=off_pl, pslot=pslot,
        off_bar=off_bar, off_toff=off_toff, tperiod=tperiod)


def _depthwise_geometry(common: dict) -> ConvGeometry | None:
    K, s, C, N = common["K"], common["stride"], common["Cout"], common["N"]
    tile = _conv_tile(common, DW_TILE_H * DW_TILE_W, DW_TILE_W, DW_TILE_H)
    if tile is None:
        return None
    tile_oh, tile_ow, conv_th, conv_tw = tile
    in_th = (conv_th - 1) * s + K
    in_tw = (conv_tw - 1) * s + K
    kt = K if K == 3 and s in (1, 2) else 0
    nstrip = -(-conv_tw // DW_VEC)
    win = (DW_VEC - 1) * s + K
    # the compiled path loads each strip's window as whole float4s
    pitch_w = _align(max(in_tw, (nstrip - 1) * DW_VEC * s + _align(win, 4)),
                     4)
    per_ch = 4 * (in_th * pitch_w + K * K
                  + (conv_th * conv_tw if common["pool_k"] else 0))
    tiles = -(-common["Po"] // tile_oh) * -(-common["Pw"] // tile_ow)
    cb = max(1, min(C, DW_ITEMS // (conv_th * nstrip),
                    DW_SMEM_MAX // per_ch))
    while cb > 1 and tiles * -(-C // cb) * N < DW_TARGET_CTAS:
        cb = -(-cb // 2)
    if cb * per_ch > DW_SMEM_MAX or \
            cb * in_th * in_tw + 4 * DW_THREADS >= MAGIC_LIMIT:
        return None
    off_w = 4 * cb * in_th * pitch_w
    off_ct = off_w + 4 * _align(cb * K * K, 4)
    smem = off_ct + (4 * cb * conv_th * conv_tw if common["pool_k"] else 0)
    return ConvGeometry(
        **common, tile_oh=tile_oh, tile_ow=tile_ow, conv_th=conv_th,
        conv_tw=conv_tw, in_th=in_th, in_tw=in_tw,
        tiles_h=-(-common["Po"] // tile_oh),
        tiles_w=-(-common["Pw"] // tile_ow), co_blocks=-(-C // cb),
        smem=smem, cb=cb, kt=kt, pitch_w=pitch_w, off_w=off_w,
        off_ct=off_ct, magic=magic_div(in_th * in_tw),
        magic_w=magic_div(in_tw), magic_pc=magic_div(conv_th * nstrip),
        magic_ns=magic_div(nstrip))


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
    return launch(x, w, bias, geom)


def launch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
           geom: ConvGeometry) -> torch.Tensor:
    """Run ``geom`` (``plan_conv``'s or ``plan_conv_dense``'s plan of
    these shapes) on CUDA tensors that ``conv2d`` checked."""
    if geom.ws:
        # the warp-specialised kernel copies 16-byte weight runs and rows
        # in copies of ec elements, with no narrower path
        _build.check_aligned("conv2d", {"w": w}, 16)
        _build.check_aligned("conv2d", {"x": x}, 2 * geom.ec)
    y = torch.empty((geom.N, geom.Cout, geom.Po, geom.Pw), dtype=x.dtype,
                    device=x.device)
    lib = _build.library("conv2d", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.conv2d_launch(
            _build.ptr(x), _build.ptr(w),
            None if bias is None else _build.ptr(bias), _build.ptr(y),
            geom.c_params, _build.stream_of(x))
    _build.check(lib, rc, "conv2d")
    launches.add(geom.kernel)
    return y
