"""The port's sequence kernels (``repro_torch.kernels.ops``) against the JAX
package, on the CPU.

* Flash attention, RWKV6 WKV and Mamba2 SSD through the port's ``ops``
  (which take the plain PyTorch versions for CPU tensors) against
  ``repro.kernels.ref`` on the shapes of ``tests/test_kernels.py``'s
  sweeps, fp32 and bf16, at that file's tolerances.
* The same against the Pallas kernels through ``repro.kernels.ops`` in
  interpret mode, the Sq > Sk causal case included.
* The fully-masked-row contract: a causal query row that sees no key
  averages V, as a numpy walk of the TPU kernel's blocks shows.
* CPU walks of the CUDA kernels' tiles, from the planners the wrappers
  use: the flash kernel's query and key tiles (online softmax, GQA head
  map, causal tile skipping, ragged last tiles) and the SSD kernel's chunk
  walk and product tiles, with their TF32 and bf16 arithmetic emulated;
  on ``chip_smoke.py`` phase 8's shapes and inputs, controls showing that
  its checks would catch one TF32 pass in place of three, and what P V
  on P's bf16 pair saves over one bf16 rounding of P.
* ``ops``-level padding, GQA and argument checks; the configs the widths
  come from."""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import launches, ops  # noqa: E402
from repro_torch.kernels import mamba2_ssd as kssd  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as kwkv  # noqa: E402
from repro_torch.kernels.ref import (MASK_VALUE,  # noqa: E402
                                     attention_plain, attention_scale,
                                     mamba2_ssd_plain, pad_time)

DTYPES = ("fp32", "bf16")
_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _tol(dtype):
    """``tests/test_kernels.py``'s tolerances for flash attention and WKV."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


def _ssd_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bf16" \
        else dict(rtol=2e-4, atol=2e-4)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor in ``dtype``
    (both round fp32 to bf16 to nearest even: the same bits)."""
    return jnp.asarray(a).astype(_JDT[dtype]), torch.from_numpy(a).to(
        _TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _needs_pallas():
    if not hasattr(pltpu, "TPUCompilerParams"):
        pytest.skip("this jax lacks pltpu.TPUCompilerParams, which the "
                    "Pallas kernels name")


# ---------------------------------------------------------------------------
# Inputs (numpy, seeded)
# ---------------------------------------------------------------------------
def _attn_inputs(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Sq, H, hd)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, Sk, KV, hd)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(B, Sk, KV, hd)) * 0.3).astype(np.float32)
    return q, k, v


def _wkv_inputs(seed, b, t, h, hd):
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.normal(size=(b, t, h, hd)) * 0.3).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.normal(size=(b, t, h, hd)))) * 0.5
         + 0.45).astype(np.float32)
    u = (rng.normal(size=(h, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _ssd_inputs(seed, b, t, h, hp, ds):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, t, h, hp)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    B = (rng.normal(size=(b, t, h, ds)) * 0.4).astype(np.float32)
    C = (rng.normal(size=(b, t, h, ds)) * 0.4).astype(np.float32)
    return x, dt, A, B, C


def _bh(a: np.ndarray) -> np.ndarray:
    """(B, S, H, hd) -> the JAX kernels' (B*H, S, hd)."""
    B, S, H, hd = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


# ---------------------------------------------------------------------------
# The port against repro.kernels.ref, on test_kernels.py's sweeps
# ---------------------------------------------------------------------------
# (bh, sq, sk, hd, causal, block_q, block_k): tests/test_kernels.py L27-38,
# its slow shapes included; bh query heads, each with its own K/V head
FLASH_SWEEP = [
    (2, 128, 128, 64, True, 64, 64),
    (1, 128, 128, 128, True, 128, 128),
    (2, 128, 256, 64, False, 64, 64),
    (1, 64, 256, 32, True, 64, 128),
    (2, 128, 128, 80, True, 64, 64),
    (1, 256, 256, 128, True, 128, 128),
    (1, 64, 384, 32, True, 64, 128),
    (3, 192, 192, 80, True, 64, 64),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_SWEEP, ids=str)
def test_flash_attention_matches_attention_ref(case, dtype):
    bh, sq, sk, hd, causal, bq, bk = case
    q, k, v = _attn_inputs(0, 1, sq, sk, bh, bh, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jref.attention_ref(_bh(jq), _bh(jk), _bh(jv), causal=causal)
    got = ops.flash_attention_gqa(tq, tk, tv, causal=causal, block_q=bq,
                                  block_k=bk)
    assert got.dtype == _TDT[dtype] and got.shape == tq.shape
    np.testing.assert_allclose(_bh(_np(got)), _np(want), **_tol(dtype))


# (b, t, h, hd, block_t): tests/test_kernels.py L144-148
WKV_SWEEP = [(2, 128, 2, 32, 32), (1, 96, 4, 64, 32), (3, 64, 1, 16, 64)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WKV_SWEEP, ids=str)
def test_rwkv6_wkv_matches_ref(case, dtype):
    b, t, h, hd, bt = case
    arrays = _wkv_inputs(1, b, t, h, hd)
    pairs = [_pair(a, dtype) for a in arrays]
    want, _ = jref.rwkv6_wkv_ref(*(j for j, _ in pairs))
    got = ops.rwkv6_wkv(*(p for _, p in pairs), block_t=bt)
    assert got.dtype == _TDT[dtype] and got.shape == (b, t, h, hd)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# (b, t, h, hp, ds, chunk): tests/test_kernels.py L184-188
SSD_SWEEP = [(2, 128, 2, 16, 8, 32), (1, 64, 4, 32, 16, 64),
             (2, 96, 1, 64, 64, 32)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SSD_SWEEP, ids=str)
def test_mamba2_ssd_matches_ref(case, dtype):
    """As ``test_mamba2_ssd_sweep``: x, dt, B, C in ``dtype`` into the
    chunked kernel, fp32 dt into the token-level oracle."""
    b, t, h, hp, ds, chunk = case
    x, dt, A, B, C = _ssd_inputs(2, b, t, h, hp, ds)
    (jx, tx), (_, tdt), (jB, tB), (jC, tC) = (
        _pair(a, dtype) for a in (x, dt, B, C))
    want, _ = jref.mamba2_ssd_ref(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC)
    got = ops.mamba2_ssd(tx, tdt, torch.from_numpy(A), tB, tC, chunk=chunk)
    assert got.dtype == _TDT[dtype] and got.shape == (b, t, h, hp)
    np.testing.assert_allclose(_np(got), _np(want), **_ssd_tol(dtype))


# ---------------------------------------------------------------------------
# The port against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
# (B, Sq, Sk, H, KV, hd, causal, block_q, block_k)
PALLAS_FLASH = {
    "gqa4": (2, 128, 128, 8, 2, 64, True, 64, 64),
    "sq_gt_sk": (1, 128, 64, 4, 2, 32, True, 64, 64),
    "cross": (1, 64, 128, 2, 1, 80, False, 64, 64),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(PALLAS_FLASH))
def test_flash_attention_matches_pallas(name, dtype):
    """The Sq > Sk rows with no visible key come out as mean(V) in both."""
    _needs_pallas()
    B, Sq, Sk, H, KV, hd, causal, bq, bk = PALLAS_FLASH[name]
    arrays = _attn_inputs(3, B, Sq, Sk, H, KV, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrays)
    want = jops.flash_attention_gqa(jq, jk, jv, causal=causal, block_q=bq,
                                    block_k=bk)
    got = ops.flash_attention_gqa(tq, tk, tv, causal=causal, block_q=bq,
                                  block_k=bk)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv6_wkv_matches_pallas_with_padding(dtype):
    """T = 50 with block_t = 32, as ``test_rwkv6_ops_padding``."""
    _needs_pallas()
    pairs = [_pair(a, dtype) for a in _wkv_inputs(4, 1, 50, 2, 16)]
    want = jops.rwkv6_wkv(*(j for j, _ in pairs), block_t=32)
    got = ops.rwkv6_wkv(*(p for _, p in pairs), block_t=32)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_ssd_matches_pallas_ragged_t(dtype):
    """T = 50, not a multiple of the chunk: both pad with zeros."""
    _needs_pallas()
    x, dt, A, B, C = _ssd_inputs(5, 2, 50, 2, 16, 8)
    (jx, tx), (jdt, tdt), (jB, tB), (jC, tC) = (
        _pair(a, dtype) for a in (x, dt, B, C))
    want = jops.mamba2_ssd(jx, jdt, jnp.asarray(A), jB, jC, chunk=32)
    got = ops.mamba2_ssd(tx, tdt, torch.from_numpy(A), tB, tC, chunk=32)
    np.testing.assert_allclose(_np(got), _np(want), **_ssd_tol(dtype))


# ---------------------------------------------------------------------------
# Rows with no visible key: the mean of V, as the TPU kernel computes
# ---------------------------------------------------------------------------
def _flash_block_walk(q, k, v, *, causal, block_q, block_k):
    """numpy walk of ``_flash_kernel``'s grid: per (bh, q block) the k
    blocks in order, with the finite -1e30 mask and (m, l, acc) carried."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    scale = np.float32(1.0 / hd**0.5)
    neg = np.float32(-1e30)
    out = np.empty_like(q)
    for b in range(BH):
        for qi in range(Sq // block_q):
            rows = slice(qi * block_q, (qi + 1) * block_q)
            m = np.full(block_q, neg, np.float32)
            l = np.zeros(block_q, np.float32)
            acc = np.zeros((block_q, hd), np.float32)
            for ki in range(Sk // block_k):
                cols = slice(ki * block_k, (ki + 1) * block_k)
                s = (q[b, rows] @ k[b, cols].T).astype(np.float32) * scale
                if causal:
                    r = qi * block_q + np.arange(block_q)[:, None] + Sk - Sq
                    c = ki * block_k + np.arange(block_k)[None, :]
                    s = np.where(c <= r, s, neg)
                m_new = np.maximum(m, s.max(axis=1))
                p = np.exp(s - m_new[:, None])
                alpha = np.exp(m - m_new)
                l = alpha * l + p.sum(axis=1)
                acc = acc * alpha[:, None] + p @ v[b, cols]
                m = m_new
            l = np.where(l == 0.0, np.float32(1.0), l)
            out[b, rows] = acc / l[:, None]
    return out


def test_fully_masked_rows_average_v():
    """Sq = 8 > Sk = 4, causal: rows 0-3 see no key.  The TPU kernel's
    block walk gives them mean(V) (not 0, as its docstring says); the
    -inf oracle gives NaN; the port gives mean(V)."""
    q, k, v = _attn_inputs(6, 1, 8, 4, 2, 2, 16)
    qb, kb, vb = _bh(q), _bh(k), _bh(v)
    walk = _flash_block_walk(qb, kb, vb, causal=True, block_q=4, block_k=4)
    np.testing.assert_allclose(walk[:, :4],
                               np.broadcast_to(vb.mean(axis=1, keepdims=True),
                                               walk[:, :4].shape),
                               rtol=1e-6, atol=1e-6)
    assert np.isnan(np.asarray(jref.attention_ref(qb, kb, vb))[:, :4]).all()
    got = ops.flash_attention_gqa(*(torch.from_numpy(a) for a in (q, k, v)),
                                  block_q=4, block_k=4)
    np.testing.assert_allclose(_bh(got.numpy()), walk, rtol=1e-6, atol=1e-6)
    assert not np.any(np.abs(walk[:, :4]).sum(axis=-1) == 0)


# ---------------------------------------------------------------------------
# The CUDA flash kernel's tile walk, on the CPU
# ---------------------------------------------------------------------------
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as ``cvt.rna.tf32.f32``: round to nearest on a 10-bit
    mantissa, ties away from zero (add half of the 13 dropped bits to the
    magnitude, then clear them); inf stays inf."""
    b = x.float().contiguous().view(torch.int32)
    mag, sign = b & 0x7FFFFFFF, b & ~0x7FFFFFFF
    r = torch.where(mag < 0x7F800000, (mag + 0x1000) & ~0x1FFF, mag)
    return (r | sign).view(torch.float32)


def _split(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b as the kernels' tf32 products: three passes in their order
    (small*big, big*small, big*big) into one fp32 sum, or big*big alone."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    if passes == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def _bf16_pv(p: torch.Tensor, v: torch.Tensor, mode: str) -> torch.Tensor:
    """P V of bf16 V with fp32 accumulation, P as ``mode`` says."""
    hi = p.to(torch.bfloat16).float()
    if mode == "split":
        return (p - hi).to(torch.bfloat16).float() @ v + hi @ v
    return {"round": hi, "fp32": p}[mode] @ v


def _emulate_flash(q, k, v, g: kfa.FlashGeometry, passes: int = 3,
                   bf16_p: str = "split"):
    """Walk the kernel's CTAs with torch ops: block x of each (b, h) takes
    query tile ``g.tile_of_block(x)`` of ``g.bq`` rows (zero-filled past
    Sq) and the key tiles of ``g.bk`` keys that ``g.k_tiles`` names
    (zero-filled past Sk, where the scores are -inf), causal masking at
    the finite mask value, the online softmax in the kernel's order.  fp32
    products are tf32 passes (``passes``), P V with V^T's keys in
    ``kfa.key_order``; bf16 products are exact in fp32, and P V takes P
    as the kernel's bf16 pair hi + lo, lo first (``bf16_p="split"``), or
    rounded once to bf16 (``"round"``), or in fp32 as the TPU kernel
    keeps it (``"fp32"``).  Every output row must be written exactly
    once."""
    out = torch.full(q.shape, float("nan"))
    scale = torch.tensor(attention_scale(g.hd), dtype=torch.float32)
    diag, bq, bk = g.Sk - g.Sq, g.bq, g.bk
    f32 = g.dtype == torch.float32
    order = torch.tensor(kfa.key_order(bk))
    for b in range(g.B):
        for h in range(g.H):
            kvh = g.kv_head(h)
            for x in range(g.grid[0]):
                qi = g.tile_of_block(x)
                q0 = qi * bq
                n = min(bq, g.Sq - q0)
                Qt = torch.zeros(bq, g.hd)
                Qt[:n] = q[b, q0:q0 + n, h].float()
                rows = torch.arange(q0, q0 + bq)[:, None]
                m = torch.full((bq,), MASK_VALUE)
                l = torch.zeros(bq)
                acc = torch.zeros(bq, g.hd)
                for kt in range(g.k_tiles[qi]):
                    k0 = kt * bk
                    kn = min(bk, g.Sk - k0)
                    Kt, Vt = torch.zeros(bk, g.hd), torch.zeros(bk, g.hd)
                    Kt[:kn] = k[b, k0:k0 + kn, kvh].float()
                    Vt[:kn] = v[b, k0:k0 + kn, kvh].float()
                    s = _mm_tf32(Qt, Kt.T, passes) if f32 else Qt @ Kt.T
                    s = s * scale
                    j = torch.arange(bk)[None, :]
                    if g.causal:
                        s = torch.where(k0 + j > rows + diag,
                                        torch.tensor(MASK_VALUE), s)
                    s = torch.where(j >= kn, torch.tensor(-float("inf")), s)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    p = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = alpha * l + p.sum(dim=1)
                    m = m_new
                    if f32:
                        pv = _mm_tf32(p[:, order], Vt[order], passes)
                    else:
                        pv = _bf16_pv(p, Vt, bf16_p)
                    acc = acc * alpha[:, None] + pv
                l = torch.where(l == 0, torch.ones_like(l), l)
                o = acc / l[:, None]
                assert torch.isnan(out[b, q0:q0 + n, h]).all(), "overlap"
                out[b, q0:q0 + n, h] = o[:n]
    assert not torch.isnan(out).any(), "a query row was never written"
    return out


def _row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error over its row's scale (its largest |want|, at least
    the RMS of ``want``), as ``chip_smoke.py`` phase 8 measures."""
    g, w = got.float(), want.float()
    floor = max(float(w.square().mean().sqrt()), 1e-30)
    scale = w.abs().amax(dim=-1, keepdim=True).clamp(min=floor)
    return float(((g - w).abs() / scale).max())


# (B, Sq, Sk, H, KV, hd, causal)
FLASH_TILES = {
    "gqa4_ragged": (2, 100, 100, 8, 2, 32, True),
    "sq_gt_sk_ragged": (1, 150, 70, 2, 1, 16, True),
    "cross_ragged": (1, 70, 130, 4, 4, 80, False),
    "decode_like": (1, 64, 200, 4, 1, 48, True),
    "many_k_tiles": (1, 192, 320, 2, 2, 112, True),
}


@pytest.mark.parametrize("name", sorted(FLASH_TILES))
def test_flash_tile_walk_reproduces_attention(name):
    """The tile walk of both dtypes' kernels against the plain version:
    fp32 (3xTF32) within 1e-5, bf16 (P V on the bf16 pair) within phase
    8's 2e-2 of each row's scale."""
    B, Sq, Sk, H, KV, hd, causal = FLASH_TILES[name]
    q, k, v = (torch.from_numpy(a)
               for a in _attn_inputs(7, B, Sq, Sk, H, KV, hd))
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        g = kfa.plan_flash(q.shape, k.shape, causal=causal, dtype=dtype)
        assert g.grid == (-(-Sq // g.bq), B * H) == (len(g.k_tiles), B * H)
        assert g.smem <= kfa.SMEM_MAX
        if causal and Sq <= Sk and Sq > g.bq:
            assert g.k_tiles[0] < -(-Sk // g.bk)  # the skip really happens
        got = _emulate_flash(qd, kd, vd, g)
        want = attention_plain(qd.float(), kd.float(), vd.float(),
                               causal=causal)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)
        else:
            assert _row_rel_err(got, want) <= 2e-2


def _big_logit_inputs(hd, Sq=80, Sk=80):
    """Scores of a few units, so that one TF32 pass (about 3 digits) moves
    the softmax visibly."""
    q, k, v = _attn_inputs(14, 1, Sq, Sk, 2, 1, hd)
    return (torch.from_numpy(q * 6), torch.from_numpy(k * 6),
            torch.from_numpy(v))


@pytest.mark.parametrize("hd", range(16, 129, 16))
def test_flash_three_tf32_passes_hold_1e4_at_every_head_dim(hd):
    q, k, v = _big_logit_inputs(hd)
    g = kfa.plan_flash(q.shape, k.shape, causal=True)
    want = attention_plain(q, k, v, causal=True)
    assert _row_rel_err(_emulate_flash(q, k, v, g), want) <= 1e-4


def _load_chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    and the port's roofline constants at load), for phase 8's cases and
    its input recipe."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_CS = _load_chip_smoke()
PHASE8_FLASH = [c for c in _CS.SMALL_MIXERS
                if c["kernel"] == "flash_attention"]
PHASE8_SSD = [c for c in _CS.SMALL_MIXERS if c["kernel"] == "mamba2_ssd"]


def _phase8_args(case, dtype, seed):
    """Phase 8's inputs for ``case`` (``chip_smoke.mixer_inputs``), made
    on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return _CS.mixer_inputs(torch, case, dtype, gen, "cpu")


def _case_id(case):
    label = case["label"].replace(" ", "_").replace(">", "_gt_")
    return "-".join([label] + [str(case[k]) for k in (
        "Sq", "Sk", "hd", "T", "hp", "chunk") if k in case])


@pytest.mark.parametrize("case", PHASE8_FLASH, ids=_case_id)
def test_flash_one_tf32_pass_fails_1e4(case):
    """The fp32 check has teeth: on phase 8's own shapes and inputs, a
    kernel that runs one TF32 pass misses 1e-4 of a row's scale, three
    passes hold it."""
    q, k, v = _phase8_args(case, torch.float32, 21)
    g = kfa.plan_flash(q.shape, k.shape, causal=case["causal"])
    want = attention_plain(q, k, v, causal=case["causal"])
    assert _row_rel_err(_emulate_flash(q, k, v, g), want) <= 1e-4
    assert _row_rel_err(_emulate_flash(q, k, v, g, passes=1), want) > 1e-4


@pytest.mark.parametrize("case", PHASE8_FLASH, ids=_case_id)
def test_flash_bf16_p_pair_keeps_fp32_p_on_phase8_inputs(case):
    """bf16 P V takes P as a bf16 pair hi + lo: within 2e-5 of a row's
    scale (a thousandth of phase 8's 2e-2) of P V with the fp32 P of the
    TPU kernel.  One bf16 rounding of P would move it by more than 1e-3
    (about 2.5e-3, as much as storing the output in bf16), so the check
    that the pair is there has teeth."""
    q, k, v = _phase8_args(case, torch.bfloat16, 22)
    g = kfa.plan_flash(q.shape, k.shape, causal=case["causal"],
                       dtype=torch.bfloat16)
    fp32_p = _emulate_flash(q, k, v, g, bf16_p="fp32")
    assert _row_rel_err(_emulate_flash(q, k, v, g), fp32_p) <= 2e-5
    assert _row_rel_err(_emulate_flash(q, k, v, g, bf16_p="round"),
                        fp32_p) > 1e-3


@pytest.mark.parametrize("bits, want", [
    (0x3F800000, 0x3F800000),      # 1.0: already tf32
    (0x3F801000, 0x3F802000),      # a tie: away from zero
    (0xBF801000, 0xBF802000),      # the negative tie: away from zero
    (0x3F800FFF, 0x3F800000),      # below the tie: down
    (0x3FFFF000, 0x40000000),      # mantissa carry into the exponent
    (0x00000000, 0x00000000),      # +0
    (0x80000000, 0x80000000),      # -0 keeps its sign
    (0x00001000, 0x00002000),      # subnormal tie: away from zero
    (0x00000FFF, 0x00000000),      # subnormal below the tie: to zero
    (0x807FF000, 0x80800000),      # largest subnormal carries to normal
    (0x7F7FF000, 0x7F800000),      # above the largest tf32: inf
    (0x7F800000, 0x7F800000),      # inf stays inf
])
def test_tf32_rounding_edge_bit_patterns(bits, want):
    x = torch.tensor([np.uint32(bits).astype(np.int32)]).view(torch.float32)
    got = int(_tf32(x).view(torch.int32)[0]) & 0xFFFFFFFF
    assert got == want, hex(got)


def test_flash_key_order_matches_the_a_fragment():
    """fp32 P V: a thread's S accumulator holds columns (2t, 2t+1) of each
    8-key block, the tf32 A fragment takes k indices (t, t+4), and V^T is
    staged with key ``key_order[k]`` at k.  Built per lane as the kernel
    builds them, A @ V^T over the staged order equals P @ V."""
    bk, hd = kfa.BK[torch.float32], 16
    order = kfa.key_order(bk)
    assert sorted(order) == list(range(bk))
    rng = np.random.default_rng(15)
    P = rng.normal(size=(16, bk))
    V = rng.normal(size=(bk, hd))
    # the staged V^T: column k holds key order[k] (the kernel's stage loop)
    Vt = np.stack([V[order[kl]] for kl in range(bk)], axis=1)   # (hd, bk)
    A = np.full((16, bk), np.nan)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(bk // 8):
            # sacc[4j + q] = (g + 8 (q >> 1), 8j + 2t + (q & 1))
            sacc = [P[g + 8 * (q >> 1), 8 * j + 2 * t + (q & 1)]
                    for q in range(4)]
            frag = (sacc[0], sacc[2], sacc[1], sacc[3])   # the kernel's a0..3
            for (r, kk), val in zip(((g, t), (g + 8, t), (g, t + 4),
                                     (g + 8, t + 4)), frag):
                A[r, 8 * j + kk] = val
    assert not np.isnan(A).any()
    np.testing.assert_allclose(A @ Vt.T, P @ V, rtol=1e-12, atol=1e-12)


def test_flash_k_tiles_keep_every_visible_key():
    """For every query tile, the key tiles walked cover every key a row of
    the tile sees, and all keys when a row sees none; the blocks take
    every query tile once."""
    for dtype in (torch.float32, torch.bfloat16):
        for Sq, Sk in ((64, 64), (100, 100), (128, 2048), (2048, 2048),
                       (150, 70), (63, 65), (1, 300)):
            g = kfa.plan_flash((1, Sq, 1, 16), (1, Sk, 1, 16), causal=True,
                               dtype=dtype)
            for qi in range(g.q_tiles):
                rows = range(qi * g.bq, min((qi + 1) * g.bq, Sq))
                need = max(r + Sk - Sq for r in rows) + 1
                if min(rows) + Sk - Sq < 0:
                    need = Sk
                assert g.k_tiles[qi] * g.bk >= min(need, Sk)
                assert (g.k_tiles[qi] - 1) * g.bk < Sk
            assert sorted(g.tile_of_block(x) for x in range(g.grid[0])) \
                == list(range(g.q_tiles))


@pytest.mark.parametrize("module, function", [
    (kfa, "flash_attention_launch"), (kssd, "mamba2_ssd_launch"),
    (kwkv, "rwkv6_wkv_launch")])
def test_ctypes_signatures_match_the_cuda_entry_points(module, function):
    """Each wrapper declares as many arguments as its C entry point takes
    (the source is read here; nothing is compiled)."""
    import re
    from repro_torch.kernels import _build
    name = function.rsplit("_", 1)[0]
    src = (_build.CSRC / f"{name}.cu").read_text()
    decl = re.search(rf"\bint {function}\(([^)]*)\)", src)
    assert decl is not None and name in _build.SOURCES
    argtypes, _ = module._SIGNATURES[function]
    assert len(argtypes) == len(decl.group(1).split(","))


def test_flash_smem_fits_two_ctas_at_every_head_dim():
    """bf16 CTAs fit two an SM at every hd."""
    for hd in range(16, 129, 16):
        g = kfa.plan_flash((1, 64, 1, hd), (1, 64, 1, hd),
                           dtype=torch.bfloat16)
        assert 2 * (g.smem + 1024) <= 228 * 1024


def test_flash_fp32_smem_fits_one_cta_at_every_head_dim():
    """fp32 CTAs (Q, K and V^T in two TF32 halves, two sets of K and V^T)
    fit one an SM at every hd, within the opt-in limit."""
    for hd in range(16, 129, 16):
        g = kfa.plan_flash((1, 64, 1, hd), (1, 64, 1, hd))
        assert g.smem + 1024 <= 228 * 1024 and g.smem <= kfa.SMEM_MAX


def test_flash_tile_constants_are_the_kernels():
    """The planner's constants and shared-memory formula are the .cu's
    (read from the source here; on the card the wrapper asks the library
    for both on first load)."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention.cu").read_text()
    c = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
         for n in ("NVSLOT", "VPAD")}
    assert (c["NVSLOT"], c["VPAD"]) == (kfa.NVSLOT, kfa.VPAD)
    tiles = re.findall(r"struct Tile<(\w+)> \{([^}]*)\}", src)
    assert [t for t, _ in tiles] == ["float", "__nv_bfloat16"]
    for (_, body), dtype in zip(tiles, (torch.float32, torch.bfloat16)):
        got = dict(re.findall(r"static constexpr int (\w+) = (\d+);", body))
        assert tuple(int(got[n]) for n in ("BQ", "BK", "THREADS", "NKSLOT")) \
            == (kfa.BQ[dtype], kfa.BK[dtype], kfa.THREADS[dtype],
                kfa.NKSLOT[dtype])
        assert kfa.THREADS[dtype] == 128 * kfa.BQ[dtype] // 64
    assert kfa.tile_constants() == (64, 32, 128, 2, 128, 64, 256, 3, 2, 4)
    # Layout<T, HD>::BYTES for the served head dims
    assert kfa.smem_bytes(128, torch.float32) == 230400
    assert kfa.smem_bytes(112, torch.float32) == 201728
    assert kfa.smem_bytes(128, torch.bfloat16) == 114688


@pytest.mark.parametrize("mangled, label", [
    ("_ZN41_GLOBAL__N__0e17b1f8_9_conv2d_cu_56f0629719conv2d_dense_kernelI13"
     "__nv_bfloat16Li16EEEvPKT_S4_PKfPS2_NS_8ConvArgsE",
     "conv2d_dense_kernel<bf16,16>"),
    ("_ZN41_GLOBAL__N__0e17b1f8_9_conv2d_cu_56f0629722conv2d_dense_ws_kernel"
     "I13__nv_bfloat16Li256EEEvPKT_PKfPS2_NS_8ConvArgsE14CUtensorMap_stS9_",
     "conv2d_dense_ws_kernel<bf16,256>"),
    ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_23f0aea712flash_kernel"
     "IfLi8EEEvPKT_S3_S3_PS1_iiiifiPKi", "flash_kernel<fp32,8>"),
    ("_ZN46_GLOBAL__N__167659e0_13_mamba2_ssd_cu_b136e7bc15ssd_scan_kernelEP"
     "fPKfii", "ssd_scan_kernel"),
    ("_ZN12_GLOBAL__N_119conv2d_dense_kernelIfLi64EEEvPKT_",
     "conv2d_dense_kernel<fp32,64>"),
    ("not_mangled", "not_mangled"),
])
def test_kernel_labels_of_mangled_names(mangled, label):
    """``chip_smoke.py`` phase 2 finds the kernels it checks by these
    labels (nvcc names the anonymous namespace after the file)."""
    from repro_torch.kernels import _build
    assert _build.kernel_label(mangled) == label


def test_misaligned_cuda_views_raise_value_error():
    """The wrappers check alignment on the CUDA path through
    ``_build.check_aligned``; a view one element in breaks it."""
    from repro_torch.kernels import _build
    base = torch.zeros(4 * 64 + 1)
    _build.check_aligned("flash_attention", {"q": base[:64]}, kfa.ALIGN)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.check_aligned("flash_attention", {"q": base[1:65]}, kfa.ALIGN)


# ---------------------------------------------------------------------------
# The CUDA SSD kernels' three passes, on the CPU
# ---------------------------------------------------------------------------
def _cumsum_seq(dt_c, a):
    """cs over a chunk, (G, L) -> (G, L): c = c + dt * a one step at a time
    in fp32, as thread 0 of a pass-1 or pass-3 CTA computes it."""
    cs = torch.empty_like(dt_c)
    c = torch.zeros(dt_c.shape[0])
    for t in range(dt_c.shape[1]):
        c = c + dt_c[:, t] * a
        cs[:, t] = c
    return cs


def _scan_states(states, decay):
    """Pass 2 over (Bb*H, nc, E) states and (Bb*H, nc) decays, in place:
    each s_c becomes the state entering chunk c."""
    h = torch.zeros(states.shape[0], states.shape[2])
    for c in range(states.shape[1]):
        s_c = states[:, c].clone()
        states[:, c] = h
        h = h * decay[:, c, None] + s_c
    return states


def _emulate_ssd(x, dt, A, B, C, plan: kssd.SsdPlan, passes: int = 3):
    """The kernels' three passes with torch ops, each over its grid from
    ``plan`` (a pass-1 or pass-3 CTA per (chunk, b*h), batched over b*h
    here), states and decays through a scratch like the wrapper's: pass 1
    writes every s_c and exp(cs_L), pass 2 scans them in place, pass 3
    reads the entering state.  Products are tf32 passes (``passes``)."""
    Bb, T, H, hp = x.shape
    ds, L = plan.ds, plan.L
    nc, G = plan.grid
    assert (nc, G) == (T // L, Bb * H) and plan.scan_grid[1] == G
    assert plan.scan_blocks * plan.scan_threads >= hp * ds
    f = lambda t: t.float().transpose(1, 2).reshape(G, T, *t.shape[3:])
    xs, Bs, Cs = f(x), f(B), f(C)
    dts = dt.float().transpose(1, 2).reshape(G, T)
    a = A.float().repeat(Bb)
    states = torch.full((plan.state_floats,), float("nan"))
    decay = torch.full((G * nc,), float("nan"))
    st, dc = states.view(G, nc, hp, ds), decay.view(G, nc)
    mm = functools.partial(_mm_tf32, passes=passes)
    for c in range(nc):                                    # pass 1
        sl = slice(c * L, (c + 1) * L)
        cs = _cumsum_seq(dts[:, sl], a)
        w = torch.exp(cs[:, -1:] - cs) * dts[:, sl]
        st[:, c] = mm((xs[:, sl] * w[..., None]).transpose(1, 2), Bs[:, sl])
        dc[:, c] = torch.exp(cs[:, -1])
    _scan_states(st.view(G, nc, hp * ds), dc)              # pass 2
    y = torch.full((G, T, hp), float("nan"))
    below = torch.tril(torch.ones(L, L, dtype=torch.bool))
    for c in range(nc):                                    # pass 3
        sl = slice(c * L, (c + 1) * L)
        cs = _cumsum_seq(dts[:, sl], a)
        att = torch.where(below, mm(Cs[:, sl], Bs[:, sl].transpose(1, 2))
                          * torch.exp(cs[:, :, None] - cs[:, None, :]),
                          torch.zeros(()))
        xd = xs[:, sl] * dts[:, sl, None]
        y[:, sl] = mm(att, xd) + torch.exp(cs)[..., None] * mm(
            Cs[:, sl], st[:, c].transpose(1, 2))
    assert not torch.isnan(y).any()
    return y.reshape(Bb, H, T, hp).transpose(1, 2).to(x.dtype)


# (b, t, h, hp, ds, chunk)
SSD_TILES = {
    "zamba2_head_widths": (1, 128, 2, 64, 64, 64),
    "sweep_small": (2, 96, 2, 16, 8, 32),
    "multi_tile": (1, 192, 1, 80, 72, 96),
}


@pytest.mark.parametrize("name", sorted(SSD_TILES))
def test_ssd_chunk_walk_reproduces_plain(name):
    """The three passes, fp32 and bf16 storage, against the plain version
    on the same stored values: within 1e-5 of scale in fp32, and of the
    bf16 output's own rounding (8e-3) in bf16."""
    b, t, h, hp, ds, chunk = SSD_TILES[name]
    arrays = [torch.from_numpy(a) for a in _ssd_inputs(8, b, t, h, hp, ds)]
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, B, C = (a if i == 2 else a.to(dtype)
                          for i, a in enumerate(arrays))
        plan = kssd.plan_ssd(b, t, h, hp, ds, chunk, dtype)
        got = _emulate_ssd(x, dt, A, B, C, plan).float()
        want = mamba2_ssd_plain(x.float(), dt.float(), A, B.float(),
                                C.float(), chunk=chunk)
        scale = max(1.0, float(want.abs().max()))
        tol = 1e-5 if dtype == torch.float32 else 8e-3
        assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("case", PHASE8_SSD, ids=_case_id)
def test_ssd_one_tf32_pass_fails_2e4(case):
    """Phase 8's SSD check has teeth: on its inputs and shapes (ragged T
    padded as ops pads it), the three passes hold its 2e-4 of a row's
    scale and an SSD with one TF32 pass a product misses it."""
    x, dt, A, B, C = _phase8_args(case, torch.float32, 23)
    L, t = case["chunk"], case["T"]
    padded = [pad_time(a, L) for a in (x, dt)] + [A] + [
        pad_time(a, L) for a in (B, C)]
    plan = kssd.plan_ssd(case["B"], padded[0].shape[1], case["H"],
                         case["hp"], case["ds"], L)
    want = mamba2_ssd_plain(x, dt, A, B, C, chunk=L)
    three = _emulate_ssd(*padded, plan)[:, :t]
    one = _emulate_ssd(*padded, plan, passes=1)[:, :t]
    assert _row_rel_err(three, want) <= 2e-4 < _row_rel_err(one, want)


# (seed, b, t, h, hp, ds, chunk); ragged T is padded as ops pads it
SSD_ORACLE = [(16, 2, 128, 2, 16, 8, 32), (17, 1, 64, 4, 32, 16, 64),
              (18, 2, 50, 2, 16, 8, 32), (19, 1, 77, 3, 32, 16, 16)]


@pytest.mark.parametrize("case", SSD_ORACLE, ids=str)
def test_ssd_three_passes_match_the_plain_version_and_the_jax_oracle(case):
    seed, b, t, h, hp, ds, chunk = case
    arrays = _ssd_inputs(seed, b, t, h, hp, ds)
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrays)
    padded = [pad_time(a, chunk) for a in (x, dt)] + [A] + [
        pad_time(a, chunk) for a in (B, C)]
    plan = kssd.plan_ssd(b, padded[0].shape[1], h, hp, ds, chunk)
    got = _emulate_ssd(*padded, plan)[:, :t]
    plain = mamba2_ssd_plain(x, dt, A, B, C, chunk=chunk)
    scale = max(1.0, float(plain.abs().max()))
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    want, _ = jref.mamba2_ssd_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_ssd_tol("fp32"))


def test_ssd_scan_equals_the_per_chunk_update_step_by_step():
    """Pass 2 is the TPU kernel's update h = h * exp(cs_L) + s_c in its
    order: from the same contributions, the state entering each chunk is
    bitwise the state the plain version's chunk loop carries there."""
    b, t, h, hp, ds, L = 2, 256, 3, 16, 8, 32
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _ssd_inputs(20, b, t, h, hp, ds))
    la = dt * A
    hstate = torch.zeros(b, h, hp, ds)
    contrib, decays, carried = [], [], []
    for c0 in range(0, t, L):
        sl = slice(c0, c0 + L)
        cs = torch.cumsum(la[:, sl], dim=1)
        w_u = torch.exp(cs[:, -1:] - cs) * dt[:, sl]
        s_c = torch.einsum("buhp,buhn->bhpn", x[:, sl] * w_u[..., None],
                           B[:, sl])
        d_c = torch.exp(cs[:, -1])
        carried.append(hstate)
        hstate = hstate * d_c[..., None, None] + s_c      # the plain loop
        contrib.append(s_c)
        decays.append(d_c)
    states = torch.stack(contrib, dim=2).reshape(b * h, t // L, hp * ds)
    decay = torch.stack(decays, dim=2).reshape(b * h, t // L)
    _scan_states(states, decay)
    for c, want in enumerate(carried):
        assert torch.equal(states[:, c], want.reshape(b * h, hp * ds))


def _mma_owners(M: int, N: int):
    """(warp, rows, cols) for each of the SSD kernels' 4 warps: 16-row
    strips m0 = 16 * warp + 64 i, 64-column groups, 8-column mma blocks
    (the blocks past N re-read the last block and are never stored)."""
    for warp in range(4):
        for m0 in range(16 * warp, M, 64):
            for n0 in range(0, N, 64):
                for nb in range(min(8, (N - n0) // 8)):
                    yield warp, range(m0, m0 + 16), range(n0 + 8 * nb,
                                                          n0 + 8 * nb + 8)


@pytest.mark.parametrize("dims", [(64, 64), (96, 80), (80, 72), (32, 8),
                                  (256, 64)])
def test_ssd_product_tiles_cover_each_output_once(dims):
    """Each product the kernels form -- (hp, ds), (L, L), (L, hp) -- is
    written once per element, multi-strip and multi-group shapes
    included."""
    M, N = dims
    hits = np.zeros((M, N), np.int64)
    for _, rows, cols in _mma_owners(M, N):
        hits[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (hits == 1).all()


def test_ssd_plan_shared_memory():
    p = kssd.plan_ssd(2, 2048, 112, 64, 64, 64)   # Zamba2-7B's widths
    assert p.params() == [getattr(p, f) for f in kssd.PARAM_FIELDS]
    assert (p.grid, p.scan_grid) == ((32, 224), (16, 224))
    assert (p.ldx1 % 32, p.ldb1 % 32, p.ldx3 % 32) == (8, 8, 8)
    assert (p.ldc3 % 32, p.ldb3 % 32, p.lda3 % 32, p.ldh3 % 32) == (4,) * 4
    assert p.smem1 == 4 * (64 * 72 * 2 + 2 * 64)
    assert p.att_over_b and p.off_a3 == p.off_b3       # att over B
    assert p.smem3 == 4 * (64 * 68 * 3 + 64 * 72 + 3 * 64)
    assert 3 * (p.smem3 + 1024) <= 228 * 1024             # 3 CTAs an SM
    assert p.state_bytes == 2 * 112 * 32 * 64 * 64 * 4     # 117 MB
    pb = kssd.plan_ssd(2, 2048, 112, 64, 64, 64, torch.bfloat16)
    assert (pb.ldx1 % 64, pb.ldb1 % 64, pb.ldx3 % 64) == (16, 16, 16)
    assert (pb.ldc3 % 64, pb.ldb3 % 64) == (8, 8)
    assert (pb.lda3, pb.ldh3) == (p.lda3, p.ldh3)        # fp32 tiles
    assert not pb.att_over_b                # B's bf16 tile is too small
    assert 3 * (pb.smem3 + 1024) <= 228 * 1024            # 3 CTAs an SM
    for q in (p, pb):                                     # 16-byte copies
        assert all(getattr(q, f) % 16 == 0 for f in kssd.PARAM_FIELDS
                   if f.startswith("off_"))
    big = kssd.plan_ssd(1, 128, 1, 64, 64, 128)
    assert not big.att_over_b and big.smem3 <= kssd.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        kssd.plan_ssd(1, 512, 1, 64, 64, 512)
    with pytest.raises(ValueError):
        kssd.plan_ssd(0, 64, 1, 64, 64, 64)


@pytest.mark.parametrize("hp, ds, chunk", [(24, 8, 32), (16, 12, 32),
                                           (16, 8, 24), (16, 8, 40)])
def test_ssd_plan_refuses_partial_mma_tiles(hp, ds, chunk):
    with pytest.raises(ValueError, match="whole mma tiles|multiple of"):
        kssd.plan_ssd(1, 2 * chunk, 1, hp, ds, chunk)


def test_ssd_param_fields_match_the_cuda_enum():
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "mamba2_ssd.cu").read_text()
    body = re.search(r"enum Param \{([^}]*)\}", src).group(1)
    names = [t.strip() for t in body.split(",") if t.strip()]
    assert names == [f"P_{f.upper()}" for f in kssd.PARAM_FIELDS] \
        + ["P_COUNT"]
    threads = re.search(r"constexpr int THREADS = (\d+);", src).group(1)
    assert int(threads) == kssd.THREADS
    fields = re.search(r"struct SsdArgs \{([^}]*)\}", src).group(1)
    assert [t.strip() for t in fields.replace("int", "", 1)
            .replace(";", "").split(",")] == list(kssd.PARAM_FIELDS)


# ---------------------------------------------------------------------------
# The CUDA WKV kernel's geometry, on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", kwkv.HEAD_DIMS)
def test_wkv_plan_fits_and_covers_every_column_once(hd, dtype):
    """The default plan at every head dim: shared memory within a CTA's
    227 KB and two CTAs an SM, whole warps, and a grid whose blocks take
    each (b, h, column) once, the lanes of a column each of its rows
    once."""
    B, H = 2, 3
    p = kwkv.plan_wkv(B, 100, H, hd, _TDT[dtype])
    assert p.smem <= 227 * 1024 and p.ctas_per_sm >= 2
    assert 2 * (p.smem + 1024) <= 228 * 1024
    assert p.threads % 32 == 0 and p.threads <= kwkv.MAX_THREADS
    assert p.jc * p.esize % 16 == 0 and p.stages >= 2
    cover = np.zeros((B, H, hd), dtype=int)
    for x in range(p.grid):
        b, h, j0 = p.block(x)
        cover[b, h, j0:j0 + p.jc] += 1
    assert (cover == 1).all()
    # the CTAs of one head are adjacent (they share r, k and w in L2)
    assert [p.block(x)[:2] for x in range(p.col_blocks)] == [(0, 0)] * \
        p.col_blocks
    rows = sorted(i for q in range(p.lanes) for i in p.rows_of(q))
    assert rows == list(range(hd))
    assert p.jc % p.cols == 0


@pytest.mark.parametrize("shape, geometry, match", [
    ((1, 8, 2, 48), {}, "head dims"),
    ((1, 8, 2, 8), {}, "head dims"),
    ((1, 8, 2, 256), {}, "head dims"),
    ((1, 8, 2, 64), dict(jc=24), "columns a CTA"),
    ((1, 8, 2, 64), dict(jc=2), "columns a CTA"),
    ((1, 8, 2, 64), dict(jc=6), "columns a CTA"),
    ((1, 8, 2, 64), dict(jc=128), "columns a CTA"),
    ((1, 8, 2, 64), dict(jc=4), "whole warps"),
    ((1, 8, 2, 128), dict(jc=128), "whole warps"),
    ((1, 8, 2, 64), dict(stages=5), "stages"),
    ((1, 8, 2, 64), dict(stages=1), "stages"),
    ((1, 8, 2, 64), dict(steps=0), "stages"),
    ((1, 8, 2, 64), dict(steps=64), "two CTAs an SM"),
])
def test_wkv_plan_refuses_what_the_kernel_does_not_take(shape, geometry,
                                                        match, monkeypatch):
    """Head dims the kernel is not built for, and run-time geometries (as
    ``scripts/wkv_sweep.py`` sets them in ``DEFAULTS``) it does not take
    with the fp32 tile."""
    if geometry:
        _set_wkv_defaults(monkeypatch, shape[3], torch.float32, **geometry)
    with pytest.raises(ValueError, match=match):
        kwkv.plan_wkv(*shape)


def _set_wkv_defaults(monkeypatch, hd, dtype, **geometry):
    key = (hd, dtype)
    given = dict(zip(("jc", "steps", "stages"), kwkv.DEFAULTS[key]))
    given.update(geometry)
    monkeypatch.setitem(kwkv.DEFAULTS, key, tuple(given.values()))


def test_wkv_plan_bf16_needs_sixteen_byte_column_runs(monkeypatch):
    """Four columns a CTA are 16 bytes of fp32 (refused only for its
    threads) but 8 of bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        _set_wkv_defaults(monkeypatch, 128, dtype, jc=4)
    with pytest.raises(ValueError, match="whole warps"):
        kwkv.plan_wkv(1, 8, 2, 128, torch.float32)
    with pytest.raises(ValueError, match="16-byte runs"):
        kwkv.plan_wkv(1, 8, 2, 128, torch.bfloat16)


def test_wkv_tiles_match_the_cuda_table():
    """The tile a thread holds is compiled per (hd, dtype): the Python
    ``TILES`` and the CUDA source's table agree, at every head dim."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "rwkv6_wkv.cu").read_text()
    body = re.search(r"constexpr int TILES\[4\]\[5\] = \{(.*?)\};", src,
                     re.S).group(1)
    table = {}
    for hd, rf, cf, rb, cb in (map(int, row.split(",")) for row in
                               re.findall(r"\{([^{}]*)\}", body)):
        table[hd, torch.float32] = (rf, cf)
        table[hd, torch.bfloat16] = (rb, cb)
    assert table == kwkv.TILES
    assert set(kwkv.DEFAULTS) == set(kwkv.TILES) == {
        (hd, d) for hd in kwkv.HEAD_DIMS for d in kwkv.ESIZE}


def _wkv_walk(plan, r, k, v, w, u):
    """The CUDA kernel's walk in torch ops: per column block, stages of
    ``plan.steps`` steps staged in the stored dtype and widened (the last
    one partial: only its steps before T run); the bonus factored out, so
    each lane sums r_i S_ij over its rows of a column into two
    accumulators (even and odd rows of each float4 chunk, chunk by chunk,
    then added), the lanes' partials are added after the stage, lane 0
    first, and v_j sum_i r_i u_i k_i is added last; out in r's dtype."""
    B, T, H, hd = r.shape
    nm, lanes, jc = plan.rows // 4, plan.lanes, plan.jc
    out = torch.zeros(B, T, H, hd, dtype=torch.float32)
    uf = u.float()[None]
    for x in range(plan.col_blocks):
        j0 = x * jc
        S = torch.zeros(B, H, hd, jc)
        for s in range(plan.n_stages):
            t0 = s * plan.steps
            # the ring slot: steps past T are zero-filled, and never run
            slot = [torch.zeros(B, plan.steps, H, n, dtype=r.dtype)
                    for n in (hd, hd, hd, jc)]
            tn = min(plan.steps, T - t0)
            for dst, src in zip(slot, (r, k, w, v[..., j0:j0 + jc])):
                dst[:, :tn] = src[:, t0:t0 + tn]
            rs, ks, ws, vs = (a.float() for a in slot)
            for tt in range(tn):
                c = rs[:, tt, :, :, None] * S
                S = S * ws[:, tt, :, :, None] + (ks[:, tt, :, :, None]
                                                 * vs[:, tt, :, None, :])
                # row i = 4 (q + lanes m) + e  ->  (m, q, e)
                c = c.reshape(B, H, nm, lanes, 4, jc)
                acc = [c[:, :, 0, :, 0], c[:, :, 0, :, 1]]
                for m in range(nm):
                    for e in range(2 if m == 0 else 0, 4):
                        acc[e % 2] = acc[e % 2] + c[:, :, m, :, e]
                part = acc[0] + acc[1]                  # (B, H, lanes, jc)
                o = torch.zeros(B, H, jc)
                for q in range(lanes):
                    o = o + part[:, :, q]
                bonus = (rs[:, tt] * uf * ks[:, tt]).sum(-1)     # (B, H)
                out[:, t0 + tt, :, j0:j0 + jc] = \
                    o + bonus[..., None] * vs[:, tt]
    return out.to(r.dtype)


# (B, T, H, hd): T inside one stage, T not a multiple of the steps, and
# phase 7's T = 2000, at RWKV6's hd and small B*H; then phase 8's small
# WKV shapes (test_kernels.py's sweep and its ragged T)
WKV_WALK = [(2, 5, 2, 64), (1, 75, 2, 64), (1, 2000, 1, 64),
            (2, 128, 2, 32), (1, 96, 4, 64), (3, 64, 1, 16), (1, 50, 2, 16)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WKV_WALK, ids=str)
def test_wkv_column_walk_reproduces_plain_and_the_jax_oracle(case, dtype):
    """The walk agrees with the plain version and the JAX reference (the
    TPU body's form) at ``test_kernels.py``'s tolerance, and in fp32 the
    factored bonus stays within 1e-4 of each row's scale, phase 8's
    limit, on phase 8's input distributions."""
    B, T, H, hd = case
    plan = kwkv.plan_wkv(B, T, H, hd, _TDT[dtype])
    arrays = _wkv_inputs(20, B, T, H, hd)
    pairs = [_pair(a, dtype) for a in arrays]
    got = _wkv_walk(plan, *(p for _, p in pairs))
    plain = kwkv.rwkv6_wkv(*(p for _, p in pairs))
    want, _ = jref.rwkv6_wkv_ref(*(j for j, _ in pairs))
    assert got.dtype == _TDT[dtype] and got.shape == (B, T, H, hd)
    np.testing.assert_allclose(_np(got), _np(plain), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    if dtype == "fp32":
        assert _row_rel_err(got, torch.from_numpy(_np(want))) <= 1e-4


def test_wkv_walk_cases_cover_short_and_ragged_stages():
    steps = kwkv.plan_wkv(1, 8, 1, 64).steps
    assert WKV_WALK[0][1] < steps and WKV_WALK[1][1] % steps
    assert WKV_WALK[2][1] == 2000


# ---------------------------------------------------------------------------
# The CPU path at head dims the CUDA kernels do not take
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", [8, 24, 160])
def test_cpu_flash_takes_any_head_dim(hd):
    """The plain version computes what the reference computes at head
    dims ``plan_flash`` refuses (it refuses them on the CUDA path only)."""
    q, k, v = _attn_inputs(21, 1, 64, 64, 2, 2, hd)
    got = ops.flash_attention_gqa(*(torch.from_numpy(a) for a in (q, k, v)),
                                  block_q=64, block_k=64)
    want = jref.attention_ref(*(jnp.asarray(_bh(a)) for a in (q, k, v)))
    np.testing.assert_allclose(_bh(got.numpy()), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="multiple of 16"):
        kfa.plan_flash(q.shape, k.shape)


@pytest.mark.parametrize("hd", [8, 48])
def test_cpu_wkv_takes_any_head_dim(hd):
    arrays = _wkv_inputs(22, 1, 32, 2, hd)
    got = ops.rwkv6_wkv(*(torch.from_numpy(a) for a in arrays), block_t=32)
    want, _ = jref.rwkv6_wkv_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="head dims"):
        kwkv.plan_wkv(1, 32, 2, hd)


# ---------------------------------------------------------------------------
# ops-level padding, GQA and argument checks
# ---------------------------------------------------------------------------
def test_wkv_padding_leaves_the_first_t_steps_alone():
    r, k, v, w, u = (torch.from_numpy(a) for a in _wkv_inputs(9, 1, 50, 2, 16))
    padded = ops.rwkv6_wkv(r, k, v, w, u, block_t=32)      # pads to 64
    assert padded.shape == (1, 50, 2, 16)
    assert torch.equal(padded, ops.rwkv6_wkv(r, k, v, w, u, block_t=1))
    want, _ = jref.rwkv6_wkv_ref(*(jnp.asarray(a.numpy())
                                   for a in (r, k, v, w, u)))
    np.testing.assert_allclose(padded.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_ssd_ragged_t_against_the_token_oracle():
    x, dt, A, B, C = _ssd_inputs(10, 2, 50, 3, 16, 8)
    got = ops.mamba2_ssd(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                         chunk=32)
    assert got.shape == (2, 50, 3, 16)
    want, _ = jref.mamba2_ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, B, C)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # the chunk's padding is the plain version's own: same numbers
    same = mamba2_ssd_plain(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                            chunk=32)
    assert torch.equal(got, same)


def test_gqa_four_query_heads_per_kv_head():
    B, S, H, KV, hd = 2, 64, 8, 2, 32
    q, k, v = _attn_inputs(11, B, S, S, H, KV, hd)
    got = ops.flash_attention_gqa(*(torch.from_numpy(a) for a in (q, k, v)),
                                  block_q=32, block_k=32)
    kr, vr = np.repeat(k, H // KV, axis=2), np.repeat(v, H // KV, axis=2)
    want = jref.attention_ref(*(jnp.asarray(_bh(a)) for a in (q, kr, vr)))
    np.testing.assert_allclose(_bh(got.numpy()), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_ops_refuse_what_the_jax_wrappers_refuse():
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(12, 1, 96, 96, 2, 1,
                                                         32))
    with pytest.raises(ValueError):
        ops.flash_attention_gqa(q, k, v)              # 96 % 128
    with pytest.raises(ValueError):
        ops.flash_attention_gqa(q, k, v, block_q=64, block_k=32)
    ops.flash_attention_gqa(q, k, v, block_q=32, block_k=96)
    with pytest.raises(ValueError):                   # H % KV
        ops.flash_attention_gqa(q[:, :, :1].contiguous(),
                                torch.zeros(1, 96, 2, 32),
                                torch.zeros(1, 96, 2, 32), block_q=32,
                                block_k=32)


def test_wrappers_reject_inputs_the_kernels_do_not_take():
    q = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError):                   # hd not a multiple of 16
        kfa.plan_flash((1, 64, 2, 24), (1, 64, 2, 24))
    with pytest.raises(TypeError):
        kfa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(TypeError):
        kfa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        kfa.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        kfa.flash_attention(*(torch.zeros(1, 64, 2, 32, device="meta"),) * 3)
    r = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        kwkv.rwkv6_wkv(r, r, r, r, torch.zeros(3, 16))
    with pytest.raises(ValueError):                   # hd 48: no kernel
        kwkv.plan_wkv(1, 8, 2, 48)
    x, dt = torch.zeros(1, 64, 2, 16), torch.zeros(1, 64, 2)
    bc, A = torch.zeros(1, 64, 2, 8), torch.zeros(2)
    with pytest.raises(ValueError):                   # T % chunk
        kssd.mamba2_ssd(x, dt, A, bc, bc, chunk=48)
    with pytest.raises(ValueError):
        kssd.mamba2_ssd(x, dt, torch.zeros(3), bc, bc)
    with pytest.raises(ValueError):
        ops.mamba2_ssd(x, dt, A, bc, bc, chunk=0)
    with pytest.raises(ValueError):
        ops.rwkv6_wkv(r, r, r, r, torch.zeros(2, 16), block_t=0)


def test_cpu_calls_never_count_launches():
    before = launches.snapshot()
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(13, 1, 64, 64, 2, 2,
                                                         16))
    ops.flash_attention_gqa(q, k, v, block_q=64, block_k=64)
    ops.rwkv6_wkv(*(torch.from_numpy(a) for a in _wkv_inputs(13, 1, 8, 1, 16)))
    ops.mamba2_ssd(*(torch.from_numpy(a)
                     for a in _ssd_inputs(13, 1, 16, 1, 8, 4)), chunk=8)
    assert launches.snapshot() == before
    assert {"flash_attention", "rwkv6_wkv", "mamba2_ssd"} <= set(before)


def test_ops_reexports_every_kernel():
    from repro_torch.kernels import conv2d, quant
    assert ops.conv2d is conv2d.conv2d
    assert ops.quantize_boundary is quant.quantize_boundary
    assert ops.dequantize_boundary is quant.dequantize_boundary
    assert ops.boundary_roundtrip is quant.boundary_roundtrip


# ---------------------------------------------------------------------------
# Configs: the widths the card runs come from copies of the JAX configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen3-4b", "rwkv6-7b", "zamba2-7b"])
def test_port_configs_equal_the_jax_configs(name):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    j, t = jget(name), tget(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.hd, t.n_mamba_heads) == (j.hd, j.n_mamba_heads)


def test_mixer_widths_of_the_three_configs():
    from repro.models.layers import RWKV_HD
    from repro_torch.configs import get_config
    qwen, rwkv, zamba = (get_config(n) for n in ("qwen3-4b", "rwkv6-7b",
                                                 "zamba2-7b"))
    assert (qwen.num_heads, qwen.num_kv_heads, qwen.hd) == (32, 8, 128)
    assert (zamba.num_heads, zamba.num_kv_heads, zamba.hd) == (32, 32, 112)
    inner = zamba.ssm_expand * zamba.d_model
    assert (zamba.d_model, inner, zamba.n_mamba_heads,
            inner // zamba.n_mamba_heads, zamba.ssm_state,
            zamba.ssm_groups) == (3584, 7168, 112, 64, 64, 8)
    assert kwkv.RWKV_HD == RWKV_HD == 64
    assert (rwkv.d_model, rwkv.d_model // kwkv.RWKV_HD) == (4096, 64)
    assert kwkv.RWKV_HD in kwkv.HEAD_DIMS
    for g in (kfa.plan_flash((2, 2048, qwen.num_heads, qwen.hd),
                             (2, 2048, qwen.num_kv_heads, qwen.hd)),
              kfa.plan_flash((2, 2048, zamba.num_heads, zamba.hd),
                             (2, 2048, zamba.num_kv_heads, zamba.hd))):
        assert g.smem <= kfa.SMEM_MAX
    kssd.plan_ssd(2, 2048, zamba.n_mamba_heads, inner // zamba.n_mamba_heads,
                  zamba.ssm_state, 64)
