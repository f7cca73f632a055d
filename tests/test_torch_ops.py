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
  walk and product tiles.
* ``ops``-level padding, GQA and argument checks; the configs the widths
  come from."""
import dataclasses

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
                                     mamba2_ssd_plain)

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
def _emulate_flash(q, k, v, g: kfa.FlashGeometry):
    """Walk the kernel's CTAs with torch ops: per (b, h, query tile) stage
    the (zero-filled) Q tile, then the key tiles ``g.k_tiles`` names, with
    keys past Sk at -inf, causal masking at the finite mask value, and the
    online softmax in the kernel's order.  Every output row must be
    written exactly once."""
    out = torch.full(q.shape, float("nan"))
    scale = torch.tensor(attention_scale(g.hd), dtype=torch.float32)
    diag = g.Sk - g.Sq
    for b in range(g.B):
        for h in range(g.H):
            kvh = g.kv_head(h)
            for qi in range(g.q_tiles):
                q0 = qi * kfa.BQ
                n = min(kfa.BQ, g.Sq - q0)
                Qt = torch.zeros(kfa.BQ, g.hd)
                Qt[:n] = q[b, q0:q0 + n, h]
                rows = torch.arange(q0, q0 + kfa.BQ)[:, None]
                m = torch.full((kfa.BQ,), MASK_VALUE)
                l = torch.zeros(kfa.BQ)
                acc = torch.zeros(kfa.BQ, g.hd)
                for kt in range(g.k_tiles[qi]):
                    k0 = kt * kfa.BK
                    kn = min(kfa.BK, g.Sk - k0)
                    Kt, Vt = torch.zeros(kfa.BK, g.hd), torch.zeros(kfa.BK,
                                                                     g.hd)
                    Kt[:kn] = k[b, k0:k0 + kn, kvh]
                    Vt[:kn] = v[b, k0:k0 + kn, kvh]
                    s = (Qt @ Kt.T) * scale
                    j = torch.arange(kfa.BK)[None, :]
                    if g.causal:
                        s = torch.where(k0 + j > rows + diag,
                                        torch.tensor(MASK_VALUE), s)
                    s = torch.where(j >= kn, torch.tensor(-float("inf")), s)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    p = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = alpha * l + p.sum(dim=1)
                    m = m_new
                    acc = acc * alpha[:, None] + p @ Vt
                l = torch.where(l == 0, torch.ones_like(l), l)
                o = acc / l[:, None]
                assert torch.isnan(out[b, q0:q0 + n, h]).all(), "overlap"
                out[b, q0:q0 + n, h] = o[:n]
    assert not torch.isnan(out).any(), "a query row was never written"
    return out


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
    B, Sq, Sk, H, KV, hd, causal = FLASH_TILES[name]
    q, k, v = (torch.from_numpy(a)
               for a in _attn_inputs(7, B, Sq, Sk, H, KV, hd))
    g = kfa.plan_flash(q.shape, k.shape, causal=causal)
    assert g.grid == (-(-Sq // kfa.BQ), B * H) == (len(g.k_tiles), B * H)
    assert g.smem <= kfa.SMEM_MAX
    if causal and Sq <= Sk and Sq > kfa.BQ:
        assert g.k_tiles[0] < -(-Sk // kfa.BK)   # the skip really happens
    got = _emulate_flash(q, k, v, g)
    want = attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_k_tiles_keep_every_visible_key():
    """For every query tile, the key tiles walked cover every key a row of
    the tile sees, and all keys when a row sees none."""
    for Sq, Sk in ((64, 64), (100, 100), (128, 2048), (2048, 2048),
                   (150, 70), (63, 65), (1, 300)):
        g = kfa.plan_flash((1, Sq, 1, 16), (1, Sk, 1, 16), causal=True)
        for qi in range(g.q_tiles):
            rows = range(qi * kfa.BQ, min((qi + 1) * kfa.BQ, Sq))
            need = max(r + Sk - Sq for r in rows) + 1
            if min(rows) + Sk - Sq < 0:
                need = Sk
            assert g.k_tiles[qi] * kfa.BK >= min(need, Sk)
            assert (g.k_tiles[qi] - 1) * kfa.BK < Sk


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
    for hd in range(16, 129, 16):
        g = kfa.plan_flash((1, 64, 1, hd), (1, 64, 1, hd))
        assert 2 * (g.smem + 1024) <= 228 * 1024


# ---------------------------------------------------------------------------
# The CUDA SSD kernel's chunk walk, on the CPU
# ---------------------------------------------------------------------------
def _emulate_ssd(x, dt, A, B, C, plan: kssd.SsdPlan):
    """Walk the kernel's CTAs with torch ops: per (b, h) the chunks in
    order, the cumsum one step at a time, the decay selected before it
    multiplies, y = intra + exp(cs) * inter, then the state update."""
    Bb, T, H, hp = x.shape
    L = plan.chunk
    y = torch.full(x.shape, float("nan"))
    below = torch.tril(torch.ones(L, L, dtype=torch.bool))
    for b in range(Bb):
        for h in range(H):
            hs = torch.zeros(plan.hp, plan.ds)
            for t0 in range(0, T, L):
                sl = slice(t0, t0 + L)
                xs, dts = x[b, sl, h].float(), dt[b, sl, h].float()
                Bs, Cs = B[b, sl, h].float(), C[b, sl, h].float()
                cs = torch.empty(L)
                c = torch.tensor(0.0)
                for t in range(L):
                    c = c + dts[t] * A[h].float()
                    cs[t] = c
                ecs = torch.exp(cs)
                wts = torch.exp(cs[-1] - cs) * dts
                cb = Cs @ Bs.T
                decay = torch.exp(cs[:, None] - cs[None])
                att = torch.where(below, cb * decay, torch.zeros(()))
                yi = att @ (xs * dts[:, None])
                out = yi + ecs[:, None] * (Cs @ hs.T)
                assert torch.isnan(y[b, t0:t0 + L, h]).all()
                y[b, t0:t0 + L, h] = out
                hs = hs * torch.exp(cs[-1]) + (xs * wts[:, None]).T @ Bs
    assert not torch.isnan(y).any()
    return y


# (b, t, h, hp, ds, chunk)
SSD_TILES = {
    "zamba2_head_widths": (1, 128, 2, 64, 64, 64),
    "sweep_small": (2, 96, 2, 16, 8, 32),
    "multi_tile": (1, 192, 1, 80, 72, 96),
}


@pytest.mark.parametrize("name", sorted(SSD_TILES))
def test_ssd_chunk_walk_reproduces_plain(name):
    b, t, h, hp, ds, chunk = SSD_TILES[name]
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _ssd_inputs(8, b, t, h, hp, ds))
    plan = kssd.plan_ssd(hp, ds, chunk)
    got = _emulate_ssd(x, dt, A, B, C, plan)
    want = mamba2_ssd_plain(x, dt, A, B, C, chunk=chunk)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


def _tile_owners(M: int, N: int):
    """(thread, rows, cols) for each of the SSD kernel's 256 threads and
    64x64 output tiles of an (M, N) product, as its ``tile_product``
    assigns them: thread ti*16 + tj owns rows r0 + ti + 16x and columns
    c0 + tj + 16y, x, y < 4."""
    for r0 in range(0, M, 64):
        for c0 in range(0, N, 64):
            for tid in range(256):
                ti, tj = tid >> 4, tid & 15
                yield (tid,
                       [r for r in (r0 + ti + 16 * x for x in range(4))
                        if r < M],
                       [c for c in (c0 + tj + 16 * y for y in range(4))
                        if c < N])


@pytest.mark.parametrize("dims", [(64, 64), (96, 80), (80, 72), (32, 8),
                                  (130, 64)])
def test_ssd_product_tiles_cover_each_output_once(dims):
    """Each product the SSD kernel forms -- (L, L), (L, hp), (hp, ds) --
    is written once per element, multi-tile shapes included."""
    M, N = dims
    hits = np.zeros((M, N), np.int64)
    for _, rows, cols in _tile_owners(M, N):
        for r in rows:
            hits[r, cols] += 1
    assert (hits == 1).all()


def test_ssd_plan_shared_memory():
    p = kssd.plan_ssd(64, 64, 64)                 # Zamba2-7B's head widths
    assert p.ld % 2 == 1 and p.smem == 4 * p.floats
    assert p.smem <= kssd.SMEM_MAX
    assert 2 * (p.smem + 1024) <= 228 * 1024      # two CTAs an SM
    assert kssd.plan_ssd(64, 64, 128).smem <= kssd.SMEM_MAX
    with pytest.raises(ValueError):
        kssd.plan_ssd(64, 64, 256)
    with pytest.raises(ValueError):
        kssd.plan_ssd(0, 64, 64)


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
        kfa.flash_attention(*(torch.zeros(1, 64, 2, 24),) * 3)
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
        kwkv.rwkv6_wkv(*(torch.zeros(1, 8, 2, 48),) * 4, torch.zeros(2, 48))
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
    kssd.plan_ssd(inner // zamba.n_mamba_heads, zamba.ssm_state, 64)
