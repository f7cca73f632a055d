"""Transformer block library of the PyTorch port (the counterpart of
``repro.models.layers``), covering every assigned architecture family:

* GQA attention (RoPE, optional qk-norm, causal / bidirectional / sliding
  window, KV-cache decode with a ring buffer for windowed caches),
* SwiGLU dense MLP,
* top-k MoE with sort-based capacity dispatch (no (T, E, C) one-hot),
* Mamba2 (SSD) block with a chunked scan + single-step decode,
* RWKV6 time-mix / channel-mix with recurrent state.

All functions are pure (params as dicts of tensors; a cache update returns
new tensors and leaves its argument as it was); layer stacking lives in
``models/transformer.py``.  On DTensors (the dry-run's
sharded pass) ``embed``, ``token_logprobs``, ``attention``, ``swiglu``,
``moe``, ``mamba2``, ``mamba2_step`` and ``rwkv6`` run
``models/sharded.py``'s per-rank bodies; on plain
tensors, the ops below.  The mixers are plain torch, as the JAX
package's are plain jnp: the sequence kernels of ``kernels/ops.py`` have no
KV ring buffer, sliding window or initial state.  The JAX package's
``jax.lax.scan``s (Mamba2 chunks, RWKV6 tokens) are Python loops here.

Initialisers draw from an explicit ``torch.Generator`` on the target
device: the port's weights are its own stream, not ``jax.random``'s; to
hold the port against ``repro`` carry the JAX weights across with
``transformer.params_from_numpy``."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharded


def _normal(g: torch.Generator, shape, dtype, scale: float,
            device=None) -> torch.Tensor:
    """N(0, 1) * scale in ``dtype``, drawn in fp32 on ``device`` (default
    the generator's) and scaled in place (no second full-size buffer).
    On ``device="meta"`` a CPU generator gives shapes and dtypes only:
    nothing is drawn or allocated."""
    t = torch.randn(shape, generator=g, device=device or g.device,
                    dtype=torch.float32).mul_(scale)
    return t if dtype == torch.float32 else t.to(dtype)


def _full(g: torch.Generator, shape, value: float, dtype,
          device=None) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device or g.device)


def count_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in [0, n): an int64
    count of each id, as a scatter-add of ones into n zeros, whose shape
    is known before the values are (``bincount``'s is not, so it has no
    meta kernel and the dry-run could not trace it)."""
    flat = ids.reshape(-1).long()
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add(
        0, flat, torch.ones_like(flat))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it: 1 / (1 + exp(-x)), each
    operation rounded to x's dtype.  ``torch.sigmoid`` rounds once, which
    moves a bf16 result by an ulp in about 30% of elements and, over a
    block, moves bf16 logits off the JAX package's by more than 2e-2."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), with ``sigmoid`` above."""
    return x * sigmoid(x)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` (vocab-parallel on DTensors)."""
    if sharded.is_dtensor(table):
        return sharded.embed(table, tokens)
    return table[tokens]


def token_logprobs(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """log_softmax(logits)[..., label] per token (vocab-parallel on
    DTensors)."""
    if sharded.is_dtensor(logits):
        return sharded.token_logprobs(logits, labels)
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels[..., None].long())[..., 0]


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """In fp32, the scale folded in, cast back to x's dtype once."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) absolute token positions."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor          # (B, M, KV, hd)
    v: torch.Tensor          # (B, M, KV, hd)
    slot_pos: torch.Tensor   # (M,) absolute position in each slot, -1 empty


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    kv, hd = cfg.num_kv_heads, cfg.hd
    return KVCache(
        k=torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        slot_pos=torch.full((max_len,), -1, dtype=torch.int32,
                            device=device))


def init_attn_params(cfg: ModelConfig, g: torch.Generator,
                     dtype=torch.bfloat16, n: tuple = (), device=None):
    """``n`` prefixes every shape: ``(L,)`` stacks L layers' weights;
    ``device`` (default the generator's) holds them."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(g, n + (d, h * hd), dtype, s, device=device),
        "wk": _normal(g, n + (d, kv * hd), dtype, s, device=device),
        "wv": _normal(g, n + (d, kv * hd), dtype, s, device=device),
        "wo": _normal(g, n + (h * hd, d), dtype, s / cfg.num_layers,
                      device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = _full(g, n + (hd,), 1.0, dtype, device=device)
        p["k_norm"] = _full(g, n + (hd,), 1.0, dtype, device=device)
    return p


def attention(cfg: ModelConfig, p, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: KVCache | None = None,
              causal: bool = True) -> tuple[torch.Tensor, KVCache | None]:
    """x: (B, S, d). positions: (B, S). If cache is given, new K/V are
    written at slot ``pos % M`` (a ring buffer: exact for both full caches
    M >= total length and sliding-window caches M == window).  One call
    must write at most M positions: with more, slots repeat and which
    write wins is unspecified (as in the JAX package's scatter).  On
    DTensors: ``sharded.attention``."""
    if sharded.is_dtensor(x):
        return sharded.attention(cfg, p, x, positions=positions,
                                 cache=cache, causal=causal)
    B, S, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = h // kv
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, kv, hd)
    v = (x @ p["wv"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        M = cache.k.shape[1]
        slots = (positions[0] % M).long()  # (S,) same layout for all rows
        # out of place: a sharded cache (the dry-run's DTensors) keeps
        # its placement, which an in-place write may not change
        ck = cache.k.index_copy(1, slots, k.to(cache.k.dtype))
        cv = cache.v.index_copy(1, slots, v.to(cache.v.dtype))
        spos = cache.slot_pos.index_copy(
            0, slots, positions[0].to(cache.slot_pos.dtype))
        keys, vals = ck, cv
        key_pos = spos[None, :]                          # (1, M)
        cache = KVCache(ck, cv, spos)
    else:
        keys, vals = k, v
        key_pos = positions                              # (B, S)

    qg = q.reshape(B, S, kv, g, hd)
    # fp32 products and sums, as JAX's preferred_element_type=float32
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), keys.float())
    scores = scores / math.sqrt(hd)
    qp = positions[:, None, None, :, None].int()       # (B,1,1,S,1)
    kp = key_pos[:, None, None, None, :].int()         # (.,1,1,1,T)
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if cfg.sliding_window:
        valid = valid & (kp > qp - cfg.sliding_window)
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    y = torch.einsum("bkgst,btkh->bskgh", w, vals.to(x.dtype))
    y = y.reshape(B, S, h * hd) @ p["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp_params(d: int, ff: int, g: torch.Generator,
                    dtype=torch.bfloat16, n_layers=32, n: tuple = (),
                    device=None):
    s = 1.0 / math.sqrt(d)
    return {"wg": _normal(g, n + (d, ff), dtype, s, device=device),
            "wu": _normal(g, n + (d, ff), dtype, s, device=device),
            "wd": _normal(g, n + (ff, d), dtype,
                          1.0 / math.sqrt(ff) / n_layers, device=device)}


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    if sharded.is_dtensor(x):
        return sharded.swiglu(p, x)
    return (silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


# ---------------------------------------------------------------------------
# Mixture of Experts: sort-based capacity dispatch
# ---------------------------------------------------------------------------
def init_moe_params(cfg: ModelConfig, g: torch.Generator,
                    dtype=torch.bfloat16, n: tuple = (), device=None):
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.e_ff
    s = 1.0 / math.sqrt(d)
    return {
        "router": _normal(g, n + (d, e), torch.float32, s,
                          device=device),
        "wg": _normal(g, n + (e, d, ff), dtype, s, device=device),
        "wu": _normal(g, n + (e, d, ff), dtype, s, device=device),
        "wd": _normal(g, n + (e, ff, d), dtype,
                      1.0 / math.sqrt(ff) / cfg.num_layers, device=device),
    }


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.experts_per_token
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(8, -(-c // 8) * 8)   # round up to 8 for lane alignment


def moe(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, S, d) -> (y, aux) with sort-based top-k capacity dispatch.

    Tokens are sorted by expert id (stably) and scattered into an (E*C)
    slot table, so compute stays proportional to *active* parameters.
    Assignments beyond an expert's capacity C are dropped; aux carries the
    router load-balance loss.

    When expert parallelism is configured (``moe_ep.EP_MESH`` set to a
    mesh whose model axis the experts divide), dispatch goes through the
    all-to-all path instead -- see ``models/moe_ep.py``.

    The combine gathers each token's K expert outputs and sums them in
    top-k order (a dropped assignment adds nothing), where the JAX
    package scatter-adds the slot table (``.at[slot_tok].add``): a fixed
    order on every device, so repeated runs on the card agree bitwise,
    which an atomic ``index_add_`` would not promise.  It may differ from
    JAX's sum in the last bits."""
    from repro_torch.models import moe_ep
    if sharded.is_dtensor(x):
        return sharded.moe(cfg, p, x)
    if moe_ep.ep_enabled(cfg, x.shape):
        return moe_ep.moe_expert_parallel(cfg, p, x)
    B, S, d = x.shape
    y, aux = moe_local(cfg, p["router"], p["wg"], p["wu"], p["wd"],
                       x.reshape(B * S, d))
    return y.reshape(B, S, d), aux


def moe_dispatch(eidx: torch.Tensor, E: int, C: int):
    """The sort-based dispatch of the (T, K) token-expert pairs ``eidx``
    into an (E*C) slot table.  Pairs are grouped by expert (stable sort,
    so token order within an expert); an expert's pairs past its capacity
    C are dropped into a trash slot E*C.  Returns ``slot_tok`` (E*C,), the
    token of each slot (0 for an empty one), ``pair_slot`` (T*K,), each
    pair's slot in (token, k) order, ``counts`` (E,), each expert's
    pairs, and ``kept`` (T*K,), in sorted order, whether a pair has a
    slot."""
    T, K = eidx.shape
    dev = eidx.device
    # Flatten the T*K (token, expert) pairs, group by expert (stable sort).
    flat_e = eidx.reshape(-1)                                  # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.sort(flat_e, stable=True).indices
    se, st = flat_e[order], flat_t[order]
    # rank of each entry within its expert group
    counts = count_ids(se, E)                                  # (E,)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[se]
    keep = rank < C
    # dropped assignments land in a trash slot past the buffer
    slot = torch.where(keep, se * C + rank, torch.full_like(se, E * C))

    # slot table: token index per (E*C) slot (+1 trash, cut off)
    slot_tok = torch.zeros(E * C + 1, dtype=torch.long,
                           device=dev).index_put((slot,), st)[:-1]
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    return slot_tok, pair_slot, counts, keep


def moe_combine(ye: torch.Tensor, pair_slot: torch.Tensor,
                gate: torch.Tensor) -> torch.Tensor:
    """Each token's K expert rows of ``ye`` (E*C, d), at ``pair_slot``
    (the trash slot E*C reads a zero row), weighted by ``gate`` (T, K) in
    ``ye``'s dtype and summed in top-k order."""
    T, K = gate.shape
    d = ye.shape[-1]
    ye = torch.cat([ye, ye.new_zeros((1, d))])[pair_slot].reshape(T, K, d)
    wk = gate.to(ye.dtype)
    y = torch.zeros((T, d), dtype=ye.dtype, device=ye.device)
    for j in range(K):
        y = y + ye[:, j] * wk[:, j, None]
    return y


def moe_local(cfg: ModelConfig, router, wg, wu, wd, xt: torch.Tensor,
              experts: tuple[int, int] | None = None):
    """The local dispatch of ``moe``: xt (T, d) -> (y (T, d), aux).
    ``experts`` = (e0, e1): the weights hold experts e0..e1-1 only (the
    dry-run's expert-sharded rank), whose outputs are the only ones
    combined; default all."""
    T, d = xt.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = moe_capacity(cfg, T)

    logits = xt.float() @ router                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)                  # (T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    slot_tok, pair_slot, _, _ = moe_dispatch(eidx, E, C)
    xe = xt[slot_tok].reshape(E, C, d)                         # gather
    if experts is not None:
        xe = xe[experts[0]:experts[1]]
    h = silu(torch.einsum("ecd,edf->ecf", xe, wg)) \
        * torch.einsum("ecd,edf->ecf", xe, wu)
    ye = torch.einsum("ecf,efd->ecd", h, wd).reshape(-1, d)

    if experts is not None:
        lo, hi = experts[0] * C, experts[1] * C
        pair_slot = torch.where((pair_slot >= lo) & (pair_slot < hi),
                                pair_slot - lo,
                                torch.full_like(pair_slot, hi - lo))
    y = moe_combine(ye, pair_slot, gate)

    # Switch-style load-balance aux loss.
    me = probs.mean(dim=0)                                     # (E,)
    ce = count_ids(eidx, E) / (T * K)
    aux = E * torch.sum(me * ce)
    return y, aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------
class MambaState(NamedTuple):
    h: torch.Tensor       # (B, nh, hp, ds) SSD state
    conv: torch.Tensor    # (B, k-1, inner) short-conv tail


CONV_K = 4


def init_mamba_params(cfg: ModelConfig, g: torch.Generator,
                      dtype=torch.bfloat16, n: tuple = (), device=None):
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    nh, ds, G = cfg.n_mamba_heads, cfg.ssm_state, cfg.ssm_groups
    s = 1.0 / math.sqrt(d)
    proj_out = 2 * inner + 2 * G * ds + nh
    return {
        "in_proj": _normal(g, n + (d, proj_out), dtype, s,
                           device=device),
        "conv_w": _normal(g, n + (CONV_K, inner), dtype, 0.5,
                          device=device),
        "A_log": _full(g, n + (nh,), 0.0, torch.float32, device=device),
        "D": _full(g, n + (nh,), 1.0, torch.float32, device=device),
        "dt_bias": _full(g, n + (nh,), 0.0, torch.float32,
                         device=device),
        "out_proj": _normal(g, n + (inner, d), dtype,
                            1.0 / math.sqrt(inner) / cfg.num_layers,
                            device=device),
        "gate_norm": _full(g, n + (inner,), 1.0, dtype,
                           device=device),
    }


def _mamba_split(cfg: ModelConfig, z_all: torch.Tensor):
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    nh, ds, G = cfg.n_mamba_heads, cfg.ssm_state, cfg.ssm_groups
    return torch.split(z_all, [inner, inner, G * ds, G * ds, nh], dim=-1)


def _causal_conv(xs: torch.Tensor, w: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv, k = CONV_K. xs: (B, S, inner); tail: the
    previous k-1 inputs for streaming decode."""
    B, S, inner = xs.shape
    if tail is None:
        tail = xs.new_zeros((B, CONV_K - 1, inner))
    full = torch.cat([tail, xs], dim=1)                   # (B, S+k-1, inner)
    out = sum(full[:, i:i + S, :] * w[i] for i in range(CONV_K))
    new_tail = full[:, -(CONV_K - 1):, :]
    return silu(out), new_tail


def mamba2(cfg: ModelConfig, p, x: torch.Tensor,
           state: MambaState | None = None, chunk: int = 64):
    """Full-sequence (chunked SSD) form. x: (B, S, d) -> (y, new_state).
    On DTensors: ``sharded.mamba2``."""
    if sharded.is_dtensor(x):
        return sharded.mamba2(cfg, p, x, state, chunk)
    B, S, d = x.shape
    inner = cfg.ssm_expand * d
    nh, ds, G = cfg.n_mamba_heads, cfg.ssm_state, cfg.ssm_groups
    hp = inner // nh
    z, xs, Bm, Cm, dt = _mamba_split(cfg, x @ p["in_proj"])
    xs, new_tail = _causal_conv(
        xs, p["conv_w"], None if state is None else state.conv)
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B,S,nh)
    A = -torch.exp(p["A_log"])                                 # (nh,)
    xh = xs.reshape(B, S, nh, hp).float()
    rep = nh // G
    Bh = Bm.reshape(B, S, G, ds).repeat_interleave(rep, dim=2).float()
    Ch = Cm.reshape(B, S, G, ds).repeat_interleave(rep, dim=2).float()
    h = torch.zeros((B, nh, hp, ds), dtype=torch.float32, device=x.device) \
        if state is None else state.h.float()
    y, h = ssd_chunked(xh, Bh, Ch, dt, A, p["D"], h, chunk)
    y = y.reshape(B, S, inner).to(x.dtype)
    y = y * silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], MambaState(h=h.float(), conv=new_tail)


def ssd_chunked(xh, Bh, Ch, dt, A, D, h, chunk: int):
    """The chunked SSD of ``mamba2`` over heads that each read their own
    B and C: xh (B, S, nh, hp), Bh and Ch (B, S, nh, ds), dt (B, S, nh),
    all fp32; A and D (nh,); h the (B, nh, hp, ds) state before the
    first token.  Returns y (B, S, nh, hp) with the D skip, and the state
    after the last token."""
    B, S, nh, hp = xh.shape
    ds = Bh.shape[-1]
    la = dt * A[None, None, :]                                 # log decay

    # pad to a chunk multiple
    nC = -(-S // chunk)
    pad = nC * chunk - S

    def padc(t):
        return F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
    xh, Bh, Ch = padc(xh), padc(Bh), padc(Ch)
    la_p, dt_p = padc(la), padc(dt)
    xh = xh.reshape(B, nC, chunk, nh, hp)
    Bh = Bh.reshape(B, nC, chunk, nh, ds)
    Ch = Ch.reshape(B, nC, chunk, nh, ds)
    la_c = la_p.reshape(B, nC, chunk, nh)
    dt_c = dt_p.reshape(B, nC, chunk, nh)

    cs = torch.cumsum(la_c, dim=2)                       # within-chunk cumsum
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # (B,nC,t,u,nh)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        torch.zeros_like(seg))

    # intra-chunk: y[t] = sum_u (C_t.B_u) decay[t,u] dt_u x_u
    cb = torch.einsum("bcthn,bcuhn->bctuh", Ch, Bh)
    att = cb * decay
    y_intra = torch.einsum("bctuh,bcuh,bcuhp->bcthp", att, dt_c, xh)

    # inter-chunk: the state carried from chunk to chunk
    chunk_decay = torch.exp(cs[:, :, -1, :])             # (B,nC,nh)
    # state contribution of each chunk: sum_u exp(cs_last - cs_u) dt_u B_u x_u^T
    w_u = torch.exp(cs[:, :, -1:, :] - cs) * dt_c        # (B,nC,chunk,nh)
    chunk_state = torch.einsum("bcuh,bcuhn,bcuhp->bchpn", w_u, Bh, xh)

    # the loop walks ``unbind``'s views, whose backward stacks the
    # gradients once (indexing a chunk at a time would make a
    # zero-filled full-size gradient a chunk)
    y_inter = []
    for C_c, cs_c, dec_c, st_c in zip(Ch.unbind(1), cs.unbind(1),
                                      chunk_decay.unbind(1),
                                      chunk_state.unbind(1)):
        # y_inter[t] = C_t . (h * exp(cs_t))
        y_inter.append(torch.einsum("bthn,bhpn,bth->bthp", C_c, h,
                                    torch.exp(cs_c)))
        h = h * dec_c[:, :, None, None] + st_c
    y_inter = torch.stack(y_inter, dim=1)                # (B,nC,chunk,nh,hp)

    y = (y_intra + y_inter).reshape(B, nC * chunk, nh, hp)[:, :S]
    y = y + xh.reshape(B, nC * chunk, nh, hp)[:, :S] \
        * D[None, None, :, None]
    return y, h


def mamba2_step(cfg: ModelConfig, p, x: torch.Tensor, state: MambaState):
    """Single-token decode. x: (B, 1, d).  On DTensors:
    ``sharded.mamba2_step``."""
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"mamba2_step takes one token, got {S}")
    if sharded.is_dtensor(x):
        return sharded.mamba2_step(cfg, p, x, state)
    inner = cfg.ssm_expand * d
    nh, ds, G = cfg.n_mamba_heads, cfg.ssm_state, cfg.ssm_groups
    hp = inner // nh
    z, xs, Bm, Cm, dt = _mamba_split(cfg, x @ p["in_proj"])
    xs, new_tail = _causal_conv(xs, p["conv_w"], state.conv)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]           # (B,nh)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, nh, hp).float()
    rep = nh // G
    Bh = Bm.reshape(B, G, ds).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(B, G, ds).repeat_interleave(rep, dim=1).float()
    y, h = ssd_step(xh, Bh, Ch, dt, A, p["D"], state.h)
    y = y.reshape(B, 1, inner).to(x.dtype)
    y = y * silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], MambaState(h=h, conv=new_tail)


def ssd_step(xh, Bh, Ch, dt, A, D, h):
    """One token of the SSD: xh (B, nh, hp), Bh and Ch (B, nh, ds), dt
    (B, nh), fp32; returns y (B, nh, hp) and the new state."""
    a = torch.exp(dt * A[None, :])                             # (B,nh)
    h = h * a[:, :, None, None] \
        + torch.einsum("bh,bhp,bhn->bhpn", dt, xh, Bh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + xh * D[None, :, None]
    return y, h


# ---------------------------------------------------------------------------
# RWKV6 block (time-mix + channel-mix)
# ---------------------------------------------------------------------------
class RWKVState(NamedTuple):
    wkv: torch.Tensor      # (B, nh, hd, hd)
    x_tm: torch.Tensor     # (B, d) last input seen by time-mix
    x_cm: torch.Tensor     # (B, d) last input seen by channel-mix


RWKV_HD = 64


def init_rwkv_params(cfg: ModelConfig, g: torch.Generator,
                     dtype=torch.bfloat16, n: tuple = (), device=None):
    d, ff = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    return {
        # r, k, v, w, g token-shift mix
        "mu": _full(g, n + (5, d), 0.5, dtype, device=device),
        "wr": _normal(g, n + (d, d), dtype, s, device=device),
        "wk": _normal(g, n + (d, d), dtype, s, device=device),
        "wv": _normal(g, n + (d, d), dtype, s, device=device),
        "ww": _normal(g, n + (d, d), dtype, 0.1 * s, device=device),
        "w_bias": _full(g, n + (d,), -6.0, torch.float32,
                        device=device),
        "wg": _normal(g, n + (d, d), dtype, s, device=device),
        # current-token bonus
        "u": _full(g, n + (d,), 0.0, torch.float32, device=device),
        "wo": _normal(g, n + (d, d), dtype, s / cfg.num_layers,
                      device=device),
        "ln_x": _full(g, n + (d,), 1.0, dtype, device=device),
        "mu_cm": _full(g, n + (2, d), 0.5, dtype, device=device),
        "ck": _normal(g, n + (d, ff), dtype, s, device=device),
        "cv": _normal(g, n + (ff, d), dtype,
                      1.0 / math.sqrt(ff) / cfg.num_layers, device=device),
        "cr": _normal(g, n + (d, d), dtype, s, device=device),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor):
    """x: (B,S,d); last: (B,d) -> x_{t-1} sequence and new last."""
    prev = torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)
    return prev, x[:, -1, :]


def rwkv6_step(s_wkv: torch.Tensor, rt, kt, vt, wt, u: torch.Tensor):
    """One token of the WKV recurrence, state math in fp32: returns the
    new (B, nh, hd, hd) state and the (B, nh, hd) output."""
    rt, kt, vt, wt = rt.float(), kt.float(), vt.float(), wt.float()
    kv = kt[:, :, :, None] * vt[:, :, None, :]            # (B,nh,hd,hd)
    out = torch.einsum("bhk,bhkv->bhv", rt,
                       s_wkv + u[None, :, :, None] * kv)
    return s_wkv * wt[:, :, :, None] + kv, out


def wkv_scan(r, k, v, w, u, s_wkv):
    """``rwkv6_step`` over the tokens of r, k, v, w (B, S, nh, hd) from
    the (B, nh, hd, hd) state ``s_wkv``: the fp32 (B, S, nh, hd) outputs
    and the state after the last token.  The tokens are ``unbind``'s
    views, whose backward stacks their gradients once (indexing a token
    at a time would make a zero-filled (B, S, nh, hd) gradient a token:
    S^2 bytes a step)."""
    outs = []
    for rt, kt, vt, wt in zip(*(t.unbind(1) for t in (r, k, v, w))):
        s_wkv, out = rwkv6_step(s_wkv, rt, kt, vt, wt, u)
        outs.append(out)
    return torch.stack(outs, dim=1), s_wkv


def rwkv6(cfg: ModelConfig, p, x: torch.Tensor,
          state: RWKVState | None = None):
    """Full-sequence RWKV6 (decode is the same call with S = 1).
    x: (B,S,d) -> (y, new_state).  Data-dependent per-channel decay
    w_t = exp(-exp(ww x + b)); static token-shift lerp.  On DTensors:
    ``sharded.rwkv6``."""
    if sharded.is_dtensor(x):
        return sharded.rwkv6(cfg, p, x, state)
    B, S, d = x.shape
    nh, hd = d // RWKV_HD, RWKV_HD
    if state is None:
        state = RWKVState(
            wkv=torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                            device=x.device),
            x_tm=x.new_zeros((B, d)), x_cm=x.new_zeros((B, d)))
    prev, new_last = _token_shift(x, state.x_tm)

    def mix(i):
        return x * p["mu"][i] + prev * (1 - p["mu"][i])
    r = (mix(0) @ p["wr"]).reshape(B, S, nh, hd)
    k = (mix(1) @ p["wk"]).reshape(B, S, nh, hd)
    v = (mix(2) @ p["wv"]).reshape(B, S, nh, hd)
    wlog = -torch.exp((mix(3) @ p["ww"]).float() + p["w_bias"])
    w = torch.exp(wlog).reshape(B, S, nh, hd)            # decay in (0,1)
    gt = silu(mix(4) @ p["wg"])
    u = p["u"].reshape(nh, hd)

    y, s_wkv = wkv_scan(r, k, v, w, u, state.wkv)
    y = y.reshape(B, S, d).to(x.dtype)
    y = rmsnorm(y, p["ln_x"], cfg.norm_eps) * gt
    y = y @ p["wo"]

    # channel-mix
    prev_c, new_last_c = _token_shift(x + y, state.x_cm)
    xc = x + y

    def mixc(i):
        return xc * p["mu_cm"][i] + prev_c * (1 - p["mu_cm"][i])
    kk = torch.square(torch.relu(mixc(0) @ p["ck"]))
    out_c = (kk @ p["cv"]) * sigmoid(mixc(1) @ p["cr"])
    return y + out_c, RWKVState(wkv=s_wkv, x_tm=new_last, x_cm=new_last_c)
