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
``models/transformer.py``.  The mixers are plain torch, as the JAX
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


def _normal(g: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    """N(0, 1) * scale in ``dtype``, drawn in fp32 on the generator's
    device and scaled in place (no second full-size buffer)."""
    t = torch.randn(shape, generator=g, device=g.device,
                    dtype=torch.float32).mul_(scale)
    return t if dtype == torch.float32 else t.to(dtype)


def _full(g: torch.Generator, shape, value: float, dtype) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=g.device)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it: 1 / (1 + exp(-x)), each
    operation rounded to x's dtype.  ``torch.sigmoid`` rounds once, which
    moves a bf16 result by an ulp in about 30% of elements and, over a
    block, moves bf16 logits off the JAX package's by more than 2e-2."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), with ``sigmoid`` above."""
    return x * sigmoid(x)


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
                     dtype=torch.bfloat16, n: tuple = ()):
    """``n`` prefixes every shape: ``(L,)`` stacks L layers' weights."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(g, n + (d, h * hd), dtype, s),
        "wk": _normal(g, n + (d, kv * hd), dtype, s),
        "wv": _normal(g, n + (d, kv * hd), dtype, s),
        "wo": _normal(g, n + (h * hd, d), dtype, s / cfg.num_layers),
    }
    if cfg.qk_norm:
        p["q_norm"] = _full(g, n + (hd,), 1.0, dtype)
        p["k_norm"] = _full(g, n + (hd,), 1.0, dtype)
    return p


def attention(cfg: ModelConfig, p, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: KVCache | None = None,
              causal: bool = True) -> tuple[torch.Tensor, KVCache | None]:
    """x: (B, S, d). positions: (B, S). If cache is given, new K/V are
    written at slot ``pos % M`` (a ring buffer: exact for both full caches
    M >= total length and sliding-window caches M == window).  One call
    must write at most M positions: with more, slots repeat and which
    write wins is unspecified (as in the JAX package's scatter)."""
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
        ck = cache.k.clone()
        cv = cache.v.clone()
        spos = cache.slot_pos.clone()
        ck[:, slots] = k.to(ck.dtype)
        cv[:, slots] = v.to(cv.dtype)
        spos[slots] = positions[0].to(spos.dtype)
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
                    dtype=torch.bfloat16, n_layers=32, n: tuple = ()):
    s = 1.0 / math.sqrt(d)
    return {"wg": _normal(g, n + (d, ff), dtype, s),
            "wu": _normal(g, n + (d, ff), dtype, s),
            "wd": _normal(g, n + (ff, d), dtype,
                          1.0 / math.sqrt(ff) / n_layers)}


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return (silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


# ---------------------------------------------------------------------------
# Mixture of Experts: sort-based capacity dispatch
# ---------------------------------------------------------------------------
def init_moe_params(cfg: ModelConfig, g: torch.Generator,
                    dtype=torch.bfloat16, n: tuple = ()):
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.e_ff
    s = 1.0 / math.sqrt(d)
    return {
        "router": _normal(g, n + (d, e), torch.float32, s),
        "wg": _normal(g, n + (e, d, ff), dtype, s),
        "wu": _normal(g, n + (e, d, ff), dtype, s),
        "wd": _normal(g, n + (e, ff, d), dtype,
                      1.0 / math.sqrt(ff) / cfg.num_layers),
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
    if moe_ep.ep_enabled(cfg, x.shape):
        return moe_ep.moe_expert_parallel(cfg, p, x)
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    C = moe_capacity(cfg, T)
    xt = x.reshape(T, d)
    dev = x.device

    logits = xt.float() @ p["router"]                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)                  # (T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    # Flatten the T*K (token, expert) pairs, group by expert (stable sort).
    flat_e = eidx.reshape(-1)                                  # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_g = gate.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st = flat_e[order], flat_t[order]
    # rank of each entry within its expert group
    counts = torch.bincount(se, minlength=E)                   # (E,)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[se]
    keep = rank < C
    # dropped assignments land in a trash slot past the buffer
    slot = torch.where(keep, se * C + rank, torch.full_like(se, E * C))

    # slot table: token index per (E*C) slot (+1 trash, cut off)
    slot_tok = torch.zeros(E * C + 1, dtype=torch.long, device=dev)
    slot_tok.index_put_((slot,), st)
    slot_tok = slot_tok[:-1]

    xe = xt[slot_tok].reshape(E, C, d)                         # gather
    h = silu(torch.einsum("ecd,edf->ecf", xe, p["wg"])) \
        * torch.einsum("ecd,edf->ecf", xe, p["wu"])
    ye = torch.einsum("ecf,efd->ecd", h, p["wd"]).reshape(E * C, d)

    # combine: each pair's slot (trash = a zero row), summed in top-k order
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    ye = torch.cat([ye, ye.new_zeros((1, d))])[pair_slot].reshape(T, K, d)
    wk = flat_g.reshape(T, K).to(ye.dtype)
    y = torch.zeros((T, d), dtype=ye.dtype, device=dev)
    for j in range(K):
        y = y + ye[:, j] * wk[:, j, None]

    # Switch-style load-balance aux loss.
    me = probs.mean(dim=0)                                     # (E,)
    ce = torch.bincount(eidx.reshape(-1), minlength=E) / (T * K)
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------
class MambaState(NamedTuple):
    h: torch.Tensor       # (B, nh, hp, ds) SSD state
    conv: torch.Tensor    # (B, k-1, inner) short-conv tail


CONV_K = 4


def init_mamba_params(cfg: ModelConfig, g: torch.Generator,
                      dtype=torch.bfloat16, n: tuple = ()):
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    nh, ds, G = cfg.n_mamba_heads, cfg.ssm_state, cfg.ssm_groups
    s = 1.0 / math.sqrt(d)
    proj_out = 2 * inner + 2 * G * ds + nh
    return {
        "in_proj": _normal(g, n + (d, proj_out), dtype, s),
        "conv_w": _normal(g, n + (CONV_K, inner), dtype, 0.5),
        "A_log": _full(g, n + (nh,), 0.0, torch.float32),
        "D": _full(g, n + (nh,), 1.0, torch.float32),
        "dt_bias": _full(g, n + (nh,), 0.0, torch.float32),
        "out_proj": _normal(g, n + (inner, d), dtype,
                            1.0 / math.sqrt(inner) / cfg.num_layers),
        "gate_norm": _full(g, n + (inner,), 1.0, dtype),
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
    """Full-sequence (chunked SSD) form. x: (B, S, d) -> (y, new_state)."""
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
                                device=x.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        torch.zeros_like(seg))

    # intra-chunk: y[t] = sum_u (C_t.B_u) decay[t,u] dt_u x_u
    cb = torch.einsum("bcthn,bcuhn->bctuh", Ch, Bh)
    att = cb * decay
    y_intra = torch.einsum("bctuh,bcuh,bcuhp->bcthp", att, dt_c, xh)

    # inter-chunk: a loop over chunks carrying the state
    chunk_decay = torch.exp(cs[:, :, -1, :])             # (B,nC,nh)
    # state contribution of each chunk: sum_u exp(cs_last - cs_u) dt_u B_u x_u^T
    w_u = torch.exp(cs[:, :, -1:, :] - cs) * dt_c        # (B,nC,chunk,nh)
    chunk_state = torch.einsum("bcuh,bcuhn,bcuhp->bchpn", w_u, Bh, xh)

    h = torch.zeros((B, nh, hp, ds), dtype=torch.float32, device=x.device) \
        if state is None else state.h.float()
    y_inter = []
    for c in range(nC):
        # y_inter[t] = C_t . (h * exp(cs_t))
        y_inter.append(torch.einsum("bthn,bhpn,bth->bthp", Ch[:, c], h,
                                    torch.exp(cs[:, c])))
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    y_inter = torch.stack(y_inter, dim=1)                # (B,nC,chunk,nh,hp)

    y = (y_intra + y_inter).reshape(B, nC * chunk, nh, hp)[:, :S]
    y = y + xh.reshape(B, nC * chunk, nh, hp)[:, :S] \
        * p["D"][None, None, :, None]
    y = y.reshape(B, S, inner).to(x.dtype)
    y = y * silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], MambaState(h=h.float(), conv=new_tail)


def mamba2_step(cfg: ModelConfig, p, x: torch.Tensor, state: MambaState):
    """Single-token decode. x: (B, 1, d)."""
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"mamba2_step takes one token, got {S}")
    inner = cfg.ssm_expand * d
    nh, ds, G = cfg.n_mamba_heads, cfg.ssm_state, cfg.ssm_groups
    hp = inner // nh
    z, xs, Bm, Cm, dt = _mamba_split(cfg, x @ p["in_proj"])
    xs, new_tail = _causal_conv(xs, p["conv_w"], state.conv)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]           # (B,nh)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None, :])                             # (B,nh)
    xh = xs.reshape(B, nh, hp).float()
    rep = nh // G
    Bh = Bm.reshape(B, G, ds).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(B, G, ds).repeat_interleave(rep, dim=1).float()
    h = state.h * a[:, :, None, None] \
        + torch.einsum("bh,bhp,bhn->bhpn", dt, xh, Bh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, inner).to(x.dtype)
    y = y * silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], MambaState(h=h, conv=new_tail)


# ---------------------------------------------------------------------------
# RWKV6 block (time-mix + channel-mix)
# ---------------------------------------------------------------------------
class RWKVState(NamedTuple):
    wkv: torch.Tensor      # (B, nh, hd, hd)
    x_tm: torch.Tensor     # (B, d) last input seen by time-mix
    x_cm: torch.Tensor     # (B, d) last input seen by channel-mix


RWKV_HD = 64


def init_rwkv_params(cfg: ModelConfig, g: torch.Generator,
                     dtype=torch.bfloat16, n: tuple = ()):
    d, ff = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    return {
        "mu": _full(g, n + (5, d), 0.5, dtype),  # r,k,v,w,g token-shift mix
        "wr": _normal(g, n + (d, d), dtype, s),
        "wk": _normal(g, n + (d, d), dtype, s),
        "wv": _normal(g, n + (d, d), dtype, s),
        "ww": _normal(g, n + (d, d), dtype, 0.1 * s),
        "w_bias": _full(g, n + (d,), -6.0, torch.float32),
        "wg": _normal(g, n + (d, d), dtype, s),
        "u": _full(g, n + (d,), 0.0, torch.float32),  # current-token bonus
        "wo": _normal(g, n + (d, d), dtype, s / cfg.num_layers),
        "ln_x": _full(g, n + (d,), 1.0, dtype),
        "mu_cm": _full(g, n + (2, d), 0.5, dtype),
        "ck": _normal(g, n + (d, ff), dtype, s),
        "cv": _normal(g, n + (ff, d), dtype,
                      1.0 / math.sqrt(ff) / cfg.num_layers),
        "cr": _normal(g, n + (d, d), dtype, s),
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


def rwkv6(cfg: ModelConfig, p, x: torch.Tensor,
          state: RWKVState | None = None):
    """Full-sequence RWKV6 (decode is the same call with S = 1).
    x: (B,S,d) -> (y, new_state).  Data-dependent per-channel decay
    w_t = exp(-exp(ww x + b)); static token-shift lerp."""
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

    s_wkv = state.wkv
    outs = []
    for t in range(S):
        s_wkv, out = rwkv6_step(s_wkv, r[:, t], k[:, t], v[:, t],
                                w[:, t], u)
        outs.append(out)
    y = torch.stack(outs, dim=1).reshape(B, S, d).to(x.dtype)
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
