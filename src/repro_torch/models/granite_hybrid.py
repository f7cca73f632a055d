"""Granite-4.0-H (``granitemoehybrid``): a hybrid of Mamba-2 and NoPE
attention layers, each followed by a dropless mixture of experts beside a
shared expert, served through ``serving/engine.py``.

The layer equations, as the published model has them (Hugging Face's
``GraniteMoeHybridForCausalLM``):

* ``x = embed(tokens) * embedding_multiplier``;
* per layer, its mixer chosen by ``layer_types[i]``::

      h = h + residual_multiplier * mixer(rmsnorm(h))
      n = rmsnorm(h)
      h = h + residual_multiplier * (moe(n) + shared(n))

* ``logits = rmsnorm(h) @ embed.T / logits_scaling`` (tied head).

The attention mixer is GQA with no positional encoding, causal, softmax
scale ``attention_multiplier``.  The Mamba-2 mixer projects to (z, xBC,
dt), convolves xBC (x, B and C together) causally with a bias, then
SiLU; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD with
the D skip; the gated RMSNorm ``rmsnorm(y * silu(z))`` over the whole
inner width (one group); ``out_proj``.  The router takes the top
``num_experts_per_tok`` of its logits and softmaxes over those; each
expert is ``(silu(x wg) * (x wu)) wo`` (the published ``input_linear`` is
``[wg | wu]``), and so is the shared expert.

Storage is bf16 (the SSM's A_log, dt_bias, D and the conv bias fp32),
arithmetic as the port's layers have it: fp32 norms, softmax, router and
SSD, bf16 GEMMs with fp32 accumulation.  Prefill attention runs the flash
kernel (``kernels/flash_attention.py``); decode attention is plain.  The
SSD is ``layers.ssd_chunked`` / ``ssd_step`` and the expert dispatch
``layers.moe_dispatch`` / ``moe_combine`` with capacity taken from the
call's own largest expert load, so no assignment is dropped;
``GraniteHybrid.stats`` counts what dispatch dropped all the same, with
the largest and mean loads.

Weights are drawn per layer from the seed (``init_params``): layer i's
leaves from a generator of its own, so a reference can draw layer i alone
(``repro_torch.reference.granite_hybrid`` draws the same bits).  Under a
profiler a decode step opens the spans ``model/mamba``,
``model/attention``, ``model/moe`` (the router, experts and shared
expert, with their norm) and ``model/head`` around its sublayers; a
prefill opens none, so each device operation is put down to its phase
(the engine's ``lm/prefill`` or ``lm/decode``) by the innermost span it
was launched in."""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.spans import span

LAYER_TYPES = ("mamba",) * 5 + ("attention",) + ("mamba",) * 9 \
    + ("attention",) + ("mamba",) * 9 + ("attention",) + ("mamba",) * 9 \
    + ("attention",) + ("mamba",) * 4
FP32_LEAVES = frozenset(("A_log", "dt_bias", "D", "conv_b"))
SSD_CHUNK = 64      # tokens a chunk of ``ssd_chunked``
SCORE_STD = 2.0     # the drawn q and k give attention scores this spread


@dataclasses.dataclass(frozen=True)
class GraniteHybridConfig:
    """The published ``config.json``'s keys (granite-4.0-h-small's values
    by default); the model runs the first ``num_hidden_layers`` of
    ``layer_types``."""

    vocab_size: int = 100352
    hidden_size: int = 4096
    num_hidden_layers: int = 40
    layer_types: tuple[str, ...] = LAYER_TYPES
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    intermediate_size: int = 768
    shared_intermediate_size: int = 1536
    num_local_experts: int = 72
    num_experts_per_tok: int = 10
    mamba_n_heads: int = 128
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk_size: int = 256
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    attention_multiplier: float = 0.0078125
    logits_scaling: float = 16.0
    rms_norm_eps: float = 1e-5
    position_embedding_type: str = "nope"
    attention_bias: bool = False
    tie_word_embeddings: bool = True
    hidden_act: str = "silu"

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.num_hidden_layers > len(self.layer_types):
            raise ValueError(f"{self.num_hidden_layers} layers, "
                             f"{len(self.layer_types)} layer types")
        if set(self.layers) - {"mamba", "attention"}:
            raise ValueError(f"layer types {set(self.layers)}")
        if self.mamba_expand * self.hidden_size != self.mamba_inner:
            raise ValueError("mamba_expand * hidden_size must be "
                             "mamba_n_heads * mamba_d_head")
        if (self.position_embedding_type, self.attention_bias,
                self.tie_word_embeddings, self.hidden_act,
                self.mamba_conv_bias, self.mamba_proj_bias) != \
                ("nope", False, True, "silu", True, False):
            raise ValueError("the model runs NoPE attention without bias, "
                             "a tied head, SiLU, a conv bias and no "
                             "projection bias")

    @classmethod
    def from_dict(cls, d: dict) -> "GraniteHybridConfig":
        """The fields of a ``config.json``-like dict; other keys are
        ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def layers(self) -> tuple[str, ...]:
        return self.layer_types[:self.num_hidden_layers]

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mamba_inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def conv_dim(self) -> int:
        return self.mamba_inner + 2 * self.mamba_n_groups * self.mamba_d_state


GRANITE_4_0_H_SMALL = GraniteHybridConfig()


def tiny() -> GraniteHybridConfig:
    """A granite-shaped config for CPU tests: d 64, two periods of
    (mamba, attention, mamba), 8 experts top-2 and a shared expert,
    vocab 256."""
    return GraniteHybridConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=6,
        layer_types=("mamba", "attention", "mamba") * 2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=32,
        shared_intermediate_size=48, num_local_experts=8,
        num_experts_per_tok=2, mamba_n_heads=8, mamba_d_head=16,
        mamba_d_state=16, mamba_chunk_size=8)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------
def qk_std(d: int, hd: int, multiplier: float) -> float:
    """The scale of wq and wk at which the attention scores (q . k times
    ``multiplier``) of unit-RMS inputs have a standard deviation of 2, as
    a trained model's are far from uniform; at 1 / sqrt(d) they would be
    about 0.09 under the published multiplier, every row near the mean of
    its values."""
    return math.sqrt(SCORE_STD / (multiplier * math.sqrt(hd) * d))


def layer_leaves(cfg: GraniteHybridConfig, kind: str) -> list[tuple]:
    """(name, shape, init) of one layer's leaves, in the order they are
    drawn.  ``init`` is ``("normal", std)``, ``"norm"`` (1 + 0.1 N(0, 1)),
    ``"A_log"`` (log U(1, 16)) or ``"dt_bias"`` (softplus^-1 of a dt
    log-uniform in [1e-3, 1e-1]); projections are N(0, 1/fan_in), but wq
    and wk (``qk_std``)."""
    d, E = cfg.hidden_size, cfg.num_local_experts
    ff, sff = cfg.intermediate_size, cfg.shared_intermediate_size

    def lin(fan_in, *shape):
        return shape, ("normal", 1.0 / math.sqrt(fan_in))
    out = [("ln1", (d,), "norm")]
    if kind == "mamba":
        nh, inner = cfg.mamba_n_heads, cfg.mamba_inner
        out += [("in_proj", *lin(d, d, inner + cfg.conv_dim + nh)),
                ("conv_w", *lin(cfg.mamba_d_conv, cfg.mamba_d_conv,
                                cfg.conv_dim)),
                ("conv_b", (cfg.conv_dim,), ("normal", 0.1)),
                ("dt_bias", (nh,), "dt_bias"), ("A_log", (nh,), "A_log"),
                ("D", (nh,), "norm"), ("gate_norm", (inner,), "norm"),
                ("out_proj", *lin(inner, inner, d))]
    else:
        H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        qk = ("normal", qk_std(d, hd, cfg.attention_multiplier))
        out += [("wq", (d, H * hd), qk), ("wk", (d, KV * hd), qk),
                ("wv", *lin(d, d, KV * hd)), ("wo", *lin(H * hd, H * hd, d))]
    out += [("ln2", (d,), "norm"), ("router", *lin(d, d, E)),
            ("wg", *lin(d, E, d, ff)), ("wu", *lin(d, E, d, ff)),
            ("wo_e", *lin(ff, E, ff, d)), ("s_wg", *lin(d, d, sff)),
            ("s_wu", *lin(d, d, sff)), ("s_wo", *lin(sff, sff, d))]
    return out


def _generator(seed: int, stream: int, device) -> torch.Generator:
    """Stream 0 draws the embedding and final norm, stream i + 1 layer i."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % 2**63)


def _draw(g: torch.Generator, shape, init, device) -> torch.Tensor:
    """One fp32 leaf."""
    if init == "norm":
        return torch.randn(shape, generator=g, device=device) \
            .mul_(0.1).add_(1.0)
    if init == "A_log":
        return torch.rand(shape, generator=g, device=device) \
            .mul_(15.0).add_(1.0).log_()
    if init == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.rand(shape, generator=g, device=device) \
            .mul_(hi - lo).add_(lo).exp_()
        return dt + torch.log(-torch.expm1(-dt))
    return torch.randn(shape, generator=g, device=device).mul_(init[1])


def init_layer(cfg: GraniteHybridConfig, i: int, seed: int, device,
               dtype=torch.bfloat16) -> dict:
    """Layer i's weights: ``dtype`` but the SSM's fp32 leaves."""
    g = _generator(seed, i + 1, device)
    out = {}
    for name, shape, init in layer_leaves(cfg, cfg.layers[i]):
        t = _draw(g, shape, init, device)
        out[name] = t if name in FP32_LEAVES else t.to(dtype)
        del t
    return out


def init_params(cfg: GraniteHybridConfig, seed: int,
                device: str | torch.device = "cuda",
                dtype=torch.bfloat16) -> dict:
    """``{"embed" (V, d), "final_norm" (d,), "layers": [per-layer
    dicts]}`` drawn from ``seed`` on ``device`` (default the card)."""
    dev = resolve_device(device)
    g = _generator(seed, 0, dev)
    V, d = cfg.vocab_size, cfg.hidden_size
    embed = _draw(g, (V, d), ("normal", 0.1), dev).to(dtype)
    final_norm = _draw(g, (d,), "norm", dev).to(dtype)
    return {"embed": embed, "final_norm": final_norm,
            "layers": [init_layer(cfg, i, seed, dev, dtype)
                       for i in range(cfg.num_hidden_layers)]}


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
class KVState(NamedTuple):
    k: torch.Tensor      # (B, M, KV, hd)
    v: torch.Tensor      # (B, M, KV, hd)


class HybridCache(NamedTuple):
    """One entry a layer, in layer order: ``layers.MambaState`` (the fp32
    SSD state (B, nh, hp, ds) and the last d_conv - 1 xBC inputs) for a
    Mamba-2 layer, ``KVState`` for an attention layer; ``pos`` tokens
    consumed (every row of a batch has the same length)."""

    pos: int
    states: tuple


def init_cache(cfg: GraniteHybridConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> HybridCache:
    dev = resolve_device(device)
    states = []
    for kind in cfg.layers:
        if kind == "mamba":
            states.append(L.MambaState(
                h=torch.zeros((batch, cfg.mamba_n_heads, cfg.mamba_d_head,
                               cfg.mamba_d_state), dtype=torch.float32,
                              device=dev),
                conv=torch.zeros((batch, cfg.mamba_d_conv - 1,
                                  cfg.conv_dim), dtype=dtype, device=dev)))
        else:
            shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
            states.append(KVState(torch.zeros(shape, dtype=dtype, device=dev),
                                  torch.zeros(shape, dtype=dtype, device=dev)))
    return HybridCache(0, tuple(states))


# ---------------------------------------------------------------------------
# Mixers
# ---------------------------------------------------------------------------
def _conv_silu(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               tail: torch.Tensor):
    """Causal depthwise conv of xbc (B, S, C) after ``tail`` (B, k-1, C),
    with bias, then SiLU; in fp32, out in xbc's dtype.  Returns (out, the
    last k-1 inputs)."""
    S, k = xbc.shape[1], w.shape[0]
    full = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    out = b.float().expand(xbc.shape).clone()
    for i in range(k):
        out += full[:, i:i + S].float() * w[i].float()
    return F.silu(out).to(xbc.dtype), full[:, S:].clone()


def mamba_mixer(cfg: GraniteHybridConfig, p: dict, x: torch.Tensor,
                state: L.MambaState):
    """x (B, S, d), normed -> (out (B, S, d), new state); S = 1 takes the
    SSD's one-token step."""
    B, S, _ = x.shape
    nh, hp, ds = cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state
    G, inner = cfg.mamba_n_groups, cfg.mamba_inner
    z, xbc, dt = torch.split(x @ p["in_proj"], [inner, cfg.conv_dim, nh],
                             dim=-1)
    xbc, tail = _conv_silu(xbc, p["conv_w"], p["conv_b"], state.conv)
    xs, Bm, Cm = torch.split(xbc, [inner, G * ds, G * ds], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, S, nh)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, nh, hp).float()
    Bh = Bm.reshape(B, S, G, ds).repeat_interleave(nh // G, dim=2).float()
    Ch = Cm.reshape(B, S, G, ds).repeat_interleave(nh // G, dim=2).float()
    if S == 1:
        y, h = L.ssd_step(xh[:, 0], Bh[:, 0], Ch[:, 0], dt[:, 0], A,
                          p["D"], state.h)
    else:
        y, h = L.ssd_chunked(xh, Bh, Ch, dt, A, p["D"], state.h, SSD_CHUNK)
    y = y.reshape(B, S, inner) * F.silu(z.float())
    y = L.rmsnorm(y, p["gate_norm"], cfg.rms_norm_eps).to(x.dtype)
    return y @ p["out_proj"], L.MambaState(h=h, conv=tail)


def attention_mixer(cfg: GraniteHybridConfig, p: dict, x: torch.Tensor,
                    state: KVState, pos: int):
    """x (B, S, d), normed, at positions pos..pos+S-1 -> (out, state).
    A prefill (pos 0) runs the flash kernel over its own keys; a decode
    step (S = 1) attends to the cache's pos + 1 keys in fp32."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    q = (x @ p["wq"]).view(B, S, H, hd)
    k = (x @ p["wk"]).view(B, S, KV, hd)
    v = (x @ p["wv"]).view(B, S, KV, hd)
    state.k[:, pos:pos + S] = k
    state.v[:, pos:pos + S] = v
    if S > 1:
        if pos:
            raise ValueError("a prefill starts at position 0")
        o = fa.flash_attention(q, k, v, causal=True,
                               scale=cfg.attention_multiplier)
    else:
        keys = state.k[:, :pos + 1].float()                   # (B, T, KV, hd)
        vals = state.v[:, :pos + 1].float()
        qg = q.view(B, KV, H // KV, hd).float()
        w = torch.softmax(torch.einsum("bkgh,btkh->bkgt", qg, keys)
                          * cfg.attention_multiplier, dim=-1)
        o = torch.einsum("bkgt,btkh->bkgh", w, vals).to(x.dtype)
    return o.reshape(B, S, H * hd) @ p["wo"], state


def _no_span(name: str):
    return contextlib.nullcontext()


def capacity(counts: torch.Tensor) -> int:
    """Slots an expert gets in one call: the call's largest load, so
    nothing is dropped."""
    return int(counts.max())


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
class GraniteHybrid:
    """The model object ``serving.engine.Engine`` serves: ``init_cache``,
    ``prefill`` (last position's logits) and ``decode`` (one token), and
    ``forward`` (every position's logits, no cache).  ``stats`` counts
    the MoE calls, the assignments their dispatch dropped, and the sums of
    each call's largest and mean expert load (``load_stats``)."""

    def __init__(self, cfg: GraniteHybridConfig, params: dict):
        self.cfg, self.params = cfg, params
        self.stats = {"moe_calls": 0, "max_load_sum": 0,
                      "mean_load_sum": 0.0, "max_load": 0}
        self._dropped = torch.zeros((), dtype=torch.long,
                                    device=params["embed"].device)

    def dropped(self) -> int:
        """Assignments dispatch dropped, over every MoE call so far."""
        return int(self._dropped)

    def load_stats(self) -> dict:
        s, n = self.stats, max(1, self.stats["moe_calls"])
        return {"calls": s["moe_calls"], "dropped": self.dropped(),
                "largest": s["max_load"], "max_mean": s["max_load_sum"] / n,
                "mean_mean": s["mean_load_sum"] / n}

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> HybridCache:
        return init_cache(self.cfg, batch, max_len, dtype,
                          device or self.params["embed"].device)

    # -- sublayers ---------------------------------------------------------
    def _moe(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """The routed experts plus the shared expert on x (B, S, d)."""
        cfg = self.cfg
        B, S, d = x.shape
        E, K = cfg.num_local_experts, cfg.num_experts_per_tok
        xt = x.reshape(B * S, d)
        top, eidx = torch.topk(xt.float() @ p["router"].float(), K, dim=-1)
        gate = torch.softmax(top, dim=-1)
        C = capacity(L.count_ids(eidx, E))
        slot_tok, pair_slot, _, kept = L.moe_dispatch(eidx, E, C)
        self._dropped += kept.numel() - kept.sum()
        self.stats["moe_calls"] += 1
        self.stats["max_load_sum"] += C
        self.stats["max_load"] = max(self.stats["max_load"], C)
        self.stats["mean_load_sum"] += B * S * K / E
        xe = xt[slot_tok].reshape(E, C, d)
        h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
        y = L.moe_combine(torch.bmm(h, p["wo_e"]).reshape(E * C, d),
                          pair_slot, gate).reshape(B, S, d)
        return y + (F.silu(x @ p["s_wg"]) * (x @ p["s_wu"])) @ p["s_wo"]

    def _layer(self, i: int, x: torch.Tensor, state, pos: int, sub):
        cfg, p = self.cfg, self.params["layers"][i]
        eps, r = cfg.rms_norm_eps, cfg.residual_multiplier
        if cfg.layers[i] == "mamba":
            with sub("model/mamba"):
                m, state = mamba_mixer(cfg, p, L.rmsnorm(x, p["ln1"], eps),
                                       state)
        else:
            with sub("model/attention"):
                m, state = attention_mixer(
                    cfg, p, L.rmsnorm(x, p["ln1"], eps), state, pos)
        x = x + m * r
        with sub("model/moe"):
            f = self._moe(p, L.rmsnorm(x, p["ln2"], eps))
        return x + f * r, state

    def _walk(self, tokens: torch.Tensor, cache: HybridCache, sub=_no_span):
        """The layers over tokens (B, S) from ``cache``; ``sub`` opens each
        sublayer's span."""
        x = self.params["embed"][tokens] * self.cfg.embedding_multiplier
        states = []
        for i, st in enumerate(cache.states):
            x, st = self._layer(i, x, st, cache.pos, sub)
            states.append(st)
        return x, HybridCache(cache.pos + tokens.shape[1], tuple(states))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(x, self.params["final_norm"], self.cfg.rms_norm_eps)
        return (x @ self.params["embed"].T).float() / self.cfg.logits_scaling

    # -- entry points ------------------------------------------------------
    def prefill(self, tokens: torch.Tensor, cache: HybridCache):
        """tokens (B, S) into an empty cache -> (last position's logits
        (B, V) fp32, the filled cache)."""
        if cache.pos:
            raise ValueError("prefill takes an empty cache")
        x, cache = self._walk(tokens, cache)
        return self._head(x[:, -1]), cache

    def decode(self, tokens: torch.Tensor, cache: HybridCache):
        """tokens (B, 1) -> (logits (B, V) fp32, the cache one longer)."""
        if tokens.shape[1] != 1:
            raise ValueError(f"decode takes one token, got {tokens.shape}")
        x, cache = self._walk(tokens, cache, span)
        with span("model/head"):
            return self._head(x[:, -1]), cache

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Every position's logits (B, S, V), through a throwaway cache."""
        B, S = tokens.shape
        x, _ = self._walk(tokens, self.init_cache(
            B, S, self.params["embed"].dtype))
        return self._head(x)
