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
``layers.moe_dispatch`` / ``moe_combine``, dropless: a call of several
positions (prefill, ``forward``) gives each expert as many slots as its
own largest load (``capacity``, one host sync), a decode step (one
position, T tokens) gives each T, which no expert can exceed since a
token's top-k experts are distinct, so its shapes are known before the
routing is.  ``GraniteHybrid.stats`` counts what dispatch dropped all the
same, with the largest and mean loads, on the device.

The cache is updated in place: each mixer writes its new state (SSD
state, conv tail, k and v) into the cache's own tensors, and a decode
step reads its position from a tensor on the device, attending over all
of the cache's keys with those past it masked out.  So on a CUDA device
a decode step is replayed from CUDA graphs: the first step on a new
cache runs eagerly, then each sublayer (norm, mixer and residual; norm,
experts and residual) and the head is captured once as a graph over that
cache and a static residual-stream and position buffer, and every later
step of the batch replays them.  The batch's graphs share one memory
pool and go when a new cache is made (``GraniteHybrid.init_cache``) or a
prefill starts.  On the CPU every step runs eagerly.

Weights are drawn per layer from the seed (``init_params``): layer i's
leaves from a generator of its own, so a reference can draw layer i alone
(``chipbench.reference.granite_hybrid`` draws the same bits).  Under a
profiler a decode step opens the spans ``model/mamba``,
``model/attention``, ``model/moe`` (the router, experts and shared
expert, with their norm) and ``model/head`` around its sublayers, eager
or replayed, and ``model/capture`` around a batch's capture (no span
opens inside one); a prefill opens none, so each device operation is put
down to its phase (the engine's ``lm/prefill`` or ``lm/decode``) by the
innermost span it was launched in."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

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
# small leaves the arithmetic reads in fp32: the model keeps fp32 copies
FP32_COPIES = ("ln1", "ln2", "gate_norm", "conv_w", "router")
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
    consumed (every row of a batch has the same length).  The model
    writes into ``states``' tensors in place: a call returns a cache with
    the same ``states`` and a later ``pos``, and the one it was given is
    spent."""

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
    last k-1 inputs, a view)."""
    S, k = xbc.shape[1], w.shape[0]
    full = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    full32, w = full.float(), w.float()
    out = b.float().expand(xbc.shape).clone()
    for i in range(k):
        out.addcmul_(full32[:, i:i + S], w[i])
    return F.silu(out).to(xbc.dtype), full[:, S:]


def _ssd_step_(xh, Bh, Ch, dt, A, D, h):
    """``layers.ssd_step`` with the new state written into ``h`` (B, nh,
    hp, ds) in two passes over it, h * exp(dt A) then + (dt x) B^T; the
    state is the largest tensor a decode step writes.  Returns y (B, nh,
    hp)."""
    h.mul_(torch.exp(dt * A[None, :])[:, :, None, None])
    h.addcmul_((dt[:, :, None] * xh)[..., None], Bh[:, :, None, :])
    return torch.einsum("bhn,bhpn->bhp", Ch, h) + xh * D[None, :, None]


def mamba_mixer(cfg: GraniteHybridConfig, p: dict, x: torch.Tensor,
                state: L.MambaState):
    """x (B, S, d), normed -> (out (B, S, d), ``state``), the new SSD
    state and conv tail written into ``state``'s tensors; S = 1 takes the
    SSD's one-token step."""
    B, S, _ = x.shape
    nh, hp, ds = cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state
    G, inner = cfg.mamba_n_groups, cfg.mamba_inner
    z, xbc, dt = torch.split(x @ p["in_proj"], [inner, cfg.conv_dim, nh],
                             dim=-1)
    xbc, tail = _conv_silu(xbc, p["conv_w"], p["conv_b"], state.conv)
    state.conv.copy_(tail)
    xs, Bm, Cm = torch.split(xbc, [inner, G * ds, G * ds], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, S, nh)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, nh, hp).float()
    Bh = Bm.reshape(B, S, G, ds).repeat_interleave(nh // G, dim=2).float()
    Ch = Cm.reshape(B, S, G, ds).repeat_interleave(nh // G, dim=2).float()
    if S == 1:
        y = _ssd_step_(xh[:, 0], Bh[:, 0], Ch[:, 0], dt[:, 0], A, p["D"],
                       state.h)
    else:
        y, h = L.ssd_chunked(xh, Bh, Ch, dt, A, p["D"], state.h, SSD_CHUNK)
        state.h.copy_(h)
    y = y.reshape(B, S, inner) * F.silu(z.float())
    y = L.rmsnorm(y, p["gate_norm"], cfg.rms_norm_eps).to(x.dtype)
    return y @ p["out_proj"], state


def attention_mixer(cfg: GraniteHybridConfig, p: dict, x: torch.Tensor,
                    state: KVState, pos):
    """x (B, S, d), normed, at positions pos..pos+S-1 -> (out, ``state``),
    k and v written into ``state``'s tensors.  A prefill (pos 0) runs the
    flash kernel over its own keys.  A decode step (S = 1; ``pos`` an int
    or a (1,) long tensor on x's device) attends in fp32 over all the
    cache's keys, those past ``pos`` masked to -inf before the softmax,
    which gives them weights of exactly 0."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    q = (x @ p["wq"]).view(B, S, H, hd)
    k = (x @ p["wk"]).view(B, S, KV, hd)
    v = (x @ p["wv"]).view(B, S, KV, hd)
    if S > 1:
        if pos:
            raise ValueError("a prefill starts at position 0")
        state.k[:, :S] = k
        state.v[:, :S] = v
        o = fa.flash_attention(q, k, v, causal=True,
                               scale=cfg.attention_multiplier)
    else:
        at = pos if torch.is_tensor(pos) else \
            torch.tensor([pos], device=x.device)
        state.k.index_copy_(1, at, k)
        state.v.index_copy_(1, at, v)
        # (B, KV, M, hd) in fp32, cast and transposed in one pass each
        keys, vals = (t.transpose(1, 2).to(
            torch.float32, memory_format=torch.contiguous_format)
            for t in (state.k, state.v))
        qg = q.view(B, KV, H // KV, hd).float()
        s = (qg @ keys.transpose(2, 3)) * cfg.attention_multiplier
        s = s.masked_fill(torch.arange(keys.shape[2], device=x.device) > at,
                          -torch.inf)                         # (B, KV, G, M)
        o = (torch.softmax(s, dim=-1) @ vals).to(x.dtype)
    return o.reshape(B, S, H * hd) @ p["wo"], state


def capacity(counts: torch.Tensor) -> int:
    """Slots an expert gets in a call of several positions: the call's
    largest load, so nothing is dropped."""
    return int(counts.max())


class Sublayer(NamedTuple):
    """One step of the walk: ``fn`` maps the residual stream (B, S, d) to
    the next (the head: to the logits); ``span`` is what a decode step
    opens around it."""

    span: str
    fn: Callable[[torch.Tensor], torch.Tensor]


class DecodeStep:
    """What the decode steps on one cache share: its ``states``, the
    residual stream's first buffer ``x`` (B, 1, d) and the position
    ``pos`` (1,) on the device, the step's sublayers bound to them, and,
    once captured on a CUDA device, one graph a sublayer and the head's
    output buffer."""

    def __init__(self, model: "GraniteHybrid", states: tuple, batch: int):
        embed = model.params["embed"]
        self.states = states
        self.x = torch.empty((batch, 1, embed.shape[1]), dtype=embed.dtype,
                             device=embed.device)
        self.pos = torch.zeros(1, dtype=torch.long, device=embed.device)
        self.sublayers = model._sublayers(states, self.pos) + [
            Sublayer("model/head", lambda x: model._head(x[:, -1]))]
        self.graphs: list = []
        self.out: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
class GraniteHybrid:
    """The model object ``serving.engine.Engine`` serves: ``init_cache``,
    ``prefill`` (last position's logits) and ``decode`` (one token), and
    ``forward`` (every position's logits, no cache).  ``stats`` counts
    the MoE calls and the sum of each call's mean expert load, and the
    decode steps run eagerly (``decode_eager_steps``) and replayed from
    graphs (``decode_graph_steps``) and the captures (``graph_captures``:
    one a batch on a CUDA device); the assignments dispatch dropped and
    the largest loads are counted on the device (``dropped``,
    ``load_stats``)."""

    def __init__(self, cfg: GraniteHybridConfig, params: dict):
        self.cfg, self.params = cfg, params
        # the layers' leaves, ``FP32_COPIES`` cast once (the same values)
        self._layers = [{**p, **{k: p[k].float() for k in FP32_COPIES
                                 if k in p}} for p in params["layers"]]
        self._final_norm = params["final_norm"].float()
        self.stats = {"moe_calls": 0, "mean_load_sum": 0.0,
                      "decode_eager_steps": 0, "decode_graph_steps": 0,
                      "graph_captures": 0}
        dev = params["embed"].device
        # the assignments dropped, the largest load, the sum of each
        # call's largest load
        self._dropped, self._max_load, self._max_load_sum = (
            torch.zeros((), dtype=torch.long, device=dev) for _ in range(3))
        self._step: DecodeStep | None = None
        self._capturing = False

    def dropped(self) -> int:
        """Assignments dispatch dropped, over every MoE call so far."""
        return int(self._dropped)

    def load_stats(self) -> dict:
        """Over every MoE call so far: the calls, the assignments dropped,
        the largest expert load of any call, and the means of each call's
        largest and mean load; one read of the device."""
        s, n = self.stats, max(1, self.stats["moe_calls"])
        dropped, largest, max_sum = torch.stack(
            [self._dropped, self._max_load, self._max_load_sum]).tolist()
        return {"calls": s["moe_calls"], "dropped": dropped,
                "largest": largest, "max_mean": max_sum / n,
                "mean_mean": s["mean_load_sum"] / n}

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> HybridCache:
        """A new cache; the last one's decode graphs are released first,
        so they and that cache are not held beside it."""
        self._step = None
        return init_cache(self.cfg, batch, max_len, dtype,
                          device or self.params["embed"].device)

    # -- sublayers ---------------------------------------------------------
    def _tally(self, tokens: int, calls: int = 1) -> None:
        self.stats["moe_calls"] += calls
        self.stats["mean_load_sum"] += calls * tokens \
            * self.cfg.num_experts_per_tok / self.cfg.num_local_experts

    def _moe(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """The routed experts plus the shared expert on x (B, S, d).  At
        S = 1 each expert gets T = B slots, else the call's largest
        load."""
        cfg = self.cfg
        B, S, d = x.shape
        E, K = cfg.num_local_experts, cfg.num_experts_per_tok
        xt = x.reshape(B * S, d)
        top, eidx = torch.topk(xt.float() @ p["router"].float(), K, dim=-1)
        gate = torch.softmax(top, dim=-1)
        C = B if S == 1 else capacity(L.count_ids(eidx, E))
        slot_tok, pair_slot, counts, kept = L.moe_dispatch(eidx, E, C)
        load = counts.max()
        self._dropped += kept.numel() - kept.sum()
        torch.maximum(self._max_load, load, out=self._max_load)
        self._max_load_sum += load
        if not self._capturing:
            self._tally(B * S)
        xe = xt[slot_tok].reshape(E, C, d)
        h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
        y = L.moe_combine(torch.bmm(h, p["wo_e"]).reshape(E * C, d),
                          pair_slot, gate).reshape(B, S, d)
        return y + (F.silu(x @ p["s_wg"]) * (x @ p["s_wu"])) @ p["s_wo"]

    def _sublayers(self, states: tuple, pos) -> list[Sublayer]:
        """Each layer's two sublayers over ``states`` at ``pos`` (an int,
        or a (1,) tensor on the device at decode): norm, mixer and
        residual; norm, experts and residual."""
        cfg, r, eps = self.cfg, self.cfg.residual_multiplier, \
            self.cfg.rms_norm_eps
        out = []
        for kind, p, st in zip(cfg.layers, self._layers, states):
            if kind == "mamba":
                def mix(x, p=p, st=st):
                    return x + mamba_mixer(
                        cfg, p, L.rmsnorm(x, p["ln1"], eps), st)[0] * r
            else:
                def mix(x, p=p, st=st):
                    return x + attention_mixer(
                        cfg, p, L.rmsnorm(x, p["ln1"], eps), st, pos)[0] * r

            def moe(x, p=p):
                return x + self._moe(p, L.rmsnorm(x, p["ln2"], eps)) * r
            out += [Sublayer(f"model/{kind}", mix), Sublayer("model/moe", moe)]
        return out

    def _walk(self, tokens: torch.Tensor, cache: HybridCache):
        """The layers over tokens (B, S) from ``cache``, eagerly and with
        no span."""
        x = self.params["embed"][tokens] * self.cfg.embedding_multiplier
        for sub in self._sublayers(cache.states, cache.pos):
            x = sub.fn(x)
        return x, HybridCache(cache.pos + tokens.shape[1], cache.states)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(x, self._final_norm, self.cfg.rms_norm_eps)
        return (x @ self.params["embed"].T).float() / self.cfg.logits_scaling

    def _capture(self, step: DecodeStep) -> None:
        """Record each of ``step``'s sublayers as a CUDA graph over its
        buffers, in one memory pool, on a side stream.  Nothing runs, so
        the cache does not advance and no count moves.  The allocator's
        cached blocks are released first (the prefill's activations may
        hold the whole card, and a capture can free none of them to
        fill its pool), and cuBLAS's workspaces before and after, so the
        one the captures take lies in the pool and goes with it."""
        dev = step.x.device
        torch.cuda.empty_cache()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        pool = torch.cuda.graph_pool_handle()
        graphs, x = [], step.x
        torch._C._cuda_clearCublasWorkspaces()
        self._capturing = True
        try:
            with torch.cuda.stream(stream):
                for sub in step.sublayers:
                    g = torch.cuda.CUDAGraph()
                    g.capture_begin(pool=pool)
                    x = sub.fn(x)
                    g.capture_end()
                    graphs.append(g)
        finally:
            self._capturing = False
            torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.current_stream(dev).wait_stream(stream)
        step.graphs, step.out = graphs, x
        self.stats["graph_captures"] += 1

    # -- entry points ------------------------------------------------------
    def prefill(self, tokens: torch.Tensor, cache: HybridCache):
        """tokens (B, S) into an empty cache -> (last position's logits
        (B, V) fp32, the filled cache)."""
        if cache.pos:
            raise ValueError("prefill takes an empty cache")
        self._step = None
        x, cache = self._walk(tokens, cache)
        return self._head(x[:, -1]), cache

    def decode(self, tokens: torch.Tensor, cache: HybridCache):
        """tokens (B, 1) -> (logits (B, V) fp32, the cache one longer).
        The first step on a cache runs eagerly, and on a CUDA device then
        captures the step's graphs; later steps on it replay them."""
        if tokens.shape[1] != 1:
            raise ValueError(f"decode takes one token, got {tokens.shape}")
        # checked here: past the keys, a replay would write out of bounds
        room = [st.k.shape[1] for st in cache.states
                if isinstance(st, KVState)]
        if room and cache.pos >= room[0]:
            raise ValueError(f"the cache's {room[0]} positions are all used")
        step = self._step
        if step is None or step.states is not cache.states:
            step = self._step = DecodeStep(self, cache.states,
                                           tokens.shape[0])
        torch.mul(self.params["embed"][tokens], self.cfg.embedding_multiplier,
                  out=step.x)
        step.pos.fill_(cache.pos)
        if step.graphs:
            for sub, g in zip(step.sublayers, step.graphs):
                with span(sub.span):
                    g.replay()
            self._tally(tokens.shape[0], self.cfg.num_hidden_layers)
            self.stats["decode_graph_steps"] += 1
            logits = step.out.clone()
        else:
            x = step.x
            for sub in step.sublayers:
                with span(sub.span):
                    x = sub.fn(x)
            logits = x
            self.stats["decode_eager_steps"] += 1
            if step.x.is_cuda:
                with span("model/capture"):
                    self._capture(step)
        return logits, HybridCache(cache.pos + 1, cache.states)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Every position's logits (B, S, V), through a throwaway cache."""
        B, S = tokens.shape
        x, _ = self._walk(tokens, init_cache(
            self.cfg, B, S, self.params["embed"].dtype,
            self.params["embed"].device))
        return self._head(x)
