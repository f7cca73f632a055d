"""Granite-4.0-H (``granitemoehybrid``) in plain PyTorch: the reference
that the served model is held to.

The configuration is a plain dict with the published ``config.json``'s
keys; the model is the first ``num_hidden_layers`` of ``layer_types``.
``forward`` runs whole token sequences, one at a time, with no cache and
no batching, in fp32 with TF32 off, layer by layer: each layer's weights
are drawn from the seed (as the served model draws them, a generator a
layer), applied to every sequence and dropped, so a model larger than the
card's memory is computed a layer at a time.  ``store`` rounds the
weights the served model keeps in bf16, and the activations it keeps, to
the storage type and back: bf16 storage with fp32 arithmetic is ``store =
to bf16 and back``, a lower storage type (the control) another ``store``.

Each layer follows the published description (Hugging Face's
``GraniteMoeHybridDecoderLayer``)::

    h = h + residual_multiplier * mixer(rmsnorm(h))
    n = rmsnorm(h)
    h = h + residual_multiplier * (moe(n) + shared(n))

with the embedding times ``embedding_multiplier``, the tied head divided
by ``logits_scaling``; NoPE attention with softmax scale
``attention_multiplier``; Mamba-2 with the conv over xBC with its bias,
``softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the D skip and the gated
RMSNorm over the inner width.  The SSD is computed by its quadratic form
(``y_t = sum_{u <= t} (C_t . B_u) exp(sum_{u < k <= t} dt_k A) dt_u x_u``)
and each expert on the tokens that chose it.

Departures: the weights are random, drawn from the seed at scales of our
choosing (1/sqrt(fan in) for every projection but wq and wk, which give
the attention scores a spread of 2; N(0, 0.1) for the embedding); the
published ``input_linear`` of an expert, ``[wg | wu]``, is held as its
two halves.  Nothing of the program is imported."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0      # float8_e4m3fn's largest finite value
FP32_LEAVES = frozenset(("A_log", "dt_bias", "D", "conv_b"))
TIE_MARGIN = 1e-2    # router logits: a gap below it at the k-th choice


def store_as(dtype: torch.dtype):
    """Round fp32 values to ``dtype`` and back.  float8_e4m3fn has no
    infinity, so its values saturate at +-448 first."""
    if dtype == torch.float32:
        return lambda t: t
    if dtype == torch.float8_e4m3fn:
        return lambda t: t.clamp(-FP8_MAX, FP8_MAX).to(dtype).float()
    return lambda t: t.to(dtype).float()


@contextlib.contextmanager
def strict_fp32():
    """fp32 matmuls in full fp32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def layer_types(cfg: dict) -> list[str]:
    return list(cfg["layer_types"][:cfg["num_hidden_layers"]])


def _dims(cfg: dict) -> dict:
    inner = cfg["mamba_n_heads"] * cfg["mamba_d_head"]
    return dict(d=cfg["hidden_size"], inner=inner,
                conv=inner + 2 * cfg["mamba_n_groups"] * cfg["mamba_d_state"],
                hd=cfg["hidden_size"] // cfg["num_attention_heads"])


# ---------------------------------------------------------------------------
# Weights, drawn as the served model draws them
# ---------------------------------------------------------------------------
def leaves(cfg: dict, kind: str) -> list[tuple]:
    """(name, shape, init) of one layer's leaves in drawing order."""
    dm = _dims(cfg)
    d, inner, conv, hd = dm["d"], dm["inner"], dm["conv"], dm["hd"]
    E, K = cfg["num_local_experts"], cfg["mamba_d_conv"]
    ff, sff = cfg["intermediate_size"], cfg["shared_intermediate_size"]
    nh = cfg["mamba_n_heads"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]

    def normal(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))
    out = [("ln1", (d,), "norm")]
    if kind == "mamba":
        out += [("in_proj", (d, inner + conv + nh), normal(d)),
                ("conv_w", (K, conv), normal(K)),
                ("conv_b", (conv,), ("normal", 0.1)),
                ("dt_bias", (nh,), "dt_bias"), ("A_log", (nh,), "A_log"),
                ("D", (nh,), "norm"), ("gate_norm", (inner,), "norm"),
                ("out_proj", (inner, d), normal(inner))]
    else:
        # q and k at the scale that gives the scores a spread of 2 under
        # the published multiplier (a trained model's attention is far
        # from uniform)
        qk = ("normal", math.sqrt(2.0 / (cfg["attention_multiplier"]
                                         * math.sqrt(hd) * d)))
        out += [("wq", (d, H * hd), qk), ("wk", (d, KV * hd), qk),
                ("wv", (d, KV * hd), normal(d)),
                ("wo", (H * hd, d), normal(H * hd))]
    out += [("ln2", (d,), "norm"), ("router", (d, E), normal(d)),
            ("wg", (E, d, ff), normal(d)), ("wu", (E, d, ff), normal(d)),
            ("wo_e", (E, ff, d), normal(ff)), ("s_wg", (d, sff), normal(d)),
            ("s_wu", (d, sff), normal(d)), ("s_wo", (sff, d), normal(sff))]
    return out


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % 2**63)


def _draw(g, shape, init, device) -> torch.Tensor:
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


def draw_head(cfg: dict, seed: int, device, store) -> dict:
    """The tied embedding and the final norm (stream 0)."""
    g = _generator(seed, 0, device)
    V, d = cfg["vocab_size"], cfg["hidden_size"]
    embed = store(_draw(g, (V, d), ("normal", 0.1), device))
    return {"embed": embed, "final_norm": store(_draw(g, (d,), "norm",
                                                      device))}


def draw_layer(cfg: dict, i: int, seed: int, device, store) -> dict:
    """Layer i's weights (stream i + 1), fp32, those the served model
    keeps in its storage type rounded by ``store``."""
    g = _generator(seed, i + 1, device)
    out = {}
    for name, shape, init in leaves(cfg, layer_types(cfg)[i]):
        t = _draw(g, shape, init, device)
        out[name] = t if name in FP32_LEAVES else store(t)
    return out


# ---------------------------------------------------------------------------
# One sequence through one layer
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def mamba(cfg: dict, p: dict, x: torch.Tensor, store) -> torch.Tensor:
    """Mamba-2 on one sequence x (S, d), normed."""
    S = x.shape[0]
    dm = _dims(cfg)
    nh, hp, ds = cfg["mamba_n_heads"], cfg["mamba_d_head"], \
        cfg["mamba_d_state"]
    G, K = cfg["mamba_n_groups"], cfg["mamba_d_conv"]
    z, xbc, dt = torch.split(store(x @ p["in_proj"]),
                             [dm["inner"], dm["conv"], nh], dim=-1)
    xbc = F.conv1d(xbc.T[None], p["conv_w"].T[:, None, :], p["conv_b"],
                   padding=K - 1, groups=dm["conv"])[0, :, :S].T
    xs, Bm, Cm = torch.split(store(F.silu(xbc)),
                             [dm["inner"], G * ds, G * ds], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                       # (S, nh)
    la = (dt * -torch.exp(p["A_log"])).T                     # (nh, S)
    # seg[h, t, u] = sum_{u < k <= t} la[h, k], by a cumsum of the masked
    # increments (exact where a difference of two long cumsums is not)
    below = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                  device=x.device), -1)
    seg = torch.cumsum(la[:, :, None].expand(nh, S, S)
                       .masked_fill(~below, 0.0), dim=1)
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))
    decay = torch.exp(seg.masked_fill(~causal, -math.inf))   # (nh, S, S)
    del seg
    group = torch.arange(nh, device=x.device) // (nh // G)
    cb = torch.einsum("tgn,ugn->gtu", Cm.view(S, G, ds), Bm.view(S, G, ds))
    mix = decay * cb[group] * dt.T[:, None, :]
    del decay
    xh = xs.view(S, nh, hp).transpose(0, 1)                  # (nh, S, hp)
    y = mix @ xh + p["D"][:, None, None] * xh
    y = y.transpose(0, 1).reshape(S, dm["inner"]) * F.silu(z)
    y = store(rmsnorm(y, p["gate_norm"], cfg["rms_norm_eps"]))
    return store(y @ p["out_proj"])


def attention(cfg: dict, p: dict, x: torch.Tensor, store) -> torch.Tensor:
    """Causal GQA with no positional encoding on x (S, d), normed."""
    S = x.shape[0]
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        _dims(cfg)["hd"]
    q = store(x @ p["wq"]).view(S, H, hd).transpose(0, 1)
    k = store(x @ p["wk"]).view(S, KV, hd).transpose(0, 1)
    v = store(x @ p["wv"]).view(S, KV, hd).transpose(0, 1)
    k, v = (t.repeat_interleave(H // KV, dim=0) for t in (k, v))
    s = (q @ k.transpose(1, 2)) * cfg["attention_multiplier"]
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))
    o = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1) @ v
    return store(store(o.transpose(0, 1).reshape(S, H * hd)) @ p["wo"])


def moe(cfg: dict, p: dict, x: torch.Tensor, store):
    """The routed experts plus the shared expert on x (S, d), normed;
    also how many tokens' k-th and (k+1)-th router logits lie within
    ``TIE_MARGIN`` (a choice that rounding may turn)."""
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    logits = x @ p["router"]
    top, idx = torch.topk(logits, min(K + 1, E), dim=-1)
    ties = int((top[:, K - 1] - top[:, K] < TIE_MARGIN).sum()) \
        if K < E else 0
    gate = torch.softmax(top[:, :K], dim=-1)
    idx = idx[:, :K]
    y = torch.zeros_like(x)
    for e in range(E):
        tok, k = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            xe = x[tok]
            h = store(F.silu(xe @ p["wg"][e]) * (xe @ p["wu"][e]))
            y.index_add_(0, tok, gate[tok, k, None] * store(h @ p["wo_e"][e]))
    shared = store(F.silu(x @ p["s_wg"]) * (x @ p["s_wu"])) @ p["s_wo"]
    return store(store(y) + store(shared)), ties


def layer(cfg: dict, kind: str, p: dict, h: torch.Tensor, store):
    """One layer on one sequence h (S, d); the router's near-ties too."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    n = store(rmsnorm(h, p["ln1"], eps))
    m = mamba(cfg, p, n, store) if kind == "mamba" \
        else attention(cfg, p, n, store)
    h = store(h + r * m)
    f, ties = moe(cfg, p, store(rmsnorm(h, p["ln2"], eps)), store)
    return store(h + r * f), ties


def forward(cfg: dict, seed: int, seqs: list[torch.Tensor], *, device,
            store, rows: list | None = None):
    """The logits of each token sequence in ``seqs`` (1-D token ids) at
    its positions ``rows[j]`` (an index or slice; default every
    position), and the count of router near-ties over every layer and
    token.  The weights are drawn on ``device`` from ``seed``."""
    rows = rows or [slice(None)] * len(seqs)
    ties = 0
    with strict_fp32():
        head = draw_head(cfg, seed, device, store)
        hs = [store(head["embed"][s.to(device)]
                    * cfg["embedding_multiplier"]) for s in seqs]
        for i, kind in enumerate(layer_types(cfg)):
            p = draw_layer(cfg, i, seed, device, store)
            for j, h in enumerate(hs):
                hs[j], t = layer(cfg, kind, p, h, store)
                ties += t
            del p
        out = [store(rmsnorm(h[r], head["final_norm"], cfg["rms_norm_eps"]))
               @ head["embed"].T / cfg["logits_scaling"]
               for h, r in zip(hs, rows)]
    return out, ties
