"""Composable transformer LM covering all 10 assigned architectures: the
PyTorch port of ``repro.models.transformer`` (``forward`` in modes
``train`` / ``prefill``, ``decode_step``, and the Zamba2 segments).

The parameters keep the JAX package's layout: each block weight is
stacked on a leading layer axis (there for ``jax.lax.scan``), and the
port loops over that index, so ``params_from_numpy`` (the CNNs' weight
bridge, re-exported here) carries ``init_params``' tree across as it is.
Zamba2's pattern (a shared attention block after every ``attn_every``
Mamba2 layers, weights shared across applications) walks uniform padded
segments; the padded slots are skipped, where the JAX package computes
them and discards the result.  In mode ``train`` with ``cfg.remat ==
"block"`` (every config's default) each block, and each Zamba2 segment,
runs under ``torch.utils.checkpoint``: its activations are recomputed in
the backward pass, as ``jax.checkpoint`` does.  ``loss_fn`` is the
training objective.

The trainer differentiates per-layer views of the stacked weights
(``unstack_blocks``): each layer's gradient is its own tensor, and an
in-place update of a view writes through to the stack.  ``forward``
takes either form of ``params["blocks"]``.

Batch conventions:
  batch = {"tokens": (B,S) int, "labels": (B,S) int (train),
           "loss_mask": (B,S) f32 (train),
           "prefix_embeds": (B,P,d) (vlm/audio stub frontends)}
For frontend archs the embeddings REPLACE token embedding for the first P
positions (vision patches / audio frames) -- the stub carve-out."""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis import hlo
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.cnn import params_from_numpy  # noqa: F401
from repro_torch.tree import leaves, tree_map


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(cfg: ModelConfig, kind: str, g: torch.Generator, dtype,
                n: tuple, dev: torch.device):
    d = cfg.d_model

    def ones():
        return torch.ones(n + (d,), dtype=dtype, device=dev)
    if kind in ("attn_mlp", "enc_attn"):
        return {"ln1": ones(),
                "attn": L.init_attn_params(cfg, g, dtype, n, dev),
                "ln2": ones(),
                "mlp": L.init_mlp_params(d, cfg.d_ff, g, dtype,
                                         cfg.num_layers, n, dev)}
    if kind == "attn_moe":
        return {"ln1": ones(),
                "attn": L.init_attn_params(cfg, g, dtype, n, dev),
                "ln2": ones(),
                "moe": L.init_moe_params(cfg, g, dtype, n, dev)}
    if kind == "mamba":
        return {"ln1": ones(),
                "mamba": L.init_mamba_params(cfg, g, dtype, n, dev)}
    if kind == "rwkv":
        return {"ln1": ones(),
                "rwkv": L.init_rwkv_params(cfg, g, dtype, n, dev)}
    raise ValueError(kind)


def _zamba_segments(cfg: ModelConfig) -> tuple[int, int]:
    """(n_seg, n_slots): layers padded to full segments of ``attn_every``."""
    n_seg = -(-cfg.num_layers // cfg.attn_every)
    return n_seg, n_seg * cfg.attn_every


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device: str | torch.device = "cuda") -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default the card; raises without one), in the JAX
    package's shapes and scales, block weights stacked on a leading layer
    axis.  The stream is torch's own: for weights equal to ``repro``'s,
    carry its ``init_params`` across with ``params_from_numpy``.  On
    ``device="meta"`` the tree has every shape and dtype and holds no
    memory (the dry-run's parameters, at any size)."""
    dev = resolve_device(device)
    # meta has no generator of its own: a CPU one stands in, and draws
    # nothing on meta
    g = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    g.manual_seed(seed)
    d, V = cfg.d_model, cfg.padded_vocab
    params: dict[str, Any] = {
        "embed": L._normal(g, (V, d), dtype, 0.02, dev),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L._normal(g, (d, V), dtype, 1.0 / d ** 0.5, dev)
    if cfg.pattern == "mamba" and cfg.attn_every:
        _, n_slots = _zamba_segments(cfg)
        params["blocks"] = _init_block(cfg, "mamba", g, dtype, (n_slots,),
                                       dev)
        params["shared"] = _init_block(cfg, "attn_mlp", g, dtype, (), dev)
    else:
        params["blocks"] = _init_block(cfg, cfg.pattern, g, dtype,
                                       (cfg.num_layers,), dev)
    return params


def _layer(tree, i: int):
    """Layer i's slice of a tree stacked on a leading axis, or entry i of
    a list of per-layer trees (``unstack_blocks``)."""
    if isinstance(tree, list):
        return tree[i]
    return tree_map(lambda t: t[i], tree)


def unstack_blocks(tree: dict) -> dict:
    """``tree`` (params, or AdamW moments of the same shape) with
    ``"blocks"`` as a list of per-layer trees whose leaves are views
    ``t[i]`` of the stacked tensors: no copy, and writing into a view
    writes into the stack."""
    n = leaves(tree["blocks"])[0].shape[0]
    return {**tree, "blocks": [_layer(tree["blocks"], i) for i in range(n)]}


def _remat(cfg: ModelConfig, train: bool, fn):
    """``fn`` under block remat (``jax.checkpoint``'s counterpart) when
    training with ``cfg.remat == "block"``, else ``fn`` itself."""
    if not (train and cfg.remat == "block"):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _mark_unit(x, i: int) -> None:
    """Before remat unit i (a block, or a Zamba2 segment) on x: its
    forward begins, and when x's gradient is complete its backward is
    done and unit i - 1's (or the embedding's) begins.
    ``analysis/hlo.py``'s stage marks: nothing is dispatched, and off the
    dry-run's memory count nothing is registered."""
    hlo.mark(f"forward: unit {i}")
    hlo.mark_at_grad(x, f"backward: unit {i - 1}" if i
                     else "backward: embedding")


def _mark_head(x, n: int) -> None:
    """After the last of n units: the head and loss begin, and their
    backward ends when x's gradient is complete (``_mark_unit``)."""
    hlo.mark("head")
    hlo.mark_at_grad(x, f"backward: unit {n - 1}")


def _stack(trees: list):
    """Stack per-layer trees (dicts or NamedTuples of tensors)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(_stack([t[j] for t in trees])
                             for j in range(len(first))))
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
class Cache(NamedTuple):
    pos: int                         # number of tokens consumed (host int)
    kv: Any = None                   # stacked L.KVCache, leading axis = layer
    ssm: Any = None                  # stacked L.MambaState
    rwkv: Any = None                 # stacked L.RWKVState
    shared_kv: Any = None            # zamba: (n_seg,) stacked KVCache


def cache_max_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: str | torch.device = "cuda"
               ) -> Cache:
    """Empty caches on ``device`` (default the card; raises without one)."""
    M = cache_max_len(cfg, max_len)
    dev = resolve_device(device)

    def stack(n, fn):
        return _stack([fn() for _ in range(n)])

    if cfg.pattern in ("attn_mlp", "attn_moe"):
        kv = stack(cfg.num_layers,
                   lambda: L.init_kv_cache(cfg, batch, M, dtype, dev))
        return Cache(pos=0, kv=kv)
    if cfg.pattern == "rwkv":
        d = cfg.d_model
        nh = d // L.RWKV_HD
        st = stack(cfg.num_layers, lambda: L.RWKVState(
            wkv=torch.zeros((batch, nh, L.RWKV_HD, L.RWKV_HD),
                            dtype=torch.float32, device=dev),
            x_tm=torch.zeros((batch, d), dtype=dtype, device=dev),
            x_cm=torch.zeros((batch, d), dtype=dtype, device=dev)))
        return Cache(pos=0, rwkv=st)
    if cfg.pattern == "mamba":
        inner = cfg.ssm_expand * cfg.d_model
        nh, hp = cfg.n_mamba_heads, inner // cfg.n_mamba_heads

        def one():
            return L.MambaState(
                h=torch.zeros((batch, nh, hp, cfg.ssm_state),
                              dtype=torch.float32, device=dev),
                conv=torch.zeros((batch, L.CONV_K - 1, inner), dtype=dtype,
                                 device=dev))
        shared_kv = None
        n_states = cfg.num_layers
        if cfg.attn_every:
            n_seg, n_slots = _zamba_segments(cfg)
            n_states = n_slots          # padded slots carry (unused) state
            shared_kv = stack(n_seg, lambda: L.init_kv_cache(
                cfg, batch, M, dtype, dev))
        return Cache(pos=0, ssm=stack(n_states, one), shared_kv=shared_kv)
    raise ValueError(cfg.pattern)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _apply_block(cfg: ModelConfig, kind: str, p, x, *, positions,
                 kv_cache=None, ssm_state=None, rwkv_state=None,
                 decode: bool = False):
    """Returns (x, new_state, aux_loss); new_state is the block's own
    cache entry (KVCache, MambaState or RWKVState; None without one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn_mlp", "attn_moe", "enc_attn"):
        h, kv_new = L.attention(cfg, p["attn"],
                                L.rmsnorm(x, p["ln1"], cfg.norm_eps),
                                positions=positions, cache=kv_cache,
                                causal=not cfg.is_encoder)
        x = x + h
        z = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if kind == "attn_moe":
            h, aux = L.moe(cfg, p["moe"], z)
        else:
            h = L.swiglu(p["mlp"], z)
        return x + h, kv_new, aux
    if kind == "mamba":
        z = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        if decode:
            h, ssm_out = L.mamba2_step(cfg, p["mamba"], z, ssm_state)
        else:
            h, ssm_out = L.mamba2(cfg, p["mamba"], z, ssm_state)
        return x + h, ssm_out, aux
    if kind == "rwkv":
        z = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        h, rwkv_out = L.rwkv6(cfg, p["rwkv"], z, rwkv_state)
        return x + h, rwkv_out, aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Forward (train / prefill) and decode
# ---------------------------------------------------------------------------
def _embed_inputs(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Token embeddings, optionally prefixed by stub-frontend embeddings
    (vision patches / audio frames).  Encoder-only audio archs may have no
    tokens at all (pure frame input)."""
    tok = batch.get("tokens")
    x = L.embed(params["embed"], tok) \
        if tok is not None and tok.shape[-1] > 0 else None
    if cfg.frontend != "none" and "prefix_embeds" in batch:
        pe = batch["prefix_embeds"]
        pe = pe.to(x.dtype if x is not None else params["embed"].dtype)
        x = pe if x is None else torch.cat([pe, x], dim=1)
    if x is None:
        raise ValueError("batch must contain tokens or prefix_embeds")
    return x


def _logits(cfg: ModelConfig, params, x):
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ unembed).float()


def _walk(cfg, params, x, positions, cache: Cache | None, decode: bool,
          train: bool = False):
    """The layer stack over x; returns (x, aux, per-layer new states).
    ``train`` puts each block under remat (``_remat``)."""
    kind = cfg.pattern
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    states = []

    def block(p, x, st):
        return _apply_block(
            cfg, kind, p, x, positions=positions,
            kv_cache=st if kind in ("attn_mlp", "attn_moe") else None,
            ssm_state=st if kind == "mamba" else None,
            rwkv_state=st if kind == "rwkv" else None, decode=decode)
    block = _remat(cfg, train, block)
    for i in range(cfg.num_layers):
        st = None
        if cache is not None:
            st = _layer(cache.kv if kind in ("attn_mlp", "attn_moe")
                        else cache.rwkv if kind == "rwkv" else cache.ssm, i)
        _mark_unit(x, i)
        x, st_o, a = block(_layer(params["blocks"], i), x, st)
        aux = aux + a
        states.append(st_o)
    _mark_head(x, cfg.num_layers)
    return x, aux, states


def _new_cache(cfg, cache: Cache, S: int, states) -> Cache:
    st = _stack(states)
    kind = cfg.pattern
    return Cache(pos=cache.pos + S,
                 kv=st if kind in ("attn_mlp", "attn_moe") else None,
                 ssm=st if kind == "mamba" else None,
                 rwkv=st if kind == "rwkv" else None)


def _positions(pos0: int, B: int, S: int, dev) -> torch.Tensor:
    return (pos0 + torch.arange(S, dtype=torch.int32, device=dev))[None, :] \
        .expand(B, S)


def forward(cfg: ModelConfig, params, batch, *, mode: str = "train",
            cache: Cache | None = None):
    """mode 'train'/'prefill'. Returns (logits, new_cache, aux_loss).

    cache is only consumed/produced in prefill mode (SSM initial states /
    KV-cache fill for subsequent decode)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', got {mode!r}")
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    pos0 = 0 if cache is None else cache.pos
    positions = _positions(pos0, B, S, x.device)
    train = mode == "train"
    if cfg.pattern == "mamba" and cfg.attn_every:
        x, new_cache, aux = _zamba_forward(cfg, params, x, positions, cache,
                                           decode=False, train=train)
    else:
        x, aux, states = _walk(cfg, params, x, positions, cache,
                               decode=False, train=train)
        new_cache = None if cache is None \
            else _new_cache(cfg, cache, S, states)
    return _logits(cfg, params, x), new_cache, aux


def _zamba_masks(cfg):
    """(layer_active (n_seg, k), attn_active (n_seg,)) as static arrays."""
    n_seg, n_slots = _zamba_segments(cfg)
    k = cfg.attn_every
    slot = np.arange(n_slots).reshape(n_seg, k)
    layer_active = slot < cfg.num_layers
    attn_active = (np.arange(n_seg) + 1) * k <= cfg.num_layers
    return layer_active, attn_active


def _zamba_forward(cfg, params, x, positions, cache: Cache | None,
                   decode: bool, train: bool = False):
    """Zamba2: segments of ``attn_every`` Mamba2 slots followed by the
    shared attention block.  Padded slots and a segment whose attention is
    past the last layer are skipped (the JAX package computes and masks
    them out); their cache entries are carried over unchanged and never
    read.  ``train`` puts each segment under remat (``_remat``).  Returns
    (x, new_cache or None, aux)."""
    n_seg, n_slots = _zamba_segments(cfg)
    k = cfg.attn_every
    shared = params["shared"]
    layer_active, attn_active = _zamba_masks(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ssm_out, skv_out = [], []

    def segment(s, x, aux, sts, skv):
        sts = list(sts)
        for j in range(k):
            if layer_active[s, j]:
                x, sts[j], a = _apply_block(
                    cfg, "mamba", _layer(params["blocks"], s * k + j), x,
                    positions=positions, ssm_state=sts[j], decode=decode)
                aux = aux + a
        if attn_active[s]:
            x, skv, a = _apply_block(cfg, "attn_mlp", shared, x,
                                     positions=positions, kv_cache=skv)
            aux = aux + a
        return x, aux, sts, skv
    segment = _remat(cfg, train, segment)
    for s in range(n_seg):
        sts = [None if cache is None else _layer(cache.ssm, s * k + j)
               for j in range(k)]
        skv = None if cache is None else _layer(cache.shared_kv, s)
        _mark_unit(x, s)
        x, aux, sts, skv = segment(s, x, aux, sts, skv)
        ssm_out += sts
        skv_out.append(skv)
    _mark_head(x, n_seg)
    if cache is None:
        return x, None, aux
    return x, Cache(pos=cache.pos + positions.shape[1],
                    ssm=_stack(ssm_out), shared_kv=_stack(skv_out)), aux


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor,
                cache: Cache):
    """One-token serve step. tokens: (B, 1). Returns (logits, new_cache)."""
    if cfg.is_encoder:
        raise ValueError("encoder-only archs have no decode step")
    x = L.embed(params["embed"], tokens)
    B, S, _ = x.shape
    positions = _positions(cache.pos, B, 1, x.device)
    if cfg.pattern == "mamba" and cfg.attn_every:
        x, new_cache, _ = _zamba_forward(cfg, params, x, positions, cache,
                                         decode=True)
    else:
        x, _, states = _walk(cfg, params, x, positions, cache, decode=True)
        new_cache = _new_cache(cfg, cache, 1, states)
    return _logits(cfg, params, x), new_cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def loss_fn(cfg: ModelConfig, params, batch, aux_weight: float = 0.01):
    """Next-token CE (decoder) or per-frame classification CE (encoder),
    from fp32 logits.  Returns (loss, {"ce", "aux"})."""
    logits, _, aux = forward(cfg, params, batch, mode="train")
    labels = batch["labels"]
    if cfg.frontend != "none" and logits.shape[1] != labels.shape[1]:
        # frontend prefix positions carry no labels
        logits = logits[:, -labels.shape[1]:]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    ll = L.token_logprobs(logits, labels)
    ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}
