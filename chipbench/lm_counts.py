"""Work and bytes of the hybrid language model from its configuration's
shapes: the yardstick of ``flash_roofline.lm`` and ``mfu.lm``.

The counts come from the configuration (the published ``config.json``'s
keys), never from the program, so a later kernel that computes a layer
in another way is held to the same work.  FLOPs are 2 a multiply-add;
the SSD counts its recurrent form (the state's update and read, 4 *
heads * head dim * state a token); causal attention counts the pairs of
query and key that the mask keeps."""
from __future__ import annotations

from chipbench.counts import STORAGE_BYTES


def layer_types(cfg: dict) -> list[str]:
    return list(cfg["layer_types"][:cfg["num_hidden_layers"]])


def flash_call(cfg: dict, batch: int, seq: int,
               storage: str = "bf16") -> dict:
    """One causal prefill attention call: QK^T and PV over the S(S+1)/2
    visible pairs of each head, and q, k, v and o each read or written
    once."""
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    flops = 2.0 * batch * H * hd * seq * (seq + 1)
    nbytes = STORAGE_BYTES[storage] * batch * seq * hd * (2 * H + 2 * KV)
    return dict(flops=flops, bytes=float(nbytes))


def token_flops(cfg: dict) -> dict:
    """FLOPs a token, outside attention's scores: each layer kind's
    projections, conv and SSD, the router, the token's experts and the
    shared expert; and the head's."""
    d, E, K = cfg["hidden_size"], cfg["num_local_experts"], \
        cfg["num_experts_per_tok"]
    nh, hp, ds = cfg["mamba_n_heads"], cfg["mamba_d_head"], \
        cfg["mamba_d_state"]
    inner = nh * hp
    conv = inner + 2 * cfg["mamba_n_groups"] * ds
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    ffn = d * E + K * 3 * d * cfg["intermediate_size"] \
        + 3 * d * cfg["shared_intermediate_size"]
    mamba = d * (inner + conv + nh) + inner * d + cfg["mamba_d_conv"] * conv \
        + 2 * nh * hp * ds
    attention = d * (H + 2 * KV) * hd + H * hd * d
    return dict(mamba=2.0 * (mamba + ffn), attention=2.0 * (attention + ffn),
                head=2.0 * d * cfg["vocab_size"])


def attention_score_flops(cfg: dict, position: int) -> float:
    """QK^T and PV of one query at ``position`` (0-based) over its
    position + 1 keys, in one attention layer."""
    H = cfg["num_attention_heads"]
    return 4.0 * H * (cfg["hidden_size"] // H) * (position + 1)


def model_flops(cfg: dict, prefills: list, decodes: list) -> float:
    """FLOPs of ``prefills`` ((batch, prompt length) each: every prompt
    token through the layers, the last one through the head) and
    ``decodes`` ((batch, position of the token fed) each: one token a row
    through the layers and the head)."""
    t = token_flops(cfg)
    kinds = layer_types(cfg)
    per_token = sum(t[k] for k in kinds)
    n_attn = kinds.count("attention")
    H = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // H
    total = 0.0
    for b, s in prefills:
        total += b * (s * per_token + t["head"]
                      + n_attn * 2.0 * H * hd * s * (s + 1))
    for b, pos in decodes:
        total += b * (per_token + t["head"]
                      + n_attn * attention_score_flops(cfg, pos))
    return total

