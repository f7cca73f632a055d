"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite/granite-3.0-1b-a400m-base
family]: 32L, d=1536, 24H GQA kv=8, 40 routed experts top-8, per-expert
ff=512, vocab 49155 (padded to the model-axis multiple; DESIGN.md sec 6)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m", arch_type="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=40, experts_per_token=8, moe_d_ff=512,
    pattern="attn_moe",
    source="hf:ibm-granite/granite-3.0 MoE family",
))
