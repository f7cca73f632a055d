"""Kimi K2 [arXiv:2501.kimi2 per assignment]: trillion-parameter MoE.
61L, d=7168, 64H GQA kv=8 (hd=128), 384 routed experts top-8,
per-expert ff=2048, vocab 163840."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=128,
    num_experts=384, experts_per_token=8, moe_d_ff=2048,
    pattern="attn_moe",
    source="arXiv:2501.kimi2 (Kimi K2, paper-table config)",
))
