"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

DeepSeek-V3-style MoE: 64 routed experts, top-6, per-expert ff=1408,
48L, d=2048, 16H (kv=16, MHA), vocab 163840."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b", arch_type="dense",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    num_experts=64, experts_per_token=6, moe_d_ff=1408,
    pattern="attn_moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
))
