"""Qwen3-4B [hf:Qwen/Qwen3-8B family]: 36L, d=2560, 32H GQA kv=8,
head_dim=128, qk-norm, SwiGLU ff=9728, vocab 151936."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-4b", arch_type="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128, qk_norm=True,
    pattern="attn_mlp", rope_theta=1e6,
    source="hf:Qwen/Qwen3 family",
))
