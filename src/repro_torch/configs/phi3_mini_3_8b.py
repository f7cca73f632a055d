"""Phi-3-mini 3.8B [arXiv:2404.14219]: 32L, d=3072, 32H MHA (kv=32),
SwiGLU ff=8192, RoPE, vocab 32064."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b", arch_type="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, pattern="attn_mlp",
    source="arXiv:2404.14219 (Phi-3)",
))
