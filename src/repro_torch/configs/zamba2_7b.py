"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone with a SHARED
attention+MLP block applied every 6th layer (weights shared across all
applications).  81 Mamba2 layers, d=3584, ssm_state=64; the shared block
uses 32 heads (kv=32) and ff=14336."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b", arch_type="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_expand=2, pattern="mamba", attn_every=6,
    source="arXiv:2411.15242 (Zamba2)",
))
