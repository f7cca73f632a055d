"""RWKV-6 'Finch' 7B [arXiv:2404.05892]: attention-free RNN with
data-dependent decay. 32L, d=4096 (64 heads x 64), channel-mix ff=14336,
vocab 65536."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b", arch_type="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536, head_dim=64, pattern="rwkv",
    source="arXiv:2404.05892 (RWKV-6 Finch)",
))
