"""StarCoder2-15B [arXiv:2402.19173]: 40L, d=6144, 48H GQA kv=4,
ff=24576, RoPE, vocab 49152."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b", arch_type="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152, head_dim=128,
    pattern="attn_mlp",
    source="arXiv:2402.19173 (StarCoder2)",
))
