"""InternVL2-Llama3-76B language backbone [arXiv:2404.16821].

VLM carve-out: the InternViT-6B vision encoder + MLP projector are a STUB --
``input_specs`` provides precomputed patch embeddings of shape
(batch, n_patches, d_model); this config is the Llama-3-70B-class LM that
consumes them (80L, d=8192, 64H GQA kv=8, ff=28672, vocab 128256)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b", arch_type="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    pattern="attn_mlp", rope_theta=5e5, frontend="vision",
    source="arXiv:2404.16821 (InternVL2; LM = Llama-3-70B class)",
))
