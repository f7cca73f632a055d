"""HuBERT X-Large [arXiv:2106.07447]: encoder-only audio transformer
(wav2vec2 architecture), 48L, d=1280, 16H, ff=5120; 504 masked-unit
classes.  Audio carve-out: the conv feature extractor is a STUB --
``input_specs`` provides precomputed frame embeddings (batch, frames, d).
Encoder => decode_32k / long_500k are skipped (DESIGN.md section 5)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge", arch_type="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, pattern="enc_attn", is_encoder=True,
    frontend="audio",
    source="arXiv:2106.07447 (HuBERT X-Large)",
))
