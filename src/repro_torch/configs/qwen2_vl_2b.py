"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
M-RoPE (sections 16/24/24 over the rotary half-dim), dynamic-resolution vision
frontend STUBBED per spec: input_specs provides precomputed patch embeddings
merged into the leading positions. [arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
    tie_embeddings=True,
).validate()
