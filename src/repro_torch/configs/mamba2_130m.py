"""mamba2-130m [ssm]: 24L d_model=768 attention-free, ssm_state=128,
vocab=50280 (SSD / state-space duality). [arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
    tie_embeddings=True,
).validate()
