"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
Llama-arch small. [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152,
    rope_theta=10000.0, tie_embeddings=True,
).validate()
