"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048. Decoder-only over EnCodec tokens (4 codebooks); the EnCodec
frontend is a STUB per spec — input_specs provides codebook token ids, the
embedding sums the 4 codebook tables. [arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, n_codebooks=4,
    act="gelu", rope_theta=10000.0,
).validate()
