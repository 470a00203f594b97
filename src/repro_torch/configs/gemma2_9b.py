"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Local(4096)/global alternating attention, attn softcap 50, final softcap 30,
gemma-style (1+w) RMSNorm with post-norms, GeGLU, scaled + tied embeddings.
[arXiv:2408.00118; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    windows=(4096, None), attn_softcap=50.0, final_softcap=30.0,
    act="gelu", norm_plus_one=True, post_norms=True,
    emb_scale=True, tie_embeddings=True, rope_theta=10000.0,
).validate()
