"""zamba2-7b [hybrid]: 81L d_model=3584, Mamba2 backbone (ssm_state=64) with a
shared attention+MLP block (32H MHA, d_ff=14336) applied every 3rd layer
(27 call sites, weights shared). [arXiv:2411.15242; unverified]

81 mamba layers with shared_attn_every=3 gives 27 shared-block invocations;
head_dim 112 = 3584/32.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
    shared_attn_every=3, rope_theta=10000.0,
).validate()
