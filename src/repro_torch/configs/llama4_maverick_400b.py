"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
vocab=202048, MoE 128 experts top-1 + shared expert (d_ff=8192 each), MoE on
alternating layers with dense d_ff=16384 between; 3-of-4 layers use chunked
(8192) attention (iRoPE-style), 4th is global. Early fusion = token-level
(modality frontends stubbed). [hf:meta-llama/Llama-4-Maverick; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=202048,
    n_experts=128, top_k=1, moe_d_ff=8192, shared_expert_d_ff=8192,
    moe_flags=(False, True), windows=(8192, 8192, 8192, None),
    rope_theta=500000.0,
    capacity_factor=4.0, router_group_size=512,
).validate()
