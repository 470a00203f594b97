"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=1536, QK-norm. [hf:Qwen/Qwen3-235B-A22B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151936,
    n_experts=128, top_k=8, moe_d_ff=1536, moe_flags=(True,),
    qk_norm=True, rope_theta=1e6,
    capacity_factor=2.0, router_group_size=512,
).validate()
