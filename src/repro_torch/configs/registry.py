"""--arch <id> registry over the assigned architectures."""
from __future__ import annotations

from .base import ModelConfig
from . import (gemma2_9b, llama4_maverick_400b, mamba2_130m, musicgen_large,
               qwen2_5_14b, qwen2_7b, qwen2_vl_2b, qwen3_moe_235b,
               smollm_360m, zamba2_7b)

ARCHS: dict[str, ModelConfig] = {
    "qwen2-7b": qwen2_7b.CONFIG,
    "gemma2-9b": gemma2_9b.CONFIG,
    "qwen2.5-14b": qwen2_5_14b.CONFIG,
    "smollm-360m": smollm_360m.CONFIG,
    "musicgen-large": musicgen_large.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "llama4-maverick-400b-a17b": llama4_maverick_400b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "qwen2-vl-2b": qwen2_vl_2b.CONFIG,
    "mamba2-130m": mamba2_130m.CONFIG,
}


def get(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]
