"""Parameter counts and MODEL_FLOPS, the roofline's useful-work numerator
(port of ``repro/launch/modelmeta.py``).

Conventions (the reference's): N = matmul-participating params —
embedding *tables* excluded (gathers), LM head included (it is a matmul;
for tied embeddings the table is counted once here). MoE experts count at
``top_k / n_experts`` of their parameters (active-path FLOPs), shared
experts fully. MODEL_FLOPS = 6·N·tokens for training, 2·N·tokens for
prefill and 2·N·batch for a decode step. Attention score/value FLOPs are
left out by this convention.

Counts come from shapes alone: the parameter tree is built on the
``meta`` device (``launch.steps.abstract_params``), so the 235 B and 400 B
configs are never allocated.
"""
from __future__ import annotations

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import Shape

__all__ = ["param_counts", "model_flops"]


def param_counts(cfg: ModelConfig) -> dict:
    """``{"total": all params, "active": matmul-active params per token,
    "embedding": the embedding tables}``."""
    from .steps import abstract_params
    total = active = embed = 0
    for path, leaf in tr.flatten_with_path(abstract_params(cfg))[0]:
        keys = [str(k) for k in path]
        size = leaf.numel()
        total += size
        name = keys[-1] if keys else ""
        if name == "embed":
            embed += size
            if cfg.tie_embeddings and not cfg.n_codebooks:
                active += size          # reused as the LM-head matmul
            continue
        if "moe" in keys and name in ("w1", "w2", "w3"):
            active += size * cfg.top_k / max(cfg.n_experts, 1)
            continue
        active += size
    return {"total": total, "active": active, "embedding": embed}


def model_flops(cfg: ModelConfig, shape: Shape) -> float:
    n = param_counts(cfg)["active"]
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch
