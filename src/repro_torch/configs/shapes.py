"""Assigned input-shape set (LM family), port of ``repro/configs/shapes.py``:
every shape applies to every arch, with the documented exceptions
(long_500k only for sub-quadratic archs).

``moe_capacity`` is ``models/moe.py``'s one rule, imported here for the
MoE problems of :func:`sc_gemm_problems`.

:func:`input_specs` and :func:`cache_specs` are the dry run's stand-ins
for one step's inputs (the reference's ``jax.ShapeDtypeStruct`` trees):
tensors on the ``meta`` device, shapes and dtypes without storage.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.moe import moe_capacity

from .base import ModelConfig

__all__ = ["Shape", "SHAPES", "is_applicable", "sc_gemm_problems",
           "moe_capacity", "input_specs", "cache_specs"]


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

#: archs allowed to run long_500k (sub-quadratic decode state growth)
_SUBQUADRATIC_FAMILIES = {"ssm", "hybrid"}


def is_applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """(runnable?, reason-if-not). Per spec: long_500k is skipped for pure
    full-attention archs; all assigned archs are decoders so decode always
    runs."""
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC_FAMILIES:
        return False, (f"{cfg.name} is (or contains) full quadratic attention; "
                       "long_500k requires sub-quadratic decode (spec: run for "
                       "SSM/hybrid only)")
    return True, ""


def sc_gemm_problems(cfg: ModelConfig,
                     shape: Shape) -> list[tuple[int, int, int]]:
    """Distinct (M, K, N) SC-GEMM problems a forward at this shape routes
    through the SC-GEMM when ``cfg.use_sc_gemm``.

    M is the token count the projection sees (one new token per sequence
    for decode); the K/N pairs enumerate the per-layer dense projections —
    attention QKV/O, the (gated) MLP, Mamba in/out, per-expert FFN rows,
    and the chunked LM head. The autotuner's keys at a shape are these
    problems at ``bucket_m(M)``.
    """
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    d = cfg.d_model
    probs: set[tuple[int, int, int]] = set()
    if cfg.family != "ssm":
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        probs.add((tokens, d, h * hd))          # wq
        probs.add((tokens, d, kv * hd))         # wk, wv
        probs.add((tokens, h * hd, d))          # wo
    if cfg.d_ff:
        probs.add((tokens, d, cfg.d_ff))        # w1, w3
        probs.add((tokens, cfg.d_ff, d))        # w2
    if cfg.n_experts and cfg.moe_d_ff:
        g = min(cfg.router_group_size, tokens)
        rows = (tokens // g) * moe_capacity(cfg)  # per-expert dispatch rows
        probs.add((rows, d, cfg.moe_d_ff))
        probs.add((rows, cfg.moe_d_ff, d))
        if cfg.shared_expert_d_ff:
            probs.add((tokens, d, cfg.shared_expert_d_ff))
            probs.add((tokens, cfg.shared_expert_d_ff, d))
    if cfg.ssm_state:
        d_in = cfg.d_inner
        proj_out = 2 * d_in + 2 * cfg.ssm_state + cfg.ssm_heads
        probs.add((tokens, d, proj_out))        # in_proj
        probs.add((tokens, d_in, d))            # out_proj
    head_rows = (shape.global_batch * min(cfg.loss_chunk, shape.seq_len)
                 if shape.kind == "train" else shape.global_batch)
    head_out = cfg.vocab_size * max(cfg.n_codebooks, 1)
    probs.add((head_rows, d, head_out))         # lm head (loss-chunked)
    return sorted(probs)


def _tokens(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    shape = (batch, seq, cfg.n_codebooks) if cfg.n_codebooks else (batch,
                                                                   seq)
    return torch.empty(shape, dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape, *,
                visual_patches: int = 1024) -> dict:
    """One step's inputs on the ``meta`` device: train and prefill take
    the whole ``(batch, seq)`` token block (and labels for train), decode
    one new token a sequence (its cache is :func:`cache_specs`); a vlm's
    train and prefill add ``visual_embeds (B, min(patches, S // 4), d)``
    bf16 and ``mrope_positions (3, B, S)`` int32."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {"tokens": _tokens(cfg, b, s), "labels": _tokens(cfg, b, s)}
    elif shape.kind == "prefill":
        specs = {"tokens": _tokens(cfg, b, s)}
    else:
        specs = {"tokens": _tokens(cfg, b, 1)}
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["visual_embeds"] = torch.empty(
            (b, min(visual_patches, s // 4), cfg.d_model),
            dtype=torch.bfloat16, device="meta")
        specs["mrope_positions"] = torch.empty((3, b, s), dtype=torch.int32,
                                               device="meta")
    return specs


def cache_specs(cfg: ModelConfig, shape: Shape):
    """The decode cache at this shape, on the ``meta`` device
    (``bind(cfg, "meta").init_cache``)."""
    from repro_torch.models import bind
    return bind(cfg, "meta").init_cache(shape.global_batch, shape.seq_len)
