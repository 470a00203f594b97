"""Serving step functions of the port (the serving subset of
``repro/launch/steps.py``).

The JAX package builds one jitted, mesh-sharded executable per shape and
memoizes the step factories. PyTorch runs eagerly, so here each step is a plain
function: it runs the bound model's step under ``torch.no_grad()``
(no autograd bookkeeping on the serving path). Capturing decode in CUDA
graphs, one per shape, is later work.
"""
from __future__ import annotations

import torch

__all__ = ["prompt_buckets", "bucket_for", "prefill_step", "decode_step",
           "chunked_prefill_step", "paged_decode_step"]


def prompt_buckets(max_seq: int, chunk: int) -> tuple[int, ...]:
    """The padded prompt-length set for chunked prefill: powers-of-two
    multiples of ``chunk``, capped at the smallest chunk multiple covering
    ``max_seq``. Every bucket is a chunk multiple, so a prompt's chunks
    always fit its bucket's staging extent."""
    if chunk < 1 or max_seq < 1:
        raise ValueError(f"need chunk/max_seq >= 1, got {chunk}/{max_seq}")
    top = -(-max_seq // chunk) * chunk
    out = []
    b = chunk
    while b < top:
        out.append(b)
        b *= 2
    out.append(top)
    return tuple(out)


def bucket_for(prompt_len: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket covering ``prompt_len``."""
    for b in buckets:
        if b >= prompt_len:
            return b
    raise ValueError(f"prompt of {prompt_len} tokens exceeds the largest "
                     f"bucket {buckets[-1]}")


@torch.no_grad()
def prefill_step(model, params, batch: dict, *, extra_slots: int = 0):
    """One-shot prefill (the sequential baseline's admission)."""
    return model.prefill_step(params, batch, extra_slots=extra_slots)


@torch.no_grad()
def decode_step(model, params, cache, batch: dict):
    """One token per sequence over a dense cache (the baseline's decode)."""
    return model.decode_step(params, cache, batch)


@torch.no_grad()
def chunked_prefill_step(model, params, cache, batch: dict):
    """One prompt chunk into a B=1 staging cache: ``batch = {"tokens":
    (1, chunk), "n_valid": int}``."""
    return model.prefill_chunk_step(params, cache, batch)


@torch.no_grad()
def paged_decode_step(model, params, cache, tables: torch.Tensor,
                      batch: dict):
    """One token per slot straight on the page pool (fused: attention
    walks the block table)."""
    return model.paged_decode_step(params, cache, tables, batch)
