"""Error-feedback int8 gradient compression (port of
``repro/optim/grad_compression.py``): the quantizer with error feedback,
applied to the gradient tree inside the train step, whose numerics are
what a compressed collective would carry. The reference's
``compressed_psum`` (a ``shard_map`` collective) comes with the port's
distribution (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tr

from .adamw import dequantize8, quantize8

__all__ = ["init_error_state", "compress_with_feedback"]


def init_error_state(grads: Any) -> Any:
    return tr.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads)


@torch.no_grad()
def compress_with_feedback(grads: Any, err: Any) -> tuple[Any, Any]:
    """Quantize ``g + err`` to int8 blocks; return (dequantized grads in
    their dtypes, new float32 err)."""

    def one(g, e):
        target = g.to(torch.float32) + e
        approx = dequantize8(quantize8(target), g.shape)
        return approx.to(g.dtype), target - approx

    flat_g, structure = tr.flatten(grads)
    out = [one(g, e) for g, e in zip(flat_g, tr.leaves(err))]
    return (tr.unflatten(structure, [o[0] for o in out]),
            tr.unflatten(structure, [o[1] for o in out]))
