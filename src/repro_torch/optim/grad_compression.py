"""Error-feedback int8 gradient compression (port of
``repro/optim/grad_compression.py``).

Two pieces:

* :func:`init_error_state` / :func:`compress_with_feedback` — the
  quantizer with error feedback, applied to the gradient tree inside the
  train step, whose numerics are what a compressed collective would carry.
* :func:`compressed_psum` — a mean-reduce over a ``torch.distributed``
  group of the int8 round trip of each rank's tensor. As in the
  reference, the reduction runs over the dequantized values: the payload
  on the link is the tensor in its own dtype, not the int8 blocks.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tr

from .adamw import dequantize8, quantize8

__all__ = ["init_error_state", "compress_with_feedback", "compressed_psum"]


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


@torch.no_grad()
def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``dequantize8(quantize8(x))`` over the ranks of ``group``
    (the default group when None): a SUM all-reduce, then a divide by the
    world size held as a tensor (dividing by a Python number multiplies by
    its reciprocal on CUDA, an ulp off)."""
    import torch.distributed as dist
    approx = dequantize8(quantize8(x), x.shape, x.dtype)
    dist.all_reduce(approx, op=dist.ReduceOp.SUM, group=group)
    return approx / approx.new_full((), dist.get_world_size(group))
