"""Functional AdamW with optional 8-bit block-quantized moments (port of
``repro/optim/adamw.py``).

Moments are float32 (or int8 blocks of 256 with a float32 scale each, the
8-bit-Adam recipe, when ``quantize_moments``); the update math runs in
float32 after dequantization, and each parameter comes back in its own
dtype, so bf16 weights stay bf16. Weight decay is decoupled and applies
to matrices only (``p.ndim >= 2``). ``state["step"]`` is an int32 tensor
on the parameters' device.

The trees are the port's: dicts and the list of layers
(``repro_torch.tree``). ``apply_updates`` runs under ``torch.no_grad()``.

The reference stacks a model's layers along a leading axis, so its
``ndim >= 2`` rule decays the layers' norm weights too, which are vectors
in the port's list of layers. :func:`decay_mask` gives the reference's
choice for a model's tree, and :func:`apply_updates` follows it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch import tree as tr

__all__ = ["AdamWConfig", "init", "apply_updates", "Quantized8", "quantize8",
           "dequantize8", "decay_mask"]

_BLOCK = 256


class Quantized8(NamedTuple):
    """int8 payload ``(blocks, 256)`` and per-block float32 scales
    ``(blocks, 1)``."""
    q: torch.Tensor
    scale: torch.Tensor


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    quantize_moments: bool = False


def _is_q(x) -> bool:
    return isinstance(x, Quantized8)


def quantize8(x: torch.Tensor) -> Quantized8:
    """Blocks of 256 (the tail zero-padded), each scaled by its abs-max /
    127 and rounded half to even. Both divisions take a tensor divisor
    (module docstring of ``optim.schedules``)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / blocks.new_full((), 127.0)
    scale = torch.maximum(scale, blocks.new_full((), 1e-20))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Quantized8(q=q, scale=scale.to(torch.float32))


def dequantize8(z: Quantized8, shape, dtype=torch.float32) -> torch.Tensor:
    flat = (z.q.to(torch.float32) * z.scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape)).to(dtype)


def _zeros_moment(p: torch.Tensor, quantize: bool):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return quantize8(z) if quantize else z


def init(params: Any, cfg: AdamWConfig) -> dict:
    flat = tr.leaves(params)
    device = flat[0].device if flat else None
    return {
        "m": tr.tree_map(lambda p: _zeros_moment(p, cfg.quantize_moments),
                         params),
        "v": tr.tree_map(lambda p: _zeros_moment(p, cfg.quantize_moments),
                         params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def decay_mask(params: Any) -> Any:
    """The tree of where the reference decays a model's weights: ``ndim >=
    2`` in its layout, where every leaf under ``params["layers"]`` (a list
    in the port) carries one more, stacking axis. A tree without
    ``"layers"`` takes the plain ``ndim >= 2`` rule."""
    def rule(extra):
        return lambda p: p.dim() + extra >= 2
    if not (isinstance(params, dict) and "layers" in params):
        return tr.tree_map(rule(0), params)
    mask = tr.tree_map(rule(0), {k: v for k, v in params.items()
                                 if k != "layers"})
    mask["layers"] = tr.tree_map(rule(1), params["layers"])
    return mask


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                  lr: torch.Tensor) -> tuple[Any, dict]:
    """One AdamW step: ``(new params, new state)``; ``lr`` a float32
    tensor (a schedule's value at ``state["step"]``). Weight decay goes
    where :func:`decay_mask` says."""
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    b1 = stepf.new_full((), cfg.b1)
    b2 = stepf.new_full((), cfg.b2)
    one = stepf.new_full((), 1.0)
    c1 = one - torch.pow(b1, stepf)
    c2 = one - torch.pow(b2, stepf)

    def upd(p, g, m, v, wd):
        g = g.to(torch.float32)
        m_f = dequantize8(m, p.shape) if cfg.quantize_moments else m
        v_f = dequantize8(v, p.shape) if cfg.quantize_moments else v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * torch.square(g)
        update = (m_f / c1) / (torch.sqrt(v_f / c2) + cfg.eps)
        if wd:   # decoupled weight decay, where decay_mask says
            update = update + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr * update).to(p.dtype)
        if cfg.quantize_moments:
            return p_new, quantize8(m_f), quantize8(v_f)
        return p_new, m_f, v_f

    flat_p, structure = tr.flatten(params)
    flat_g = tr.leaves(grads)
    flat_m = tr.leaves(state["m"], is_leaf=_is_q)
    flat_v = tr.leaves(state["v"], is_leaf=_is_q)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"{len(flat_p)} parameters, {len(flat_g)} "
                         f"gradients, {len(flat_m)}/{len(flat_v)} moments")
    flat_d = tr.leaves(decay_mask(params))
    out = [upd(*leaf) for leaf in zip(flat_p, flat_g, flat_m, flat_v, flat_d)]
    new_p = tr.unflatten(structure, [o[0] for o in out])
    new_m = tr.unflatten(structure, [o[1] for o in out])
    new_v = tr.unflatten(structure, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}
