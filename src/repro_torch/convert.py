"""Carry JAX parameters across to the port.

The JAX package's ``transformer.init_params`` returns a pytree whose layers
are stacked for ``lax.scan``: ``params["layers"]`` is a tuple over the
window/MoE group positions, each leaf shaped ``(ngroups, ...)``
(``repro/models/transformer.py:116-122``). The port keeps one dict per
layer, so layer ``l`` is group ``l // group_size`` of position
``l % group_size``. Leaf shapes are otherwise unchanged: ``wq``/``wk``/``wv``
stay ``(d, heads, hd)`` and are flattened to ``(d, heads·hd)`` at use, as
the JAX model does.

The ssm and hybrid families stack their Mamba layers over ``n_layers``
(``jax.vmap`` in ``ssm_lm.init_params`` / ``zamba2.init_params``): layer
``l`` is index ``l`` of every leaf under ``params["layers"]``; the
hybrid's ``shared`` block and ``lm_head`` come across as they are. Every
leaf is cast to the model dtype except the Mamba mixers' ``dt_bias``,
``A_log`` and ``D``, which the reference keeps in float32.

The input is the pytree with its leaves as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``) — this module never imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.errors import ConfigError
from repro_torch.models.mamba2 import F32_LEAVES
from repro_torch.models.transformer import model_dtype

__all__ = ["from_jax_params"]


def _tensor(leaf, dtype, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        # ml_dtypes bfloat16 arrives as a 2-byte type numpy cannot cast;
        # go through float32, which holds every bfloat16 exactly
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def from_jax_params(tree: dict, cfg: ModelConfig, *,
                    device: str | torch.device | None = None) -> dict:
    """The port's parameter dict from a JAX ``init_params`` pytree of numpy
    leaves, cast to the config's dtype on ``device`` (the Mamba float32
    leaves stay float32)."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise ConfigError(f"conversion of family {cfg.family!r} comes with "
                          f"its slice of the port")
    dev = resolve_device(device)
    dtype = model_dtype(cfg)

    def conv(node: Any, index: int | None = None, name: str = ""):
        if isinstance(node, dict):
            return {k: conv(v, index, k) for k, v in node.items()}
        arr = np.asarray(node)
        return _tensor(arr if index is None else arr[index],
                       torch.float32 if name in F32_LEAVES else dtype, dev)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    if cfg.family == "dense":
        gsz = cfg.group_size
        out["layers"] = [conv(tree["layers"][l % gsz], l // gsz)
                         for l in range(cfg.n_layers)]
    else:
        out["layers"] = [conv(tree["layers"], l)
                         for l in range(cfg.n_layers)]
    return out
