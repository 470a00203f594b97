"""Pure-SSM language model, the ``ssm`` family (mamba2-130m): embeddings,
Mamba-2 layers, tied head — port of ``repro/models/ssm_lm.py``.

Parameters are the reference's with the layers a list (one dict per layer)
instead of a stack: ``embed (V, d)``, ``layers[l] = {"ln", "mixer"}``,
``final_norm``. The head is the tied ``x @ embed.T`` as in the reference,
never ``sc_proj``; it is a :func:`~.layers.tree_sum` over ``d`` for each
row, so a row's logits do not depend on the batch (the engine decodes four
slots, the baseline one). The cache holds no sequence leaf: every leaf is
O(1) per sequence, so its paged layout is its slot layout and the paged
decode step is the decode step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.parallel.context import shard_activations

from .layers import chunk_cross_entropy, remat_group, rms_norm, tree_sum
from .mamba2 import (MambaCache, init_mamba_cache, init_mamba_params,
                     mamba_block, mamba_chunk_step, mamba_decode_step,
                     pack_mamba_layers)
from .transformer import model_dtype, normal_init

__all__ = ["init_params", "forward_hidden", "loss_fn", "prefill_step",
           "prefill_chunk_step", "SSMCacheState", "init_cache",
           "decode_step", "paged_decode_step", "pack_sc_weights"]


class SSMCacheState(NamedTuple):
    """Decode cache: ``mamba`` leaves stacked over layers, ``conv (L, B,
    width-1, C)`` and ``state (L, B, H, P, N)`` (the slot axis at 1), and
    ``pos`` the per-sequence ``(B,)`` int32 positions."""
    mamba: MambaCache
    pos: torch.Tensor


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> dict:
    """Random parameters from ``seed`` with the reference's shapes and
    scales, drawn on ``device`` (the draws differ from JAX's)."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    normal = normal_init(seed, dtype, dev)
    d = cfg.d_model
    return {
        "embed": normal((cfg.vocab_size, d), d ** -0.5),
        "layers": [{"ln": torch.ones((d,), dtype=dtype, device=dev),
                    "mixer": init_mamba_params(cfg, normal, dtype, dev)}
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }


def pack_sc_weights(params: dict, cfg: ModelConfig, pack) -> dict:
    """Every layer's ``in_proj`` and ``out_proj`` packed by ``pack``; the
    tied head stays a float matmul, as in the reference."""
    return {**params, "layers": pack_mamba_layers(params["layers"], cfg,
                                                  pack)}


def _embed(params, tokens):
    return params["embed"][tokens.to(torch.long)]


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied logits ``x @ embed.T`` in the model dtype, then float32: each
    logit a ``tree_sum`` of its row's products, batch-invariant."""
    prod = x.to(torch.float32)[..., None, :] \
        * params["embed"].to(torch.float32)
    return tree_sum(prod, -1).to(x.dtype).to(torch.float32)


def _norm(layer, x, cfg):
    return rms_norm(x, layer["ln"], eps=cfg.norm_eps)


def _final(params, cfg, x):
    return rms_norm(x, params["final_norm"], eps=cfg.norm_eps)


def forward_hidden(params: dict, cfg: ModelConfig, batch: dict):
    """Full-sequence forward → (hidden after the final norm, zero aux).
    Under a gradient with ``cfg.remat`` each layer is rematerialised
    (``layers.remat_group``), as the reference checkpoints its scan
    body."""
    x = _embed(params, batch["tokens"])
    for layer in params["layers"]:
        def run(x, layer=layer):
            x = shard_activations(x)
            return x + mamba_block(layer["mixer"], _norm(layer, x, cfg), cfg)
        x = remat_group(cfg, run, x, layer)
    return _final(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                               device=x.device)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy in ``cfg.loss_chunk`` chunks (the sequence
    a whole number of them), labels -1 masked, through the tied head as a
    plain ``h @ embed.T`` in the model dtype (reference ``ssm_lm.py:53``),
    no aux loss."""
    hidden, _ = forward_hidden(params, cfg, batch)
    labels = batch["labels"]
    head = params["embed"].T
    return chunk_cross_entropy(hidden, labels,
                               min(cfg.loss_chunk, labels.shape[1]),
                               lambda h: (h @ head).to(torch.float32))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: str | torch.device | None = None) -> SSMCacheState:
    """Zero states for ``batch`` sequences; ``max_seq`` does not size an
    O(1) state."""
    del max_seq
    dev = resolve_device(device)
    return SSMCacheState(
        mamba=init_mamba_cache(cfg, batch, model_dtype(cfg), dev,
                               lead=(cfg.n_layers,)),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))


def prefill_step(params: dict, cfg: ModelConfig, batch: dict, *,
                 extra_slots: int = 0):
    """Prompt pass → (last-token logits ``(B, 1, V)``, the cache after the
    prompt). ``extra_slots`` sizes nothing here. The prompt length must be
    a multiple of ``cfg.ssm_chunk``."""
    del extra_slots
    x = _embed(params, batch["tokens"])
    caches = []
    for layer in params["layers"]:
        x = shard_activations(x)
        y, mc = mamba_block(layer["mixer"], _norm(layer, x, cfg), cfg,
                            return_cache=True)
        x = x + y
        caches.append(mc)
    x = _final(params, cfg, x)
    b, s = batch["tokens"].shape[:2]
    mamba = MambaCache(conv=torch.stack([c.conv for c in caches]),
                       state=torch.stack([c.state for c in caches]))
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return _head(params, x[:, -1:]), SSMCacheState(mamba=mamba, pos=pos)


def _layer_cache(cache, i: int) -> MambaCache:
    return MambaCache(conv=cache.mamba.conv[i], state=cache.mamba.state[i])


def prefill_chunk_step(params: dict, cfg: ModelConfig, cache: SSMCacheState,
                       batch: dict) -> tuple[torch.Tensor, SSMCacheState]:
    """Advance a B=1 staging cache by one prompt chunk, in place.

    ``batch["tokens"]: (1, T)`` with ``T % cfg.ssm_chunk == 0`` (the SSD
    recurrence splits across calls at the boundaries a one-shot prefill
    uses), zero-padded past ``batch["n_valid"]`` real tokens (an int or an
    int32 tensor of one element). Returns the last valid row's logits
    ``(1, 1, V)`` and the cache, its states advanced and ``pos`` moved by
    ``n_valid``; nothing is read on the host."""
    x = _embed(params, batch["tokens"])
    n_valid = torch.as_tensor(batch["n_valid"], dtype=torch.int32,
                              device=x.device).reshape(-1)[:1]
    for i, layer in enumerate(params["layers"]):
        x = shard_activations(x)
        x = x + mamba_chunk_step(layer["mixer"], _norm(layer, x, cfg),
                                 _layer_cache(cache, i), cfg, n_valid)
    x = _final(params, cfg, x)
    last = x.index_select(1, (n_valid - 1).to(torch.long))
    cache.pos.add_(n_valid)
    return _head(params, last), cache


def decode_step(params: dict, cfg: ModelConfig, cache: SSMCacheState,
                batch: dict) -> tuple[torch.Tensor, SSMCacheState]:
    """One token for every sequence (``batch["tokens"]: (B, 1)``); the
    states advance in place. Returns the logits ``(B, 1, V)`` and the
    cache with ``pos + 1``."""
    x = _embed(params, batch["tokens"])
    for i, layer in enumerate(params["layers"]):
        x = x + mamba_decode_step(layer["mixer"], _norm(layer, x, cfg),
                                  _layer_cache(cache, i), cfg)
    x = _final(params, cfg, x)
    return _head(params, x), SSMCacheState(mamba=cache.mamba,
                                           pos=cache.pos + 1)


def paged_decode_step(params: dict, cfg: ModelConfig, cache: SSMCacheState,
                      tables: torch.Tensor,
                      batch: dict) -> tuple[torch.Tensor, SSMCacheState]:
    """The decode step: without sequence leaves the paged layout is the
    slot layout and the block table goes unread (kept in the signature so
    every family's steps are driven alike)."""
    del tables
    return decode_step(params, cfg, cache, batch)
