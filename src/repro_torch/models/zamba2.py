"""Zamba2-style hybrid, the ``hybrid`` family (zamba2-7b): a Mamba-2
backbone with one *shared* attention + MLP block applied after every
``cfg.shared_attn_every``-th Mamba layer — port of
``repro/models/zamba2.py`` (arXiv:2411.15242).

The shared block's weights are one set reused at ``n_attn_sites(cfg)``
call sites, each with its own KV cache. As in the reference, the shared
block reads the hidden state directly (no concatenation with the original
embedding, no per-site LoRA deltas). It is the dense transformer's block
(``transformer.block_forward`` with its attention-site helpers), so every
attention call runs the kernels the dense family runs: flash for prefill
chunks and one-shot prefill, paged for decode.

Parameters: ``embed``, ``layers`` (a list of ``{"ln", "mixer"}``),
``shared`` ``{"ln1", "ln2", "attn", "mlp"}``, ``final_norm``, ``lm_head
(d, V)`` (through ``sc_proj``). Cache: :class:`HybridCache`, whose ``k``/
``v`` ``(sites, B, S, KV, hd)`` are sequence leaves (paged in the paged
pool) and whose Mamba leaves are slot leaves.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sc_layers import sc_proj
from repro_torch.device import resolve_device

from .layers import PagedKV, rms_norm
from .mamba2 import (MambaCache, init_mamba_cache, init_mamba_params,
                     mamba_block, mamba_chunk_step, mamba_decode_step,
                     pack_mamba_layers)
from .transformer import (block_forward, chunk_attend, chunk_positions,
                          decode_attend, full_attend, init_block, model_dtype,
                          normal_init, pack_block)

__all__ = ["n_attn_sites", "init_params", "forward_hidden", "prefill_step",
           "prefill_chunk_step", "HybridCache", "init_cache", "decode_step",
           "paged_decode_step", "pack_sc_weights"]


def n_attn_sites(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


class HybridCache(NamedTuple):
    """Decode cache: ``mamba`` leaves stacked over the ``n_layers`` Mamba
    layers (slot axis 1), ``k``/``v`` ``(sites, B, S, KV, hd)`` (or page
    pools ``(sites, P, block, KV, hd)`` in the paged layout), ``pos`` the
    per-sequence ``(B,)`` int32 positions."""
    mamba: MambaCache
    k: torch.Tensor
    v: torch.Tensor
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
    params = {
        "embed": normal((cfg.vocab_size, d), d ** -0.5),
        "layers": [{"ln": torch.ones((d,), dtype=dtype, device=dev),
                    "mixer": init_mamba_params(cfg, normal, dtype, dev)}
                   for _ in range(cfg.n_layers)],
        "shared": init_block(cfg, normal, dtype, dev),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "lm_head": normal((d, cfg.vocab_size), d ** -0.5),
    }
    return params


def pack_sc_weights(params: dict, cfg: ModelConfig, pack) -> dict:
    """Every Mamba layer's ``in_proj``/``out_proj``, the shared block's
    attention and MLP weights — packed once for all its sites, since they
    are one set — and the head, packed by ``pack``."""
    return {**params,
            "layers": pack_mamba_layers(params["layers"], cfg, pack),
            "shared": pack_block(params["shared"], cfg, pack),
            "packed": {"head": pack(params["lm_head"], cfg.sc_bits)}}


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """LM head through the configured numeric, float32 logits."""
    return sc_proj(x, params["lm_head"], cfg,
                   params.get("packed", {}).get("head")).to(torch.float32)


def _embed(params, tokens):
    return params["embed"][tokens.to(torch.long)]


def _final(params, cfg, x):
    return rms_norm(x, params["final_norm"], eps=cfg.norm_eps)


def _layer_cache(mamba: MambaCache, i: int) -> MambaCache:
    return MambaCache(conv=mamba.conv[i], state=mamba.state[i])


def _groups(cfg: ModelConfig):
    """``(site, [layer indices])`` in order: each site after its group of
    ``shared_attn_every`` Mamba layers."""
    every = cfg.shared_attn_every
    return [(g, range(g * every, (g + 1) * every))
            for g in range(n_attn_sites(cfg))]


def _whole(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           collect: bool):
    """Causal forward over whole sequences at positions ``0..S-1``: the
    final hidden states, with ``collect`` each layer's Mamba cache and each
    site's ``(k, v)``."""
    x = _embed(params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    mcaches, kvs = [], ([] if collect else None)
    for site, layer_ids in _groups(cfg):
        for i in layer_ids:
            layer = params["layers"][i]
            h = rms_norm(x, layer["ln"], eps=cfg.norm_eps)
            if collect:
                y, mc = mamba_block(layer["mixer"], h, cfg, return_cache=True)
                mcaches.append(mc)
            else:
                y = mamba_block(layer["mixer"], h, cfg)
            x = x + y
        x = block_forward(params["shared"], x, cfg,
                          full_attend(cfg, positions, None, kvs))
    return _final(params, cfg, x), mcaches, kvs


def forward_hidden(params: dict, cfg: ModelConfig, batch: dict):
    """Full-sequence forward → (hidden after the final norm, zero aux)."""
    hidden, _, _ = _whole(params, cfg, batch["tokens"], collect=False)
    return hidden, torch.zeros((), dtype=torch.float32, device=hidden.device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: str | torch.device | None = None) -> HybridCache:
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    shape = (n_attn_sites(cfg), batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return HybridCache(
        mamba=init_mamba_cache(cfg, batch, dtype, dev, lead=(cfg.n_layers,)),
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))


def prefill_step(params: dict, cfg: ModelConfig, batch: dict, *,
                 extra_slots: int = 0):
    """Prompt pass → (last-token logits ``(B, 1, V)``, the cache: Mamba
    states after the prompt, each site's K/V with ``extra_slots`` zero
    positions after it). The prompt length must be a multiple of
    ``cfg.ssm_chunk``."""
    hidden, mcaches, kvs = _whole(params, cfg, batch["tokens"], collect=True)
    b, s = hidden.shape[:2]

    def stack(which):
        t = torch.stack([kv[which] for kv in kvs])
        if extra_slots:
            pad = list(t.shape)
            pad[2] = extra_slots
            t = torch.cat([t, t.new_zeros(pad)], dim=2)
        return t

    mamba = MambaCache(conv=torch.stack([c.conv for c in mcaches]),
                       state=torch.stack([c.state for c in mcaches]))
    pos = torch.full((b,), s, dtype=torch.int32, device=hidden.device)
    return _head(params, cfg, hidden[:, -1:]), HybridCache(
        mamba=mamba, k=stack(0), v=stack(1), pos=pos)


def prefill_chunk_step(params: dict, cfg: ModelConfig, cache: HybridCache,
                       batch: dict) -> tuple[torch.Tensor, HybridCache]:
    """Advance a B=1 staging cache by one prompt chunk, in place: the Mamba
    layers continue their SSD recurrence (``mamba2.mamba_chunk_step``) and
    each site writes the chunk's K/V at the staging offset and
    flash-attends with absolute positions (``transformer.chunk_attend``).
    ``batch`` carries ``tokens: (1, T)`` (``T % cfg.ssm_chunk == 0``) and
    ``n_valid``; returns the last valid row's logits and the cache with
    ``pos`` moved by ``n_valid``. Nothing is read on the host."""
    x = _embed(params, batch["tokens"])
    n_valid = torch.as_tensor(batch["n_valid"], dtype=torch.int32,
                              device=x.device).reshape(-1)[:1]
    positions = chunk_positions(cache.pos, x)
    for site, layer_ids in _groups(cfg):
        for i in layer_ids:
            layer = params["layers"][i]
            x = x + mamba_chunk_step(
                layer["mixer"], rms_norm(x, layer["ln"], eps=cfg.norm_eps),
                _layer_cache(cache.mamba, i), cfg, n_valid)
        x = block_forward(params["shared"], x, cfg, chunk_attend(
            cfg, cache.k[site], cache.v[site], positions, None))
    x = _final(params, cfg, x)
    last = x.index_select(1, (n_valid - 1).to(torch.long))
    cache.pos.add_(n_valid)
    return _head(params, cfg, last), cache


def _run_decode(params: dict, cfg: ModelConfig, cache: HybridCache,
                batch: dict, site_cache) -> tuple[torch.Tensor, HybridCache]:
    """One token a sequence over the Mamba backbone and the shared-block
    sites; ``site_cache(k_leaf, v_leaf)`` is what a site attends through —
    a dense ``(k, v)`` pair or a :class:`~.layers.PagedKV`. The Mamba
    leaves are O(1) a slot and the same in both layouts."""
    x = _embed(params, batch["tokens"])                  # (B, 1, d)
    b = x.shape[0]
    pos = cache.pos.expand(b) if cache.pos.numel() == 1 else cache.pos
    positions = pos[:, None]
    for site, layer_ids in _groups(cfg):
        for i in layer_ids:
            layer = params["layers"][i]
            x = x + mamba_decode_step(
                layer["mixer"], rms_norm(x, layer["ln"], eps=cfg.norm_eps),
                _layer_cache(cache.mamba, i), cfg)
        x = block_forward(params["shared"], x, cfg, decode_attend(
            cfg, positions, pos, None,
            site_cache(cache.k[site], cache.v[site])))
    x = _final(params, cfg, x)
    return _head(params, cfg, x), cache._replace(pos=pos + 1)


def decode_step(params: dict, cfg: ModelConfig, cache: HybridCache,
                batch: dict) -> tuple[torch.Tensor, HybridCache]:
    """One token for every sequence of a dense cache; the states and the
    sites' K/V advance in place."""
    return _run_decode(params, cfg, cache, batch, lambda k, v: (k, v))


def paged_decode_step(params: dict, cfg: ModelConfig, cache: HybridCache,
                      tables: torch.Tensor,
                      batch: dict) -> tuple[torch.Tensor, HybridCache]:
    """One token for every slot on the paged pool: each site's page pools
    ``(P, block, KV, hd)`` walked through the shared block table; the Mamba
    state keeps the slot layout."""
    return _run_decode(params, cfg, cache, batch,
                       lambda k, v: PagedKV(k, v, tables))
