"""Decoder-only transformer, dense family (port of the dense path of
``repro/models/transformer.py``).

Parameters are a plain dict with the JAX package's leaf shapes — ``wq``
``(d, H, hd)``, ``wk``/``wv`` ``(d, KV, hd)``, ``wo`` ``(H, hd, d)`` — except
that the layers are a list (one dict per layer) instead of a scanned stack;
``repro_torch.convert`` carries JAX parameters across. The KV cache keeps
the JAX layout: ``k``/``v`` are tuples over the window/MoE group positions
of ``(ngroups, B, S, KV, hd)`` tensors (the slot axis at 1), and layer
``l`` lives at ``k[l % group][l // group]``.

With ``cfg.use_sc_gemm`` every dense projection — QKV/O, MLP, and the LM
head — runs through ``core.sc_layers.sc_proj``, i.e. the SC-GEMM kernel on
the card. :func:`pack_sc_weights` quantizes and packs those weights once
(a ``"packed"`` dict beside the float weights of each layer's ``attn`` and
``mlp`` and at the top for the head); given packed weights, each
projection is one fused kernel launch and no weight is quantized per call.
The serving entry points pack once per set of parameters.

With ``cfg.attn_sc`` every attention site takes ``sc_bits = cfg.sc_bits``
(:func:`_attn_sc_bits`): prefill through the flash kernel, decode through
the paged kernel, both on their SC path.

The decode steps update the cache in place (the page pool and the slot
cache are the largest tensors of a serving process) and return it.
"""
from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sc_layers import sc_proj
from repro_torch.device import resolve_device
from repro_torch.kernels.sc_matmul import pack_weight

from .layers import (PagedKV, apply_rope, decode_attention, flash_attention,
                     paged_decode_attention, rms_norm, rope, softcap)

__all__ = ["init_params", "forward_hidden", "logits_from_hidden",
           "prefill_step", "prefill_chunk_step", "KVCache", "init_kv_cache",
           "decode_step", "decode_window_step", "paged_decode_step",
           "model_dtype", "params_to", "pack_sc_weights"]


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ----------------------------------------------------------------- params

def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> dict:
    """Random parameters from ``seed`` with the JAX package's shapes and
    scales (``transformer.py:93-123``): normal weights scaled by
    ``fan_in ** -0.5``, unit norms. Drawn on ``device`` in float32 from a
    ``torch.Generator`` there, then cast to the model dtype. The draws
    differ from JAX's; tests carry JAX's parameters across with
    ``repro_torch.convert`` instead."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32) * scale
        return w.to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    params: dict[str, Any] = {
        "embed": normal((cfg.vocab_size, d), d ** -0.5),
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    layers = []
    for _ in range(cfg.n_layers):
        attn = {
            "wq": normal((d, h, hd), d ** -0.5),
            "wk": normal((d, kv, hd), d ** -0.5),
            "wv": normal((d, kv, hd), d ** -0.5),
            "wo": normal((h, hd, d), (h * hd) ** -0.5),
        }
        if cfg.qkv_bias:
            attn["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
            attn["bk"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
            attn["bv"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
        if cfg.qk_norm:
            attn["q_norm"] = ones(hd)
            attn["k_norm"] = ones(hd)
        layer = {"ln1": ones(d), "ln2": ones(d), "attn": attn,
                 "mlp": {"w1": normal((d, f), d ** -0.5),
                         "w3": normal((d, f), d ** -0.5),
                         "w2": normal((f, d), f ** -0.5)}}
        if cfg.post_norms:
            layer["ln1_post"] = ones(d)
            layer["ln2_post"] = ones(d)
        layers.append(layer)
    params["layers"] = layers
    return params


def params_to(params, device: str | torch.device):
    """The parameter tree with every tensor (and packed weight) moved to
    ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params.to(device)


def _lm_head(params):
    """The LM head ``(d, vocab)``: ``lm_head``, or the tied ``embed.T``."""
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def pack_sc_weights(params: dict, cfg: ModelConfig) -> dict:
    """The parameter tree with every SC-GEMM weight quantized and packed
    once (``kernels.sc_matmul.pack_weight`` at ``cfg.sc_bits``) beside its
    float weight, as each projection takes it: ``wq``/``wk``/``wv`` as
    ``(d, heads·hd)``, ``wo`` as ``(H·hd, d)``, the MLP weights as they
    are, the head as ``(d, vocab)``. Packs are always made anew from the
    float weights, so a tree packed before a weight changed is never used
    in place of the new one. Without ``cfg.use_sc_gemm`` the tree comes
    back as it is. The float weights stay for the exact path, for
    gradients and for a ``cfg.sc_impl`` of ``"ref"`` or ``"mxu_split"``,
    which ``sc_proj`` runs per call."""
    if not cfg.use_sc_gemm:
        return params
    bits, d = cfg.sc_bits, cfg.d_model
    out = dict(params)
    out["packed"] = {"head": pack_weight(_lm_head(params), bits)}
    layers = []
    for layer in params["layers"]:
        attn, mlp = dict(layer["attn"]), dict(layer["mlp"])
        attn["packed"] = {name: pack_weight(attn[name].reshape(d, -1), bits)
                          for name in ("wq", "wk", "wv")}
        attn["packed"]["wo"] = pack_weight(attn["wo"].reshape(-1, d), bits)
        mlp["packed"] = {name: pack_weight(mlp[name], bits)
                         for name in ("w1", "w3", "w2")}
        layers.append({**layer, "attn": attn, "mlp": mlp})
    out["layers"] = layers
    return out


# ------------------------------------------------------------------ cache

class KVCache(NamedTuple):
    """Decode cache: ``k``/``v`` tuples over group positions of
    ``(ngroups, B, S, KV, hd)`` tensors (or page pools
    ``(ngroups, P, block, KV, hd)`` in the paged layout); ``pos`` the
    per-sequence ``(B,)`` int32 positions."""
    k: Any
    v: Any
    pos: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                  device: str | torch.device | None = None) -> KVCache:
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    ngroups = cfg.n_layers // cfg.group_size
    shape = (ngroups, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    k = tuple(torch.zeros(shape, dtype=dtype, device=dev)
              for _ in range(cfg.group_size))
    v = tuple(torch.zeros(shape, dtype=dtype, device=dev)
              for _ in range(cfg.group_size))
    return KVCache(k=k, v=v, pos=torch.zeros((batch,), dtype=torch.int32,
                                             device=dev))


def _layer_kv(cache: KVCache, cfg: ModelConfig, layer: int):
    gsz = cfg.group_size
    return cache.k[layer % gsz][layer // gsz], cache.v[layer % gsz][layer // gsz]


# ---------------------------------------------------------------- forward

def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    b, s, d = x.shape
    hd = cfg.head_dim
    packed = p.get("packed", {})

    def proj(name, bias):
        # (d, heads, hd) is a matmul with the head axes flattened
        w = p[name]
        nh = w.shape[1]
        out = sc_proj(x, w.reshape(d, nh * hd), cfg,
                      packed.get(name)).reshape(b, s, nh, hd)
        return out + bias if bias is not None else out

    q = proj("wq", p.get("bq"))
    k = proj("wk", p.get("bk"))
    v = proj("wv", p.get("bv"))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    cos, sin = rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out_proj(p: dict, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s = out.shape[:2]
    hd, h, d = cfg.head_dim, cfg.n_heads, cfg.d_model
    return sc_proj(out.reshape(b, s, h * hd), p["wo"].reshape(h * hd, d), cfg,
                   p.get("packed", {}).get("wo"))


def _mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # jax.nn.gelu, the reference's activation, defaults to the tanh form
    act = F.silu if cfg.act == "silu" else partial(F.gelu, approximate="tanh")
    packed = p.get("packed", {})
    h = act(sc_proj(x, p["w1"], cfg, packed.get("w1"))) \
        * sc_proj(x, p["w3"], cfg, packed.get("w3"))
    return sc_proj(h, p["w2"], cfg, packed.get("w2"))


def _layer(layer: dict, x: torch.Tensor, cfg: ModelConfig, attend):
    """One pre-norm block; ``attend(q, k, v)`` is the attention site."""
    attn_in = rms_norm(x, layer["ln1"], eps=cfg.norm_eps,
                       plus_one=cfg.norm_plus_one)
    attn_out = _out_proj(layer["attn"], attend(layer["attn"], attn_in), cfg)
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, layer["ln1_post"], eps=cfg.norm_eps,
                            plus_one=cfg.norm_plus_one)
    x = x + attn_out
    ff_in = rms_norm(x, layer["ln2"], eps=cfg.norm_eps,
                     plus_one=cfg.norm_plus_one)
    ff_out = _mlp_forward(layer["mlp"], ff_in, cfg)
    if cfg.post_norms:
        ff_out = rms_norm(ff_out, layer["ln2_post"], eps=cfg.norm_eps,
                          plus_one=cfg.norm_plus_one)
    return x + ff_out


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor):
    x = params["embed"][tokens.to(torch.long)]
    if cfg.emb_scale:
        x = x * x.new_full((), cfg.d_model ** 0.5)
    return x


def _attn_sc_bits(cfg: ModelConfig) -> int | None:
    """The one resolution point of the attention numeric, so prefill, dense
    decode and paged decode never disagree on it."""
    return cfg.sc_bits if cfg.attn_sc else None


def _final(params, cfg, x):
    return rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                    plus_one=cfg.norm_plus_one)


def _full_sequence(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   collect: bool):
    """Causal forward over whole sequences at positions ``0..S-1``; returns
    the final hidden states and, with ``collect``, each layer's K/V."""
    x = _embed_tokens(params, cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    kvs = []
    for i, layer in enumerate(params["layers"]):
        window = cfg.window_at(i % cfg.group_size)

        def attend(p, h, window=window):
            q, k, v = _qkv(p, h, cfg, positions)
            if collect:
                kvs.append((k, v))
            return flash_attention(
                q, k, v, q_positions=positions, kv_positions=positions,
                causal=True, window=window, logit_softcap=cfg.attn_softcap,
                q_block=min(cfg.q_block, s), kv_block=min(cfg.kv_block, s),
                skip_masked_blocks=cfg.skip_masked_blocks,
                bf16_probs=cfg.bf16_probs, kernel_impl=cfg.attn_kernel,
                q_offset=0, sc_bits=_attn_sc_bits(cfg))

        x = _layer(layer, x, cfg, attend)
    return _final(params, cfg, x), kvs


def forward_hidden(params: dict, cfg: ModelConfig,
                   batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (hidden ``(B, S, d)`` after the final norm,
    aux loss — zero for the dense family)."""
    hidden, _ = _full_sequence(params, cfg, batch["tokens"], collect=False)
    return hidden, torch.zeros((), dtype=torch.float32, device=hidden.device)


def logits_from_hidden(params: dict, cfg: ModelConfig,
                       hidden: torch.Tensor) -> torch.Tensor:
    """LM head: ``lm_head``, or the tied ``embed.T`` (``K = d``,
    ``N = vocab``; the largest SC-GEMM of every step) through ``sc_proj``."""
    logits = sc_proj(hidden, _lm_head(params), cfg,
                     params.get("packed", {}).get("head"))
    return softcap(logits.to(torch.float32), cfg.final_softcap)


def _stack_cache(cfg: ModelConfig, kvs, extra_slots: int) -> tuple:
    """Per-layer ``(B, S, KV, hd)`` pairs → the grouped cache tuples."""
    gsz = cfg.group_size

    def leaf(i, which):
        t = torch.stack([kvs[l][which] for l in range(i, cfg.n_layers, gsz)])
        if extra_slots:
            pad = list(t.shape)
            pad[2] = extra_slots
            t = torch.cat([t, t.new_zeros(pad)], dim=2)
        return t

    return (tuple(leaf(i, 0) for i in range(gsz)),
            tuple(leaf(i, 1) for i in range(gsz)))


def prefill_step(params: dict, cfg: ModelConfig, batch: dict, *,
                 extra_slots: int = 0) -> tuple[torch.Tensor, KVCache]:
    """Process the full prompt → (last-token logits ``(B, 1, V)``, filled
    :class:`KVCache`); ``extra_slots`` pads the cache's sequence axis."""
    hidden, kvs = _full_sequence(params, cfg, batch["tokens"], collect=True)
    b, s = hidden.shape[:2]
    logits = logits_from_hidden(params, cfg, hidden[:, -1:])
    k, v = _stack_cache(cfg, kvs, extra_slots)
    pos = torch.full((b,), s, dtype=torch.int32, device=hidden.device)
    return logits, KVCache(k=k, v=v, pos=pos)


def prefill_chunk_step(params: dict, cfg: ModelConfig, cache: KVCache,
                       batch: dict) -> tuple[torch.Tensor, KVCache]:
    """Commit one prompt chunk into a B=1 staging cache at the cache's
    current position (chunked prefill).

    ``batch["tokens"]: (1, T)`` is the chunk, zero-padded past
    ``batch["n_valid"]`` real tokens (an int, or an int32 tensor of one
    element). Returns the logits of the last valid row ``(1, 1, V)`` and
    the cache, updated in place: the chunk's K/V written at its positions
    and ``cache.pos`` advanced by ``n_valid``. Pad rows write garbage K/V
    past the prompt, which ``cache_ops.truncate_seq`` slices away before
    pool admission.

    Nothing here reads a device value on the host, so a CUDA graph can
    capture the step and replay it at any offset: the offset and the
    valid length stay tensors (the JAX step's ``dynamic_slice_in_dim``
    becomes ``index_copy_`` / ``index_select`` at positions computed on
    the device, and the flash kernel reads its ``q_offset`` there). The
    caller, which knows the offset on the host, keeps ``pos + T`` within
    the staging extent.
    """
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    b, t, _ = x.shape
    n_valid = torch.as_tensor(batch["n_valid"], dtype=torch.int32,
                              device=x.device).reshape(-1)[:1]
    pos = cache.pos.expand(b) if cache.pos.numel() == 1 else cache.pos
    positions = (pos[:, None].to(torch.int32)
                 + torch.arange(t, dtype=torch.int32, device=x.device)[None])
    # every row of the chunk sits at the shared staging offset
    offset = pos[0]
    cols = positions[0].to(torch.long)
    e = cache.k[0].shape[2]
    kv_pos = torch.arange(e, dtype=torch.int32, device=x.device).expand(b, e)
    for i, layer in enumerate(params["layers"]):
        k_cache, v_cache = _layer_kv(cache, cfg, i)
        window = cfg.window_at(i % cfg.group_size)

        def attend(p, h, k_cache=k_cache, v_cache=v_cache, window=window):
            q, k, v = _qkv(p, h, cfg, positions)
            # columns past the filled prefix are causally masked, so bucket
            # padding and pad-row writes are exact no-ops for valid rows.
            # q_offset puts the chunk on the flash kernel on the card, so
            # its rows reduce as a one-shot prefill's do.
            k_cache.index_copy_(1, cols, k.to(k_cache.dtype))
            v_cache.index_copy_(1, cols, v.to(v_cache.dtype))
            return flash_attention(
                q, k_cache, v_cache, q_positions=positions,
                kv_positions=kv_pos, causal=True, window=window,
                logit_softcap=cfg.attn_softcap,
                q_block=min(cfg.q_block, t), kv_block=min(cfg.kv_block, e),
                skip_masked_blocks=False, bf16_probs=cfg.bf16_probs,
                kernel_impl=cfg.attn_kernel, q_offset=offset,
                sc_bits=_attn_sc_bits(cfg))

        x = _layer(layer, x, cfg, attend)
    x = _final(params, cfg, x)
    last = x.index_select(1, (n_valid - 1).to(torch.long))
    logits = logits_from_hidden(params, cfg, last)
    cache.pos.add_(n_valid)
    return logits, cache


# ------------------------------------------------------------------ decode

def _run_decode(params: dict, cfg: ModelConfig, cache: KVCache, batch: dict,
                attend_cached) -> tuple[torch.Tensor, KVCache]:
    """Shared decode of ``W`` consecutive tokens a sequence (``batch
    ["tokens"]: (B, W)``, rows at ``cache.pos + i``): embed, run the
    layers, project. ``attend_cached(layer_index, q, k, v, pos, window)``
    writes the rows' K/V into the cache and attends."""
    x = _embed_tokens(params, cfg, batch["tokens"])
    b, w = x.shape[:2]
    pos = cache.pos.expand(b) if cache.pos.numel() == 1 else cache.pos
    positions = pos[:, None]
    if w > 1:
        positions = positions + torch.arange(w, dtype=pos.dtype,
                                             device=x.device)[None, :]
    for i, layer in enumerate(params["layers"]):
        window = cfg.window_at(i % cfg.group_size)

        def attend(p, h, i=i, window=window):
            q, k, v = _qkv(p, h, cfg, positions)
            return attend_cached(i, q, k, v, pos, window)

        x = _layer(layer, x, cfg, attend)
    x = _final(params, cfg, x)
    logits = logits_from_hidden(params, cfg, x)
    return logits, KVCache(k=cache.k, v=cache.v, pos=pos + w)


def decode_step(params: dict, cfg: ModelConfig, cache: KVCache,
                batch: dict) -> tuple[torch.Tensor, KVCache]:
    """One token for every sequence of a dense cache —
    ``batch["tokens"]: (B, 1)``; positions are per sequence — or ``W``
    consecutive ones (:func:`decode_window_step`). Row ``i``'s K/V lands
    at ``pos + i``; a row past the cache extent (an idle slot drifting, a
    window running off the end) is dropped, never clamped onto a live
    row's tail."""

    def attend_cached(i, q, k, v, pos, window):
        k_cache, v_cache = _layer_kv(cache, cfg, i)
        b, s = k_cache.shape[:2]
        rows = torch.arange(b, device=q.device)
        base = pos.to(torch.long)
        # one column a sequence at a time, so a dropped row's write-back
        # of the old value never races a kept row's write at the same cell
        for j in range(q.shape[1]):
            p = base + j if j else base
            col = torch.clamp(p, max=s - 1)
            keep = (p < s)[:, None, None]
            k_cache[rows, col] = torch.where(keep, k[:, j].to(k_cache.dtype),
                                             k_cache[rows, col])
            v_cache[rows, col] = torch.where(keep, v[:, j].to(v_cache.dtype),
                                             v_cache[rows, col])
        return decode_attention(q, k_cache, v_cache, q_position=pos,
                                window=window,
                                logit_softcap=cfg.attn_softcap,
                                sc_bits=_attn_sc_bits(cfg))

    return _run_decode(params, cfg, cache, batch, attend_cached)


def decode_window_step(params: dict, cfg: ModelConfig, cache: KVCache,
                       batch: dict) -> tuple[torch.Tensor, KVCache]:
    """``W`` consecutive tokens for every sequence in one forward: the
    exact-path verify step of speculative decoding.

    ``batch["tokens"]: (B, W)`` holds each sequence's last sampled token
    followed by its ``W - 1`` draft proposals; rows enter at positions
    ``[cache.pos, cache.pos + W)``, their K/V written there in place (the
    drop rule of :func:`decode_step`). Row ``i`` of the logits ``(B, W,
    V)`` masks the window's later rows by its own position, and
    ``layers.decode_attention`` gives it exactly what the one-row step at
    ``pos + i`` computes — on the card the same paged kernel call — so
    it equals ``i + 1`` sequential :func:`decode_step` calls on the same
    prefix. Returns the logits and the cache with ``pos + W``."""
    return decode_step(params, cfg, cache, batch)


def paged_decode_step(params: dict, cfg: ModelConfig, cache: KVCache,
                      tables: torch.Tensor,
                      batch: dict) -> tuple[torch.Tensor, KVCache]:
    """One token for every slot, straight on the paged pool.

    ``cache`` is the ``cache_ops.paged_init`` layout (page pools
    ``(ngroups, P, block, KV, hd)``) and ``tables`` the shared
    ``(capacity, max_blocks)`` block table. Each layer scatters its token
    into its page — ``(tables[slot, pos // block], pos % block)``, a free
    slot's −1 entry landing in the trash page — and attends through the
    table (``layers.paged_decode_attention``)."""
    from .cache_ops import paged_token_entry

    def attend_cached(i, q, k, v, pos, window):
        k_pages, v_pages = _layer_kv(cache, cfg, i)
        paged = PagedKV(k_pages, v_pages, tables)
        entry, off = paged_token_entry(tables, pos, block=paged.block)
        bid = torch.where(entry < 0, paged.trash, entry).to(torch.long)
        off = off.to(torch.long)
        k_pages[bid, off] = k[:, 0].to(k_pages.dtype)
        v_pages[bid, off] = v[:, 0].to(v_pages.dtype)
        return paged_decode_attention(q, paged, q_position=pos, window=window,
                                      logit_softcap=cfg.attn_softcap,
                                      kernel_impl=cfg.paged_attn_kernel,
                                      sc_bits=_attn_sc_bits(cfg))

    return _run_decode(params, cfg, cache, batch, attend_cached)
