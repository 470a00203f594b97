"""Decoder-only transformer: the dense, moe, vlm and audio families (port
of ``repro/models/transformer.py``).

Parameters are a plain dict with the JAX package's leaf shapes — ``wq``
``(d, H, hd)``, ``wk``/``wv`` ``(d, KV, hd)``, ``wo`` ``(H, hd, d)`` — except
that the layers are a list (one dict per layer) instead of a scanned stack;
``repro_torch.convert`` carries JAX parameters across. The KV cache keeps
the JAX layout: ``k``/``v`` are tuples over the window/MoE group positions
of ``(ngroups, B, S, KV, hd)`` tensors (the slot axis at 1), and layer
``l`` lives at ``k[l % group][l // group]``.

The moe family (qwen3-moe, llama4) holds a ``"moe"`` FFN
(``models/moe.py``) instead of ``"mlp"`` in each layer whose position in
the group is a MoE one (``cfg.moe_at``; llama4 alternates dense and MoE
layers). :func:`block_forward` routes it, and :func:`forward_hidden`
returns its aux losses summed (group by group, as the reference's scan).

With ``cfg.use_sc_gemm`` every dense projection — QKV/O, MLP, the experts
(one batched launch a projection for all of a layer's experts) and the LM
head — runs through ``core.sc_layers.sc_proj``, i.e. the SC-GEMM kernel on
the card. :func:`pack_sc_weights` quantizes and packs those weights once
(a ``"packed"`` dict beside the float weights of each layer's ``attn`` and
``mlp`` and at the top for the head); given packed weights, each
projection is one fused kernel launch and no weight is quantized per call.
The serving entry points pack once per set of parameters.

With ``cfg.attn_sc`` every attention site takes ``sc_bits = cfg.sc_bits``
(:func:`_attn_sc_bits`): prefill through the flash kernel, decode through
the paged kernel, both on their SC path.

The vlm family (qwen2-vl) rotates Q and K by M-RoPE
(``layers.apply_mrope``) at every attention site: ``batch
["mrope_positions"] (3, B, S)`` where given, else the call's positions in
all three streams, which gives plain RoPE's bits, so a text-only step
needs no input beyond the tokens. ``batch["visual_embeds"] (B, P, d)``,
the vision front end's stub, replaces the first ``P`` embedded rows. The
audio family (musicgen) embeds ``(B, S, K)`` codebook tokens through ``K``
tables summed, and its head gives ``(..., K, V)`` logits.

The decode steps update the cache in place (the page pool and the slot
cache are the largest tensors of a serving process) and return it.

Every layer group of a whole-sequence forward or a prefill chunk starts
with ``parallel.context.shard_activations``, as the reference's scan
bodies do: a no-op outside an activation-sharding scope.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sc_layers import sc_proj
from repro_torch.device import resolve_device
from repro_torch.kernels.sc_matmul import pack_weight
from repro_torch.parallel.context import (batch_axes, constrain,
                                          shard_activations)
from repro_torch.parallel.sharding import P

from .layers import (PagedKV, apply_mrope, apply_rope, chunk_cross_entropy,
                     decode_attention, flash_attention, paged_decode_attention,
                     remat_group, rms_norm, rope, softcap)
from .moe import gated_ffn, init_moe_params, moe_ffn, pack_moe

__all__ = ["init_params", "forward_hidden", "logits_from_hidden", "loss_fn",
           "prefill_step", "prefill_chunk_step", "KVCache", "init_kv_cache",
           "decode_step", "decode_window_step", "paged_decode_step",
           "model_dtype", "params_to", "pack_sc_weights", "normal_init",
           "init_block", "pack_block", "block_forward", "full_attend",
           "chunk_positions", "chunk_attend", "decode_attend",
           "dense_decode_attend", "paged_decode_attend"]


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ----------------------------------------------------------------- params

def normal_init(seed: int, dtype: torch.dtype, device: torch.device):
    """``normal(shape, scale, dtype=dtype)``: float32 normal draws from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, scaled and cast
    to ``dtype`` — the draw every family's ``init_params`` makes. On the
    ``meta`` device (shapes alone) nothing is drawn."""
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def normal(shape, scale, out_dtype=dtype):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale
        return w.to(out_dtype)

    return normal


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> dict:
    """Random parameters from ``seed`` with the JAX package's shapes and
    scales (``transformer.py:93-123``): normal weights scaled by
    ``fan_in ** -0.5``, unit norms; with ``cfg.n_codebooks`` an embed of
    ``(K, V, d)`` and a head of ``(d, K·V)``; a MoE FFN where
    ``cfg.moe_at`` the layer's group position (its router in float32). Drawn on ``device`` in
    float32 from a ``torch.Generator`` there, then cast to the model
    dtype. The draws differ from JAX's; tests carry JAX's parameters
    across with ``repro_torch.convert`` instead."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    normal = normal_init(seed, dtype, dev)
    d, kb = cfg.d_model, cfg.n_codebooks
    params: dict[str, Any] = {
        "embed": normal((kb, cfg.vocab_size, d) if kb
                        else (cfg.vocab_size, d), d ** -0.5),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, max(kb, 1) * cfg.vocab_size),
                                   d ** -0.5)
    params["layers"] = [init_block(cfg, normal, dtype, dev,
                                   pos=i % cfg.group_size)
                        for i in range(cfg.n_layers)]
    return params


def init_block(cfg: ModelConfig, normal, dtype, dev,
               pos: int | None = None) -> dict:
    """One attention + FFN block (``ln1``, ``ln2``, ``attn``, ``mlp`` —
    ``moe`` instead where group position ``pos`` is a MoE one — and with
    ``cfg.post_norms`` the post norms) with the reference's shapes and
    scales (its ``_init_attn`` / ``_init_mlp`` / ``init_moe_params``);
    ``normal(shape, scale)`` draws the weights."""
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

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
    layer = {"ln1": ones(d), "ln2": ones(d), "attn": attn}
    if pos is not None and cfg.moe_at(pos):
        layer["moe"] = init_moe_params(cfg, normal, dtype)
    else:
        layer["mlp"] = {"w1": normal((d, f), d ** -0.5),
                        "w3": normal((d, f), d ** -0.5),
                        "w2": normal((f, d), f ** -0.5)}
    if cfg.post_norms:
        layer["ln1_post"] = ones(d)
        layer["ln2_post"] = ones(d)
    return layer


def params_to(params, device: str | torch.device):
    """The parameter tree with every tensor (and packed weight) moved to
    ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params.to(device)


def _lm_head(params, cfg: ModelConfig):
    """The LM head ``(d, vocab)`` (``(d, K·vocab)`` with codebooks):
    ``lm_head``, or the tied ``embed.T`` (codebooks: the ``(K, V, d)``
    embed permuted to ``(d, K, V)`` and flattened, as the reference
    does)."""
    if "lm_head" in params:
        return params["lm_head"]
    if cfg.n_codebooks:
        return params["embed"].permute(2, 0, 1).reshape(cfg.d_model, -1)
    return params["embed"].T


def pack_sc_weights(params: dict, cfg: ModelConfig,
                    pack=pack_weight) -> dict:
    """The parameter tree with every SC-GEMM weight quantized and packed
    once (``kernels.sc_matmul.pack_weight`` at ``cfg.sc_bits``) beside its
    float weight, as each projection takes it: ``wq``/``wk``/``wv`` as
    ``(d, heads·hd)``, ``wo`` as ``(H·hd, d)``, the MLP weights as they
    are, each expert projection ``(E, K, N)`` as one batched pack and a
    shared expert's as plain ones (``moe.pack_moe``), the head as ``(d,
    vocab)`` (``(d, K·vocab)``). Packs are always made anew from the
    float weights, so a tree packed before a weight changed is never used
    in place of the new one. Without ``cfg.use_sc_gemm`` the tree comes
    back as it is. The float weights stay for the exact path, for
    gradients and for a ``cfg.sc_impl`` of ``"ref"`` or ``"mxu_split"``,
    which ``sc_proj`` runs per call. ``pack(w, bits)`` makes each pack
    (``launch.steps.repack`` passes one that returns ``w`` itself, to pair
    a tree's packs with the float weights they are made from)."""
    if not cfg.use_sc_gemm:
        return params
    out = dict(params)
    out["packed"] = {"head": pack(_lm_head(params, cfg), cfg.sc_bits)}
    out["layers"] = [pack_block(layer, cfg, pack)
                     for layer in params["layers"]]
    return out


def pack_block(layer: dict, cfg: ModelConfig, pack) -> dict:
    """One block with its attention and MLP (or MoE) weights packed by
    ``pack`` beside the float weights, as the projections take them."""
    bits, d = cfg.sc_bits, cfg.d_model
    attn = dict(layer["attn"])
    attn["packed"] = {name: pack(attn[name].reshape(d, -1), bits)
                      for name in ("wq", "wk", "wv")}
    attn["packed"]["wo"] = pack(attn["wo"].reshape(-1, d), bits)
    if "moe" in layer:
        return {**layer, "attn": attn,
                "moe": pack_moe(layer["moe"], cfg, pack)}
    mlp = dict(layer["mlp"])
    mlp["packed"] = {name: pack(mlp[name], bits)
                     for name in ("w1", "w3", "w2")}
    return {**layer, "attn": attn, "mlp": mlp}


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

def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions,
         mrope_positions: torch.Tensor | None = None):
    """Q, K, V of ``x`` at ``positions (B, S)``, Q and K rotated: by
    M-RoPE with ``cfg.mrope_sections`` (``mrope_positions (3, B, S)``, or
    ``positions`` in all three streams), else by RoPE."""
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
    if cfg.mrope_sections is not None:
        mp = (positions.expand(3, *positions.shape)
              if mrope_positions is None else mrope_positions)
        return (apply_mrope(q, mp, cfg.mrope_sections, cfg.rope_theta),
                apply_mrope(k, mp, cfg.mrope_sections, cfg.rope_theta), v)
    cos, sin = rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out_proj(p: dict, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s = out.shape[:2]
    hd, h, d = cfg.head_dim, cfg.n_heads, cfg.d_model
    return sc_proj(out.reshape(b, s, h * hd), p["wo"].reshape(h * hd, d), cfg,
                   p.get("packed", {}).get("wo"))


def block_forward(layer: dict, x: torch.Tensor, cfg: ModelConfig, attend,
                  aux: list | None = None):
    """One pre-norm block; ``attend(q, k, v)`` is the attention site. Its
    FFN is the gated MLP or, in a MoE layer, ``moe.moe_ffn``; with ``aux``
    (a list) the block appends its aux loss, a float32 zero for a dense
    block, and only then is a MoE layer's computed."""
    attn_in = rms_norm(x, layer["ln1"], eps=cfg.norm_eps,
                       plus_one=cfg.norm_plus_one)
    attn_out = _out_proj(layer["attn"], attend(layer["attn"], attn_in), cfg)
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, layer["ln1_post"], eps=cfg.norm_eps,
                            plus_one=cfg.norm_plus_one)
    x = x + attn_out
    ff_in = rms_norm(x, layer["ln2"], eps=cfg.norm_eps,
                     plus_one=cfg.norm_plus_one)
    if "moe" in layer:
        ff_out, loss = moe_ffn(layer["moe"], ff_in, cfg,
                               with_aux=aux is not None)
    else:
        ff_out = gated_ffn(layer["mlp"], ff_in, cfg)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
    if aux is not None:
        aux.append(loss)
    if cfg.post_norms:
        ff_out = rms_norm(ff_out, layer["ln2_post"], eps=cfg.norm_eps,
                          plus_one=cfg.norm_plus_one)
    return x + ff_out


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                  visual_embeds: torch.Tensor | None = None):
    """``tokens (B, S)`` — ``(B, S, K)`` with codebooks, whose ``K``
    tables are summed left to right — embedded; ``visual_embeds (B, P,
    d)`` (the vision front end's stub) written over the first ``P``
    rows."""
    tokens = tokens.to(torch.long)
    if cfg.n_codebooks:
        x = params["embed"][0][tokens[..., 0]]
        for i in range(1, cfg.n_codebooks):
            x = x + params["embed"][i][tokens[..., i]]
    else:
        x = params["embed"][tokens]
    if cfg.emb_scale:
        x = x * x.new_full((), cfg.d_model ** 0.5)
    if visual_embeds is not None:
        p = visual_embeds.shape[1]
        if p > x.shape[1]:
            raise ValueError(f"{p} visual embeddings do not fit "
                             f"{x.shape[1]} positions")
        x = torch.cat([visual_embeds.to(x.dtype), x[:, p:]], dim=1)
    return x


def _embed(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    return _embed_tokens(params, cfg, batch["tokens"],
                         batch.get("visual_embeds"))


def _attn_sc_bits(cfg: ModelConfig) -> int | None:
    """The one resolution point of the attention numeric, so prefill, dense
    decode and paged decode never disagree on it."""
    return cfg.sc_bits if cfg.attn_sc else None


def _final(params, cfg, x):
    return rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                    plus_one=cfg.norm_plus_one)


def _full_sequence(params: dict, cfg: ModelConfig, batch: dict,
                   collect: bool):
    """Causal forward over whole sequences at positions ``0..S-1`` (M-RoPE
    at ``batch["mrope_positions"]`` where given): ``(hidden after the final
    norm, kvs, aux)``. With ``collect``, ``kvs`` holds each layer's K/V and
    ``aux`` is None; without, ``kvs`` is None and ``aux`` the MoE layers'
    aux loss summed as the reference's scan sums it (a group's positions in
    order, then the groups), and under a gradient with ``cfg.remat`` each
    group of ``cfg.group_size`` layers is rematerialised
    (``layers.remat_group``), as the reference checkpoints its scan body.
    A collecting run writes outside itself, so it is never
    rematerialised."""
    x = _embed(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    mrope_positions = batch.get("mrope_positions")
    gsz = cfg.group_size
    layers = params["layers"]
    kvs = [] if collect else None

    def group(g0):
        def run(x):
            x = shard_activations(x)
            aux = None if collect else []
            for i in range(g0, min(g0 + gsz, len(layers))):
                attend = full_attend(cfg, positions, cfg.window_at(i % gsz),
                                     kvs, mrope_positions)
                x = block_forward(layers[i], x, cfg, attend, aux)
            if collect:
                return x
            total = torch.zeros((), dtype=torch.float32, device=x.device)
            for a in aux:
                total = total + a
            return x, total
        return run

    totals = []
    for g0 in range(0, len(layers), gsz):
        if collect:
            x = group(g0)(x)
        else:
            x, total = remat_group(cfg, group(g0), x, layers[g0:g0 + gsz])
            totals.append(total)
    aux = None if collect else torch.stack(totals).sum()
    return _final(params, cfg, x), kvs, aux


def full_attend(cfg: ModelConfig, positions: torch.Tensor,
                window: int | None, kvs: list | None = None,
                mrope_positions: torch.Tensor | None = None):
    """The attention site of a causal forward over whole sequences at
    ``positions`` (``0..S-1`` a row): ``attend(p, h)`` projects Q/K/V
    (:func:`_qkv`), appends ``(k, v)`` to ``kvs`` when given, and
    flash-attends."""
    s = positions.shape[1]

    def attend(p, h):
        q, k, v = _qkv(p, h, cfg, positions, mrope_positions)
        if cfg.attn_kv_gather:
            # K/V gathered once a layer on a mesh (a no-op outside a scope)
            spec = P(batch_axes(), None, None, None)
            k, v = constrain(k, spec), constrain(v, spec)
        if kvs is not None:
            kvs.append((k, v))
        return flash_attention(
            q, k, v, q_positions=positions, kv_positions=positions,
            causal=True, window=window, logit_softcap=cfg.attn_softcap,
            q_block=min(cfg.q_block, s), kv_block=min(cfg.kv_block, s),
            skip_masked_blocks=cfg.skip_masked_blocks,
            bf16_probs=cfg.bf16_probs, kernel_impl=cfg.attn_kernel,
            q_offset=0, sc_bits=_attn_sc_bits(cfg))

    return attend


def forward_hidden(params: dict, cfg: ModelConfig,
                   batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (hidden ``(B, S, d)`` after the final norm,
    aux loss — the MoE layers' summed as the reference's scan sums them;
    zero without MoE layers). ``batch`` may hold ``visual_embeds`` and
    ``mrope_positions``. Under a gradient with ``cfg.remat`` each layer
    group is rematerialised (:func:`_full_sequence`)."""
    hidden, _, aux = _full_sequence(params, cfg, batch, collect=False)
    return hidden, aux


def logits_from_hidden(params: dict, cfg: ModelConfig,
                       hidden: torch.Tensor) -> torch.Tensor:
    """LM head: ``lm_head``, or the tied ``embed.T`` (``K = d``,
    ``N = vocab``; the largest SC-GEMM of every step) through ``sc_proj``;
    with codebooks reshaped to ``(..., K, vocab)``."""
    logits = sc_proj(hidden, _lm_head(params, cfg), cfg,
                     params.get("packed", {}).get("head"))
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    if cfg.n_codebooks:
        logits = logits.reshape(*hidden.shape[:-1], cfg.n_codebooks,
                                cfg.vocab_size)
    return logits


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy in ``cfg.loss_chunk`` sequence chunks (the
    sequence padded to a whole chunk with labels -1), labels -1 masked,
    ``total / max(count, 1)``, plus ``0.01`` times the MoE aux loss
    (reference ``transformer.py:366-391``). Audio labels are ``(B, S, K)``
    over the codebooks."""
    hidden, aux = forward_hidden(params, cfg, batch)
    labels = batch["labels"]
    s = labels.shape[1]
    chunk = min(cfg.loss_chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = torch.cat([hidden, hidden.new_zeros(
            (hidden.shape[0], pad, hidden.shape[2]))], dim=1)
        labels = torch.cat([labels, labels.new_full(
            (labels.shape[0], pad, *labels.shape[2:]), -1)], dim=1)
    ce = chunk_cross_entropy(hidden, labels, chunk,
                             lambda h: logits_from_hidden(params, cfg, h))
    return ce + 0.01 * aux


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
    :class:`KVCache`); ``extra_slots`` pads the cache's sequence axis.
    ``batch`` may hold ``visual_embeds`` and ``mrope_positions``; without
    the latter M-RoPE takes positions ``0..S-1`` in all three streams, the
    default the reference's other entry points build (its own
    ``prefill_step`` needs them given)."""
    hidden, kvs, _ = _full_sequence(params, cfg, batch, collect=True)
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
    x = _embed(params, cfg, batch)
    n_valid = torch.as_tensor(batch["n_valid"], dtype=torch.int32,
                              device=x.device).reshape(-1)[:1]
    positions = chunk_positions(cache.pos, x)
    for i, layer in enumerate(params["layers"]):
        if i % cfg.group_size == 0:
            x = shard_activations(x)
        k_cache, v_cache = _layer_kv(cache, cfg, i)
        attend = chunk_attend(cfg, k_cache, v_cache, positions,
                              cfg.window_at(i % cfg.group_size),
                              batch.get("mrope_positions"))
        x = block_forward(layer, x, cfg, attend)
    x = _final(params, cfg, x)
    last = x.index_select(1, (n_valid - 1).to(torch.long))
    logits = logits_from_hidden(params, cfg, last)
    cache.pos.add_(n_valid)
    return logits, cache


def chunk_positions(pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The ``(B, T)`` absolute positions of a chunk ``x (B, T, d)`` written
    at the staging offset ``pos`` (device values, never read here)."""
    b, t = x.shape[:2]
    pos = pos.expand(b) if pos.numel() == 1 else pos
    return (pos[:, None].to(torch.int32)
            + torch.arange(t, dtype=torch.int32, device=x.device)[None])


def chunk_attend(cfg: ModelConfig, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, positions: torch.Tensor,
                 window: int | None,
                 mrope_positions: torch.Tensor | None = None):
    """The attention site of a prefill chunk at ``positions`` (a
    :func:`chunk_positions`) over a B=1 staging site ``k_cache``/``v_cache``
    ``(B, E, KV, hd)``: ``attend(p, h)`` writes the chunk's K/V at its
    positions, in place, and flash-attends over the staging extent."""
    b, t = positions.shape
    e = k_cache.shape[1]
    # every row of the chunk sits at the shared staging offset
    offset = positions[0, 0]
    cols = positions[0].to(torch.long)
    kv_pos = torch.arange(e, dtype=torch.int32,
                          device=positions.device).expand(b, e)

    def attend(p, h):
        q, k, v = _qkv(p, h, cfg, positions, mrope_positions)
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

    return attend


# ------------------------------------------------------------------ decode

def _run_decode(params: dict, cfg: ModelConfig, cache: KVCache, batch: dict,
                site) -> tuple[torch.Tensor, KVCache]:
    """Shared decode of ``W`` consecutive tokens a sequence (``batch
    ["tokens"]: (B, W)``, rows at ``cache.pos + i``): embed, run the
    layers, project. ``site(layer_index)`` is the layer's attention site
    (:func:`decode_attend`), where the rows' K/V are written and read."""
    x = _embed(params, cfg, batch)
    b, w = x.shape[:2]
    pos = cache.pos.expand(b) if cache.pos.numel() == 1 else cache.pos
    positions = pos[:, None]
    if w > 1:
        positions = positions + torch.arange(w, dtype=pos.dtype,
                                             device=x.device)[None, :]
    for i, layer in enumerate(params["layers"]):
        x = block_forward(layer, x, cfg, decode_attend(
            cfg, positions, pos, cfg.window_at(i % cfg.group_size),
            site(i), batch.get("mrope_positions")))
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
    return _run_decode(params, cfg, cache, batch,
                       lambda i: _layer_kv(cache, cfg, i))


def dense_decode_attend(cfg: ModelConfig, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, q, k, v, pos: torch.Tensor,
                        window: int | None) -> torch.Tensor:
    """A decode site over a dense cache ``(B, S, KV, hd)``: the ``W`` rows'
    K/V written in place at ``pos + i`` (a row past the extent dropped),
    then decode attention."""
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
                            window=window, logit_softcap=cfg.attn_softcap,
                            sc_bits=_attn_sc_bits(cfg))


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
    return _run_decode(params, cfg, cache, batch,
                       lambda i: PagedKV(*_layer_kv(cache, cfg, i), tables))


def decode_attend(cfg: ModelConfig, positions: torch.Tensor,
                  pos: torch.Tensor, window: int | None, site,
                  mrope_positions: torch.Tensor | None = None):
    """The attention site of a decode step at ``positions`` (rows from
    ``pos``): ``attend(p, h)`` projects Q/K/V and attends through ``site``
    — a dense ``(k_cache, v_cache)`` pair (:func:`dense_decode_attend`) or
    a :class:`~.layers.PagedKV` (:func:`paged_decode_attend`)."""

    def attend(p, h):
        q, k, v = _qkv(p, h, cfg, positions, mrope_positions)
        if isinstance(site, PagedKV):
            return paged_decode_attend(cfg, site, q, k, v, pos, window)
        return dense_decode_attend(cfg, *site, q, k, v, pos, window)

    return attend


def paged_decode_attend(cfg: ModelConfig, paged: PagedKV, q, k, v,
                        pos: torch.Tensor,
                        window: int | None) -> torch.Tensor:
    """A decode site on the page pool: each slot's token scattered into its
    page — ``(tables[slot, pos // block], pos % block)``, a free slot's −1
    entry landing in the trash page — then attention through the table."""
    from .cache_ops import paged_token_entry
    entry, off = paged_token_entry(paged.tables, pos, block=paged.block)
    bid = torch.where(entry < 0, paged.trash, entry).to(torch.long)
    off = off.to(torch.long)
    paged.k[bid, off] = k[:, 0].to(paged.k.dtype)
    paged.v[bid, off] = v[:, 0].to(paged.v.dtype)
    return paged_decode_attention(q, paged, q_position=pos, window=window,
                                  logit_softcap=cfg.attn_softcap,
                                  kernel_impl=cfg.paged_attn_kernel,
                                  sc_bits=_attn_sc_bits(cfg))
