"""Shared model layers of the port: RMSNorm, RoPE, GQA attention (the
main-path subset of ``repro/models/layers.py``).

Attention keeps the JAX package's formulations and layouts: a blocked
online-softmax "flash" formulation with explicit positions for (chunked)
prefill, a W-row exact-softmax decode attention against a dense cache, and
decode attention straight against the paged pool through the block table.
Each takes ``sc_bits``: the SC-attention path (``cfg.attn_sc``), whose QKᵀ
and PV contractions run through the paper's popcount multiplier
(``kernels/sc_attention.py``).

**Flash-kernel dispatch departs from the reference.** The JAX package runs
its fused flash kernel only for canonical positions at 128-aligned widths
and sends chunked prefill through the jnp formulation. Here the kernel
takes a ``q_offset`` (query row ``i`` at position ``q_offset + i``, keys at
``0..Skv-1``; an int, or a one-element int32 tensor on the card that the
kernel reads, so a captured chunk replays at any staging offset), so on
the card one-shot prefill (offset 0) and chunked prefill (the staging
offset) both run it — and the chunked engine, the
one-shot engine and the sequential baseline reduce each row identically.
The MXU alignment is dropped: the gate is causal, no window, no softcap,
not ``bf16_probs``, SC bits in 2..8.

**Batch invariance.** The serving engine's streams must equal the
sequential per-request baseline token for token on the card, where
PyTorch's reductions and matmuls pick their kernels (and so their order of
summation) by shape. Every float reduction on this path is therefore a
:func:`tree_sum` — pairwise halving over a power-of-two padded axis, one
elementwise add per level — whose result for a row depends only on that
row, and is unchanged by trailing zeros (masked keys, bucket padding). The
projections are integer-exact under SC-GEMM, and decode attention on the
card runs one CUDA kernel for both the paged and the dense cache (a dense
cache is a pool of one page per slot), so both decode paths reduce in the
same order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.sc_attention import (sc_attention_bits_ok, sc_pv,
                                              sc_scores)
from repro_torch.parallel.context import is_dtensor, whole_groups
from repro_torch.tree import leaves

__all__ = ["rms_norm", "rope", "apply_rope", "apply_mrope",
           "flash_attention", "decode_attention", "paged_decode_attention",
           "PagedKV", "softcap", "tree_sum", "remat_group",
           "chunk_cross_entropy"]

NEG_INF = -1e30


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` by pairwise halving after zero-padding it to a power
    of two. Each level is one elementwise add, so a row's sum is the same
    whatever the batch, the device kernel, or the number of trailing zeros —
    what :func:`torch.sum` does not promise."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        return x.sum(dim=dim)
    p = 1 << (n - 1).bit_length()
    if p != n:
        pad = list(x.shape)
        pad[dim] = p - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while p > 1:
        p //= 2
        x = x.narrow(dim, 0, p) + x.narrow(dim, p, p)
    return x.squeeze(dim)


def remat_group(cfg, fn: Callable, x: torch.Tensor, group_params):
    """``fn(x)`` for one layer group — under activation rematerialisation
    (``torch.utils.checkpoint``, non-reentrant) when ``cfg.remat`` and a
    gradient is being taken through ``x`` or the group's parameters, as the
    reference wraps each group in ``jax.checkpoint``. Without a gradient
    (serving, graph capture) ``fn`` runs as it is. ``fn`` must not write
    outside itself: it runs again in the backward."""
    if cfg.remat and torch.is_grad_enabled() and (
            x.requires_grad or any(
                isinstance(p, torch.Tensor) and p.requires_grad
                for p in leaves(group_params))):
        # the model draws no random numbers: no RNG state to carry over
        return checkpoint(fn, x, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(x)


def chunk_cross_entropy(hidden: torch.Tensor, labels: torch.Tensor,
                        chunk: int, head: Callable) -> torch.Tensor:
    """Mean next-token cross-entropy over sequence chunks, so ``(B, S,
    V)`` logits never exist at once (the reference's ``chunk_loss`` scan):
    ``hidden (B, S, d)``, ``labels (B, S)`` or ``(B, S, K)`` with -1
    masked, ``head(h)`` float32 logits ``(..., V)`` of a chunk. Returns
    ``total / max(count, 1)``; ``S`` must be a multiple of ``chunk``."""
    s = labels.shape[1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c0 in range(0, s, chunk):
        y = labels[:, c0:c0 + chunk]
        logp = torch.log_softmax(head(hidden[:, c0:c0 + chunk]), dim=-1)
        valid = y >= 0
        ll = torch.gather(logp, -1,
                          torch.clamp(y, min=0).to(torch.long)[..., None])
        total = total + torch.where(valid, -ll[..., 0], 0.0).sum()
        count = count + valid.sum(dtype=torch.int32)
    return total / torch.clamp(count, min=1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32 with a cast back. ``plus_one`` is gemma-style (1+w)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = tree_sum(x * x, -1)[..., None] / x.shape[-1]
    x = x * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    out = x * (1.0 + w if plus_one else w)
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(positions: torch.Tensor, head_dim: int,
         theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions ``(..., S)`` → ``(..., S, head_dim/2)``."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x: (B, S, H, D)`` with tables ``(B, S, D/2)`` (half-split)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...], theta: float) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): ``positions (3, B, S)`` are (t, h, w)
    ids. The rotary half-dim is split into ``sections`` (16/24/24 at
    head_dim 128); each section rotates by its own position stream. The
    angles are :func:`rope`'s, so positions equal in all three streams
    give :func:`rope`'s tables bit for bit."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not split the "
                         f"rotary half-dim {half}")
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].to(torch.float32) * freqs  # (3, B, S, h)
    parts, start = [], 0
    for axis, sec in enumerate(sections):
        parts.append(angles[axis, :, :, start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                           # (B, S, half)
    return apply_rope(x, torch.cos(ang), torch.sin(ang))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q (B, KV, G, Q, D)`` · ``k (B, KV, K, D)`` → ``(B, KV, G, Q, K)``
    float32, each dot product a :func:`tree_sum` over D."""
    return tree_sum(q.to(torch.float32)[:, :, :, :, None, :]
                    * k.to(torch.float32)[:, :, None, None, :, :], -1)


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``p (B, KV, G, Q, K)`` · ``v (B, KV, K, D)`` → ``(B, KV, G, Q, D)``,
    summed over K by :func:`tree_sum`."""
    return tree_sum(p[..., None] * v.to(torch.float32)[:, :, None, None],
                    -2)


def _flash_kernel_eligible(*, causal: bool, window: int | None,
                           logit_softcap: float | None, bf16_probs: bool,
                           kv_block: int, d: int,
                           sc_bits: int | None = None) -> bool:
    """Calls the CUDA flash kernel serves: plain causal attention, no
    window, no softcap, float32 probabilities (``bf16_probs`` would mix
    probability precisions across a model's layers), SC bits in 2..8, and
    a head dim and quantization group that fit the kernel's shared memory.
    Unlike the TPU kernel's gate there is no 128-alignment of S or D."""
    from repro_torch.kernels.flash_attention import MAX_D, MAX_GROUP
    return (causal and window is None and logit_softcap is None
            and not bf16_probs and sc_attention_bits_ok(sc_bits)
            and d <= MAX_D and kv_block <= MAX_GROUP)


class _FlashKernelCall(torch.autograd.Function):
    """The flash kernel in the layer layout ``(B, S, H, D)``. Its backward
    recomputes through the plain formulation (the kernel is forward only,
    as the TPU kernel is), so this is a true VJP of the same math; under
    SC the quantization steps make it piecewise constant, as in the JAX
    package's ``_flash_kernel_call_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_block, sc_bits, q_block,
                skip_masked_blocks):
        from repro_torch.kernels.ops import flash_attention_tuned
        out = flash_attention_tuned(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=True,
                                    q_offset=q_offset, group=kv_block,
                                    sc_bits=sc_bits)
        ctx.save_for_backward(q, k, v)
        ctx.opts = (q_offset, kv_block, sc_bits, q_block, skip_masked_blocks)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        q_offset, kv_block, sc_bits, q_block, skip = ctx.opts
        b, sq = q.shape[:2]
        skv = k.shape[1]
        # a tensor offset stays on the device: positions are built there
        qpos = (q_offset + torch.arange(sq, dtype=torch.int32,
                                        device=q.device)).expand(b, sq)
        canonical = isinstance(q_offset, int) and q_offset == 0
        kpos = torch.arange(skv, dtype=torch.int32,
                            device=q.device).expand(b, skv)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _flash_plain(*leaves, q_positions=qpos, kv_positions=kpos,
                               causal=True, window=None, logit_softcap=None,
                               q_block=q_block, kv_block=kv_block,
                               skip_masked_blocks=skip and canonical,
                               bf16_probs=False, sc_bits=sc_bits)
            grads = torch.autograd.grad(out, leaves, grad)
        return (*grads, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    logit_softcap: float | None = None,
                    q_block: int = 512, kv_block: int = 1024,
                    skip_masked_blocks: bool = False,
                    bf16_probs: bool = False, kernel_impl: str = "auto",
                    q_offset: int | torch.Tensor | None = None,
                    sc_bits: int | None = None) -> torch.Tensor:
    """Blocked online-softmax attention with grouped (GQA) heads.

    ``q: (B, Sq, H, D)``; ``k, v: (B, Skv, KV, D)`` with ``H % KV == 0``;
    ``*_positions: (B, Sq)/(B, Skv)`` absolute positions for the causal and
    sliding-window masks. ``sc_bits`` routes QKᵀ and PV through the SC
    popcount path; probabilities are quantized per row over each
    ``kv_block`` of keys.

    ``q_offset`` declares the positions canonical: query row ``i`` at
    ``q_offset + i`` and keys at ``0..Skv-1`` for every batch row (an int,
    or a one-element int32 tensor on the positions' device, never read on
    the host). Only then may the fused kernel serve the call (module
    docstring):
    ``kernel_impl="auto"`` runs it for tensors on the card, "pallas_tuned"
    goes through its wrapper on every eligible call (the plain version on
    the CPU), "jnp" forces the plain formulation; both kernel routes take
    the autotuner's heads and m-tiles a block (``ops.flash_attention_tuned``).
    The kernel quantizes SC probabilities over the same ``kv_block`` groups
    of keys.
    """
    if kernel_impl not in ("auto", "jnp", "pallas_tuned"):
        raise ValueError(f"unknown attention kernel_impl {kernel_impl!r}")
    if sc_bits is not None:
        # the SC PV is a quantized contraction with float32 state; a bf16
        # squeeze would only change the quantizer's inputs
        bf16_probs = False
    eligible = q_offset is not None and _flash_kernel_eligible(
        causal=causal, window=window, logit_softcap=logit_softcap,
        bf16_probs=bf16_probs, kv_block=kv_block, d=q.shape[-1],
        sc_bits=sc_bits)
    if eligible and (kernel_impl == "pallas_tuned"
                     or (kernel_impl == "auto" and q.is_cuda)):
        if not isinstance(q_offset, torch.Tensor):
            q_offset = int(q_offset)
        return _FlashKernelCall.apply(q, k, v, q_offset, kv_block,
                                      sc_bits, q_block, skip_masked_blocks)
    return _flash_plain(q, k, v, q_positions=q_positions,
                        kv_positions=kv_positions, causal=causal,
                        window=window, logit_softcap=logit_softcap,
                        q_block=q_block, kv_block=kv_block,
                        skip_masked_blocks=skip_masked_blocks,
                        bf16_probs=bf16_probs, sc_bits=sc_bits)


def _flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_positions: torch.Tensor, kv_positions: torch.Tensor,
                 causal: bool, window: int | None,
                 logit_softcap: float | None, q_block: int, kv_block: int,
                 skip_masked_blocks: bool, bf16_probs: bool,
                 sc_bits: int | None) -> torch.Tensor:
    """The flash formulation in plain PyTorch (the JAX package's jnp
    path): the CPU's prefill, the kernel's plain version, and its
    backward."""
    b, sq, h, d = q.shape
    _, skv, kv_heads, _ = k.shape
    g = h // kv_heads
    scale = d ** -0.5

    pq = (-sq) % q_block
    pk = (-skv) % kv_block
    if pq:
        q = torch.cat([q, q.new_zeros((b, pq, h, d))], dim=1)
        q_positions = torch.cat(
            [q_positions, q_positions.new_full((b, pq), -1)], dim=1)
    if pk:
        k = torch.cat([k, k.new_zeros((b, pk, kv_heads, d))], dim=1)
        v = torch.cat([v, v.new_zeros((b, pk, kv_heads, d))], dim=1)
        kv_positions = torch.cat(
            [kv_positions, kv_positions.new_full((b, pk), 2 ** 31 - 1)], dim=1)
    nq, nk = (sq + pq) // q_block, (skv + pk) // kv_block

    # grouped layouts: q (B, KV, G, S, D), k/v (B, KV, S, D)
    qg = whole_groups(q, 2, kv_heads).reshape(
        b, sq + pq, kv_heads, g, d).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 1, 3)
    vg = v.permute(0, 2, 1, 3)

    outs = []
    for qi in range(nq):
        qs = slice(qi * q_block, (qi + 1) * q_block)
        qb, qp = qg[:, :, :, qs], q_positions[:, qs]
        m = torch.full((b, kv_heads, g, q_block), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((b, kv_heads, g, q_block, d), dtype=torch.float32,
                        device=q.device)
        limit = nk
        if skip_masked_blocks and causal and window is None:
            limit = min(qi * q_block // kv_block + 1, nk)
        for ki in range(limit):
            ks = slice(ki * kv_block, (ki + 1) * kv_block)
            kp = kv_positions[:, ks]
            if sc_bits is not None:
                # q (B, KV, G, Q, D) against k rows (B, KV, 1, K, D)
                s = sc_scores(qb, kg[:, :, ks][:, :, None],
                              bits=sc_bits) * scale
            else:
                s = _scores(qb, kg[:, :, ks]) * scale
            s = softcap(s, logit_softcap)
            mask = torch.ones((b, q_block, kv_block), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (qp[:, :, None] >= kp[:, None, :])
            elif pk and ki == nk - 1:
                # the zero padding past Skv is no key; the causal test
                # masks it through its position, a full mask must too
                mask = mask & (ki * kv_block + torch.arange(
                    kv_block, device=q.device) < skv)[None, None, :]
            if window is not None:
                mask = mask & ((qp[:, :, None] - kp[:, None, :]) < window)
            s = torch.where(mask[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + tree_sum(p, -1)
            vb = vg[:, :, ks]
            if sc_bits is not None:
                # block-local unnormalized probs (B, KV, G, Q, K) against
                # value rows (B, KV, 1, 1, K, D)
                pv = sc_pv(p, vb.to(torch.float32)[:, :, None, None],
                           bits=sc_bits)
            else:
                if bf16_probs:
                    # probs and values squeezed to bf16 for the PV
                    # product, sums kept in float32
                    # repro-lint: disable=R5 -- deliberate bf16_probs squeeze, config-gated and never on the SC path; _pv sums in float32 by tree_sum
                    p = p.to(torch.bfloat16).to(torch.float32)
                    # repro-lint: disable=R5 -- deliberate bf16_probs squeeze; _pv casts the values to float32 before its tree_sum
                    vb = vb.to(torch.bfloat16)
                pv = _pv(p, vb)
            o = o * alpha[..., None] + pv
            m = m_new
        out = o / torch.clamp(l, min=1e-30)[..., None]
        # (B, KV, G, Q, D) -> (B, Q, KV, G, D) -> (B, Q, H, D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_block, h, d))
    out = torch.cat(outs, dim=1)
    return out[:, :sq].to(q.dtype)


class PagedKV(NamedTuple):
    """One attention site's KV state in the paged pool layout: page pools
    ``k, v: (P, block, KV, hd)`` (last page = trash) plus the shared
    ``(capacity, max_blocks)`` block table."""
    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor

    @property
    def block(self) -> int:
        return self.k.shape[1]

    @property
    def trash(self) -> int:
        return self.k.shape[0] - 1


def _gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """``(P, block, KV, D)`` pages through a ``(C, MB)`` table →
    ``(C, MB·block, KV, D)``, unallocated entries redirected to the trash
    page (the same redirect as ``cache_ops.paged_gather``)."""
    safe = torch.where(tables < 0, pages.shape[0] - 1, tables).to(torch.long)
    g = pages[safe]                            # (C, MB, block, KV, D)
    c, mb, blk = g.shape[:3]
    return g.reshape(c, mb * blk, *g.shape[3:])


def _paged_kernel_eligible(g: int, kv: int, logit_softcap: float | None,
                           sc_bits: int | None = None) -> bool:
    """Layouts the CUDA paged kernel serves. Unlike the TPU kernel there is
    no lane alignment to meet (``head_dim`` 64 is eligible); softcap layers
    stay on the gathered path, as in the JAX package's dispatch, and so
    does float single-KV-head full-MHA (``KV == 1``, ``G == 1``). The SC
    path widens the envelope to every head layout, as the reference's
    does: its contraction is an integer popcount sum. The layout gate is
    the autotuner's grid (``autotune.candidate_paged_configs``), empty for
    what the kernel does not serve, as in the JAX package."""
    from repro_torch.kernels.autotune import candidate_paged_configs
    if logit_softcap is not None or not sc_attention_bits_ok(sc_bits):
        return False
    return bool(candidate_paged_configs(kv, g, sc=sc_bits is not None))


def paged_decode_attention(q: torch.Tensor, paged: PagedKV, *,
                           q_position: torch.Tensor,
                           window: int | None = None,
                           logit_softcap: float | None = None,
                           kernel_impl: str = "auto",
                           sc_bits: int | None = None) -> torch.Tensor:
    """Single-step attention straight against the paged KV pool.

    ``q: (C, 1, H, D)``; ``paged`` holds this site's pools and block table;
    ``q_position: (C,)``. ``"auto"`` and ``"pallas_tuned"`` go through the
    paged kernel's wrapper on every eligible layout (the CUDA kernel on the
    card, its plain version on the CPU), looked up through the autotuner
    under ``"pallas_tuned"`` and, on the card, ``"auto"``
    (``ops.paged_decode_attention_tuned``); ``"jnp"`` and ineligible
    layouts gather the pages and run :func:`decode_attention`'s plain
    formulation. ``sc_bits`` selects the SC score and PV path.
    """
    if kernel_impl not in ("auto", "jnp", "pallas_tuned"):
        raise ValueError(f"unknown paged attention kernel_impl "
                         f"{kernel_impl!r}")
    c, _, h, d = q.shape
    kv = paged.k.shape[2]
    g = h // kv
    if kernel_impl != "jnp" and _paged_kernel_eligible(g, kv, logit_softcap,
                                                       sc_bits):
        if kernel_impl == "pallas_tuned" or q.is_cuda:
            from repro_torch.kernels.ops import (
                paged_decode_attention_tuned as kernel)
        else:
            from repro_torch.kernels.paged_attention import (
                paged_attention as kernel)
        out = kernel(whole_groups(q[:, 0], 1, kv).reshape(c, kv, g, d),
                     paged.k, paged.v,
                     paged.tables, q_position, window=window,
                     sc_bits=sc_bits)
        return out.reshape(c, 1, h, d)
    return _decode_attention_plain(q, _gather_pages(paged.k, paged.tables),
                                   _gather_pages(paged.v, paged.tables),
                                   q_position=q_position, window=window,
                                   logit_softcap=logit_softcap,
                                   sc_bits=sc_bits)


def _decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, *,
                            q_position: torch.Tensor,
                            window: int | None = None,
                            logit_softcap: float | None = None,
                            sc_bits: int | None = None) -> torch.Tensor:
    """W-row exact-softmax decode attention, plain PyTorch (the JAX
    package's ``decode_attention`` formulation). Under ``sc_bits`` the
    normalized probability row is quantized over the whole cache extent;
    masked keys are exact zeros, so the extent does not matter."""
    b, w, h, d = q.shape
    _, s, kv_heads, _ = k_cache.shape
    g = h // kv_heads
    scale = d ** -0.5
    qg = whole_groups(q, 2, kv_heads).reshape(
        b, w, kv_heads, g, d).permute(0, 2, 3, 1, 4)
    if sc_bits is not None:
        # q (B, KV, G, W, D) against k rows (B, KV, 1, S, D)
        scores = sc_scores(qg, k_cache.permute(0, 2, 1, 3)[:, :, None],
                           bits=sc_bits) * scale
    else:
        scores = _scores(qg, k_cache.permute(0, 2, 1, 3)) * scale
    scores = softcap(scores, logit_softcap)            # (B, KV, G, W, S)
    kpos = torch.arange(s, device=q.device)[None, None, :]
    row_pos = (q_position.to(torch.long)[:, None]
               + torch.arange(w, device=q.device)[None, :])      # (B, W)
    mask = kpos <= row_pos[:, :, None]                 # (B, W, S)
    if window is not None:
        mask = mask & ((row_pos[:, :, None] - kpos) < window)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    mx = scores.amax(dim=-1, keepdim=True)
    un = torch.exp(scores - mx)
    p = un / tree_sum(un, -1)[..., None]
    if sc_bits is not None:
        # value rows (B, KV, 1, 1, S, D) against p (B, KV, G, W, S)
        out = sc_pv(p, v_cache.to(torch.float32).permute(
            0, 2, 1, 3)[:, :, None, None], bits=sc_bits)
    else:
        out = _pv(p, v_cache.permute(0, 2, 1, 3))      # (B, KV, G, W, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, w, h, d)
    return out.to(q.dtype)


def _per_rank_rows(fn, q, k_cache, v_cache, q_position, **kw):
    """``fn`` on each rank's own sequences of ``DTensor`` operands: the
    batch split as the cache splits it, every other axis whole (the
    kernel reads whole heads and whole rows), and ``fn`` run on the local
    tensors. The kernel's route views a dense cache as one page a
    sequence, so a rank's rows must meet its own pages, which DTensor's
    rule for the operator (any table entry may name any page) would
    gather whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = k_cache.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in k_cache.placements]

    def local(t):
        return t.redistribute(mesh, rows).to_local() if is_dtensor(t) \
            else t

    out = fn(local(q), local(k_cache), local(v_cache),
             q_position=local(q_position), **kw)
    return DTensor.from_local(
        out, mesh, rows, shape=q.shape,
        stride=torch.empty(q.shape, device="meta").stride())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, q_position: torch.Tensor,
                     window: int | None = None,
                     logit_softcap: float | None = None,
                     sc_bits: int | None = None,
                     kernel_impl: str = "auto") -> torch.Tensor:
    """Decode-window attention against a (partly filled) dense KV cache.

    ``q: (B, W, H, D)`` — W consecutive query rows per sequence;
    ``k_cache, v_cache: (B, S, KV, D)``; ``q_position: (B,)`` position of
    the first row. Each row masks cache slots past its own position.
    ``sc_bits`` selects the SC score and PV path.

    On the card every eligible layout runs the paged kernel over the cache
    viewed as one page per sequence, the window flattened into ``B·W``
    query rows: row ``(b, i)`` takes table row ``b`` at position
    ``q_position[b] + i``, so it is exactly the one-row call at that
    position. It is the same kernel, and so the same order of summation,
    as the engine's paged decode: the sequential baseline, the engine and
    a speculative verify window stay token-identical, float and SC alike.
    Its plan is looked up through the autotuner, as the paged decode's.
    ``kernel_impl="pallas_tuned"`` takes that route on any device (the
    kernel's plain version on the CPU, which gathers the same rows).
    Everything else (the CPU, softcap layers) is the plain formulation,
    whose rows are W-invariant too.
    """
    b, w, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    g = h // kv
    if ((q.is_cuda or kernel_impl == "pallas_tuned")
            and k_cache.is_contiguous() and v_cache.is_contiguous()
            and _paged_kernel_eligible(g, kv, logit_softcap, sc_bits)):
        if is_dtensor(k_cache):
            return _per_rank_rows(decode_attention, q, k_cache, v_cache,
                                  q_position, window=window,
                                  logit_softcap=logit_softcap,
                                  sc_bits=sc_bits, kernel_impl=kernel_impl)
        from repro_torch.kernels.ops import paged_decode_attention_tuned
        tables = torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
        rows = q_position
        if w > 1:
            tables = tables.expand(b, w).reshape(b * w, 1)
            rows = (q_position.to(torch.int32)[:, None]
                    + torch.arange(w, dtype=torch.int32,
                                   device=q.device)[None, :]).reshape(b * w)
        out = paged_decode_attention_tuned(
            whole_groups(q, 2, kv).reshape(b * w, kv, g, d), k_cache,
            v_cache, tables, rows,
            window=window, sc_bits=sc_bits)
        return out.reshape(b, w, h, d)
    return _decode_attention_plain(q, k_cache, v_cache, q_position=q_position,
                                   window=window, logit_softcap=logit_softcap,
                                   sc_bits=sc_bits)
