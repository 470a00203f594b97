"""Shared model layers of the port: RMSNorm, RoPE, GQA attention (the
main-path subset of ``repro/models/layers.py``).

Attention keeps the JAX package's formulations and layouts: a blocked
online-softmax "flash" formulation with explicit positions for (chunked)
prefill, a W-row exact-softmax decode attention against a dense cache, and
decode attention straight against the paged pool through the block table.

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

from typing import NamedTuple

import torch

__all__ = ["rms_norm", "rope", "apply_rope", "flash_attention",
           "decode_attention", "paged_decode_attention", "PagedKV", "softcap",
           "tree_sum"]

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    logit_softcap: float | None = None,
                    q_block: int = 512, kv_block: int = 1024,
                    skip_masked_blocks: bool = False,
                    bf16_probs: bool = False) -> torch.Tensor:
    """Blocked online-softmax attention with grouped (GQA) heads.

    ``q: (B, Sq, H, D)``; ``k, v: (B, Skv, KV, D)`` with ``H % KV == 0``;
    ``*_positions: (B, Sq)/(B, Skv)`` absolute positions for the causal and
    sliding-window masks. Plain PyTorch — the formulation the JAX package
    computes outside Pallas, and the one chunked prefill always takes. The
    fused flash kernel (canonical positions at 128-aligned widths) is not
    ported yet, so every prefill takes this formulation.
    """
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
    qg = q.reshape(b, sq + pq, kv_heads, g, d).permute(0, 2, 3, 1, 4)
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
            s = softcap(_scores(qb, kg[:, :, ks]) * scale, logit_softcap)
            mask = torch.ones((b, q_block, kv_block), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= qp[:, :, None] >= kp[:, None, :]
            if window is not None:
                mask &= (qp[:, :, None] - kp[:, None, :]) < window
            s = torch.where(mask[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + tree_sum(p, -1)
            vb = vg[:, :, ks]
            if bf16_probs:
                # probs and values squeezed to bf16 for the PV product,
                # sums kept in float32
                p = p.to(torch.bfloat16).to(torch.float32)
                vb = vb.to(torch.bfloat16)
            o = o * alpha[..., None] + _pv(p, vb)
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


def _paged_kernel_eligible(g: int, kv: int,
                           logit_softcap: float | None) -> bool:
    """Layouts the CUDA paged kernel serves. Unlike the TPU kernel there is
    no lane alignment to meet (``head_dim`` 64 is eligible); softcap layers
    and single-KV-head full-MHA (``KV == 1``, ``G == 1``) stay on the
    gathered path, as in the JAX package's dispatch."""
    return logit_softcap is None and not (g == 1 and kv == 1)


def paged_decode_attention(q: torch.Tensor, paged: PagedKV, *,
                           q_position: torch.Tensor,
                           window: int | None = None,
                           logit_softcap: float | None = None,
                           kernel_impl: str = "auto") -> torch.Tensor:
    """Single-step attention straight against the paged KV pool.

    ``q: (C, 1, H, D)``; ``paged`` holds this site's pools and block table;
    ``q_position: (C,)``. ``"auto"`` and ``"pallas_tuned"`` go through the
    paged kernel's wrapper on every eligible layout (the CUDA kernel on the
    card, its plain version on the CPU); ``"jnp"`` and ineligible layouts
    gather the pages and run :func:`decode_attention`'s plain formulation.
    """
    if kernel_impl not in ("auto", "jnp", "pallas_tuned"):
        raise ValueError(f"unknown paged attention kernel_impl "
                         f"{kernel_impl!r}")
    c, _, h, d = q.shape
    kv = paged.k.shape[2]
    g = h // kv
    if kernel_impl != "jnp" and _paged_kernel_eligible(g, kv, logit_softcap):
        from repro_torch.kernels.paged_attention import paged_attention
        out = paged_attention(q[:, 0].reshape(c, kv, g, d), paged.k, paged.v,
                              paged.tables, q_position, window=window)
        return out.reshape(c, 1, h, d)
    return _decode_attention_plain(q, _gather_pages(paged.k, paged.tables),
                                   _gather_pages(paged.v, paged.tables),
                                   q_position=q_position, window=window,
                                   logit_softcap=logit_softcap)


def _decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, *,
                            q_position: torch.Tensor,
                            window: int | None = None,
                            logit_softcap: float | None = None
                            ) -> torch.Tensor:
    """W-row exact-softmax decode attention, plain PyTorch (the JAX
    package's ``decode_attention`` formulation)."""
    b, w, h, d = q.shape
    _, s, kv_heads, _ = k_cache.shape
    g = h // kv_heads
    scale = d ** -0.5
    qg = q.reshape(b, w, kv_heads, g, d).permute(0, 2, 3, 1, 4)
    scores = _scores(qg, k_cache.permute(0, 2, 1, 3)) * scale
    scores = softcap(scores, logit_softcap)            # (B, KV, G, W, S)
    kpos = torch.arange(s, device=q.device)[None, None, :]
    row_pos = (q_position.to(torch.long)[:, None]
               + torch.arange(w, device=q.device)[None, :])      # (B, W)
    mask = kpos <= row_pos[:, :, None]                 # (B, W, S)
    if window is not None:
        mask &= (row_pos[:, :, None] - kpos) < window
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    mx = scores.amax(dim=-1, keepdim=True)
    un = torch.exp(scores - mx)
    p = un / tree_sum(un, -1)[..., None]
    out = _pv(p, v_cache.permute(0, 2, 1, 3))          # (B, KV, G, W, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, w, h, d)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, q_position: torch.Tensor,
                     window: int | None = None,
                     logit_softcap: float | None = None) -> torch.Tensor:
    """Decode-window attention against a (partly filled) dense KV cache.

    ``q: (B, W, H, D)`` — W consecutive query rows per sequence;
    ``k_cache, v_cache: (B, S, KV, D)``; ``q_position: (B,)`` position of
    the first row. Each row masks cache slots past its own position.

    On the card a one-row step (``W == 1``) of an eligible layout runs the
    paged kernel over the cache viewed as one page per sequence — the same
    kernel, and so the same order of summation, as the engine's paged
    decode, which keeps the sequential baseline and the engine
    token-identical. Everything else is the plain formulation.
    """
    b, w, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    g = h // kv
    if (q.is_cuda and w == 1 and k_cache.is_contiguous()
            and v_cache.is_contiguous()
            and _paged_kernel_eligible(g, kv, logit_softcap)):
        from repro_torch.kernels.paged_attention import paged_attention
        tables = torch.arange(b, dtype=torch.int32,
                              device=q.device)[:, None]
        out = paged_attention(q[:, 0].reshape(b, kv, g, d), k_cache, v_cache,
                              tables, q_position, window=window)
        return out.reshape(b, 1, h, d)
    return _decode_attention_plain(q, k_cache, v_cache, q_position=q_position,
                                   window=window, logit_softcap=logit_softcap)
