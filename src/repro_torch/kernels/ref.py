"""Plain-PyTorch oracles for the port's kernels (port of
``repro/kernels/ref.py``): for SC-GEMM one full ``(M, K, N)`` broadcast of
the closed form, no chunking, no packing; for the stream kernel the
unpacked N-bit streams ANDed and popcounted; for the attention kernels
plain (not online) softmax attention over the whole key row — the
simplest statements of the functions the kernels and their plain versions
compute. ``proposed_closed_form`` lives in ``core/multipliers.py`` and is
re-exported here.

The SC attention oracles build on the canonical core ops
(``quantize_sign_magnitude``, ``proposed_closed_form``), never on the
helpers of ``kernels/sc_attention.py`` that the kernels' plain versions
and the model layers share, so they state the function independently of
the code they hold. Masked scores are ``-1e30`` and softmax runs in
float32, as in the reference."""
from __future__ import annotations

import torch

from repro_torch.core.multipliers import proposed_closed_form
from repro_torch.core.sc_numerics import quantize_sign_magnitude
from repro_torch.core.tcu import (correlation_encode, pack_stream,
                                  stream_length, tcu_decode)

__all__ = ["proposed_closed_form", "sc_matmul_counts_ref", "sc_matmul_ref",
           "sc_stream_mul_ref", "sc_stream_words_ref", "flash_attention_ref",
           "sc_attention_scores_ref", "sc_attention_pv_ref",
           "sc_flash_attention_ref", "sc_decode_attention_ref"]

_MASKED = -1e30


def sc_matmul_counts_ref(sx, mx, sy, my, bits: int) -> torch.Tensor:
    """Signed SC-GEMM counts Σ_k s_x s_y O(x, y) — int32 ``(M, N)``."""
    o = proposed_closed_form(mx[:, :, None], my[None, :, :], bits=bits)
    s = sx[:, :, None].to(torch.int32) * sy[None, :, :].to(torch.int32)
    return (s * o).sum(dim=1, dtype=torch.int32)


def sc_matmul_ref(a, b, bits: int = 8, row_quant: bool = False):
    """Float-in/float-out SC-GEMM oracle (quantize → counts → dequantize)."""
    qa = quantize_sign_magnitude(a.to(torch.float32), bits=bits,
                                 axis=-1 if row_quant else None)
    qb = quantize_sign_magnitude(b.to(torch.float32), bits=bits)
    counts = sc_matmul_counts_ref(qa.sign, qa.mag, qb.sign, qb.mag, bits)
    return counts.to(torch.float32) * (stream_length(bits) * qa.scale
                                       * qb.scale)


def sc_stream_mul_ref(x, y, bits: int) -> torch.Tensor:
    """Bit-level elementwise stream multiplier oracle: popcount(X_u & Y_u)."""
    xu = tcu_decode(x, bits=bits, dtype=torch.int32)
    yu = correlation_encode(y, bits=bits, dtype=torch.int32)
    return (xu & yu).sum(dim=-1, dtype=torch.int32)


def sc_stream_words_ref(x, y, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed stream words for X_u and Y_u (int64 holding the unsigned
    32-bit value; oracle for in-kernel packing)."""
    xw = pack_stream(tcu_decode(x, bits=bits, dtype=torch.int32))
    yw = pack_stream(correlation_encode(y, bits=bits, dtype=torch.int32))
    return xw, yw


def _causal(s: torch.Tensor) -> torch.Tensor:
    """Scores ``(..., Sq, Skv)`` with key ``j > i`` masked for query ``i``."""
    sq, skv = s.shape[-2:]
    mask = (torch.arange(sq, device=s.device)[:, None]
            >= torch.arange(skv, device=s.device)[None, :])
    return torch.where(mask, s, s.new_full((), _MASKED))


def flash_attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Naive attention oracle for the flash kernel: ``q (B, H, Sq, D)``;
    ``k, v (B, KV, Skv, D)`` (GQA broadcast)."""
    d = q.shape[-1]
    g = q.shape[1] // k.shape[1]
    k = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    v = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k) * (d ** -0.5)
    if causal:
        s = _causal(s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def sc_attention_scores_ref(q, k, *, bits: int) -> torch.Tensor:
    """Dequantized SC scores: ``q (..., Q, D)`` × ``k (..., K, D)`` →
    float32 ``(..., Q, K)``, per-row sign-magnitude quantization, unscaled
    (the caller applies ``d ** -0.5``)."""
    qq = quantize_sign_magnitude(q.to(torch.float32), bits=bits, axis=-1)
    qk = quantize_sign_magnitude(k.to(torch.float32), bits=bits, axis=-1)
    o = proposed_closed_form(qq.mag[..., :, None, :],
                             qk.mag[..., None, :, :], bits=bits)
    s = (qq.sign[..., :, None, :].to(torch.int32)
         * qk.sign[..., None, :, :].to(torch.int32))
    counts = (s * o).sum(dim=-1, dtype=torch.int32)
    return counts.to(torch.float32) * (
        stream_length(bits) * qq.scale * qk.scale.transpose(-1, -2))


def sc_attention_pv_ref(p, v, *, bits: int) -> torch.Tensor:
    """SC prob-weighted value mix: ``p (..., K)`` × ``v (..., K, D)`` →
    float32 ``(..., D)``. Probs quantize per row over K, values per row
    over D; the O-term dequantizes elementwise (PV scales do not
    factorize) and the float32 sum runs over the key axis."""
    qp = quantize_sign_magnitude(p.to(torch.float32), bits=bits, axis=-1)
    qv = quantize_sign_magnitude(v.to(torch.float32), bits=bits, axis=-1)
    o = proposed_closed_form(qp.mag[..., :, None], qv.mag, bits=bits)
    sgn = qp.sign[..., :, None].to(torch.int32) * qv.sign.to(torch.int32)
    term = (sgn * o).to(torch.float32) * qv.scale
    return term.sum(dim=-2) * (stream_length(bits) * qp.scale)


def sc_flash_attention_ref(q, k, v, *, bits: int,
                           causal: bool = True) -> torch.Tensor:
    """Plain-softmax SC attention oracle in the flash kernel's layout:
    ``q (B, H, Sq, D)``; ``k, v (B, KV, Skv, D)`` (GQA broadcast)."""
    d = q.shape[-1]
    g = q.shape[1] // k.shape[1]
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    s = sc_attention_scores_ref(q, k, bits=bits) * (d ** -0.5)
    if causal:
        s = _causal(s)
    p = torch.softmax(s, dim=-1)
    out = sc_attention_pv_ref(p, v[:, :, None], bits=bits)  # (B, H, Sq, D)
    return out.to(q.dtype)


def sc_decode_attention_ref(q, k_cache, v_cache, *, q_position, bits: int,
                            window: int | None = None,
                            logit_softcap: float | None = None
                            ) -> torch.Tensor:
    """Gathered-dense SC decode oracle in the model layers' layout:
    ``q (B, 1, H, D)``; ``k_cache, v_cache (B, S, KV, D)``; ``q_position``
    an int or ``(B,)``. Keys past ``q_position`` or outside the sliding
    window are masked exactly as ``models.layers.decode_attention`` masks
    them."""
    d = q.shape[-1]
    s_len, g = k_cache.shape[1], q.shape[2] // k_cache.shape[2]
    qh = q.transpose(1, 2)                                      # (b, h, 1, d)
    k = torch.repeat_interleave(k_cache.transpose(1, 2), g, dim=1)
    v = torch.repeat_interleave(v_cache.transpose(1, 2), g, dim=1)
    s = sc_attention_scores_ref(qh, k, bits=bits) * (d ** -0.5)  # (b,h,1,S)
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    kpos = torch.arange(s_len, device=q.device)
    qpos = torch.as_tensor(q_position, device=q.device).reshape(-1)
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask[:, None, None, :], s, s.new_full((), _MASKED))
    p = torch.softmax(s, dim=-1)
    out = sc_attention_pv_ref(p, v[:, :, None], bits=bits)     # (b, h, 1, d)
    return out.transpose(1, 2).to(q.dtype)                     # (b, 1, h, d)
