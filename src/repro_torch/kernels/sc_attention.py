"""SC-attention primitives: the paper's AND+popcount multiplier as the QKᵀ
and PV contractions of an attention step (port of
``repro/kernels/sc_attention.py``).

These are the plain PyTorch versions of the four steps that both CUDA
attention kernels run as ``__device__`` functions (``csrc/sc_attention.cuh``)
— the CPU path and the tests use them, and the kernels are held against
them on the card. They follow the JAX helpers operation for operation:

* :func:`sc_quant_rows` — per-row (last axis) abs-max sign-magnitude
  quantization: ``scale = max(absmax, 1e-12) / n_max`` as one float32
  division, ``mag = clip(round(|v| / scale), 0, n_max)`` with a true
  division rounded half to even, ``sign = -1 where v < 0`` (so −0.0 gives
  +1);
* :func:`sc_popcount` — ``popcount(X_u AND Y_u)`` in closed form, with a
  floor for ``(x − msb) // 2``, so ``O(0, y) = 0`` exactly;
* :func:`sc_scores` — integer QKᵀ counts (int32-exact: ``|count| ≤
  D·(N−1)``), dequantized by ``(N · Δq[i]) · Δk[j]``;
* :func:`sc_pv` — elementwise-dequantized PV terms, summed over the key
  axis by :func:`~repro_torch.models.layers.tree_sum`, times ``N · Δp``.

Per-row scales make a row's planes independent of its batch, chunk and
page; a masked probability is an exact ``0.0`` whose magnitude is 0, so a
masked key contributes an exact zero term.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import (SC_ATTN_BITS_MAX, SC_ATTN_BITS_MIN,
                                      sc_attention_bits_ok)
from repro_torch.core.tcu import stream_length
from repro_torch.errors import ConfigError

__all__ = ["SC_ATTN_BITS_MIN", "SC_ATTN_BITS_MAX", "sc_attention_bits_ok",
           "check_sc_bits", "QuantRows", "sc_quant_rows", "sc_popcount",
           "sc_scores", "sc_pv"]


def check_sc_bits(bits: int | None) -> None:
    """Raise :class:`ConfigError` unless ``bits`` is None or in 2..8."""
    if not sc_attention_bits_ok(bits):
        raise ConfigError(f"SC attention takes {SC_ATTN_BITS_MIN}..."
                          f"{SC_ATTN_BITS_MAX}-bit operands, got {bits}")


class QuantRows(NamedTuple):
    sign: torch.Tensor     # int32 in {+1, -1}
    mag: torch.Tensor      # int32 in [0, 2**bits)
    scale: torch.Tensor    # float32, last axis kept as size 1


def sc_quant_rows(v: torch.Tensor, bits: int) -> QuantRows:
    """Per-row (last axis) abs-max sign-magnitude quantization."""
    v = v.to(torch.float32)
    n_max = stream_length(bits) - 1
    absmax = v.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one ulp off the true quotient. It is
    # filled on the divisor's device: a tensor copied from the host would
    # make the host wait for the device
    scale = absmax.clamp_min(1e-12) / absmax.new_full((), float(n_max))
    mag = torch.clamp(torch.round(v.abs() / scale), 0, n_max).to(torch.int32)
    sign = torch.where(v < 0, -1, 1).to(torch.int32)
    return QuantRows(sign=sign, mag=mag, scale=scale)


def sc_popcount(x: torch.Tensor, y: torch.Tensor, bits: int) -> torch.Tensor:
    """``popcount(X_u AND Y_u)`` of the proposed multiplier, closed form:
    ``msb·⌊x/2⌋ + max(min(y_low, ⌊(x − msb)/2⌋), 0)``. ``x`` is the Q or
    probability magnitude, ``y`` the K or V magnitude (``O`` is not
    symmetric)."""
    half = stream_length(bits) // 2
    x = x.to(torch.int32)
    y = y.to(torch.int32)
    msb = (y >= half).to(torch.int32)
    y_low = y - msb * half
    tail = torch.clamp(torch.minimum(
        y_low, torch.div(x - msb, 2, rounding_mode="floor")), min=0)
    return msb * torch.div(x, 2, rounding_mode="floor") + tail


def sc_scores(q: torch.Tensor, k: torch.Tensor, *, bits: int) -> torch.Tensor:
    """SC QKᵀ: ``q (..., Q, D)`` × ``k (..., K, D)`` → float32 ``(..., Q, K)``.
    Leading dims broadcast. The caller applies the attention scale and the
    mask to the float32 result, as on the float path."""
    qq = sc_quant_rows(q, bits)
    qk = sc_quant_rows(k, bits)
    o = sc_popcount(qq.mag[..., :, None, :], qk.mag[..., None, :, :], bits)
    sgn = qq.sign[..., :, None, :] * qk.sign[..., None, :, :]
    counts = (sgn * o).sum(dim=-1, dtype=torch.int32)          # (..., Q, K)
    return counts.to(torch.float32) * (
        stream_length(bits) * qq.scale * qk.scale.transpose(-1, -2))


def sc_pv(p: torch.Tensor, v: torch.Tensor, *, bits: int) -> torch.Tensor:
    """SC PV: probabilities ``p (..., K)`` × values ``v (..., K, D)`` →
    float32 ``(..., D)``. The V scales are per key, so the dequantization
    stays elementwise and the float32 sum runs over the key axis — a
    :func:`tree_sum`, to which a masked key's exact ``0.0`` term is a
    no-op."""
    from repro_torch.models.layers import tree_sum
    qp = sc_quant_rows(p, bits)                                 # over K
    qv = sc_quant_rows(v, bits)                                 # over D
    o = sc_popcount(qp.mag[..., :, None], qv.mag, bits)         # (..., K, D)
    sgn = qp.sign[..., :, None] * qv.sign
    term = (sgn * o).to(torch.float32) * qv.scale               # (..., K, D)
    return tree_sum(term, -2) * (stream_length(bits) * qp.scale)
