"""Quantization and value-domain mappings for SC-GEMM (port of
``repro/core/sc_numerics.py``).

The paper's multiplier operates on unipolar magnitudes ``x/N ∈ [0, 1)``.
SC-GEMM maps signed reals to ``v ≈ sign(v) · mag · Δ`` with ``mag ∈ [0, N)``
an integer magnitude and ``Δ`` a per-tensor (or per-row) scale. Signs
multiply exactly; magnitudes multiply through the stochastic multiplier.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .tcu import stream_length

__all__ = ["SignMagnitude", "quantize_sign_magnitude", "absmax_scale",
           "quantize_at_scale", "dequantize_sign_magnitude",
           "recover_counts"]


class SignMagnitude(NamedTuple):
    """``sign`` int8 in {+1, -1}; ``mag`` int32 in ``[0, 2**bits - 1]``;
    ``scale`` float32, broadcastable against ``mag``; ``bits`` the width."""
    sign: torch.Tensor
    mag: torch.Tensor
    scale: torch.Tensor
    bits: int


def quantize_sign_magnitude(v: torch.Tensor, *, bits: int,
                            axis: int | tuple | None = None) -> SignMagnitude:
    """Abs-max sign-magnitude quantization to B-bit magnitudes.

    ``axis=None`` → one per-tensor scale; otherwise the scale is reduced
    over ``axis`` (kept as a size-1 dim). The max is exact in any order, so
    per-row scales make each row's planes independent of its neighbours.
    """
    av = v.abs()
    if axis is None:
        absmax = av.amax()
    else:
        absmax = av.amax(dim=axis, keepdim=True)
    return quantize_at_scale(v, absmax_scale(absmax, bits=bits), bits=bits)


def absmax_scale(absmax: torch.Tensor, *, bits: int) -> torch.Tensor:
    """The float32 scale of values whose largest magnitude is ``absmax``:
    ``max(absmax, 1e-12) / (2**bits - 1)``."""
    absmax = absmax.clamp_min(1e-12).to(torch.float32)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one ulp off the true quotient. It is
    # filled on the divisor's device: a tensor copied from the host would
    # make the host wait for the device
    return absmax / absmax.new_full((), float(stream_length(bits) - 1))


def quantize_at_scale(v: torch.Tensor, scale: torch.Tensor, *,
                      bits: int) -> SignMagnitude:
    """Sign-magnitude planes of ``v`` at a given ``scale`` (broadcastable):
    elementwise, so a tensor quantized piece by piece at its whole
    scale gives the bits of :func:`quantize_sign_magnitude`."""
    n_max = stream_length(bits) - 1
    mag = torch.clamp(torch.round(v.abs() / scale), 0, n_max).to(torch.int32)
    sign = torch.where(v < 0, -1, 1).to(torch.int8)
    return SignMagnitude(sign=sign, mag=mag, scale=scale, bits=bits)


def dequantize_sign_magnitude(q: SignMagnitude) -> torch.Tensor:
    return (q.sign.float() * q.mag.float()) * q.scale


def recover_counts(out, a, b, *, bits: int = 8,
                   row_quant: bool = False) -> np.ndarray:
    """De-scale an SC-GEMM float output back to its exact integer counts
    (int64 numpy). The final ``counts · N·Δa·Δb`` multiply may differ by an
    ulp between implementations, so exact comparisons are made on these
    integers — counts stay below 2²⁴, so float64 rounding is exact.
    ``row_quant`` must match the producer's LHS quantization."""
    a = torch.as_tensor(np.asarray(a, np.float32))
    b = torch.as_tensor(np.asarray(b, np.float32))
    qa = quantize_sign_magnitude(a, bits=bits, axis=-1 if row_quant else None)
    qb = quantize_sign_magnitude(b, bits=bits)
    scale = (stream_length(bits) * qa.scale.double().numpy()
             * qb.scale.double().numpy())
    out = out.detach().cpu().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    return np.round(out / scale).astype(np.int64)
