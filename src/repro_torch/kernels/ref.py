"""Plain-PyTorch oracles for the SC-GEMM kernel (port of
``repro/kernels/ref.py:19-35``): one full ``(M, K, N)`` broadcast of the
closed form, no chunking, no packing — the simplest statement of the
function the kernel and its plain version compute."""
from __future__ import annotations

import torch

from repro_torch.core.sc_numerics import quantize_sign_magnitude
from repro_torch.core.tcu import stream_length

__all__ = ["proposed_closed_form", "sc_matmul_counts_ref", "sc_matmul_ref"]


def proposed_closed_form(x: torch.Tensor, y: torch.Tensor, *,
                         bits: int) -> torch.Tensor:
    """popcount(X_u AND Y_u) of the proposed multiplier:
    ``O(x, y) = msb·⌊x/2⌋ + clamp(min(y_low, ⌊(x − msb)/2⌋), 0)``."""
    half = stream_length(bits) // 2
    x = x.to(torch.int32)
    y = y.to(torch.int32)
    msb = (y >= half).to(torch.int32)
    y_low = y - msb * half
    return msb * torch.div(x, 2, rounding_mode="floor") + torch.clamp(
        torch.minimum(y_low, torch.div(x - msb, 2, rounding_mode="floor")),
        min=0)


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
