"""Plain-PyTorch oracles for the SC-GEMM and bit-parallel stream kernels
(port of ``repro/kernels/ref.py:19-48``): for SC-GEMM one full
``(M, K, N)`` broadcast of the closed form, no chunking, no packing; for
the stream kernel the unpacked N-bit streams ANDed and popcounted — the
simplest statements of the functions the kernels and their plain versions
compute. ``proposed_closed_form`` lives in ``core/multipliers.py`` and is
re-exported here."""
from __future__ import annotations

import torch

from repro_torch.core.multipliers import proposed_closed_form
from repro_torch.core.sc_numerics import quantize_sign_magnitude
from repro_torch.core.tcu import (correlation_encode, pack_stream,
                                  stream_length, tcu_decode)

__all__ = ["proposed_closed_form", "sc_matmul_counts_ref", "sc_matmul_ref",
           "sc_stream_mul_ref", "sc_stream_words_ref"]


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
