"""Public wrappers around the port's kernels: SC-GEMM of two float operands
(port of ``repro/kernels/ops.py::sc_matmul_pallas``), the bit-parallel stream
multiplier over any shape (port of ``sc_stream_mul``), and the flash
kernel's entry at fixed tile sizes (port of ``flash_attention_tuned``).

The TPU wrappers padded every operand to its block multiples (signs with
+1, magnitudes with 0) because Pallas blocks must tile the array. The CUDA
kernels mask their ragged edges themselves, so nothing is padded here and
nothing is sliced off afterwards.
"""
from __future__ import annotations

import torch

from repro_torch.core.sc_numerics import quantize_sign_magnitude
from repro_torch.core.tcu import stream_length
from repro_torch.errors import ConfigError

from .flash_attention import flash_attention
from .sc_bitops import sc_stream_mul_cuda
from .sc_matmul import (pack_signed, pack_weight, sc_linear,
                        sc_matmul_counts_signed)

__all__ = ["sc_matmul", "sc_stream_mul", "flash_attention_tuned"]


def sc_matmul(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8,
              row_quant: bool = False) -> torch.Tensor:
    """SC-GEMM ``a @ b`` through the SC-GEMM kernel. ``a: (M, K)``,
    ``b: (K, N)`` float.

    With ``row_quant`` (per-row LHS scales, as every model projection
    runs) ``b`` is packed for this call and the fused kernel quantizes,
    counts and dequantizes in one launch; otherwise the per-tensor LHS is
    quantized and packed here, counted, and dequantized by ``N·Δa·Δb``.
    Tensors on the card launch the CUDA kernel; tensors on the CPU take its
    plain version. A weight that does not change is packed once instead
    (``sc_matmul.pack_weight`` and ``sc_linear``).
    """
    if row_quant:
        return sc_linear(a.to(torch.float32), pack_weight(b, bits))
    qa = quantize_sign_magnitude(a.to(torch.float32), bits=bits)
    qb = quantize_sign_magnitude(b.to(torch.float32), bits=bits)
    counts = sc_matmul_counts_signed(pack_signed(qa.sign, qa.mag, bits),
                                     pack_signed(qb.sign, qb.mag, bits),
                                     bits=bits)
    return counts * (stream_length(bits) * qa.scale * qb.scale)


def sc_stream_mul(x: torch.Tensor, y: torch.Tensor, *, bits: int = 8,
                  block_rows: int = 8, tune: bool = False) -> torch.Tensor:
    """Elementwise bit-parallel stochastic multiply of same-shape integer
    magnitudes in ``[0, 2**bits)``: int32 counts ``O(x, y)`` in the input's
    shape, through the stream kernel on the card and its plain version on
    the CPU.

    ``block_rows`` is the rows of 128 elements one CUDA block processes
    (1..8); the result does not depend on it. ``tune=True`` would pick it
    through the autotuner, which is not ported yet.
    """
    if tune:
        raise ConfigError("sc_stream_mul(tune=True) needs the autotuner, "
                          "which is not ported yet (ROADMAP Queue 1 #13)")
    if x.shape != y.shape:
        raise ConfigError(f"stream operands must have one shape, got "
                          f"{tuple(x.shape)} and {tuple(y.shape)}")
    # the wrapper returns an empty operand's empty result directly
    out = sc_stream_mul_cuda(x.reshape(-1).to(torch.int32),
                             y.reshape(-1).to(torch.int32), bits=bits,
                             block_rows=block_rows)
    return out.reshape(x.shape)


def flash_attention_tuned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int | torch.Tensor = 0, group: int = 64,
                          sc_bits: int | None = None) -> torch.Tensor:
    """The flash kernel in its layout ``q (B, H, Sq, D)``, ``k, v (B, KV,
    Skv, D)``. The JAX package picks ``(bq, bk)`` through its autotuner;
    here the tiles are fixed — m-tiles of ``flash_attention.BLOCK_Q`` = 16
    query positions, ``TILE_K`` keys per shared-memory tile, the heads a
    block serves from ``flash_attention.plan`` — and ``group`` (the SC
    quantization group, which the result depends on) comes from the
    caller, never from a tuner."""
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                           group=group, sc_bits=sc_bits)
