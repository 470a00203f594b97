"""Public wrappers around the port's kernels: SC-GEMM of two float operands
(port of ``repro/kernels/ops.py::sc_matmul_pallas``), the bit-parallel stream
multiplier over any shape (port of ``sc_stream_mul``), and the attention
kernels at their tuned launch plans (ports of ``flash_attention_tuned`` and
``paged_decode_attention_tuned``).

The TPU wrappers padded every operand to its block multiples (signs with
+1, magnitudes with 0) because Pallas blocks must tile the array. The CUDA
kernels mask their ragged edges themselves, so nothing is padded here and
nothing is sliced off afterwards. ``tune=True`` and the ``*_tuned`` entries
take their launch plan from the autotuner (``kernels/autotune.py``), which
sweeps the shape on its first call and serves the cached winner after.
"""
from __future__ import annotations

import torch

from repro_torch.core.sc_numerics import quantize_sign_magnitude
from repro_torch.core.tcu import stream_length
from repro_torch.errors import ConfigError

from . import autotune
from .flash_attention import flash_attention
from .paged_attention import paged_attention
from .sc_bitops import sc_stream_mul_cuda
from .sc_matmul import (pack_signed, pack_weight, sc_linear,
                        sc_matmul_counts_signed)

__all__ = ["sc_matmul", "sc_stream_mul", "flash_attention_tuned",
           "paged_decode_attention_tuned", "launch_counters"]


def launch_counters() -> dict:
    """The launch counters of the kernel wrappers (``.launches``), by
    name: a replayed graph launches their kernels without calling them,
    so a step's ``replay`` adds what its capture recorded. The attention
    wrappers count all their launches and, under ``*_sc``, their SC
    path's alone; ``paged_attention_softcap`` counts the paged kernel's
    launches with a logit softcap, and ``paged_attention_sc_softcap``
    their SC path's alone."""
    return {"sc_linear": sc_linear,
            "sc_matmul_counts": sc_matmul_counts_signed,
            "paged_attention": paged_attention,
            "paged_attention_sc": paged_attention.sc,
            "paged_attention_softcap": paged_attention.softcap,
            "paged_attention_sc_softcap": paged_attention.sc.softcap,
            "flash_attention": flash_attention,
            "flash_attention_sc": flash_attention.sc,
            "sc_stream_mul": sc_stream_mul_cuda}


def sc_matmul(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8,
              row_quant: bool = False, tune: bool = False) -> torch.Tensor:
    """SC-GEMM ``a @ b`` through the SC-GEMM kernel. ``a: (M, K)``,
    ``b: (K, N)`` float.

    With ``row_quant`` (per-row LHS scales, as every model projection
    runs) ``b`` is packed for this call and the fused kernel quantizes,
    counts and dequantizes in one launch; otherwise the per-tensor LHS is
    quantized and packed here, counted, and dequantized by ``N·Δa·Δb``.
    Tensors on the card launch the CUDA kernel; tensors on the CPU take its
    plain version. ``tune=True`` launches at the autotuner's plan for the
    shape (:func:`autotune.get_or_tune`), else at ``sc_matmul.plan``'s; the
    bits are the same. A weight that does not change is packed once
    instead (``sc_matmul.pack_weight`` and ``sc_linear``).
    """
    if row_quant:
        a, pw = a.to(torch.float32), pack_weight(b, bits)
        config = autotune.get_or_tune(a, pw) if tune else None
        return sc_linear(a, pw, config=config)
    qa = quantize_sign_magnitude(a.to(torch.float32), bits=bits)
    qb = quantize_sign_magnitude(b.to(torch.float32), bits=bits)
    pa = pack_signed(qa.sign, qa.mag, bits)
    pb = pack_signed(qb.sign, qb.mag, bits)
    config = autotune.get_or_tune(pa, pb, bits=bits) if tune else None
    counts = sc_matmul_counts_signed(pa, pb, bits=bits, config=config)
    return counts * (stream_length(bits) * qa.scale * qb.scale)


def sc_stream_mul(x: torch.Tensor, y: torch.Tensor, *, bits: int = 8,
                  block_rows: int = 8, tune: bool = False) -> torch.Tensor:
    """Elementwise bit-parallel stochastic multiply of same-shape integer
    magnitudes in ``[0, 2**bits)``: int32 counts ``O(x, y)`` in the input's
    shape, through the stream kernel on the card and its plain version on
    the CPU.

    ``block_rows`` is the rows of 128 elements one CUDA block processes
    (1..8); ``tune=True`` takes it from the autotuner for the operands'
    size instead (:func:`autotune.get_or_tune_stream`). The result does not
    depend on it.
    """
    if x.shape != y.shape:
        raise ConfigError(f"stream operands must have one shape, got "
                          f"{tuple(x.shape)} and {tuple(y.shape)}")
    fx, fy = x.reshape(-1).to(torch.int32), y.reshape(-1).to(torch.int32)
    if tune and fx.numel():
        block_rows = autotune.get_or_tune_stream(fx, fy,
                                                 bits=bits).block_rows
    # the wrapper returns an empty operand's empty result directly
    out = sc_stream_mul_cuda(fx, fy, bits=bits, block_rows=block_rows)
    return out.reshape(x.shape)


def flash_attention_tuned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int | torch.Tensor = 0, group: int = 64,
                          sc_bits: int | None = None) -> torch.Tensor:
    """The flash kernel in its layout ``q (B, H, Sq, D)``, ``k, v (B, KV,
    Skv, D)``, with the heads and m-tiles a block from the autotuner
    (:func:`autotune.get_or_tune_flash`; keyed by the launch's m-tile count,
    so an offset held on the card is never read). ``group`` (the SC
    quantization group, which the result depends on) comes from the
    caller, never from a tuner."""
    config = autotune.get_or_tune_flash(q, k, v, causal=causal,
                                        q_offset=q_offset, group=group,
                                        sc_bits=sc_bits)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                           group=group, sc_bits=sc_bits, config=config)


def paged_decode_attention_tuned(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, tables: torch.Tensor,
                                 q_positions: torch.Tensor, *,
                                 window: int | None = None,
                                 logit_softcap: float | None = None,
                                 sc_bits: int | None = None) -> torch.Tensor:
    """The paged decode kernel in its layout ``q (C, KV, G, D)``, pages
    ``(P, block, KV, D)``, ``tables (C, MB)``, its plan looked up through
    the autotuner (:func:`autotune.get_or_tune_paged`, a one-point grid).
    The model layer checks eligibility and owns the gathered fallback."""
    autotune.get_or_tune_paged(q, k_pages, v_pages, tables, q_positions,
                               window=window, sc_bits=sc_bits)
    return paged_attention(q, k_pages, v_pages, tables, q_positions,
                           window=window, logit_softcap=logit_softcap,
                           sc_bits=sc_bits)
