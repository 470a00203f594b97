"""Transition-coded-unary (TCU) decoding and the bit-position correlation
encoder (port of ``repro/core/tcu.py``): the bit-level model of the
paper's multiplier front end.

Streams are represented two ways:

* **unpacked** — integer tensors of shape ``(..., N)`` with stream position
  ``i`` (1-indexed from the trailing end, as in the paper's
  ``[x^N .. x^1]`` notation) stored at index ``i-1``;
* **packed** — words of shape ``(..., N//32)`` (N >= 32), bit ``i`` of the
  stream at bit ``(i-1) % 32`` of word ``(i-1) // 32``. PyTorch's
  ``uint32`` supports few operations (no shifts or sums on the CPU or the
  card), so a packed word is an **int64 tensor holding the unsigned 32-bit
  value**, in ``[0, 2**32)``; ``.numpy().astype(np.uint32)`` gives the JAX
  package's words.

Every function works on the device of its input.
"""
from __future__ import annotations

import torch

__all__ = [
    "stream_length",
    "tcu_decode",
    "correlation_encode",
    "pack_stream",
    "unpack_stream",
    "popcount_u32",
]

_WORD_MASK = 0xFFFFFFFF


def stream_length(bits: int) -> int:
    """N = 2**B, the stochastic-bitstream length for B-bit operands."""
    if bits < 1:
        raise ValueError(f"operand width must be >= 1, got {bits}")
    return 1 << bits


def tcu_decode(x: torch.Tensor, *, bits: int,
               dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """B-to-TCU decoder: integer ``x`` in [0, 2**bits) -> thermometer stream.

    Ones are grouped at the trailing end: position ``i`` is 1 iff ``i <= x``.
    Output shape is ``x.shape + (N,)`` with N = 2**bits.
    """
    n = stream_length(bits)
    pos = torch.arange(1, n + 1, dtype=torch.int32, device=x.device)
    return (pos <= x[..., None].to(torch.int32)).to(dtype)


def correlation_encode(y: torch.Tensor, *, bits: int,
                       dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Bit-position correlation encoder for operand Y (the paper's AND/OR
    array).

    The low B-1 bits of ``y`` are TCU-decoded to a thermometer ``t`` of N/2
    bits; together with the MSB ``y^B`` they form the N-bit stream::

        Y_u[2k]   = y^B OR  t_k          (even positions,  k = 1..N/2)
        Y_u[2k-1] = y^B AND t_{k-1}      (odd positions,   t_0 = 0)

    The result is value-preserving (``popcount(Y_u) == y``) and satisfies
    the deterministic correlation condition P(Y_u|X_u) = P(X_u) against
    thermometer X_u streams.
    """
    n = stream_length(bits)
    half = n // 2
    y = y.to(torch.int32)
    msb = (y >= half).to(torch.int32)
    y_low = torch.where(msb == 1, y - half, y)

    k = torch.arange(1, half + 1, dtype=torch.int32, device=y.device)
    t_k = (k <= y_low[..., None]).to(torch.int32)                 # t_k
    t_km1 = ((k - 1) <= y_low[..., None]).to(torch.int32) * (k > 1)  # t_0 = 0

    even = msb[..., None] | t_k          # position 2k   -> index 2k-1
    odd = msb[..., None] & t_km1         # position 2k-1 -> index 2k-2

    out = torch.stack([odd, even], dim=-1).reshape(*y.shape, n)
    return out.to(dtype)


def pack_stream(stream: torch.Tensor) -> torch.Tensor:
    """Pack an unpacked ``(..., N)`` 0/1 stream into ``(..., N//32)`` words
    (int64 holding the unsigned 32-bit value)."""
    n = stream.shape[-1]
    if n % 32 != 0:
        raise ValueError(f"stream length {n} is not a multiple of 32")
    words = stream.reshape(*stream.shape[:-1], n // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=stream.device) \
        << torch.arange(32, dtype=torch.int64, device=stream.device)
    return (words * weights).sum(dim=-1)


def unpack_stream(packed: torch.Tensor,
                  dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Inverse of :func:`pack_stream` (takes any integer tensor holding the
    words' bit patterns)."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1],
                        packed.shape[-1] * 32).to(dtype)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of the low 32 bits of each lane, as int32.

    Works in int64, so no step overflows: an int32 bit pattern and an int64
    unsigned value of the same word give the same count."""
    x = x.to(torch.int64) & _WORD_MASK
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _WORD_MASK) >> 24).to(torch.int32)
