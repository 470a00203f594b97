"""The bit-parallel stream multiplier (port of ``repro/kernels/sc_bitops.py``).

Replaces the Pallas TPU kernel ``sc_stream_mul_pallas``
(``repro/kernels/sc_bitops.py:84``) with the CUDA kernel in
``csrc/sc_bitops.cu``: for each element, the thermometer stream of ``x``
ANDed with the correlation-encoded stream of ``y`` one 32-bit word at a
time, popcounted and summed — the paper's literal datapath, which proves
on the device that the closed form (``core/multipliers.py``) is
bit-exact. Operands are int32 magnitudes in ``[0, 2**bits)`` with
``bits >= 5`` (a stream fills whole words); counts are int32.

:func:`sc_stream_mul_cuda` is the kernel's wrapper: it launches the kernel
for tensors on the card and takes the plain PyTorch version
:func:`sc_stream_mul_torch` for tensors on the CPU — never on a failure.
``sc_stream_mul_cuda.launches`` counts kernel launches. The public entry,
which takes any shape, is ``kernels/ops.py::sc_stream_mul``.

The plain version mirrors the TPU kernel's helpers (``sc_bitops.py:25-67``):
:func:`thermo_word` and :func:`correlation_word` build word ``w`` of each
stream, the latter with the JAX package's 32-step bit loop (the CUDA
kernel reads the thermometer word from a ROM of the 33 distinct words and
builds the correlation word with a funnel shift of a per-element pattern;
``tests/test_torch_stream.py`` mirrors that construction on the CPU).
Words are int64 tensors holding the unsigned 32-bit value
(``core/tcu.py``). It loops over the ``2**bits / 32`` words and keeps one
word per element at a time, never the N-wide unpacked stream, so it
scales to every pair at B = 12 on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tcu import popcount_u32, stream_length
from repro_torch.errors import ConfigError

from . import build

__all__ = ["sc_stream_mul_cuda", "sc_stream_mul_torch", "thermo_word",
           "correlation_word", "MAX_BLOCK_ROWS"]

#: Rows of 128 elements one CUDA block takes (32 threads a row, 4 elements
#: a thread), as the TPU kernel's (block_rows, 128) tiles.
MAX_BLOCK_ROWS = 8
#: Widest operand: 2**30 still indexes in int32, and a count fits int32.
MAX_BITS = 30
#: The kernel loads and stores 16 bytes a thread: the operands' alignment.
ALIGN = 16

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: Argument types of the C entry ``sc_stream_mul``: x, y, out, n, bits,
#: block_rows and the stream.
ARGTYPES = [_PTR] * 3 + [_I64, _I32, _I32, _PTR]
_ENTRIES: dict = {}


def _entry():
    """The C entry point, its argument types set once."""
    if not _ENTRIES:
        fn = build.load("sc_bitops").sc_stream_mul
        fn.argtypes = ARGTYPES
        fn.restype = _I32
        _ENTRIES["sc_stream_mul"] = fn
    return _ENTRIES["sc_stream_mul"]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address: a view that starts
    elsewhere in its storage (``x[1:]``) is copied to a fresh buffer."""
    t = t.contiguous()
    return t if t.data_ptr() % ALIGN == 0 else t.clone()


def thermo_word(x: torch.Tensor, w: int) -> torch.Tensor:
    """Word ``w`` (bits j = 0..31 ~ positions 32w+1 .. 32w+32) of the
    thermometer stream of ``x``: ones at positions ``i <= x``."""
    rem = torch.clamp(x.to(torch.int64) - 32 * w, 0, 32)
    # int64: (1 << 32) - 1 is the full word, with no shift by the width
    return (torch.ones_like(rem) << rem) - 1


def correlation_word(y: torch.Tensor, w: int, bits: int) -> torch.Tensor:
    """Word ``w`` of the correlation-encoded stream Y_u::

        position 2k   -> msb | (k <= y_low)
        position 2k-1 -> msb & (k >= 2) & (k <= y_low + 1)
    """
    half = stream_length(bits) // 2
    y = y.to(torch.int64)
    msb = (y >= half).to(torch.int64)
    y_low = y - msb * half
    word = torch.zeros_like(y)
    for j in range(32):
        pos = 32 * w + (j + 1)           # 1-based; parity of pos == of j+1
        if (j + 1) % 2 == 0:
            k = pos // 2
            bit = msb | (k <= y_low).to(torch.int64)
        else:
            k = (pos + 1) // 2
            bit = msb * ((y_low + 1 >= k) & (k >= 2)).to(torch.int64)
        word = word | (bit << j)
    return word


def sc_stream_mul_torch(x: torch.Tensor, y: torch.Tensor, *,
                        bits: int) -> torch.Tensor:
    """Plain version: Σ_w popcount(thermo_word(x, w) & correlation_word(y,
    w)) as int32, elementwise."""
    acc = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for w in range(stream_length(bits) // 32):
        acc += popcount_u32(thermo_word(x, w) & correlation_word(y, w, bits))
    return acc


def sc_stream_mul_cuda(x: torch.Tensor, y: torch.Tensor, *, bits: int,
                       block_rows: int = MAX_BLOCK_ROWS) -> torch.Tensor:
    """Stream-multiplier counts of same-shape int32 operands: the CUDA
    kernel for CUDA tensors (``block_rows`` rows of 128 elements per
    block), the plain version for CPU tensors. The result does not depend
    on ``block_rows``."""
    if not 5 <= bits <= MAX_BITS:
        raise ConfigError(f"the bit-parallel stream kernel needs 5 <= bits <= "
                          f"{MAX_BITS} (streams of whole 32-bit words), got "
                          f"{bits}")
    if not 1 <= block_rows <= MAX_BLOCK_ROWS:
        raise ConfigError(f"block_rows must be 1..{MAX_BLOCK_ROWS} (rows of "
                          f"128 elements a block), got {block_rows}")
    if x.shape != y.shape:
        raise ConfigError(f"stream operands must have one shape, got "
                          f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.numel() == 0:      # nothing to launch
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return sc_stream_mul_torch(x, y, bits=bits)
    if not (x.is_cuda and y.is_cuda and x.device == y.device):
        raise ConfigError(f"stream operands on {x.device} and {y.device}: "
                          f"both must be on one CUDA device or on the CPU")
    if x.dtype != torch.int32 or y.dtype != torch.int32:
        raise ConfigError(f"stream operands must be int32, got {x.dtype} and "
                          f"{y.dtype}")
    x, y = _aligned(x), _aligned(y)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _entry()(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
                  bits, block_rows, stream)
    build.check(rc, "sc_stream_mul")
    sc_stream_mul_cuda.launches += 1
    return out


sc_stream_mul_cuda.launches = 0
