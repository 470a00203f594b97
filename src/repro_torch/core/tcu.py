"""Stream lengths of the paper's multiplier (the port's subset of
``repro/core/tcu.py``: the bit-level TCU/correlation encoders come with the
bit-parallel stream kernel in a later slice)."""
from __future__ import annotations

__all__ = ["stream_length"]


def stream_length(bits: int) -> int:
    """N = 2**B, the stochastic-bitstream length for B-bit operands."""
    if bits < 1:
        raise ValueError(f"operand width must be >= 1, got {bits}")
    return 1 << bits
