"""The paper's bit-parallel deterministic stochastic multiplier and the three
baselines (port of ``repro/core/multipliers.py``).

Every multiplier maps integer operands ``x, y`` in ``[0, 2**bits)`` to an
estimate of the unipolar product ``(x/N)·(y/N)`` where ``N = 2**bits``. Two
evaluation paths exist for the proposed design:

* :func:`proposed_closed_form` — exact integer closed form (3 ALU ops), the
  form SC-GEMM and SC attention compute;
* :func:`proposed_bitlevel` — materializes the N-bit streams through the
  B-to-TCU decoder and the correlation encoder, ANDs them, popcounts: the
  RTL-faithful oracle. The bit-parallel stream kernel
  (``kernels/sc_bitops.py``) computes the same on packed words.

Baselines:

* :func:`gaines` — classic LFSR-SNG stochastic multiplier [Gaines 1969].
  ``shared_sng=True`` (one LFSR driving both comparators) degenerates to
  ``min(x,y)``; independent LFSRs give the low-error variant.
* :func:`jenson` — deterministic SC [Jenson & Riedel, ICCAD 2016]: operand
  A's unary stream repeated, operand B clock-divided; exact after N²
  cycles. ``operand_bits`` models a truncated cycle budget.
* :func:`umul` — uGEMM's unary multiplier [Wu et al., ISCA 2020]:
  rate-coded stream (bit-reversal low-discrepancy SNG) AND temporal-coded
  stream.

Counts are int32 on the operands' device; the eval functions of
:data:`MULTIPLIERS` return float32 estimates.
"""
from __future__ import annotations

import torch

from .tcu import correlation_encode, stream_length, tcu_decode

__all__ = [
    "proposed_closed_form",
    "proposed_bitlevel",
    "gaines",
    "gaines_period",
    "jenson",
    "jenson_cycles",
    "umul",
    "MULTIPLIERS",
]


# ---------------------------------------------------------------------------
# Proposed multiplier
# ---------------------------------------------------------------------------

def proposed_closed_form(x: torch.Tensor, y: torch.Tensor, *,
                         bits: int) -> torch.Tensor:
    """popcount(X_u AND Y_u) of the proposed multiplier, in closed form:
    ``O(x, y) = msb·⌊x/2⌋ + clamp(min(y_low, ⌊(x − msb)/2⌋), 0)`` with
    ``msb = y ≥ N/2`` and ``y_low = y mod N/2``.

    Returns the integer popcount; the product estimate is ``O / N``.
    """
    half = stream_length(bits) // 2
    x = x.to(torch.int32)
    y = y.to(torch.int32)
    msb = (y >= half).to(torch.int32)
    y_low = y - msb * half
    # floor division: x - msb can be -1, where floor gives -1 (the clamp
    # zeroes it either way)
    return msb * torch.div(x, 2, rounding_mode="floor") + torch.clamp(
        torch.minimum(y_low, torch.div(x - msb, 2, rounding_mode="floor")),
        min=0)


def proposed_bitlevel(x: torch.Tensor, y: torch.Tensor, *,
                      bits: int) -> torch.Tensor:
    """Bit-level oracle: B-to-TCU -> correlation encoder -> AND array ->
    popcount."""
    x_u = tcu_decode(x, bits=bits, dtype=torch.int32)
    y_u = correlation_encode(y, bits=bits, dtype=torch.int32)
    return (x_u & y_u).sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Gaines (1969): LFSR stochastic number generators + AND
# ---------------------------------------------------------------------------

# maximal-length taps per width (x^8+x^6+x^5+x^4+1 for 8-bit, etc.)
_GAINES_TAPS = {3: 0b110, 4: 0b1100, 5: 0b10100, 6: 0b110000,
                7: 0b1100000, 8: 0b10111000}


def _lfsr_sequence(bits: int, seed: int, taps: int) -> list[int]:
    """Fibonacci LFSR state sequence of period 2**bits - 1 (never hits 0):
    the ``n - 1`` states from ``seed`` on. ``bits`` and the seed are static,
    so this is a plain loop on the host."""
    n = stream_length(bits)
    states = []
    state = seed
    for _ in range(n - 1):
        states.append(state)
        fb = state & taps
        feedback = 0
        for _ in range(bits):      # parity of the tapped bits
            feedback ^= fb & 1
            fb >>= 1
        state = ((state << 1) | feedback) & (n - 1)
    return states


def gaines(x: torch.Tensor, y: torch.Tensor, *, bits: int,
           shared_sng: bool = True, seed_x: int = 1,
           seed_y: int = 0x5A) -> torch.Tensor:
    """Gaines stochastic multiplier. Returns popcount over the LFSR period.

    Product estimate is ``count / (N - 1)`` (maximal LFSR period is N−1).
    With ``shared_sng=True`` both comparators share one LFSR — the standard
    area-saving configuration, which maximally correlates the streams and
    degrades AND-multiplication toward ``min(x, y)``.

    Seeds are LFSR start states and must lie in ``[1, 2**bits)`` (state 0 is
    the lock-up state; values ≥ N alias modulo the register width and
    corrupt the first stream bit). ``seed_y`` is only consulted — and
    therefore only validated — when ``shared_sng=False``. Unsupported widths
    raise rather than silently running a non-maximal polynomial.
    """
    if bits not in _GAINES_TAPS:
        raise ValueError(
            f"gaines: no maximal-length LFSR taps for bits={bits}; "
            f"supported widths are {sorted(_GAINES_TAPS)}")
    taps = _GAINES_TAPS[bits]
    n = stream_length(bits)

    def _check_seed(name: str, seed: int) -> None:
        if not 1 <= seed < n:
            raise ValueError(
                f"gaines: {name}={seed:#x} outside the {bits}-bit LFSR state "
                f"space [1, {n}); 0 is the lock-up state and values >= {n} "
                f"alias modulo the register width")

    _check_seed("seed_x", seed_x)
    if not shared_sng:
        _check_seed("seed_y", seed_y)
    r_x = torch.tensor(_lfsr_sequence(bits, seed_x, taps), dtype=torch.int32,
                       device=x.device)
    r_y = r_x if shared_sng else torch.tensor(
        _lfsr_sequence(bits, seed_y, taps), dtype=torch.int32,
        device=x.device)

    x = x.to(torch.int32)[..., None]
    y = y.to(torch.int32)[..., None]
    sb_x = (r_x <= x) & (r_x > 0)   # exactly x ones over the period
    sb_y = (r_y <= y) & (r_y > 0)
    return (sb_x & sb_y).sum(dim=-1, dtype=torch.int32)


def gaines_period(bits: int) -> int:
    return stream_length(bits) - 1


# ---------------------------------------------------------------------------
# Jenson & Riedel (ICCAD 2016): deterministic SC, exact after N^2 cycles
# ---------------------------------------------------------------------------

def jenson(x: torch.Tensor, y: torch.Tensor, *, bits: int,
           operand_bits: int | None = None) -> torch.Tensor:
    """Deterministic SC multiplier: repeat-A x clock-divide-B.

    Cycle ``c`` (0-indexed, ``c < N'^2``) computes
    ``A_u[c mod N'] AND B_u[c div N']`` with both streams
    thermometer-coded. The count over the full N'² cycles is exactly
    ``x'·y'``. ``operand_bits`` < ``bits`` models running the design under
    a truncated cycle budget (operands rounded to fewer bits,
    N' = 2**operand_bits).

    Returns the integer count; the product estimate is ``count / N'²``.
    """
    ob = bits if operand_bits is None else operand_bits
    shift = bits - ob
    if shift < 0:
        raise ValueError("operand_bits must be <= bits")
    x = x.to(torch.int32) >> shift
    y = y.to(torch.int32) >> shift
    # count over N'^2 cycles of (c mod N' < x) & (c div N' < y) == x*y exactly
    return x * y


def jenson_cycles(bits: int, operand_bits: int | None = None) -> int:
    ob = bits if operand_bits is None else operand_bits
    return stream_length(ob) ** 2


# ---------------------------------------------------------------------------
# uMUL (uGEMM, ISCA 2020): rate-coded (low-discrepancy SNG) x temporal-coded
# ---------------------------------------------------------------------------

def _bit_reverse(values: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(values)
    for i in range(bits):
        out = out | (((values >> i) & 1) << (bits - 1 - i))
    return out


def umul(x: torch.Tensor, y: torch.Tensor, *, bits: int,
         variant: str = "rate_temporal") -> torch.Tensor:
    """uGEMM's unary multiplier over N = 2**bits cycles. Returns the
    popcount.

    Variants:

    * ``"rate_temporal"`` — X rate-coded by a bit-reversal (van der Corput)
      comparator SNG, Y temporal-coded (thermometer). uGEMM's mixed-format
      multiplier.
    * ``"rate_rate_shared"`` — both operands rate-coded off one shared SNG
      (fully correlated; degenerates toward min).
    * ``"rate_rate_indep"`` — X rate-coded (bit-reversal), Y rate-coded off
      the raw counter, rotated by ``N // 3``.
    """
    n = stream_length(bits)
    c = torch.arange(n, dtype=torch.int32, device=x.device)
    vdc = _bit_reverse(c, bits)      # low-discrepancy permutation of 0..N-1
    x = x.to(torch.int32)[..., None]
    y = y.to(torch.int32)[..., None]
    if variant == "rate_temporal":
        sb_x = vdc < x
        sb_y = c < y
    elif variant == "rate_rate_shared":
        sb_x = vdc < x
        sb_y = vdc < y
    elif variant == "rate_rate_indep":
        sb_x = vdc < x
        sb_y = torch.roll(c < y, n // 3, dims=-1)
    else:
        raise ValueError(f"unknown uMUL variant {variant!r}")
    return (sb_x & sb_y).sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Uniform evaluation API: name -> callable(x, y, bits) -> float32 estimate
# ---------------------------------------------------------------------------

def _ratio(counts: torch.Tensor, denominator: float) -> torch.Tensor:
    """``counts / denominator`` in float32, divided exactly: the divisor is a
    tensor, since PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal (one ulp off the quotient for N − 1). It is filled on
    the counts' device, never copied from the host (a synchronizing copy)."""
    c = counts.to(torch.float32)
    return c / c.new_full((), float(denominator))


def _proposed_eval(x, y, bits):
    return _ratio(proposed_closed_form(x, y, bits=bits), stream_length(bits))


def _gaines_eval(x, y, bits):
    return _ratio(gaines(x, y, bits=bits), gaines_period(bits))


def _jenson_eval(x, y, bits, operand_bits=None):
    return _ratio(jenson(x, y, bits=bits, operand_bits=operand_bits),
                  jenson_cycles(bits, operand_bits))


def _umul_eval(x, y, bits):
    return _ratio(umul(x, y, bits=bits), stream_length(bits))


#: name -> callable(x, y, bits) returning the unipolar product estimate in
#: [0, 1] as float32.
MULTIPLIERS = {
    "proposed": _proposed_eval,
    "gaines": _gaines_eval,
    "jenson": _jenson_eval,
    "umul": _umul_eval,
}
