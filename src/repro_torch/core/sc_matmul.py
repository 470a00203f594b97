"""SC-GEMM: matrix multiplication with the paper's stochastic multiplier as
the scalar-product numeric (port of ``repro/core/sc_matmul.py``).

Each scalar product inside the GEMM is
``a·b ≈ s_a s_b · (O(x, y) / N) · (N² Δ_a Δ_b)`` where ``O`` is the proposed
multiplier's closed form and ``x, y`` are B-bit magnitudes. Accumulation
across K is exact integer addition.

Implementations, all count-identical:

* :func:`sc_matmul_reference` — K-blocked broadcast of the closed form,
  plain PyTorch. The oracle.
* :func:`sc_matmul_mxu_split` — the split

      O(x, y) = msb_y · ⌊x/2⌋ + clamp(min(y_low, ⌊(x − msb_y)/2⌋), 0)

  whose first term is a true matmul ``(s_x·⌊x/2⌋) @ (s_y·msb_y)`` (exact in
  float32 while counts stay below 2²⁴) and whose residual is a K-chunked
  elementwise sum. Plain PyTorch, as the JAX package computes it outside
  Pallas.
* ``"pallas"``/``"pallas_tuned"`` — :func:`repro_torch.kernels.ops.sc_matmul`,
  which launches the hand-written CUDA kernel for tensors on the card and
  takes the kernel's plain version for tensors on the CPU: ``"pallas"`` at
  ``kernels.sc_matmul.plan``'s launch plan, ``"pallas_tuned"`` at the
  autotuner's for the shape (``kernels/autotune.py``; on the CPU it still
  keys and times the plain version). The names are kept so a config means
  the same thing in both packages.
"""
from __future__ import annotations

import os

import torch

from .sc_numerics import quantize_sign_magnitude
from .tcu import stream_length

__all__ = [
    "sc_matmul_reference",
    "sc_matmul_mxu_split",
    "sc_matmul",
    "sc_residual_term",
    "signed_counts",
    "resolve_impl",
    "SC_IMPLS",
    "IMPL_ENV",
]

#: Accepted ``impl`` names ("ref" and "reference" are synonyms).
SC_IMPLS = ("auto", "ref", "reference", "mxu_split", "pallas", "pallas_tuned")

#: Environment override consulted by :func:`resolve_impl` when the config
#: leaves the choice open (``"auto"``/None).
IMPL_ENV = "REPRO_SC_IMPL"

#: Elements of the (M, k, N) int32 broadcast the chunked closed forms may
#: materialise at once.
_BROADCAST_BUDGET = 1 << 24


def signed_counts(sx, mx, sy, my, bits: int) -> torch.Tensor:
    """Σ_k s_x s_y O(x, y) as int32 ``(M, N)``, walking K in chunks sized so
    one ``(M, chunk, N)`` broadcast stays under a fixed budget.

    ``sx, mx: (M, K)``; ``sy, my: (K, N)``; any integer dtypes."""
    half = stream_length(bits) // 2
    m, k = mx.shape
    n = my.shape[1]
    chunk = max(1, min(k, _BROADCAST_BUDGET // max(m * n, 1)))
    out = torch.zeros((m, n), dtype=torch.int32, device=mx.device)
    for k0 in range(0, k, chunk):
        x = mx[:, k0:k0 + chunk, None].to(torch.int32)          # (M, c, 1)
        y = my[None, k0:k0 + chunk, :].to(torch.int32)          # (1, c, N)
        msb = (y >= half).to(torch.int32)
        y_low = y - msb * half
        # floor division: x - msb can be -1, where floor gives -1 (and the
        # clamp below zeroes it); torch's // floors like jnp's
        o = msb * (x // 2) + torch.clamp(torch.minimum(y_low, (x - msb) // 2),
                                         min=0)
        s = (sx[:, k0:k0 + chunk, None].to(torch.int32)
             * sy[None, k0:k0 + chunk, :].to(torch.int32))
        out += (s * o).sum(dim=1, dtype=torch.int32)
    return out


def _quantize_lhs(a: torch.Tensor, bits: int, row_quant: bool):
    """LHS quantization: per-tensor scale, or per-row (``axis=-1``) when
    ``row_quant`` — each output row then depends only on its own input row,
    which makes batched inference batch-composition invariant. Weights stay
    per-tensor; their scale is batch-independent already."""
    return quantize_sign_magnitude(a, bits=bits,
                                   axis=-1 if row_quant else None)


def sc_matmul_reference(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8,
                        row_quant: bool = False) -> torch.Tensor:
    """Oracle SC-GEMM: quantize, multiply every pair via the closed form,
    sum, dequantize."""
    qa = _quantize_lhs(a, bits, row_quant)
    qb = quantize_sign_magnitude(b, bits=bits)
    counts = signed_counts(qa.sign, qa.mag, qb.sign, qb.mag, bits)
    return counts.to(torch.float32) * (stream_length(bits) * qa.scale
                                       * qb.scale)


def sc_residual_term(sx, mx, sy, my, bits: int,
                     chunk: int = 16) -> torch.Tensor:
    """Σ_k s_x s_y · clamp(min(y_low, ⌊(x − msb)/2⌋), 0) — the elementwise
    residual of the split, K walked in chunks of ``chunk`` (int32)."""
    half = stream_length(bits) // 2
    m, k = mx.shape
    n = my.shape[1]
    out = torch.zeros((m, n), dtype=torch.int32, device=mx.device)
    for k0 in range(0, k, chunk):
        x = mx[:, k0:k0 + chunk, None].to(torch.int32)
        ssx = sx[:, k0:k0 + chunk, None].to(torch.int32)
        y = my[None, k0:k0 + chunk, :].to(torch.int32)
        ssy = sy[None, k0:k0 + chunk, :].to(torch.int32)
        msb = (y >= half).to(torch.int32)
        y_low = y - msb * half
        res = torch.clamp(torch.minimum(y_low, (x - msb) // 2), min=0)
        out += (ssx * ssy * res).sum(dim=1, dtype=torch.int32)
    return out


def sc_matmul_mxu_split(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8,
                        chunk: int = 16,
                        row_quant: bool = False) -> torch.Tensor:
    """Matmul term + elementwise residual; count-identical to
    :func:`sc_matmul_reference` for every ``chunk``."""
    half = stream_length(bits) // 2
    qa = _quantize_lhs(a, bits, row_quant)
    qb = quantize_sign_magnitude(b, bits=bits)
    msb = (qb.mag >= half).to(torch.int32)
    # matmul term in float32: integer operands, partial sums < 2**24, so
    # every order of summation is exact (TF32 is off, device.exact_float32)
    lhs = (qa.sign.to(torch.int32) * (qa.mag // 2)).to(torch.float32)
    rhs = (qb.sign.to(torch.int32) * msb).to(torch.float32)
    term1 = lhs @ rhs
    term2 = sc_residual_term(qa.sign, qa.mag, qb.sign, qb.mag, bits, chunk)
    counts = term1 + term2.to(torch.float32)
    return counts * (stream_length(bits) * qa.scale * qb.scale)


def resolve_impl(impl: str | None = None) -> str:
    """Resolve an SC-GEMM implementation request: an explicit config value
    wins; ``"auto"``/None defers to ``$REPRO_SC_IMPL``; absent both, the
    result stays ``"auto"`` and :func:`sc_matmul` picks by device. Unknown
    names fail here."""
    if impl is None:
        impl = "auto"
    if impl not in SC_IMPLS:
        raise ValueError(
            f"unknown SC impl {impl!r}; expected one of {SC_IMPLS}")
    if impl != "auto":
        return impl
    env = os.environ.get(IMPL_ENV)
    if env:
        if env not in SC_IMPLS:
            raise ValueError(
                f"${IMPL_ENV}={env!r} is not a valid SC impl; "
                f"expected one of {SC_IMPLS}")
        return env
    return "auto"


def sc_matmul(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8,
              impl: str = "mxu_split", row_quant: bool = False) -> torch.Tensor:
    """Dispatching entry point. ``a: (M, K)``, ``b: (K, N)`` float32.

    ``"auto"`` resolves through ``autotune.choose_impl``: the kernel at its
    tuned plan (``"pallas_tuned"``) on the card, ``"mxu_split"`` on the CPU
    (the JAX package's off-TPU choice); ``"pallas"``/``"pallas_tuned"``
    take the kernel path on any device (its wrapper runs the plain version
    only for CPU tensors) at the default or the tuned plan; ``"ref"`` and
    ``"mxu_split"`` are always the plain formulations. All are
    count-identical.
    """
    impl = resolve_impl(impl)
    if impl == "auto":
        from repro_torch.kernels.autotune import choose_impl
        impl = choose_impl(a.shape[0], a.shape[1], b.shape[1], bits=bits,
                           device=a.device)
    if impl in ("ref", "reference"):
        return sc_matmul_reference(a, b, bits=bits, row_quant=row_quant)
    if impl == "mxu_split":
        return sc_matmul_mxu_split(a, b, bits=bits, row_quant=row_quant)
    if impl in ("pallas", "pallas_tuned"):
        from repro_torch.kernels.ops import sc_matmul as kernel_sc_matmul
        return kernel_sc_matmul(a, b, bits=bits, row_quant=row_quant,
                                tune=impl == "pallas_tuned")
    raise ValueError(f"unknown impl {impl!r}")
