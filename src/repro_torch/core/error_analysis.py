"""Error analysis for stochastic multipliers (port of
``repro/core/error_analysis.py``) — the MAE column of the paper's Table II,
Fig. 1(b) (absolute error vs normalized operand difference) and the
exact-vs-SC attention divergence of the serving bench's error columns.

The exhaustive grid is built on the caller's device, so on the card the
card runs the sweep; the error is float32, as in the JAX package, and
Fig. 1(b)'s binning runs in numpy on the host, with the JAX package's
bins. ``device=None`` means the card (:func:`repro_torch.device.resolve_device`).
"""
from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

from .multipliers import MULTIPLIERS
from .tcu import stream_length

__all__ = ["exhaustive_grid", "mae", "error_vs_operand_difference",
           "table2_mae", "sc_attention_divergence"]


def exhaustive_grid(bits: int, device: str | torch.device | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """All (x, y) operand pairs for B-bit inputs, as two flat int32
    tensors (x major)."""
    dev = resolve_device(device)
    n = stream_length(bits)
    r = torch.arange(n, dtype=torch.int32, device=dev)
    x, y = torch.meshgrid(r, r, indexing="ij")
    return x.reshape(-1), y.reshape(-1)


def _abs_error(fn: Callable, bits: int, device) -> torch.Tensor:
    x, y = exhaustive_grid(bits, device)
    n = stream_length(bits)
    est = fn(x, y, bits)
    # x*y <= (2^B - 1)^2 < 2^24 is exact in float32; N² is a power of two
    prod = x.to(torch.float32) * y
    target = prod / prod.new_full((), float(n * n))
    return torch.abs(est - target)


def _resolve(name_or_fn) -> Callable:
    return MULTIPLIERS[name_or_fn] if isinstance(name_or_fn, str) \
        else name_or_fn


def mae(name_or_fn, bits: int = 8, *,
        device: str | torch.device | None = None) -> float:
    """Mean absolute error of a multiplier over the exhaustive B-bit grid."""
    return float(_abs_error(_resolve(name_or_fn), bits, device).mean())


def table2_mae(bits: int = 8,
               multipliers: Mapping[str, Callable] | None = None, *,
               device: str | torch.device | None = None) -> dict[str, float]:
    """MAE for every multiplier — the accuracy column of the paper's
    Table II."""
    multipliers = multipliers or MULTIPLIERS
    return {name: mae(fn, bits, device=device)
            for name, fn in multipliers.items()}


def _attention_draws(*, b: int, kv: int, g: int, s: int, d: int,
                     seed: int) -> tuple[torch.Tensor, ...]:
    """``q (b, kv·g, s, d)``, ``k, v (b, kv, s, d)``: float32 normal draws
    from a CPU ``torch.Generator`` seeded by ``seed``, so every device sees
    the same problem."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, dtype=torch.float32)
                 for shape in ((b, kv * g, s, d), (b, kv, s, d),
                               (b, kv, s, d)))


def sc_attention_divergence(bits: int, *, b: int = 2, kv: int = 2,
                            g: int = 2, s: int = 64, d: int = 32,
                            seed: int = 0,
                            device: str | torch.device | None = None
                            ) -> dict[str, float]:
    """Exact-vs-SC attention divergence on a seeded synthetic problem.

    Runs the same ``(B, H, S, D)`` causal attention once through the exact
    float32 oracle and once through the SC score path at ``bits`` operand
    width, and reports the mean absolute divergence of the outputs and the
    mean absolute error of the raw (pre-softmax, unit-scale) scores — the
    serving bench's per-bits error columns. The draws are the port's own
    (:func:`_attention_draws`; the reference's come from ``jax.random``);
    the oracles run on ``device``.
    """
    from repro_torch.kernels import ref   # lazy: kernels import core

    dev = resolve_device(device)
    q, k, v = (t.to(dev) for t in _attention_draws(b=b, kv=kv, g=g, s=s,
                                                   d=d, seed=seed))
    exact = ref.flash_attention_ref(q, k, v, causal=True)
    sc = ref.sc_flash_attention_ref(q, k, v, bits=bits, causal=True)
    kr = torch.repeat_interleave(k, g, dim=1)
    scores_exact = torch.einsum("bhqd,bhkd->bhqk", q, kr)
    scores_sc = ref.sc_attention_scores_ref(q, kr, bits=bits)
    return {
        "bits": bits,
        "output_mad": float(torch.mean(torch.abs(exact - sc))),
        "score_mad": float(torch.mean(torch.abs(scores_exact - scores_sc))),
    }


def error_vs_operand_difference(name_or_fn, bits: int = 8,
                                n_bins: int = 16, *,
                                device: str | torch.device | None = None
                                ) -> dict[str, np.ndarray]:
    """Fig. 1(b): distribution of absolute error binned by ``|x - y| / N``.

    Returns bin centers, per-bin mean/max absolute error, and per-bin count.
    The paper's claim: the proposed multiplier's error is less dependent on
    the normalized operand difference than the baselines'.
    """
    fn = _resolve(name_or_fn)
    n = stream_length(bits)
    x, y = exhaustive_grid(bits, device)
    err = _abs_error(fn, bits, device).cpu().numpy()
    diff = np.abs(x.cpu().numpy() - y.cpu().numpy()) / n
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(diff, edges) - 1, 0, n_bins - 1)
    mean_err = np.zeros(n_bins)
    max_err = np.zeros(n_bins)
    count = np.zeros(n_bins, dtype=np.int64)
    for b in range(n_bins):
        mask = idx == b
        count[b] = mask.sum()
        if count[b]:
            mean_err[b] = err[mask].mean()
            max_err[b] = err[mask].max()
    return {
        "bin_centers": (edges[:-1] + edges[1:]) / 2,
        "mean_abs_error": mean_err,
        "max_abs_error": max_err,
        "count": count,
    }
