"""Error analysis for stochastic multipliers (port of
``repro/core/error_analysis.py``) — the MAE column of the paper's Table II
and Fig. 1(b) (absolute error vs normalized operand difference).

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
           "table2_mae"]


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
