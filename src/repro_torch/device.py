"""Device resolution for the port's entry points.

``device=None`` means the card: every public constructor (``models.bind``,
``transformer.init_params``/``init_kv_cache``, ``serving.Engine``,
``launch.serve.generate``) resolves its device here, so a machine without
CUDA fails at once with a typed :class:`ConfigError` instead of silently
running the plain CPU versions. Tests pass ``device="cpu"``. ``"meta"``
builds shape-only trees (``launch.steps.abstract_params``): tensors with
shapes and dtypes and no storage, which nothing computes on.

Resolution also switches TF32 off for matmuls and cuDNN: the port computes
float32 products in full float32, as the JAX reference does on the CPU.
"""
from __future__ import annotations

import torch

from .errors import ConfigError

__all__ = ["resolve_device", "exact_float32"]


def exact_float32() -> None:
    """Full-precision float32 products (no TF32) for everything the port
    computes — PyTorch leaves cuDNN in TF32 by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; raises :class:`ConfigError` if CUDA was asked
    for (explicitly or by default) and no card is visible. ``meta`` is
    admitted for shape-only trees."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            "no CUDA device is visible: the port runs on the card by "
            "default — pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ConfigError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                          f"('meta' for shapes alone)")
    exact_float32()
    return dev
