"""PyTorch/CUDA port of the SC-GEMM serving stack (the JAX package
``repro`` stays the reference).

The port mirrors ``repro``'s layout module for module — ``repro_torch/core``
↔ ``repro/core``, ``repro_torch/models`` ↔ ``repro/models`` and so on — and
imports neither ``jax`` nor anything of ``repro``. Each Pallas TPU kernel on
the ported path is a CUDA C++ kernel written for Hopper
(``repro_torch/kernels/csrc``), built with ``nvcc`` at first use and bound
with ``ctypes``; beside each sits a plain PyTorch version of the same
function, which a wrapper takes only for tensors on the CPU.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and raises :class:`ConfigError` when no
card is visible.
"""
from .device import resolve_device
from .errors import (CacheLayoutError, ConfigError, EngineInvariantError,
                     KernelLaunchError, PoolExhausted,
                     PrefixCacheInvariantError)

__all__ = ["resolve_device", "ConfigError", "CacheLayoutError",
           "EngineInvariantError", "KernelLaunchError", "PoolExhausted",
           "PrefixCacheInvariantError"]
