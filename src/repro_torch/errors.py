"""Typed error hierarchy of the PyTorch port (the port's own copy of
``repro/errors.py``, plus the capacity signal ``PoolExhausted``).

Callers distinguish *capacity* exhaustion (retryable: the engine waits,
preempts, or sheds load) from *configuration* mistakes (non-retryable) and
from *invariant* violations (a bug in the engine itself). Each class
subclasses the builtin it replaces, so callers that catch
``ValueError``/``RuntimeError`` keep working.
"""
from __future__ import annotations

__all__ = ["ConfigError", "CacheLayoutError", "EngineInvariantError",
           "PrefixCacheInvariantError", "PoolExhausted", "KernelLaunchError"]


class ConfigError(ValueError):
    """A caller-supplied configuration or request is malformed, or asks for
    something this build does not provide (a missing device, a feature of
    a later slice). Retrying cannot fix it."""


class CacheLayoutError(ValueError):
    """A cache tensor violates the slot-cache layout contract
    (``models/cache_ops.py``): a model wired its decode step incorrectly."""


class EngineInvariantError(RuntimeError):
    """The engine violated one of its own scheduling invariants."""


class PrefixCacheInvariantError(RuntimeError):
    """The page-sharing protocol was violated (negative refcounts, a
    retained page freed)."""


class KernelLaunchError(RuntimeError):
    """A hand-written CUDA kernel failed to build or launch (the C entry
    returned a non-zero ``cudaError_t``)."""


class PoolExhausted(RuntimeError):
    """A capacity refusal: no free slot, no free page, or a request that can
    never fit the pool. Typed so the engine can tell backpressure
    (preempt / re-queue / wait) from genuine errors.

    ``uid`` is the request the refusal blocks (``None`` when none is
    attributable), ``reason`` is ``"admission"`` (prompt pages at admit
    time) or ``"decode"`` (page growth for a live slot), and page-pressure
    refusals carry the shortfall — ``pages_needed`` vs ``pages_free``."""

    def __init__(self, message: str, *, pages_needed: int | None = None,
                 pages_free: int | None = None, uid: str | None = None,
                 reason: str = "admission"):
        super().__init__(message)
        self.pages_needed = pages_needed
        self.pages_free = pages_free
        self.uid = uid
        self.reason = reason
