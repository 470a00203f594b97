"""Continuous-batching serving of the port: request queue, paged and
contiguous slot pools, the copy-on-write prefix cache over the paged pool,
and the engine loop driving the steps."""
from repro_torch.errors import (ConfigError, EngineInvariantError,
                                PrefixCacheInvariantError)

from .engine import Engine
from .prefix import PrefixCache, PrefixMatch
from .queue import Request, RequestQueue, RequestResult
from .slots import PagedSlotPool, PoolExhausted, SlotEntry, SlotPool

__all__ = ["Engine", "Request", "RequestQueue", "RequestResult", "SlotEntry",
           "SlotPool", "PagedSlotPool", "PoolExhausted", "PrefixCache",
           "PrefixMatch", "ConfigError", "EngineInvariantError",
           "PrefixCacheInvariantError"]
