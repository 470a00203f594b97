"""Continuous-batching serving of the port: request queue, paged and
contiguous slot pools, and the engine loop driving the eager steps."""
from repro_torch.errors import ConfigError, EngineInvariantError

from .engine import Engine
from .queue import Request, RequestQueue, RequestResult
from .slots import PagedSlotPool, PoolExhausted, SlotEntry, SlotPool

__all__ = ["Engine", "Request", "RequestQueue", "RequestResult", "SlotEntry",
           "SlotPool", "PagedSlotPool", "PoolExhausted", "ConfigError",
           "EngineInvariantError"]
